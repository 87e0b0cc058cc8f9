"""Host engine: the time the host thread is blocked on the card, a block:
waiting for an upload ring slot's last copy and for the device-to-host
copies it drains (``pipe.timing`` ``ring_wait_s`` + ``drain_wait_s``, the
``engine.upload.ring_wait`` and ``engine.drain.wait`` spans)."""

from sdrbench import spans


def read(ctx):
    return spans.per_block_ms(ctx, "ring_wait_s", "drain_wait_s")
