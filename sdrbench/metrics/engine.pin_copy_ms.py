"""Host engine: the copy of each block into the pinned upload ring and the
enqueue of its host-to-device copy, a block (``pipe.timing["pin_copy_s"]``,
the ``engine.upload.pin_copy`` spans)."""

from sdrbench import spans


def read(ctx):
    return spans.per_block_ms(ctx, "pin_copy_s")
