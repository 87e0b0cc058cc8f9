"""Engine step: the host's time enqueueing a block's device work (widen,
K1, the resamplers, the stages after them, the state merges), a block
(``pipe.timing["launch_s"]``, the ``engine.step.launch`` spans)."""

from sdrbench import spans


def read(ctx):
    return spans.per_block_ms(ctx, "launch_s")
