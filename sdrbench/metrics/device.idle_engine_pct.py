"""Host engine: the share of the traced window in which the device idles
while the innermost program span open on the host is the engine's
(``engine.*``: pump, dispatch, upload, launches, drain), from
``torch.profiler``'s record."""

from sdrbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "engine.")
