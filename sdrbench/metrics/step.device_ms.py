"""Engine step: device time of kernels and copies a block, from
``torch.profiler``'s device events in the window."""


def read(ctx):
    s = ctx["trace"]["device_s"]
    return 1e3 * s / ctx["blocks"] if ctx["blocks"] and s else None
