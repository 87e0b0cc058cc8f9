"""K1 (channelizer + discriminator, ``ops/chain.py`` -> ``csrc/chain.cu``,
``csrc/bank.cu``): the least time the window's blocks need, counted from
the configuration's samples, channels, taps and decimation, over K1's
profiled device time."""

from sdrbench import roofline, trace

KERNELS = ("chain_kernel", "bank_kernel")


def read(ctx):
    t = trace.device_s(ctx["trace"], KERNELS)
    if not t:
        return None
    cfg = ctx["cfg"]
    least = roofline.k1_least_s(
        ctx["block"], len(cfg["channels"]), len(cfg["lpfTaps"]),
        cfg["decimationFactor"], cfg["wire"]) * ctx["blocks"]
    return 100.0 * least / t
