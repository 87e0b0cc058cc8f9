"""The ratio groups' resamplers (K3 ``ops/row_resampler.py``, K4
``ops/frame_resampler.py``): the least time the window's blocks need,
counted from each group's rows, ratio and taps, over their profiled device
time."""

from sdrbench import roofline, trace
from sdrbench.bench import channel_table
from sdrbench.reference import receiver

KERNELS = ("row_resample_kernel", "frame_resample_kernel")


def read(ctx):
    t = trace.device_s(ctx["trace"], KERNELS)
    if not t:
        return None
    cfg = ctx["cfg"]
    rate = cfg["sampleRateHz"] / cfg["decimationFactor"]
    rows = {}
    for _, proto in channel_table(cfg):
        gid = receiver.ratio(proto, rate)
        rows[gid] = rows.get(gid, 0) + 1
    k_in = ctx["block"] // cfg["decimationFactor"]
    least = sum(roofline.resample_least_s(k_in, g, ip, dp,
                                         roofline.resampler_taps(ip, dp))
                for (ip, dp), g in rows.items() if (ip, dp) != (1, 1))
    return 100.0 * least * ctx["blocks"] / t
