"""K1 on the 8-bit wire (``csrc/chain.cu``'s ``uint8_t`` instantiation,
which widens the RTL-SDR's bytes in registers as it stages them): the
least time the window's blocks need, counted from the configuration's
samples, channels, taps and decimation with the rtl_u8 wire's 2 bytes a
sample in, over that instantiation's profiled device time; None where no
K1 launch read the 8-bit wire (a program that widens the block first)."""

from sdrbench import roofline


def read(ctx):
    t = [v["s"] for n, v in ctx["trace"]["kernels"].items()
         if "chain_kernel" in n and "unsigned char" in n]
    if not t:
        return None
    cfg = ctx["cfg"]
    least = roofline.k1_least_s(
        ctx["block"], len(cfg["channels"]), len(cfg["lpfTaps"]),
        cfg["decimationFactor"], "rtl_u8") * ctx["blocks"]
    return 100.0 * least / sum(t)
