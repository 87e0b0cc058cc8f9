"""Decoders: the host's time a block in the POCSAG and FLEX state machines
and in unpacking the rows they are fed, from ``pipe.timing``."""


def read(ctx):
    tm = ctx["timing"]
    s = tm.get("decode_s", 0.0) + tm.get("unpack_s", 0.0)
    return 1e3 * s / ctx["blocks"] if ctx["blocks"] and s else None
