"""Engine step: the share of the window's blocks whose K1 read the rtl_u8
bytes as they were uploaded, with no widening pass on the device, from
``stream_stats()["k1_wire8"]`` over ``["blocks"]``; None for a program
without the count."""


def read(ctx):
    n, blocks = ctx["stats"].get("k1_wire8"), ctx["stats"]["blocks"]
    return 100.0 * n / blocks if n is not None and blocks else None
