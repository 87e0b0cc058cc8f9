"""Host engine: the dispatch thread's blocked time a block (the upload into
pinned memory and its copy, the device step's launches, the start of the
egress copies), from ``pipe.timing``."""


def read(ctx):
    tm = ctx["timing"]
    s = sum(tm.get(k, 0.0) for k in ("dispatch_s", "upload_s",
                                      "egress_start_s"))
    return 1e3 * s / ctx["blocks"] if ctx["blocks"] and s else None
