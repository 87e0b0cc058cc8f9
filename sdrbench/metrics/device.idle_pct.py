"""Device: the share of the traced window that no kernel or copy covers."""


def read(ctx):
    t = ctx["trace"]
    if not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
