"""Egress gate (K7): the share of gated rows whose whole block was fetched
to the host and decoded, from ``stream_stats()["fetched"]``."""


def read(ctx):
    rows = ctx["gated_rows"] * ctx["blocks"]
    return 100.0 * float(ctx["stats"]["fetched"].sum()) / rows if rows else None
