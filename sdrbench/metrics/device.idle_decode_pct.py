"""Decoders: the share of the traced window in which the device idles while
the innermost program span open on the host is a decoder's
(``decoders.<protocol>``), from ``torch.profiler``'s record."""

from sdrbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "decoders.")
