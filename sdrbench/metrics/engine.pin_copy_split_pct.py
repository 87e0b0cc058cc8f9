"""Host engine: the share of uploads through the pinned ring that were
copied into their slot in more than one part, from
``stream_stats()["upload_split"]`` over ``["uploads"]``; None for a program
without the counts, or with no upload through the ring (the CPU)."""


def read(ctx):
    uploads = ctx["stats"].get("uploads")
    return 100.0 * ctx["stats"]["upload_split"] / uploads if uploads else None
