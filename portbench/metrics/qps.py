"""Queries answered over the window's wall time, the window closed by a
synchronise (ann-benchmarks' measure of batch and single-query search)."""


def read(ctx):
    if not ctx["window_s"]:
        return None
    return ctx["rows"] / ctx["window_s"]
