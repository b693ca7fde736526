"""Queries answered over the window's wall time, the window closed by a
synchronise (ann-benchmarks' measure of batch and single-query search)."""


def read(ctx):
    return ctx["rows"] / ctx["window_s"]
