"""Queries answered from the spilled index over the window's wall time,
the window closed by a synchronise. Named apart from ``qps``: its spread
comes from the host and the file system."""


def read(ctx):
    return ctx["rows"] / ctx["window_s"]
