"""Queries answered from the spilled index over the window's wall time,
the window closed by a synchronise. Named apart from ``qps``: its spread
comes from the host and the file system."""


def read(ctx):
    if not ctx["window_s"]:
        return None
    return ctx["rows"] / ctx["window_s"]
