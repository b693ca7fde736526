"""The kernels' share of their roofline, in %: the least time the window's
batches need on the H100 (each radius's hashing by operations, its chain
rows and candidate rows by bytes, counted by the plain reference for the
rows each batch searched there; ``portbench.roofline``) over the device's
busy time in the traced window. Busy time, not time under kernel names, so
that a fused or renamed kernel leaves the share meaningful."""

NEEDS = {"least_s"}


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["least_s"] is None or tr.busy_s <= 0:
        return None
    return 100.0 * ctx["least_s"] / tr.busy_s
