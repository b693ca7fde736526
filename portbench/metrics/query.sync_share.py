"""The host's time under the early-exit reads (``query.sync``: the host blocked
on ``bool(done.all())``, once a radius), as a share of the window's wall
time: the union of those spans over the window's length, read in a traced
run; None without spans."""
from portbench.spans import share_under


def read(ctx):
    return share_under(ctx, "query.sync")
