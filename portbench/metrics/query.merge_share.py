"""The host's time under each radius's fold (``query.merge``: one
``topk_merge`` launch), as a share of the window's wall time: the union of
those spans over the window's length, read in a traced run; None without
spans."""
from portbench.spans import share_under


def read(ctx):
    return share_under(ctx, "query.merge")
