"""The host's time under each radius's probe (``query.probe``: ``probe_append``
and ``l2_distance_by_id``), as a share of the window's wall time: the union
of those spans over the window's length, read in a traced run; None without
spans."""
from portbench.spans import share_under


def read(ctx):
    return share_under(ctx, "query.probe")
