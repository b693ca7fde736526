"""The host's time under the hash stage (``query.hash``: one ``lsh_hash``
launch for every radius, then the table lookups), as a share of the window's
wall time: the union of those spans over the window's length, read in a
traced run; None without spans."""
from portbench.spans import share_under


def read(ctx):
    return share_under(ctx, "query.hash")
