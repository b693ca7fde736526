"""The host's time under the sharded plan's merge of the gathered shard parts
(``query.shard_merge``: ``core/distributed.py``'s ``_merge``, a stable sort of
every shard's top-k by squared distance), as a share of the window's wall
time: the union of those spans over the window's length, read in a traced
run; None without spans."""
from portbench.spans import share_under


def read(ctx):
    return share_under(ctx, "query.shard_merge")
