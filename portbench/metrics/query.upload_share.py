"""The host's time under the batch's copy to the card (``query.upload``:
``_as_queries`` and ``_as_valid`` in ``SearchEngine.query``), as a share of
the window's wall time: the union of those spans over the window's length,
read in a traced run; None without spans."""
from portbench.spans import share_under


def read(ctx):
    return share_under(ctx, "query.upload")
