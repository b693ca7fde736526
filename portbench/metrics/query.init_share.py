"""The host's time under the search state's set-up (``query.init``:
``_init_state`` and the thresholds), as a share of the window's wall time:
the union of those spans over the window's length, read in a traced run;
None without spans."""
from portbench.spans import share_under


def read(ctx):
    return share_under(ctx, "query.init")
