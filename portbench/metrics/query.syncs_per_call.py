"""Early-exit reads (``query.sync`` spans, one a radius searched plus the
last that finds every row done) per call of ``SearchEngine.query`` (root
``query`` spans) in the traced window; None without spans."""
from portbench.spans import count


def read(ctx):
    calls = count(ctx, "query", root=True)
    if not calls:
        return None
    return count(ctx, "query.sync") / calls
