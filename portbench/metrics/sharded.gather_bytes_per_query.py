"""Bytes the sharded plan's all-gathers brought to rank 0 over the window
(``e2lsh_sharded_gather_bytes_total``: every shard's packed top-k part, one
int32 row of 2k + 5 values a query) per query answered; None without the
counter, as in a program that does not count it, or in an untraced run."""

COUNTER = "e2lsh_sharded_gather_bytes_total"


def read(ctx):
    counters = ctx["counters"]
    if not counters or COUNTER not in counters or not ctx["rows"]:
        return None
    return sum(s["value"] for s in counters[COUNTER]["samples"]) / ctx["rows"]
