"""Rank 0's card's time in NCCL kernels (device operations whose names start
``nccl``: the sharded plan's all-gather) over the traced window's wall time.
A rank's card spins in the all-gather until every rank has sent its part,
so this is where rank 0 waits on the others. Read from the trace's ten
longest device operations by name; None without a trace."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return sum(s for name, s in tr.device_ops if name.startswith("nccl")) / tr.window_s
