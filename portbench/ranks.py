"""A cell of more than one chip: one process a card, started by ``run.py``.

``launch`` holds the ``TCPStore`` the ranks meet at and starts ``chips``
rank processes through torch's own process supervisor
(``torch.distributed.elastic.multiprocessing.start_processes``), which
returns each rank's return value and, when one rank fails, stops the
others. Rank r takes ``cuda:r`` and joins the default process group over
NCCL (gloo on the host, for the tests), and runs ``harness.run_cell`` with
its ``Ranks``: every rank makes the same data from the seed, builds its part
through the cell's tier with the ``RankLayout`` of all ranks, and makes the
same calls. Rank 0's clock ends the window; the other ranks read its
decision after each call from the store (``Ranks.agree``), not through a
collective on the card. After the window every rank frees its program and
hands its answers and readings to rank 0 through the store; rank 0 runs the
check and returns the result line.

A rank that fails ends the run with no result: so does a rank that holds
JAX or the JAX package once its window has closed, a wait on another rank
longer than ``WAIT_S`` (the store's and the process groups' timeout), and a
run longer than ``RUN_S`` in all.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import time
from typing import Optional

__all__ = ["Ranks", "launch", "WAIT_S", "RUN_S"]

WAIT_S = 600.0     # the longest one rank waits for another
RUN_S = 1150.0     # the longest a run of every rank may take, a first build included


class Ranks:
    """This process's place among a cell's ranks, and the store they share."""

    def __init__(self, rank: int, world: int, store):
        self.rank = rank
        self.world = world
        self.store = store

    def agree(self, i: int, stop: bool) -> bool:
        """Whether the window ends after call ``i``: rank 0's ``stop``, which
        the others wait for."""
        key = f"window/{i}"
        if self.rank == 0:
            self.store.set(key, b"1" if stop else b"0")
            return stop
        return self.store.get(key) == b"1"

    def barrier(self, name: str) -> None:
        """Wait until every rank has reached ``name``."""
        self.store.set(f"{name}/{self.rank}", b"1")
        self.store.wait([f"{name}/{r}" for r in range(self.world)])

    def gather(self, name: str, obj) -> Optional[list]:
        """Every rank's ``obj``, in rank order, on rank 0; None elsewhere."""
        if self.rank != 0:
            self.store.set(f"{name}/{self.rank}", pickle.dumps(obj))
            return None
        return [obj] + [pickle.loads(self.store.get(f"{name}/{r}"))
                        for r in range(1, self.world)]


def launch(root, workload: str, *, seed: int, seconds: float, trace: bool, chips: int,
           device: str = "cuda", t_start: Optional[float] = None, work_dir=None,
           wait_s: float = WAIT_S, run_s: float = RUN_S):
    """Run the cell on ``chips`` rank processes. Returns (0, rank 0's result)
    or (the exit code of the run's failure, None). The ranks' output goes to
    standard error."""
    from torch.distributed import TCPStore
    from torch.distributed.elastic.multiprocessing import DefaultLogsSpecs, start_processes
    from torch.distributed.elastic.multiprocessing.api import SignalException
    t_start = time.perf_counter() if t_start is None else t_start
    store = TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                     timeout=datetime.timedelta(seconds=wait_s))
    args = (chips, store.port, str(root), workload, int(seed), float(seconds), bool(trace),
            device, float(t_start), None if work_dir is None else str(work_dir), float(wait_s))
    procs = start_processes("portbench", _rank, {r: (r,) + args for r in range(chips)},
                            {r: {} for r in range(chips)},
                            DefaultLogsSpecs(log_dir=os.devnull))
    try:
        res = procs.wait(run_s, period=0.1)
    except SignalException:           # ended from outside: the ranks stop first
        procs.close()
        return 143, None
    if res is None:
        procs.close()
        print(f"the ranks ran past {run_s:.0f} s: the run is stopped", file=sys.stderr)
        return 124, None
    if res.is_failed():
        r, f = min(res.failures.items())
        print(f"rank {r} exited with code {f.exitcode}: the run is stopped", file=sys.stderr)
        return f.exitcode or 1, None
    return 0, res.return_values[0]


def _rank(rank: int, world: int, port: int, root: str, workload: str, seed: int,
          seconds: float, trace: bool, device: str, t_start: float, work_dir: Optional[str],
          wait_s: float) -> Optional[dict]:
    """One rank of the cell; rank 0 returns the result line, the others None."""
    os.dup2(2, 1)                      # standard output is the launcher's result alone
    import torch
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d

    from portbench.harness import run_cell
    from portbench.run import forbidden_modules

    timeout = datetime.timedelta(seconds=wait_s)
    # the groups the program makes (RankLayout.make's new_group) take c10d's
    # default timeout, not the default group's: 30 minutes on gloo
    c10d.default_pg_timeout = c10d.default_pg_nccl_timeout = timeout
    store = dist.TCPStore("127.0.0.1", port, is_master=False, timeout=timeout)
    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.PrefixStore("group", store), rank=rank,
                            world_size=world, timeout=timeout)
    try:
        out = run_cell(root, workload, seed=seed, seconds=seconds, trace=trace, device=dev,
                       t_start=t_start, work_dir=work_dir, ranks=Ranks(rank, world, store))
    finally:
        dist.destroy_process_group()
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"rank {rank} holds {bad} by the time the window closed")
    return out
