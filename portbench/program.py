"""What the tiers share: the index built as a configuration states it, and the
handle the harness drives (``query(rows)``, ``close()``, ``params``,
``params_off``, ``external``).

A tier is a file ``tiers/<tier>.py`` with ``build(cfg, data, family_seed,
device, work_dir, layout)`` that returns such a handle; ``layout`` is the
``RankLayout`` of a cell of more than one chip and None otherwise.
"""
from __future__ import annotations

import gc
import os

import torch

__all__ = ["Served", "build_index", "flush_and_drop", "free", "sync"]


def build_index(cfg: dict, db: torch.Tensor, family_seed: int, device):
    """``E2LSHoS.build`` under the configuration's build rule. Returns (the
    index, its parameters as built, how many of them differ from the
    configuration's ``index``)."""
    from repro_torch.core import E2LSHoS
    from repro_torch.core.query import QueryConfig
    b = cfg["build"]
    idx = E2LSHoS.build(db, c=float(b["c"]), w=float(b["w"]), gamma=float(b["gamma"]),
                        max_L=int(b["max_L"]), block_bytes=int(b["block_bytes"]),
                        seed=family_seed, device=device)
    p = idx.params
    got = dict(m=p.m, L=p.L, r=p.r, S=p.S, u=p.u, fp_bits=p.fp_bits, w=p.w, c=p.c,
               block_objs=p.block_objs,
               max_chain=QueryConfig.from_params(p, k=int(cfg["k"])).max_chain)
    want = cfg["index"]
    return idx, got, sum(1 for key, v in got.items() if float(v) != float(want[key]))


class Served:
    """A built program behind ``SearchEngine``: ``query(rows)`` runs the
    configuration's plan at its k. ``external`` is the external index where
    the plan serves one (its store and plan totals are read around the
    window); ``files`` are deleted at ``close()``."""

    def __init__(self, engine, cfg: dict, params: dict, params_off: int, *,
                 external=None, files=()):
        self.engine = engine
        self.k = int(cfg["k"])
        self.plan = cfg["plan"]
        self.params = params
        self.params_off = params_off
        self.external = external
        self.files = tuple(files)

    def query(self, rows):
        return self.engine.query(rows, plan=self.plan, k=self.k)

    def close(self) -> None:
        self.engine = None
        if self.external is not None:
            self.external.close()
            self.external = None
        for path in self.files:
            if path.exists():
                path.unlink()


def flush_and_drop(path) -> None:
    """Write a file through to storage, then drop its pages from the host's
    page cache, so the window's reads start cold."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        if hasattr(os, "posix_fadvise"):
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
