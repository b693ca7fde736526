"""One cell, once: set-up, the measured window, the metric readers and the
check that decides ``correct``.

A cell is found by name in ``BENCHMARK.json``. Its configuration file says
how the program is built (``tier``: ``memory``, the index on the card, or
``spill``, the index spilled to a file and served from it); its traffic
file says how it is driven: one closed-loop client that sends its next
batch of ``batch`` queries when the last returned (``loop``: ``closed``,
the only loop so far). Each metric is a file ``metrics/<name>.py`` with a
``read(ctx)`` that returns a number, or None where it finds nothing. The
limits of the check are ``limits.json``'s, the same for every cell.

``run_cell(..., device="cpu")`` runs the same path on the host at a small
configuration, for the tests; the command line insists on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from . import roofline
from .compare import Answers, judge
from .data import DataSpec, make_dataset
from .reference import RefParams, RefResult, Reference, family_from_seed

__all__ = ["Cell", "load_cell", "run_cell", "FAR"]

FAR = 1e6            # a warm-up row this far out matches no bucket entry


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic_name: str
    traffic: dict
    metrics: dict        # name -> manifest entry, the cell's end-to-end metrics first
    end_to_end: tuple    # names of the cell's end-to-end metrics
    per_layer: tuple     # names of the cell's per-layer metrics
    bench_dir: pathlib.Path


def load_cell(root, name: str) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files found by
    name under the benchmark's folder."""
    root = pathlib.Path(root)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r}; expected one of {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench_dir = root / manifest["paths"][0]
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name=name, chips=int(w["chips"]), config=cfg, traffic_name=w["traffic"],
                traffic=traffic,
                metrics={m["name"]: m for m in e2e + layer},
                end_to_end=tuple(m["name"] for m in e2e),
                per_layer=tuple(m["name"] for m in layer), bench_dir=bench_dir)


def load_reader(bench_dir: pathlib.Path, name: str):
    """The module ``metrics/<name>.py`` (its ``read(ctx)``, and ``NEEDS``, the
    extra readings it asks the harness for)."""
    path = pathlib.Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the program ---------------------------------------------------------------

class Program:
    """The system under test, built from a configuration: an index on the
    card (``tier="memory"``) or spilled to ``work_dir`` and served from the
    file (``tier="spill"``), behind ``SearchEngine``."""

    def __init__(self, cfg: dict, db: torch.Tensor, family_seed: int, device,
                 work_dir: pathlib.Path):
        from repro_torch.core import E2LSHoS, SearchEngine
        from repro_torch.core.query import QueryConfig
        b = cfg["build"]
        self.k = int(cfg["k"])
        self.plan = cfg["plan"]
        self.spill_path = None
        self.external = None
        idx = E2LSHoS.build(db, c=float(b["c"]), w=float(b["w"]), gamma=float(b["gamma"]),
                            max_L=int(b["max_L"]), block_bytes=int(b["block_bytes"]),
                            seed=family_seed, device=device)
        p = idx.params
        got = dict(m=p.m, L=p.L, r=p.r, S=p.S, u=p.u, fp_bits=p.fp_bits, w=p.w, c=p.c,
                   block_objs=p.block_objs,
                   max_chain=QueryConfig.from_params(p, k=self.k).max_chain)
        want = cfg["index"]
        self.params = got
        self.params_off = sum(1 for key, v in got.items() if float(v) != float(want[key]))
        if cfg["tier"] == "memory":
            self.engine = SearchEngine(idx, device=device)
        elif cfg["tier"] == "spill":
            from repro_torch.storage import load_external
            store = cfg["store"]
            work_dir.mkdir(parents=True, exist_ok=True)
            self.spill_path = work_dir / f"{cfg['name']}.e2l"
            idx.index.spill(self.spill_path)
            del idx
            _free(device)
            _flush_and_drop(self.spill_path)
            self.external = load_external(self.spill_path, backend=store["backend"],
                                          qd=int(store["qd"]), device=device)
            self.engine = SearchEngine(self.external)
        else:
            raise ValueError(f"unknown tier {cfg['tier']!r}")

    def query(self, rows):
        return self.engine.query(rows, plan=self.plan, k=self.k)

    def close(self) -> None:
        self.engine = None
        if self.external is not None:
            self.external.close()
            self.external = None
        if self.spill_path is not None and self.spill_path.exists():
            self.spill_path.unlink()


def _flush_and_drop(path) -> None:
    """Write the spill through to storage, then drop its pages from the
    host's page cache, so the window's reads start cold."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        if hasattr(os, "posix_fadvise"):
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- the load loop ---------------------------------------------------------------

@dataclasses.dataclass
class Window:
    """What the load loop saw: its bounds on the host clock and its work."""

    start_ns: int
    end_ns: int
    attempted: int                 # queries
    answered_rows: int
    failed: int
    kept: list                     # [(pool row ids, Answers)]
    pool_counts: np.ndarray        # executions of each pool batch
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _closed_loop(prog: Program, pool: np.ndarray, tr: dict, seconds: float, seed: int,
                 device, spans: Optional[list]) -> Window:
    B = int(tr["batch"])
    P = pool.shape[0] // B
    repeat = bool(tr["repeat"])
    keep_n = max(1, math.ceil(int(tr["check_rows"]) / B))
    rng = np.random.default_rng([int(seed), 7])
    kept: list = []
    counts = np.zeros(P, np.int64)
    nio = None
    t0 = time.perf_counter_ns()
    end = t0 + int(seconds * 1e9)
    per_s = np.zeros(int(math.ceil(seconds)) + 1, np.int64)
    i = 0
    while True:
        j = i % P
        if not repeat and i >= P:
            raise RuntimeError(f"the pool of {P} batches ran out: the traffic may "
                               "not repeat a query, so its pool must grow")
        c0 = time.perf_counter_ns() if spans is not None else 0
        res = prog.query(pool[j * B:(j + 1) * B])
        if spans is not None:
            spans.append((c0, time.perf_counter_ns(), "client.call"))
        if prog.external is not None:
            s = res.nio_blocks.sum()
            nio = s if nio is None else nio + s
        counts[j] += 1
        per_s[min(per_s.size - 1, (time.perf_counter_ns() - t0) // 1_000_000_000)] += B
        if len(kept) < keep_n:
            kept.append((j, res))
        else:
            r = int(rng.integers(0, i + 1))
            if r < keep_n:
                kept[r] = (j, res)
        i += 1
        if time.perf_counter_ns() >= end:
            break
    _sync(device)
    t1 = time.perf_counter_ns()
    out = [(np.arange(j * B, (j + 1) * B), Answers.of(res)) for j, res in kept]
    w = Window(start_ns=t0, end_ns=t1, attempted=i * B, answered_rows=i * B, failed=0,
               kept=out, pool_counts=counts)
    w.extra["rows_by_second"] = per_s[:int(seconds)].tolist()
    if nio is not None:
        w.extra["nio_blocks"] = int(nio)
    return w


# -- the run ---------------------------------------------------------------------

def _limits(cell: Cell) -> dict:
    base = json.loads((cell.bench_dir / "limits.json").read_text())
    return {key: float(v["limit"]) for key, v in base.items()}


def run_cell(root, workload: str, *, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             work_dir: Optional[pathlib.Path] = None) -> dict:
    """Run one cell once; returns the result line as a dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, optionally
    ``breakdown``, and ``checks``, each number compared beside its limit)."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = pathlib.Path(root)
    cell = load_cell(root, workload)
    cfg, tr = cell.config, cell.traffic
    work_dir = pathlib.Path(work_dir) if work_dir else root / "build" / "portbench"
    dev = torch.device(device)
    names = cell.per_layer if trace else cell.end_to_end
    readers = {n: load_reader(cell.bench_dir, n) for n in names}
    needs = set().union(*(getattr(m, "NEEDS", set()) for m in readers.values()))
    family_seed = int(seed) % (2**31 - 1)

    if tr["loop"] != "closed":
        raise ValueError(f"unknown loop {tr['loop']!r}: the harness drives a closed loop")
    B = int(tr["batch"])
    pool_n, warm_n = B * int(tr["pool_batches"]), B * int(tr["warm_calls"])
    data = make_dataset(DataSpec.from_config(cfg), pool_n + warm_n, int(seed), dev)
    host_q = data.queries.cpu().numpy()
    pool, warm = host_q[:pool_n], host_q[pool_n:]
    prog = Program(cfg, data.db, family_seed, dev, work_dir)
    try:
        prog.query(np.full((B, data.db.shape[1]), FAR, np.float32))
        for c in range(int(tr["warm_calls"])):
            prog.query(warm[c * B:(c + 1) * B])
        _sync(dev)
        store0 = prog.external.store.stats.snapshot() if prog.external else None
        totals0 = prog.external.plan_totals.snapshot() if prog.external else None
        spans = [] if trace else None
        tracer = None
        if trace:
            from repro_torch import telemetry
            tracer = telemetry.enable(sampling=1.0, capacity=1 << 22)
            tracer.clear()
        setup_s = time.perf_counter() - t_start
        dtrace = None
        if trace:
            from .trace import DeviceTrace
            dtrace = DeviceTrace()
        with dtrace if dtrace is not None else contextlib.nullcontext():
            win = _closed_loop(prog, pool, tr, seconds, seed, dev, spans)
        summary = None
        if dtrace is not None:
            from .trace import Span
            prog_spans = [Span(s.ts_ns, s.ts_ns + (s.dur_ns or 0), s.name)
                          for s in tracer.spans()]
            dtrace.window(win.start_ns, win.end_ns)
            summary = dtrace.summary(prog_spans, [Span(*s) for s in spans])
            tracer.configure(enabled=False)
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
        store = prog.external.store.stats.since(store0) if prog.external else None
        totals = prog.external.plan_totals.since(totals0) if prog.external else None
        ctx = dict(window_s=win.seconds, attempted=win.attempted, rows=win.answered_rows,
                   setup_s=setup_s, peak_bytes=peak, trace=summary, plan_totals=totals,
                   store=store, least_s=None)
        checks_extra = {}
        if prog.external is not None:
            checks_extra["store_reads_gap"] = abs(store.reads - win.extra["nio_blocks"])
        params_off, params = prog.params_off, prog.params
    finally:
        prog.close()
    del prog
    _free(dev)

    # -- the check, once the program's state is freed ------------------------
    t_check = time.perf_counter()
    p = RefParams.from_config(cfg)
    ref = Reference(data.db, family_from_seed(family_seed, p), p)
    rows = [r for r, _ in win.kept]
    if "least_s" in needs:
        rows.append(np.arange(pool.shape[0]))
    need = np.unique(np.concatenate(rows)) if rows else np.zeros(0, np.int64)
    qpool = torch.from_numpy(pool)
    answer = ref.answer(qpool[need].to(dev)).cpu()
    where = np.full(pool.shape[0], -1, np.int64)
    where[need] = np.arange(need.size)
    if win.kept:
        sel = torch.from_numpy(np.concatenate([where[r] for r, _ in win.kept]))
        sub = _take(answer, sel)
        qs = qpool[torch.from_numpy(np.concatenate([r for r, _ in win.kept]))]
        reading = judge(Answers.concat([a for _, a in win.kept]), sub, qs, ref)
    else:
        reading = dict(rows_off=1.0, dist_err=float("inf"), rows=0, ambiguous=0)
    if "least_s" in needs:
        least = 0.0
        for j in np.nonzero(win.pool_counts)[0]:
            r_j = torch.from_numpy(where[j * B:(j + 1) * B])
            least += win.pool_counts[j] * roofline.batch_least_s(
                answer.active[r_j].numpy(), answer.blocks[r_j].numpy(),
                answer.cands[r_j].numpy(), d=p.d, L=p.L, m=p.m,
                block_objs=p.block_objs, S=p.S)
        ctx["least_s"] = least

    check_s = time.perf_counter() - t_check
    limits = _limits(cell)
    checks = dict(params_off=(params_off, 0.0), unanswered=(win.failed, 0.0),
                  rows_off=(reading["rows_off"], limits["rows_off"]),
                  dist_err=(reading["dist_err"], limits["dist_err"]))
    for key, v in checks_extra.items():
        checks[key] = (v, 0.0)
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    for n in names:
        v = readers[n].read(ctx)
        if v is not None:
            metrics[n] = dict(value=float(v), unit=cell.metrics[n]["unit"])
    out = dict(correct=bool(correct), attempted=int(win.attempted), failed=int(win.failed),
               metrics=metrics, device=_device_info(dev, cell.chips, peak, summary))
    if summary is not None:
        out["breakdown"] = dict(device_ops=summary.device_ops, idle_gaps=summary.idle_gaps)
    out["info"] = dict(rows_checked=reading["rows"], rows_ambiguous=reading["ambiguous"],
                       window_s=win.seconds, setup_s=setup_s, check_s=check_s, params=params,
                       scale=data.scale,
                       **{k: v for k, v in win.extra.items() if k.endswith("_by_second")})
    out["checks"] = {k: dict(value=float(v), limit=float(lim)) for k, (v, lim) in checks.items()}
    return out


def _take(res: RefResult, sel: torch.Tensor) -> RefResult:
    return RefResult(**{f.name: getattr(res, f.name)[sel]
                        for f in dataclasses.fields(RefResult)})


def _device_info(dev: torch.device, chips: int, peak: int, summary) -> dict:
    if dev.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=int(chips),
                    memory_peak_bytes=int(peak))
    else:
        info = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    if summary is not None:
        info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    return info
