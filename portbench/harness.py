"""One cell, once: set-up, the measured window, the metric readers and the
check that decides ``correct``.

A cell is found by name in ``BENCHMARK.json``, and everything it needs by
name under the benchmark's folder, so that a deployment is added by new
files alone:

* its configuration file (``configs/<config>.json``) names a tier, a file
  ``tiers/<tier>.py`` whose ``build(cfg, data, family_seed, device,
  work_dir, layout)`` builds the program (``program.py`` says what it
  returns), and whose optional ``reference(cfg, db, family_seed, device,
  layout)`` is the plain reference that judges it (``reference.py``'s
  ``Reference`` where the tier gives none);
* its traffic file (``traffic/<mix>.json``) says how it is driven: one
  closed-loop client that sends its next batch of ``batch`` queries when
  the last returned (``loop``: ``closed``, the only loop so far);
* each metric is a file ``metrics/<name>.py`` with a ``read(ctx)`` that
  returns a number, or None where it finds nothing. A traced run's ``ctx``
  holds the program's spans and counters (``spans.py``).

The limits of the check are ``limits.json``'s, the same for every cell. A
cell of more than one chip runs one process a card (``ranks.py``); each
calls ``run_cell`` with its ``Ranks``.

``run_cell(..., device="cpu")`` runs the same path on the host at a small
configuration, for the tests; the command line insists on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from . import roofline
from .compare import Answers, judge
from .data import DataSpec, make_dataset
from .program import free, sync
from .reference import RefParams, RefResult, Reference, family_from_seed

__all__ = ["Cell", "load_cell", "load_reader", "load_tier", "run_cell", "FAR"]

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
    name under the benchmark's folder. A configuration, traffic or tier file
    that is not there, or a data generator that is unknown, fails here,
    before any work, naming what it looked for."""
    root = pathlib.Path(root)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r}; expected one of {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    if w["config"] not in configs:
        raise ValueError(f"workload {name!r} names configuration {w['config']!r}, which "
                         f"BENCHMARK.json does not list; it lists {sorted(configs)}")
    cfg_path = root / configs[w["config"]]["file"]
    if not cfg_path.is_file():
        raise FileNotFoundError(f"configuration {w['config']!r}: no file {cfg_path}")
    cfg = json.loads(cfg_path.read_text())
    bench_dir = root / manifest["paths"][0]
    tr_path = bench_dir / "traffic" / f"{w['traffic']}.json"
    if not tr_path.is_file():
        raise FileNotFoundError(f"traffic {w['traffic']!r}: no file {tr_path}")
    traffic = json.loads(tr_path.read_text())
    tier_path = bench_dir / "tiers" / f"{cfg['tier']}.py"
    if not tier_path.is_file():
        raise FileNotFoundError(f"{cfg_path} names tier {cfg['tier']!r}: no file {tier_path}")
    try:
        DataSpec.from_config(cfg)
    except ValueError as e:
        raise ValueError(f"{cfg_path}: {e}") from None
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name=name, chips=int(w["chips"]), config=cfg, traffic_name=w["traffic"],
                traffic=traffic,
                metrics={m["name"]: m for m in e2e + layer},
                end_to_end=tuple(m["name"] for m in e2e),
                per_layer=tuple(m["name"] for m in layer), bench_dir=bench_dir)


def _load_file(path: pathlib.Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(bench_dir: pathlib.Path, name: str):
    """The module ``metrics/<name>.py`` (its ``read(ctx)``, and ``NEEDS``, the
    extra readings it asks the harness for)."""
    path = pathlib.Path(bench_dir) / "metrics" / f"{name}.py"
    return _load_file(path, f"portbench_metric_{name}")


def load_tier(bench_dir: pathlib.Path, name: str):
    """The module ``tiers/<name>.py``: its ``build``, and ``reference`` where
    the tier brings its own."""
    path = pathlib.Path(bench_dir) / "tiers" / f"{name}.py"
    return _load_file(path, f"portbench_tier_{name}")


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


def _closed_loop(prog, pool: np.ndarray, tr: dict, seconds: float, seed: int,
                 device, spans: Optional[list], ranks=None) -> Window:
    """One client, closed loop, until ``seconds`` have passed after a call.
    Among ranks every rank makes the same calls; rank 0's clock ends the
    window (``Ranks.agree``)."""
    B = int(tr["batch"])
    P = pool.shape[0] // B
    repeat = bool(tr["repeat"])
    keep_n = max(1, math.ceil(int(tr["check_rows"]) / B))
    rng = np.random.default_rng([int(seed), 7])
    kept: list = []
    counts = np.zeros(P, np.int64)
    nio = None
    external = getattr(prog, "external", None)
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
        if external is not None:
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
        stop = time.perf_counter_ns() >= end
        if ranks is not None:
            stop = ranks.agree(i, stop)
        if stop:
            break
    sync(device)
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
             work_dir: Optional[pathlib.Path] = None, ranks=None) -> Optional[dict]:
    """Run one cell once; returns the result line as a dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, optionally
    ``breakdown``, and ``checks``, each number compared beside its limit).

    With ``ranks`` (``portbench.ranks.Ranks``) this is one rank of a cell of
    more than one chip: every rank builds and drives its part, and rank 0
    gathers the others' readings and answers, runs the check and returns the
    result; the other ranks return None."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = pathlib.Path(root)
    cell = load_cell(root, workload)
    cfg, tr = cell.config, cell.traffic
    work_dir = pathlib.Path(work_dir) if work_dir else root / "build" / "portbench"
    dev = torch.device(device)
    names = cell.per_layer if trace else cell.end_to_end
    readers = {n: load_reader(cell.bench_dir, n) for n in names}
    tier = load_tier(cell.bench_dir, cfg["tier"])
    needs = set().union(*(getattr(m, "NEEDS", set()) for m in readers.values()))
    family_seed = int(seed) % (2**31 - 1)

    if tr["loop"] != "closed":
        raise ValueError(f"unknown loop {tr['loop']!r}: the harness drives a closed loop")
    B = int(tr["batch"])
    pool_n, warm_n = B * int(tr["pool_batches"]), B * int(tr["warm_calls"])
    data = make_dataset(DataSpec.from_config(cfg), pool_n + warm_n, int(seed), dev)
    host_q = data.queries.cpu().numpy()
    pool, warm = host_q[:pool_n], host_q[pool_n:]
    layout = None
    if ranks is not None:
        from repro_torch.core.distributed import RankLayout
        layout = RankLayout.make(ranks.world)
    prog = tier.build(cfg, data, family_seed, dev, work_dir, layout)
    external = getattr(prog, "external", None)
    try:
        prog.query(np.full((B, data.db.shape[1]), FAR, np.float32))
        for c in range(int(tr["warm_calls"])):
            prog.query(warm[c * B:(c + 1) * B])
        sync(dev)
        store0 = external.store.stats.snapshot() if external else None
        totals0 = external.plan_totals.snapshot() if external else None
        spans = [] if trace else None
        tracer = None
        if trace:
            from repro_torch import telemetry
            tracer = telemetry.enable(sampling=1.0, capacity=1 << 22)
            tracer.clear()
            telemetry.get_registry().reset()    # snapshots count from here
        if ranks is not None:
            ranks.barrier("window")
        setup_s = time.perf_counter() - t_start
        dtrace = None
        if trace and dev.type == "cuda":
            from .trace import DeviceTrace
            dtrace = DeviceTrace()
        with dtrace if dtrace is not None else contextlib.nullcontext():
            win = _closed_loop(prog, pool, tr, seconds, seed, dev, spans, ranks)
        summary = prog_spans = counters = None
        if trace:
            from .spans import window_spans
            prog_spans = window_spans(tracer.spans(), win.start_ns, win.end_ns)
            counters = telemetry.snapshot()
            tracer.configure(enabled=False)
        if dtrace is not None:
            from .trace import Span
            dtrace.window(win.start_ns, win.end_ns)
            summary = dtrace.summary([Span(s.start_ns, s.end_ns, s.name) for s in prog_spans],
                                     [Span(*s) for s in spans])
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
        store = external.store.stats.since(store0) if external else None
        totals = external.plan_totals.since(totals0) if external else None
        ctx = dict(window_s=win.seconds, attempted=win.attempted, rows=win.answered_rows,
                   setup_s=setup_s, peak_bytes=peak, trace=summary, plan_totals=totals,
                   store=store, least_s=None, spans=prog_spans, counters=counters)
        checks_extra = {}
        if external is not None:
            checks_extra["store_reads_gap"] = abs(store.reads - win.extra["nio_blocks"])
        params_off, params = prog.params_off, prog.params
    finally:
        prog.close()
    del prog, external
    free(dev)

    if ranks is not None:
        # every rank's program is freed before rank 0 checks the answers of all
        mine = dict(kept=win.kept, failed=win.failed, peak=peak, params_off=params_off,
                    checks=checks_extra, busy_s=summary.busy_s if summary else None)
        parts = ranks.gather("readings", mine)
        if parts is None:
            return None
        win.kept = [kv for part in parts for kv in part["kept"]]
        win.failed = sum(part["failed"] for part in parts)
        peak = ctx["peak_bytes"] = max(part["peak"] for part in parts)
        params_off = max(part["params_off"] for part in parts)
        for key in checks_extra:
            checks_extra[key] = max(part["checks"][key] for part in parts)
        if summary is not None:
            by_rank = [part["busy_s"] for part in parts]
            summary = dataclasses.replace(summary, busy_s=sum(by_rank) / len(by_rank))
            ctx["trace"] = summary

    # -- the check, once the program's state is freed ------------------------
    t_check = time.perf_counter()
    p = RefParams.from_config(cfg)
    if hasattr(tier, "reference"):
        ref = tier.reference(cfg, data.db, family_seed, dev, layout)
    else:
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
    if ranks is not None and summary is not None:
        out["device"].update(busy_s_by_rank=by_rank, breakdown_of="rank 0's card")
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
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=int(chips),
                    memory_peak_bytes=int(peak))
    else:
        info = dict(platform="cpu", kind="cpu", count=int(chips), memory_peak_bytes=0)
    if summary is not None:
        info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    return info
