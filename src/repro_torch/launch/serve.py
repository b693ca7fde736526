"""Serving launcher: batched ANN serving (the paper's workload) and LM
serving with kNN retrieval over an E2LSHoS index, served by the port.

    # build an index over a synthetic dataset and answer one query batch
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann --dataset sift \
        --n 20000 --queries 256 --k 10

    # micro-batched serving front end: a ragged request stream through the
    # BatchQueue (ONE plan dispatch per tick; per-tick occupancy/pad stats)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann --queue \
        --tick-us 200 --max-batch 128 --queries 256

    # external-memory serving with QoS deadlines: blocks striped across 2
    # per-shard spill files behind io_uring, queued requests shed with
    # DeadlineExceeded when their budget expires
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann --queue \
        --shards 2 --store uring --deadline-ms 50

    # the sharded plan across ranks: one range shard a rank, the merge an
    # all-gather (with --queue: rank 0 owns the queue, the others follow)
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc_per_node 2 -m repro_torch.launch.serve --mode ann --n-points 20000

    # LM decode with the retrieval hook: each step's logits probe an index
    # over a datastore in the logits space
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch mamba2-1.3b --reduced --steps 8 --retrieval

Runs on the CUDA device unless ``--device cpu`` is given; without a card and
without that flag it raises instead of carrying on on the host. Under
``torch.distributed.run`` (``WORLD_SIZE`` > 1) ``--mode ann`` serves the
sharded plan, the counterpart of the reference's multi-device branch: each
rank builds its own shard and joins the group over ``nccl`` with one card a
rank (``cuda:LOCAL_RANK``) where there are as many cards as ranks, and
otherwise over ``gloo`` with every rank on ``cuda:0`` (``nccl`` refuses two
ranks on one card); ``--device cpu`` runs over ``gloo`` on the host. Rank 0
prints the transport and the results.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import pathlib
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry
from ..configs import get_config
from ..core import E2LSHoS, SearchEngine, measured_query, overall_ratio
from ..core.distributed import RankLayout, build_local_shard
from ..core.e2lshos import _sync
from ..data import make_dataset
from ..kernels.dispatch import resolve_device
from ..models import Model
from ..serving import BatchQueue, DeadlineExceeded, ServeEngine

__all__ = ["main", "serve_ann", "serve_ann_queued", "serve_ann_external", "serve_ann_ranks",
           "join_ranks", "serve_lm", "lm_inputs"]

RANK_TIMEOUT_S = 300     # a collective that waits longer fails the run


def _ragged_requests(queries: np.ndarray, *, max_batch: int, seed: int):
    """Split the query set into a ragged request stream (sizes 1..max_batch/4,
    the arbitrary-per-caller shapes the queue exists to absorb)."""
    rng = np.random.default_rng(seed + 1)
    out, i = [], 0
    hi = max(2, max_batch // 4)
    while i < queries.shape[0]:
        b = int(rng.integers(1, hi + 1))
        out.append(queries[i:i + b])
        i += b
    return out


def serve_ann_queued(args, engine: SearchEngine, queries: np.ndarray,
                     gt_dists: np.ndarray, *, plan=None):
    """Serve a ragged request stream through the micro-batching queue and
    report per-tick occupancy / pad waste / dispatch p50/p99 vs the direct
    per-request baseline."""
    ladder = tuple(int(s) for s in args.ladder.split(","))
    plan = plan or engine.default_plan
    requests = _ragged_requests(queries, max_batch=args.max_batch,
                                seed=args.seed)
    # direct baseline: one dispatch per request at its own shape (on a
    # multi-rank engine every rank makes these calls)
    _, direct_fn = engine.make_plan_fn(plan=plan, k=args.k)
    for r in requests:
        direct_fn(r)                 # first sight of every request shape
    _sync(engine.device)
    t0 = time.perf_counter()
    for r in requests:
        direct_fn(r)
    _sync(engine.device)
    t_direct = time.perf_counter() - t0
    if engine.group is not None and dist.get_rank() != engine.group.leader:
        BatchQueue.follow(engine, plan=plan, k=args.k)   # until the leader closes
        return
    queue = BatchQueue(engine, plan=plan, k=args.k, ladder=ladder,
                       max_batch=args.max_batch, tick_us=args.tick_us)

    deadline_ms = getattr(args, "deadline_ms", None)
    t0 = time.perf_counter()
    with queue:
        tickets = [queue.submit(r, deadline_ms=deadline_ms) for r in requests]
        # grade only the served requests (the shed ones return no dists);
        # requests are consumed in stream order, so gt rows line up
        served, served_rows, lo = [], 0, 0
        for t, r in zip(tickets, requests):
            hi = lo + r.shape[0]
            try:
                served.append((t.result(timeout=600), gt_dists[lo:hi, :args.k]))
                served_rows += r.shape[0]
            except DeadlineExceeded:
                pass   # shed by the QoS router; counted below
            lo = hi
    t_queued = time.perf_counter() - t0
    queue.close()
    rows = queries.shape[0]
    s = queue.stats_summary()
    ratio = overall_ratio(
        np.concatenate([res.dists.numpy() for res, _ in served]),
        np.concatenate([g for _, g in served]))
    print(f"[queue] {len(requests)} requests / {rows} rows in "
          f"{s['ticks']} ticks ({s['dispatches']} dispatches); "
          f"occupancy {s['occupancy_mean']:.2f}, pad waste {s['pad_waste']:.2f}")
    print(f"[queue] dispatch p50 {s['p50_dispatch_ms']:.2f} ms / "
          f"p99 {s['p99_dispatch_ms']:.2f} ms; ratio={ratio:.4f}")
    qos = s["qos"]
    if deadline_ms is not None:
        print(f"[queue] qos: deadline {deadline_ms:.0f}ms, "
              f"hit rate {qos.get('deadline_hit_rate', 1.0):.3f}, "
              f"shed {qos['shed']}/{qos['tickets']} tickets")
    print(f"[queue] qps {served_rows / t_queued:.0f} queued vs "
          f"{rows / t_direct:.0f} direct ({t_direct / t_queued:.2f}x)")


def serve_ann_external(args, ds, device: torch.device):
    """--store mmap|aio|uring|mem: build, spill, and serve the index FROM
    STORAGE through plan="external" (block rows on disk behind the selected
    BlockStore backend; hash tables and coordinates resident on the device).
    With --shards N > 1 the block file is striped round-robin across N
    per-shard spill files (the paper's multi-drive layout) and served through
    plan="sharded_external" — bit for bit the single-file plan, with a
    per-shard I/O ledger rolled into the global one."""
    from ..storage import load_external, load_external_sharded, spill_index_sharded

    shards = max(1, int(getattr(args, "shards", 1)))
    plan = "sharded_external" if shards > 1 else "external"
    idx = E2LSHoS.build(ds.db, gamma=args.gamma, max_L=args.max_L,
                        seed=args.seed, device=device)
    with contextlib.ExitStack() as stack:
        if args.spill:     # operator-chosen path: keep the spill around
            spill = pathlib.Path(args.spill)
        else:              # scratch spill: cleaned up on exit
            tmp = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="serve_spill_"))
            spill = pathlib.Path(tmp) / ("index" if shards > 1
                                         else "index.e2l")
        if shards > 1:
            spill_index_sharded(spill, idx.index.arrays, shards,
                                params=idx.index.params,
                                stats=idx.index.stats)
            size = sum(f.stat().st_size for f in spill.iterdir())
            print(f"[external] spilled {size/1e6:.1f} MB -> {spill} "
                  f"({shards} shard stripes; backend={args.store}, "
                  f"qd={args.qd})")
            ext = stack.enter_context(
                load_external_sharded(spill, backend=args.store, qd=args.qd,
                                      direct=args.direct, device=device))
        else:
            idx.index.spill(spill)
            print(f"[external] spilled {spill.stat().st_size/1e6:.1f} MB -> "
                  f"{spill} (backend={args.store}, qd={args.qd})")
            ext = stack.enter_context(
                load_external(spill, backend=args.store, qd=args.qd,
                              direct=args.direct, device=device))
        engine = SearchEngine(ext)
        # startup provenance: the resolved backend, and — when the probe
        # rejected the requested one — where it fell back from and why
        fb_from = getattr(ext.store, "fallback_from", None)
        fb_reason = getattr(ext.store, "fallback_reason", None)
        print(f"[external] store backend={ext.store.name}"
              + (f" shards={shards}" if shards > 1 else "")
              + (f" fallback_from={fb_from} reason={fb_reason!r}"
                 if fb_from else ""))
        if ext.store.name == "uring":
            st0 = ext.store.shards[0] if shards > 1 else ext.store
            mode = "O_DIRECT" if st0.o_direct else "buffered"
            print(f"[external] uring engine up: qd={st0.qd}, {mode} "
                  f"(align={st0.align})")
        if args.queue:
            serve_ann_queued(args, engine, ds.queries, ds.gt_dists, plan=plan)
            s = ext.store.stats
            print(f"[external] store: {s.reads} block reads, "
                  f"hit rate {s.hit_rate:.2f}, {s.device_reads} device reads, "
                  f"{s.prefetch_reads} prefetched")
            if shards > 1:
                for i, ps in enumerate(ext.store.per_shard_stats()):
                    print(f"[external]   shard {i}: {ps.reads} reads, "
                          f"hit rate {ps.hit_rate:.2f}")
            return
        _, fn = engine.make_plan_fn(plan=plan, k=args.k)
        fn(ds.queries)                 # warm: kernel libraries, allocator
        _sync(device)
        t0 = time.perf_counter()
        res = fn(ds.queries)
        _sync(device)
        dt = time.perf_counter() - t0
        ps = engine.external.last_plan_stats
        ratio = overall_ratio(res.dists.cpu().numpy(), ds.gt_dists[:, :args.k])
        print(f"[external/{args.store}] ratio={ratio:.4f} "
              f"nio/query={float(res.nio.float().mean()):.0f} "
              f"t/query={dt/args.queries*1e6:.0f}us")
        print(f"[external/{args.store}] measured N_io={ps.measured_nio_blocks} "
              f"(counters agree: {ps.measured_nio_blocks == ps.nio_blocks_counted}), "
              f"cache hit rate {ps.cache_hit_rate:.2f}")
        for r in ps.rungs:
            print(f"[external/{args.store}]   rung {r.t}: "
                  f"{r.active_queries} active, {r.blocks_fetched} blocks in "
                  f"{r.fetch_ms:.1f}ms, prefetched {r.prefetch_rows} under "
                  f"{r.compute_wait_ms:.1f}ms of compute wait")


def join_ranks(device_arg) -> tuple:
    """Join the ``torch.distributed`` group that ``torch.distributed.run``
    describes in the environment: (device, transport). One card a rank over
    nccl where there are as many cards as ranks; otherwise every rank on
    ``cuda:0`` over gloo (nccl refuses two ranks on one card); gloo on the
    host for ``device_arg="cpu"``. Without a card and without "cpu" it
    raises. A collective that waits ``RANK_TIMEOUT_S`` fails."""
    world = int(os.environ["WORLD_SIZE"])
    device = resolve_device(device_arg)      # raises before any work
    if device.type == "cpu":
        backend = "gloo"
    elif torch.cuda.device_count() >= world:
        backend, device = "nccl", torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    else:
        backend, device = "gloo", torch.device("cuda", 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    return device, backend


def serve_ann_ranks(args, ds, device, transport):
    """The sharded plan across the group's ranks (the counterpart of the
    reference's multi-device branch): each rank builds its range shard of
    the database, and one batch goes through ``plan="sharded"`` directly,
    or with ``--queue`` the request stream through rank 0's queue."""
    world = dist.get_world_size()
    layout = RankLayout.make(world)
    if layout.leader == dist.get_rank():
        print(f"[ranks] world={world} transport={transport} device={device} "
              f"layout={layout.shards}x{layout.query_groups} (index x query)", flush=True)
    local = build_local_shard(ds.db, world, layout.shard, gamma=args.gamma,
                              max_L=args.max_L, seed=args.seed, device=device)
    engine = SearchEngine(local, device=device, group=layout)
    if args.queue:
        serve_ann_queued(args, engine, ds.queries, ds.gt_dists, plan="sharded")
        return
    engine.query(ds.queries, plan="sharded", k=args.k)    # warm: kernels, allocator
    _sync(device)
    t0 = time.perf_counter()
    res = engine.query(ds.queries, plan="sharded", k=args.k)
    _sync(device)
    dt = time.perf_counter() - t0
    if layout.leader == dist.get_rank():
        ratio = overall_ratio(res.dists.cpu().numpy(), ds.gt_dists[:, :args.k])
        print(f"[sharded x{world}] ratio={ratio:.4f} "
              f"nio/query={float(res.nio.float().mean()):.0f} "
              f"t/query={dt/args.queries*1e6:.0f}us", flush=True)


def serve_ann(args):
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if args.store != "ram":
            raise ValueError("--store serves from one process; across ranks the "
                             "sharded plan holds its shards in memory (--store ram)")
        device, transport = join_ranks(args.device)
        try:
            ds = make_dataset(args.dataset, n=args.n, n_queries=args.queries,
                              seed=args.seed)
            serve_ann_ranks(args, ds, device, transport)
        finally:
            dist.destroy_process_group()
        return
    device = resolve_device(args.device)     # raises before any work
    ds = make_dataset(args.dataset, n=args.n, n_queries=args.queries, seed=args.seed)
    if args.store != "ram":
        serve_ann_external(args, ds, device)
        return
    idx = E2LSHoS.build(ds.db, gamma=args.gamma, max_L=args.max_L, seed=args.seed,
                        device=device)
    if args.queue:
        serve_ann_queued(args, SearchEngine(idx, device=device), ds.queries,
                         ds.gt_dists, plan=args.plan)
        return
    mq = measured_query(idx, ds.queries, k=args.k, plan=args.plan)
    ratio = overall_ratio(mq.result.dists.cpu().numpy(), ds.gt_dists[:, :args.k])
    print(f"[single/{args.plan}] ratio={ratio:.4f} nio/query={mq.nio_mean:.0f} "
          f"cands={mq.cands_mean:.0f} radii={mq.radii_mean:.2f} "
          f"t/query={mq.t_compute_per_query*1e6:.0f}us")
    fp = idx.footprint()
    print(f"index on storage: {fp.index_on_storage/1e6:.1f} MB; "
          f"DRAM: {fp.dram_usage/1e6:.1f} MB (index part {fp.dram_index_part/1e6:.2f} MB)")


def lm_inputs(cfg, *, batch: int, seq: int, dstore: int, seed: int, device):
    """The LM server's inputs, drawn from one numpy stream seeded ``seed`` in
    the reference's order: the prompt batch ({"tokens": [B, T] int32, +
    "frames" [B, enc_frames, d] float32 for encdec}, on ``device``), then
    the datastore, ``dstore`` unit-norm rows of width ``vocab`` (numpy
    float32; 0 rows gives None)."""
    rng = np.random.default_rng(seed)
    inputs = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)).to(device)}
    if cfg.family == "encdec":
        inputs["frames"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)).to(device)
    if not dstore:
        return inputs, None
    # kNN-LM style: a datastore of random "context" vectors in the model's
    # output space
    ds = rng.normal(size=(dstore, cfg.vocab)).astype(np.float32)
    ds /= np.linalg.norm(ds, axis=1, keepdims=True)
    return inputs, ds


def serve_lm(args):
    device = resolve_device(args.device)     # raises before any work
    cfg = get_config(args.arch, reduced=args.reduced)
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    batch, dstore = lm_inputs(cfg, batch=args.batch, seq=args.seq,
                              dstore=args.dstore if args.retrieval else 0, seed=args.seed,
                              device=device)
    retrieval_fn = None
    if args.retrieval:
        idx = E2LSHoS.build(dstore, gamma=0.8, max_L=16, seed=args.seed, device=device)
        retrieval_fn = ServeEngine.make_retrieval_fn(idx, k=args.k, device=device)
    eng = ServeEngine(model, params, max_seq=args.seq + args.steps + 1,
                      cache_dtype=cfg.activation_dtype, retrieval_fn=retrieval_fn,
                      device=device)
    t0 = time.perf_counter()
    out = eng.generate(batch, steps=args.steps)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.tokens.shape)} in {dt:.2f}s "
          f"({dt / args.steps * 1e3:.0f} ms/step at batch {args.batch})")
    if out.neighbors is not None:
        print(f"retrieved neighbors per step: {tuple(out.neighbors.shape)}")
    print("sample:", out.tokens[0, :16].cpu().numpy())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("ann", "lm"), default="ann")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu (the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--plan", "--engine", dest="plan",
                    choices=("fused", "oracle", "host"), default="fused",
                    help="in-memory query execution plan: the fused kernel "
                         "path, the plain oracle, or the host-driven loop")
    ap.add_argument("--dataset", default="sift")
    ap.add_argument("--n", "--n-points", dest="n", type=int, default=20000,
                    help="database size (spelled --n-points under torch 2.11's "
                         "torch.distributed.run, which reads --n as an "
                         "abbreviation of its own options)")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--queue", action="store_true",
                    help="serve a ragged request stream through the dynamic "
                         "micro-batching BatchQueue (one plan dispatch per "
                         "tick) and report occupancy/pad/p50/p99 vs direct "
                         "per-request dispatch")
    ap.add_argument("--tick-us", dest="tick_us", type=float, default=200.0,
                    help="queue tick interval in microseconds")
    ap.add_argument("--max-batch", dest="max_batch", type=int, default=128,
                    help="max rows per tick (larger requests spill)")
    ap.add_argument("--ladder", default="8,32,128",
                    help="batch-shape ladder, comma-separated")
    ap.add_argument("--store", choices=("ram", "mem", "mmap", "aio", "uring"),
                    default="ram",
                    help="where bucket blocks live: ram (in-memory plans), "
                         "or a spill served by plan=\"external\" through the "
                         "mem (in-memory parity store), mmap (sync QD1), aio "
                         "(thread-pool fan-out + cache + prefetch), or uring "
                         "(io_uring batch submission + O_DIRECT where "
                         "supported; falls back to aio with a warning) "
                         "BlockStore backend")
    ap.add_argument("--qd", type=int, default=16,
                    help="async backend queue depth (pread fan-out width "
                         "for aio; reads in flight at the device for uring)")
    ap.add_argument("--no-direct", dest="direct", action="store_false",
                    help="keep the uring backend on buffered (page-cache) "
                         "reads instead of O_DIRECT")
    ap.add_argument("--spill", default=None,
                    help="spill path for --store (default: a temporary "
                         "directory); a directory when --shards > 1")
    ap.add_argument("--shards", type=int, default=1,
                    help="stripe the block file round-robin across N "
                         "per-shard spill files and serve through "
                         "plan=\"sharded_external\"")
    ap.add_argument("--deadline-ms", dest="deadline_ms", type=float,
                    default=None,
                    help="per-request deadline for --queue: requests still "
                         "unserved when it expires are shed with "
                         "DeadlineExceeded; the QoS hit rate and shed "
                         "counts are reported after the run")
    ap.add_argument("--gamma", type=float, default=0.8)
    ap.add_argument("--max-L", dest="max_L", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="mamba2-1.3b", help="--mode lm: the model")
    ap.add_argument("--reduced", action="store_true",
                    help="--mode lm: the arch's reduced (CPU-test) config")
    ap.add_argument("--batch", type=int, default=2, help="--mode lm: prompts")
    ap.add_argument("--seq", type=int, default=64, help="--mode lm: prompt tokens")
    ap.add_argument("--steps", type=int, default=8, help="--mode lm: decode steps")
    ap.add_argument("--retrieval", action="store_true",
                    help="--mode lm: probe an E2LSHoS index over the datastore with "
                         "each decode step's logits")
    ap.add_argument("--dstore", type=int, default=5000,
                    help="--mode lm: datastore rows for --retrieval")
    ap.add_argument("--metrics-port", dest="metrics_port", type=int,
                    default=None,
                    help="expose live telemetry over HTTP while serving: "
                         "/metrics (Prometheus text), /trace?last=N "
                         "(Perfetto-loadable chrome trace of the last N "
                         "spans), /snapshot (raw JSON). 0 picks an "
                         "ephemeral port (printed at startup)")
    ap.add_argument("--trace-sampling", dest="trace_sampling", type=float,
                    default=1.0,
                    help="span-tracing sample rate when --metrics-port is "
                         "up (per query tree; 0 disables tracing but keeps "
                         "/metrics live)")
    args = ap.parse_args(argv)
    server = None
    if args.metrics_port is not None:
        if args.trace_sampling > 0:
            telemetry.enable(sampling=args.trace_sampling)
        server = telemetry.MetricsServer(args.metrics_port).start()
        print(f"[telemetry] live at {server.url}/metrics "
              f"(+ /trace?last=N, /snapshot; "
              f"trace sampling {args.trace_sampling:g})")
    try:
        if args.mode == "ann":
            serve_ann(args)
        else:
            serve_lm(args)
    finally:
        if server is not None:
            server.stop()


if __name__ == "__main__":
    main()
