#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three paths at the SIFT1M shape of the paper's Table 1
(n = 1,000,000, d = 128, 256 queries, synthetic data from seed 0) with the
ANN server's defaults (gamma = 0.8, max_L = 32, c = 2, w = 4, 512 B blocks),
and holds each to the repo's own contracts:

  1. the card: name and power limit; the four hand-written kernels built
     from ``src/repro_torch/csrc`` by nvcc, one process per source;
  2. ``[main]`` the in-memory path — build an E2LSHoS index, answer batches
     through ``SearchEngine.query(plan="fused")``: launch counts (each of
     its kernels > 0), qps and p50 per batch, the overall ratio against
     exact ground truth, peak device memory, a device profile; then
     ``[oracle]``, which must match fused on every row whose kernel hashes
     equal the plain hashes;
  3. ``[exact]`` the exact k-NN baseline (``baselines.exact_knn``, the dense
     ``l2_distance`` kernel per 16,384-row block) over all n points, held to
     the dataset's float64 ground truth;
  4. ``[spill]`` the SIFT1M index spilled to ``--spill-dir`` (about 20 GB;
     free space, filesystem and drive model printed first; deleted at exit),
     then ``[external]`` ``plan="external"`` served from that file through
     the mmap, aio and uring block stores, each cold (page cache dropped)
     then warm: every result field equal to the fused plan's, the store's
     reads equal to the io_count replay;
  5. each kernel against its plain PyTorch version on the card at the
     paths' shapes plus ragged ones, with its median time, its plain
     version's and a library yardstick's.

Exits nonzero on any failure, without printing a result. The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import faulthandler
import glob
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
TOL = 2e-4                  # the reference's kernel tolerance (tests/test_kernels.py)
MARGIN = 1e-4               # hashes this far from a floor() boundary must agree
K = 10
N_QUERIES = 256             # the batch of the main path and of every kernel shape
REPEATS = 20                # timed batches per batch size
EXACT_BLOCK = 16384         # exact_knn's database rows per dense-kernel launch
GT_TOL = 1e-3               # exact scan vs float64 truth (fp32 expansion cancels)
BACKENDS = ("mmap", "aio", "uring")
QD = 32                     # queue depth of the aio and uring block stores
WATCHDOG_S = 1100           # the whole run's budget, builds included


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def median_ms(torch, fn, *, iters=30, warmup=3, flush=None):
    """Median device time of fn() by CUDA events, L2 flushed before each call
    (the main path finds these inputs cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes, flops):
    """Least time for the work: bytes over HBM rate vs flops over fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profile_batches(torch, run, p50_s, n_prof=5, **labels):
    """Where a batch's time goes: device busy time from the profiler against
    the batch's wall p50 (single stream, so busy = sum of device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            run()
        torch.cuda.synchronize()
    busy = {}
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in dev_events:
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / n_prof
    busy_ms = sum(busy.values()) / 1e3
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    say("profile", **labels, batch=N_QUERIES, device_busy_ms=f"{busy_ms:.4f}",
        device_events=len(dev_events) // n_prof,
        idle_share=f"{1 - busy_ms / (p50_s * 1e3):.4f}" if busy else "not measured",
        top_us=json.dumps({k[:60]: round(v, 2) for k, v in top}))


def storage_info(path):
    """Filesystem, mount source and the drives' models behind ``path``: a
    storage number names its drive as a card number names its card."""
    path = str(pathlib.Path(path).resolve())
    best = ("?", "/", "?")
    with open("/proc/mounts") as f:
        for line in f:
            src, mnt, fstype = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) >= len(best[1]):
                best = (src, mnt, fstype)
    models = {}
    for m in sorted(glob.glob("/sys/block/*/device/model")):
        models[m.split("/")[3]] = pathlib.Path(m).read_text().strip()
    return dict(fs=best[2], source=best[0], mount=best[1], drive_models=models)


def knn_agreement(ids, dists, want_ids, want_dists, tol):
    """(ok, swaps, max_rel_err): distances allclose at tol; ids may differ
    only at ranks where the two distances tie within tol."""
    import numpy as np
    close = np.isclose(dists, want_dists, rtol=tol, atol=tol)
    differ = ids != want_ids
    rel = np.abs(dists - want_dists) / np.maximum(np.abs(want_dists), 1e-30)
    return bool(close.all()), int(differ.sum()), float(rel.max())


def exact_phase(torch, ix, queries, ds, res, kernels):
    """The exact k-NN baseline over every database row, counts read just
    after; held to the dataset's float64 ground truth."""
    from repro_torch.baselines import exact_knn
    from repro_torch.core import overall_ratio

    for kern in kernels:
        kern.launches = 0
    times = []
    for _ in range(2):          # the first call loads the kernel's library
        t0 = time.perf_counter()
        ids, dists = exact_knn(ix.db, queries, k=K, block=EXACT_BLOCK, device=ix.db.device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {kern.name: kern.launches for kern in kernels}
    check(launches["l2_distance_dense"] > 0,
          f"exact_knn never launched the dense kernel: {launches}")
    ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    check(ids.shape == (queries.shape[0], K) and bool((dists >= 0).all()),
          "exact_knn results malformed")
    ok, swaps, rel = knn_agreement(ids, dists, ds.gt_ids[:, :K], ds.gt_dists[:, :K], GT_TOL)
    fused = res.dists.cpu().numpy()
    say("exact", n=ix.db.shape[0], queries=queries.shape[0], k=K, block=EXACT_BLOCK,
        launches=json.dumps(launches), first_s=f"{times[0]:.4f}", s=f"{times[1]:.4f}",
        tie_swaps_vs_float64=swaps, max_rel_err=f"{rel:.3e}", tol=GT_TOL,
        fused_ratio_vs_float64=f"{overall_ratio(fused, ds.gt_dists[:, :K]):.6f}",
        fused_ratio_vs_exact_knn=f"{overall_ratio(fused, dists):.6f}")
    check(ok, f"exact_knn distances differ from the float64 truth beyond {GT_TOL}")
    return launches


def spill_phase(torch, idx, path):
    """Spill the index to ``path``; returns its header. Prints free space,
    the planned size and the storage behind the directory first."""
    from repro_torch.storage import read_header

    spill_dir = path.parent
    ix = idx.index.arrays
    planned = spill_bytes(ix)
    free = shutil.disk_usage(spill_dir).free
    say("spill", dir=json.dumps(str(spill_dir)), free_bytes=free, planned_bytes=planned,
        n=ix.db.shape[0], **{k: json.dumps(v) for k, v in storage_info(spill_dir).items()})
    t0 = time.perf_counter()
    idx.index.spill(path)
    t1 = time.perf_counter()
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)            # dirty pages cannot be dropped from the cache
    finally:
        os.close(fd)
    t2 = time.perf_counter()
    hdr = read_header(path)
    size = path.stat().st_size
    say("spill", file_bytes=size, blocks_bytes=hdr.sections["blocks"]["nbytes"],
        block_rows=hdr.nb, blkp=hdr.blkp, lane_pad=hdr.lane_pad, spill_s=f"{t1 - t0:.3f}",
        fsync_s=f"{t2 - t1:.3f}", write_gb_per_s=f"{size / (t2 - t0) / 1e9:.3f}")
    return hdr


def spill_bytes(ix) -> int:
    """The spill file's size: every leaf once (the fingerprints as uint16),
    plus page padding between the sections."""
    leaves = sum(getattr(ix, f).nbytes for f in ix.array_fields())
    return leaves - ix.entries_fp.nbytes // 2 + 12 * 4096


def spill_n(ix, free: int) -> int:
    """The largest n in {10^6, 10^5} whose spill the disk can hold with a
    10 % margin (the file scales with n), or 0."""
    n = ix.db.shape[0]
    for cand in (n, n // 10):
        if spill_bytes(ix) * cand / n * 1.1 < free:
            return cand
    return 0


def rungs_json(ps):
    return json.dumps([dict(t=r.t, blocks=r.blocks_fetched, fetch_ms=round(r.fetch_ms, 3),
                            overlap_ms=round(r.overlap_ms, 3),
                            compute_wait_ms=round(r.compute_wait_ms, 3))
                       for r in ps.rungs])


def external_phase(torch, engine, params, path, hdr, queries, kernels):
    """plan="external" from the spill file through each backend: cold (page
    cache dropped), then REPEATS warm batches; every result field equal to
    the fused plan's, the store's reads equal to the io_count replay."""
    from repro_torch.core import SearchEngine
    from repro_torch.core.io_count import nio_for_block_size
    from repro_torch.storage import drop_page_cache, load_external, page_cache_residency

    fields = ("ids", "dists", "found", "radii_searched", "nio_table", "nio_blocks",
              "cands_checked", "probe_sizes")
    want = engine.query(queries, plan="fused", k=K, collect_probe_sizes=True)
    torch.cuda.synchronize()
    Q = queries.shape[0]
    blocks_len = int(hdr.sections["blocks"]["nbytes"])
    for kern in kernels:
        kern.launches = 0
    for backend in BACKENDS:
        t0 = time.perf_counter()
        ext = load_external(path, backend=backend, qd=QD, device=queries.device)
        open_s = time.perf_counter() - t0
        try:
            store = ext.store
            ext_engine = SearchEngine(ext)
            dropped = drop_page_cache(path)
            resid = page_cache_residency(path, hdr.blocks_offset, blocks_len)
            t0 = time.perf_counter()
            cold = ext_engine.query(queries, k=K, collect_probe_sizes=True)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            ps = ext.last_plan_stats
            say("external", backend=backend, served_by=store.name,
                fallback_from=getattr(store, "fallback_from", None),
                fallback_reason=json.dumps(getattr(store, "fallback_reason", None)),
                o_direct=getattr(store, "o_direct", None), qd=getattr(store, "qd", 1),
                open_s=f"{open_s:.3f}", page_cache_dropped=dropped,
                blocks_resident_after_drop=f"{resid:.4f}")
            for name in fields:
                check(torch.equal(getattr(cold, name), getattr(want, name)),
                      f"external ({backend}) differs from fused on {name}")
            replay = nio_for_block_size(cold.probe_sizes.cpu().numpy(), s_cap=params.S,
                                        block_bytes=params.block_bytes)
            nio_blocks = int(cold.nio_blocks.sum())
            check(ps.measured_nio_blocks == nio_blocks == ps.nio_blocks_counted,
                  f"store reads {ps.measured_nio_blocks} != sum(nio_blocks) {nio_blocks}")
            check(bool((replay == cold.nio.cpu().numpy()).all()),
                  "the io_count replay differs from the measured N_io")
            say("external", backend=backend, run="cold", ms=f"{cold_s * 1e3:.3f}",
                qps=f"{Q / cold_s:.1f}", blocks_read=ps.io.reads,
                device_reads=ps.io.device_reads, bytes_read=ps.io.device_reads * hdr.block_row_bytes,
                cache_hit_rate=f"{ps.cache_hit_rate:.4f}", prefetch_reads=ps.io.prefetch_reads,
                replay_equal=True, nio_blocks_total=nio_blocks, setup_ms=f"{ps.setup_ms:.3f}",
                rungs=rungs_json(ps))
            times, io = [], []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                out = ext_engine.query(queries, k=K)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                io.append(ext.last_plan_stats.io)
            for name in fields[:-1]:
                check(torch.equal(getattr(out, name), getattr(want, name)),
                      f"external ({backend}, warm) differs from fused on {name}")
            ps = ext.last_plan_stats
            p50 = statistics.median(times)
            say("external", backend=backend, run="warm", batches=REPEATS,
                p50_ms=f"{p50 * 1e3:.3f}", qps=f"{Q * len(times) / sum(times):.1f}",
                blocks_read=ps.io.reads, device_reads=sum(x.device_reads for x in io),
                cache_hit_rate=f"{sum(x.cache_hits for x in io) / sum(x.reads for x in io):.4f}",
                setup_ms=f"{ps.setup_ms:.3f}", rungs=rungs_json(ps))
            profile_batches(torch, lambda: ext_engine.query(queries, k=K), p50,
                            n_prof=3, plan="external", backend=backend)
        finally:
            ext.close()
    launches = {kern.name: kern.launches for kern in kernels}
    say("external", launches=json.dumps(launches))
    check(launches["lsh_hash"] > 0 and launches["l2_distance"] > 0,
          f"plan=external did not launch its kernels: {launches}")
    check(launches["bucket_probe"] == 0 and launches["l2_distance_dense"] == 0,
          f"plan=external launched a kernel off its path: {launches}")


def dense_kernel_phase(torch, dev, flush):
    """The dense kernel against its plain version at the exact scan's block
    shape plus ragged and float16 ones (Gaussian inputs, the reference's
    test), and its times."""
    from repro_torch.kernels import l2_distance, l2_distance_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for nq, nc, d, dtype in ((N_QUERIES, EXACT_BLOCK, 128, torch.float32),
                             (1, EXACT_BLOCK - 3, 128, torch.float32),
                             (33, 190, 100, torch.float32), (33, 190, 128, torch.float16)):
        q = torch.randn((nq, d), generator=gen, device=dev).to(dtype)
        x = torch.randn((nc, d), generator=gen, device=dev).to(dtype)
        got, want = l2_distance(q, x), l2_distance_ref(q, x)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        say("l2_distance_dense", NQ=nq, NC=nc, D=d, dtype=str(dtype).split(".")[1],
            max_abs_err=f"{err:.3e}")
        check(got.dtype == torch.float32 and bool(torch.allclose(got, want, rtol=TOL, atol=TOL)),
              f"l2_distance disagrees with its plain version at {nq}x{nc}x{d} {dtype}")
    NQ, NC, D = N_QUERIES, EXACT_BLOCK, 128
    q = torch.randn((NQ, D), generator=gen, device=dev)
    x = torch.randn((NC, D), generator=gen, device=dev)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the yardstick")

    def library():
        qn2, xn2 = (q * q).sum(-1), (x * x).sum(-1)
        return torch.addmm(qn2[:, None] + xn2[None, :], q, x.T, alpha=-2).clamp_min_(0)

    t_k = median_ms(torch, lambda: l2_distance(q, x), flush=flush)
    t_p = median_ms(torch, lambda: l2_distance_ref(q, x), flush=flush)
    t_l = median_ms(torch, library, flush=flush)
    b_ms, b_by = bound_ms(4 * (NQ * D + NC * D + NQ * NC),
                          2 * NQ * NC * D + 2 * (NQ + NC) * D + 3 * NQ * NC)
    say("l2_distance_dense", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
        library_addmm_ms=f"{t_l:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        tflops=f"{2 * NQ * NC * D / t_k / 1e9:.2f}")
    return worst, t_k, t_p, t_l, b_ms, b_by


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="database size")
    ap.add_argument("--spill-dir", default=str(ROOT / "build" / "spill"),
                    help="directory on local storage for the spill file (not a "
                         "tmpfs: /tmp may be RAM)")
    args = ap.parse_args(argv)

    # a run that outlives its budget dumps every thread's stack and exits 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "the port's kernels run only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import E2LSHoS, SearchEngine, overall_ratio
    from repro_torch.core import query as tq
    from repro_torch.data import make_dataset
    from repro_torch.kernels import (KERNELS, bucket_probe, bucket_probe_ref,
                                     l2_distance_gathered, l2_distance_gathered_ref,
                                     lsh_hash_all_radii, lsh_hash_all_radii_ref)
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.lsh_hash.ref import floor_margin

    # ---- the card and the build ----------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed (rc {smi.returncode}): {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    name = torch.cuda.get_device_name(0)
    say("card", name=json.dumps(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    build_s = build_all()
    say("build", kernels=len(KERNELS), nvcc_parallel_s=f"{build_s:.3f}")

    t0 = time.perf_counter()
    ds = make_dataset("sift", n=args.n, n_queries=N_QUERIES, seed=0)
    say("data", dataset="sift", n=ds.db.shape[0], d=ds.db.shape[1],
        queries=ds.queries.shape[0], host_s=f"{time.perf_counter() - t0:.3f}")
    say("reduced", cuts="none" if args.n == 1_000_000 else f"n={args.n}")

    # ---- the main path (counts 0 just before, read just after) -------------
    t_phase = time.perf_counter()
    for kern in KERNELS:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = E2LSHoS.build(ds.db, gamma=0.8, max_L=32, seed=0, device=dev)
    torch.cuda.synchronize()
    build_index_s = time.perf_counter() - t0
    p, ix = idx.params, idx.index.arrays
    say("params", m=p.m, L=p.L, r=p.r, u=p.u, S=p.S, block_objs=p.block_objs,
        fp_bits=p.fp_bits, radii=list(p.radii))
    say("index", build_s=f"{build_index_s:.3f}", device_bytes=ix.nbytes(),
        block_rows=ix.ids_blocks.shape[0], blkp=ix.ids_blocks.shape[1],
        entries=idx.index.stats.entries,
        build_peak_bytes=torch.cuda.max_memory_allocated())

    engine = SearchEngine(idx)
    queries = torch.from_numpy(ds.queries).to(dev)

    def timed_batches(q):
        res = engine.query(q, plan="fused", k=K)   # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(REPEATS):
            t = time.perf_counter()
            res = engine.query(q, plan="fused", k=K)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return res, times

    res, times = timed_batches(queries)
    per_batch = [kern.launches // (REPEATS + 1) for kern in KERNELS]
    res1, times1 = timed_batches(queries[:1])
    launches = {kern.name: kern.launches for kern in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    check(all(launches[k] > 0 for k in ("lsh_hash", "bucket_probe", "l2_distance")),
          f"a kernel of the main path never launched: {launches}")
    ratio = overall_ratio(res.dists.cpu().numpy(), ds.gt_dists[:, :K])
    Q = queries.shape[0]
    say("main", launches=json.dumps(launches),
        per_batch_q256=json.dumps(dict(zip(launches, per_batch))))
    say("main", batch=Q, p50_ms=f"{statistics.median(times) * 1e3:.3f}",
        qps=f"{Q * len(times) / sum(times):.1f}",
        q1_p50_ms=f"{statistics.median(times1) * 1e3:.3f}",
        overall_ratio=f"{ratio:.4f}", found=f"{float(res.found.float().mean()):.4f}",
        nio_mean=f"{float(res.nio.float().mean()):.2f}",
        radii_mean=f"{float(res.radii_searched.float().mean()):.3f}",
        peak_bytes=peak)
    check(res.ids.shape == (Q, K) and bool(torch.isfinite(res.dists[res.found]).all()),
          "fused results malformed")
    check(launches["l2_distance_dense"] == 0, "the fused plan launched the dense kernel")
    check(ratio < 1.5, f"overall ratio {ratio} is not an ANN result")
    lone = res1.rows_agree(res.slice_rows(0, 1), tol=TOL)
    check(bool(lone.all()), "a lone query differs from the same row in the batch")

    profile_batches(torch, lambda: engine.query(queries, plan="fused", k=K),
                    statistics.median(times), plan="fused")

    # the oracle plan on the same index, held to the fused plan on every row
    # whose kernel hashes equal the plain hashes
    cfg = engine.config(k=K)
    hkw = dict(w=cfg.w, radii=cfg.radii, u=cfg.u, fp_bits=cfg.fp_bits)
    bk, fp = lsh_hash_all_radii(queries, ix.a, ix.b, ix.rm, **hkw)
    bk_p, fp_p = lsh_hash_all_radii_ref(queries, ix.a, ix.b, ix.rm, **hkw)
    agree = ((bk == bk_p) & (fp == fp_p)).all(dim=2).all(dim=0).cpu().numpy()
    oracle = engine.query(queries, plan="oracle", k=K)
    matched = res.rows_agree(oracle, tol=TOL) & agree
    swaps = int(((res.ids != oracle.ids).any(dim=1).cpu().numpy() & matched).sum())
    say("oracle", rows=Q, hashes_agree=int(agree.sum()), match=int(matched.sum()),
        tie_swaps=swaps, remaining_rows=int((~agree).sum()))
    check(bool((matched == agree).all()),
          f"{int((agree & ~matched).sum())} rows with agreeing hashes differ from the oracle")
    say("main", seconds=f"{time.perf_counter() - t_phase:.3f}")

    # ---- [exact]: the exact k-NN baseline's path ----------------------------
    t_phase = time.perf_counter()
    exact_launches = exact_phase(torch, ix, queries, ds, res, KERNELS)
    say("exact", seconds=f"{time.perf_counter() - t_phase:.3f}")

    # ---- [spill] and [external]: plan="external" from a spill file ---------
    t_phase = time.perf_counter()
    spill_dir = pathlib.Path(args.spill_dir)
    spill_dir.mkdir(parents=True, exist_ok=True)
    # a run ended by its watchdog or a kill skips the unlink below: clear what
    # such a run left before counting the free bytes
    for stale in spill_dir.glob("sift*.e2l"):
        stale.unlink(missing_ok=True)
    free = shutil.disk_usage(spill_dir).free
    n_sp = spill_n(ix, free)
    check(n_sp > 0, f"{spill_dir} has {free} bytes free: not enough for a spill at n=10^5")
    sp_idx, sp_engine = idx, engine
    if n_sp != ix.db.shape[0]:
        say("reduced", cuts=f"spill_n={n_sp}", reason=f"free_bytes={free}")
        sp_idx = E2LSHoS.build(ds.db[:n_sp], gamma=0.8, max_L=32, seed=0, device=dev)
        sp_engine = SearchEngine(sp_idx)
    path = spill_dir / "sift.e2l"
    try:
        hdr = spill_phase(torch, sp_idx, path)
        say("spill", seconds=f"{time.perf_counter() - t_phase:.3f}")
        t_phase = time.perf_counter()
        external_phase(torch, sp_engine, sp_idx.params, path, hdr, queries, KERNELS)
        say("external", seconds=f"{time.perf_counter() - t_phase:.3f}")
    finally:
        path.unlink(missing_ok=True)
    del sp_idx, sp_engine
    t_phase = time.perf_counter()

    # ---- each kernel against its plain version at its path's shapes
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    record = []

    # lsh_hash: the batch's all-radius hash
    r, L, m, D = ix.a.shape
    RLM = r * L * m
    worst = 0
    for n in (Q, 1):
        x = queries[:n]
        bk, fp = lsh_hash_all_radii(x, ix.a, ix.b, ix.rm, **hkw)
        bk_p, fp_p = lsh_hash_all_radii_ref(x, ix.a, ix.b, ix.rm, **hkw)
        safe = floor_margin(x, ix.a, ix.b, w=cfg.w, radii=cfg.radii) > MARGIN
        same = (bk == bk_p) & (fp == fp_p)
        bad = int((safe & ~same).sum())
        worst = max(worst, int(((bk - bk_p).abs() * safe).max()))
        say("lsh_hash", rows=n, hashes=same.numel(), clear_of_boundary=int(safe.sum()),
            disagree_clear=bad, flips_near_boundary=int((~safe & ~same).sum()))
        check(bad == 0, f"lsh_hash: {bad} hashes clear of a boundary disagree")
    a2 = ix.a.reshape(RLM, D)
    t_k = median_ms(torch, lambda: lsh_hash_all_radii(queries, ix.a, ix.b, ix.rm, **hkw),
                    flush=flush)
    t_p = median_ms(torch, lambda: lsh_hash_all_radii_ref(queries, ix.a, ix.b, ix.rm, **hkw),
                    flush=flush)
    t_y = median_ms(torch, lambda: queries @ a2.T, flush=flush)
    b_ms, b_by = bound_ms(Q * D * 4 + RLM * D * 4 + 3 * RLM * 4 + 2 * Q * r * L * 4,
                          2 * Q * D * RLM)
    say("lsh_hash", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
        yardstick_projection_matmul_ms=f"{t_y:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    record.append(dict(name="lsh_hash", route="cuda", source="src/repro_torch/csrc/lsh_hash.cu",
                       replaces="src/repro/kernels/lsh_hash/kernel.py:76",
                       launches=launches["lsh_hash"], max_abs_err=float(worst), ms=t_k,
                       plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # bucket_probe: radius 0's chain rows for the whole batch, as the fused
    # probe builds them (every query active)
    cnt_all, head_all, qfp_all = tq.hash_stage(ix, queries, cfg)
    C, BLKp = cfg.max_chain, ix.ids_blocks.shape[1]
    steps = torch.arange(C, device=dev, dtype=torch.int32)
    cnt, head = cnt_all[0], head_all[0]
    readable = (cnt[:, None, :] > 0) & (cnt[:, None, :] > steps[None, :, None] * cfg.block_objs)
    rows = torch.where(readable, head[:, None, :] + steps[None, :, None], 0)
    rows = rows.reshape(-1).to(torch.int32).contiguous()
    qfp = qfp_all[0][:, None, :].expand(Q, C, L).reshape(-1).contiguous()
    G = rows.shape[0]
    worst = 0
    for g in (G, G - 3, 1):
        got = bucket_probe(rows[:g].contiguous(), qfp[:g].contiguous(),
                           ix.ids_blocks, ix.fps_blocks)
        want = bucket_probe_ref(rows[:g], qfp[:g], ix.ids_blocks, ix.fps_blocks)
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, diff)
        say("bucket_probe", G=g, BLKp=BLKp, matches=int((got != tq.INVALID).sum()),
            max_abs_err=diff)
        check(diff == 0, f"bucket_probe disagrees with its plain version at G={g}")
    t_k = median_ms(torch, lambda: bucket_probe(rows, qfp, ix.ids_blocks, ix.fps_blocks),
                    flush=flush)
    t_p = median_ms(torch, lambda: bucket_probe_ref(rows, qfp, ix.ids_blocks, ix.fps_blocks),
                    flush=flush)
    rows64 = rows.to(torch.int64)
    t_y = median_ms(torch, lambda: ix.ids_blocks.index_select(0, rows64), flush=flush)
    distinct = int(torch.unique(rows).numel())
    b_ms, b_by = bound_ms(2 * G * 4 + 2 * distinct * BLKp * 4 + G * BLKp * 4, G * BLKp * 3)
    say("bucket_probe", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
        yardstick_one_row_gather_ms=f"{t_y:.4f}", distinct_rows=distinct,
        bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    record.append(dict(name="bucket_probe", route="cuda",
                       source="src/repro_torch/csrc/bucket_probe.cu",
                       replaces="src/repro/kernels/bucket_probe/kernel.py:38",
                       launches=launches["bucket_probe"], max_abs_err=float(worst), ms=t_k,
                       plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # l2_distance_gathered: a candidate buffer of the fused probe's width
    S = tq._fused_sbuf(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    cand = torch.randint(0, ix.db.shape[0], (Q, S), device=dev, generator=gen)
    coords, xn2 = ix.db[cand], ix.db_norm2[cand]
    qn2 = (queries * queries).sum(-1)
    worst = 0.0
    for nq, ns in ((Q, S), (1, S), (Q, S - 3)):
        args_k = (queries[:nq].contiguous(), coords[:nq, :ns].contiguous(),
                  xn2[:nq, :ns].contiguous(), qn2[:nq].contiguous())
        got = l2_distance_gathered(*args_k)
        want = l2_distance_gathered_ref(*args_k)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        say("l2_distance_gathered", Q=nq, S=ns, D=D, max_abs_err=f"{err:.3e}")
        check(bool(torch.allclose(got, want, rtol=TOL, atol=TOL)),
              f"l2_distance_gathered disagrees with its plain version at Q={nq} S={ns}")
    base = (xn2 + qn2[:, None]).unsqueeze(-1)
    qcol = queries.unsqueeze(-1)
    t_k = median_ms(torch, lambda: l2_distance_gathered(queries, coords, xn2, qn2), flush=flush)
    t_p = median_ms(torch, lambda: l2_distance_gathered_ref(queries, coords, xn2, qn2),
                    flush=flush)
    t_l = median_ms(torch, lambda: torch.baddbmm(base, coords, qcol, alpha=-2.0), flush=flush)
    b_ms, b_by = bound_ms(4 * (Q * S * D + Q * D + 2 * Q * S + Q), 2 * Q * S * D + 3 * Q * S)
    say("l2_distance_gathered", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
        library_baddbmm_ms=f"{t_l:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    record.append(dict(name="l2_distance_gathered", route="cuda",
                       source="src/repro_torch/csrc/l2_distance.cu",
                       replaces="src/repro/kernels/l2_distance/kernel.py:66",
                       launches=launches["l2_distance"], max_abs_err=worst, ms=t_k,
                       plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l))

    # l2_distance (dense): one block of the exact scan
    worst, t_k, t_p, t_l, b_ms, b_by = dense_kernel_phase(torch, dev, flush)
    record.append(dict(name="l2_distance_dense", route="cuda",
                       source="src/repro_torch/csrc/l2_distance_dense.cu",
                       replaces="src/repro/kernels/l2_distance/kernel.py:31",
                       launches=exact_launches["l2_distance_dense"], max_abs_err=worst,
                       ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l))
    say("kernels", seconds=f"{time.perf_counter() - t_phase:.3f}")

    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
