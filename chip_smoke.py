#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — build an E2LSHoS index, then answer query
batches through ``SearchEngine.query(plan="fused")`` — at the SIFT1M shape
of the paper's Table 1 (n = 1,000,000, d = 128, 256 queries, synthetic data
from seed 0) with the ANN server's defaults (gamma = 0.8, max_L = 32, c = 2,
w = 4, 512 B blocks), and holds it to the repo's own contracts:

  1. the card: name and power limit;
  2. the three hand-written kernels (lsh_hash, bucket_probe,
     l2_distance_gathered), built from ``src/repro_torch/csrc`` by nvcc,
     each against its plain PyTorch version on the card at the main path's
     shapes plus ragged ones, with its median time, its plain version's and
     a library yardstick's;
  3. the main path: launch counts of every kernel (each must be > 0), qps
     and p50 per batch, the overall ratio against exact ground truth, peak
     device memory; then the port's oracle plan on the same index, which
     must match the fused plan on every row whose kernel hashes equal the
     plain hashes.

Exits nonzero on any failure, without printing a result. The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="database size")
    args = ap.parse_args(argv)

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

    # ---- phase 1: the card ------------------------------------------------
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

    # ---- phase 3: the main path (counts 0 just before, read just after) ----
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
    check(all(v > 0 for v in launches.values()),
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
    check(ratio < 1.5, f"overall ratio {ratio} is not an ANN result")
    lone = res1.rows_agree(res.slice_rows(0, 1), tol=TOL)
    check(bool(lone.all()), "a lone query differs from the same row in the batch")

    # where a batch's time goes: device busy time from the profiler against
    # the batch's wall p50 (single stream, so busy = sum of device events)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            engine.query(queries, plan="fused", k=K)
        torch.cuda.synchronize()
    busy = {}
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in dev_events:
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / n_prof
    busy_ms = sum(busy.values()) / 1e3
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    say("profile", batch=Q, device_busy_ms=f"{busy_ms:.4f}",
        device_events=len(dev_events) // n_prof,
        idle_share=(f"{1 - busy_ms / (statistics.median(times) * 1e3):.4f}" if busy
                    else "not measured"),
        top_us=json.dumps({k[:60]: round(v, 2) for k, v in top}))

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

    # ---- phase 2: each kernel against its plain version at the main path's shapes
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

    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
