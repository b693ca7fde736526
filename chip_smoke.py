#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's ANN paths at the SIFT1M shape of the paper's Table 1
(n = 1,000,000, d = 128, 256 queries, synthetic data from seed 0) with the
ANN server's defaults (gamma = 0.8, max_L = 32, c = 2, w = 4, 512 B blocks),
then LM serving with the retrieval hook at deepseek-7b's full config and
LM training at h2o-danube-1.8b's, and holds each to the repo's own
contracts:

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
  5. ``[serve]`` the serving front end on the same SIFT1M index: a ragged
     stream of requests of 1-32 rows (the 256 queries 8 times over, in a
     seeded order) through ``repro_torch.serving.BatchQueue`` (ladder 8, 32,
     128; background tick loop) over ``plan="fused"``, every ticket equal
     bit for bit to a direct dispatch of its rows; the same stream with half
     its requests at priority 1 under a 5 ms deadline (every ticket equal to
     its direct dispatch or shed with ``DeadlineExceeded``); and, from the
     spill file, the stream over ``plan="external"`` on the aio store with
     cache warming, its store reads equal to the served ``nio_blocks``, and
     ``/metrics`` from a live ``MetricsServer``; then ``[serve_cli]``, the
     ``python -m repro_torch.launch.serve --mode ann --queue`` entry point in
     a subprocess on the card;
  6. each kernel against its plain PyTorch version on the card at the
     paths' shapes plus ragged ones, with its median time, its plain
     version's and a library yardstick's: ``lsh_hash``, the fused probe
     (``probe_append``) and the distance epilogue by id
     (``l2_distance_by_id``) at radius 0 of the batch, the dense
     ``l2_distance`` at one block of the exact scan.
  7. with the main index dropped: ``[sharded]`` the database in 4 range
     shards on the card (``repro_torch.core.distributed``, the ANN server's
     build defaults), queried through ``plan="sharded"`` (the fused body per
     shard, merged): launch counts, p50, qps, the ratio against the exact
     scan, ``nio_blocks`` and ``cands_checked``; held to the per-shard
     oracle on every row whose kernel hashes equal the plain hashes, and
     through the BatchQueue (the ``[serve]`` stream) to its direct dispatch
     bit for bit; its ``to_global()`` held leaf for leaf to a direct build
     of the whole database under the same family; ``[sharded_ranks]`` the
     same plan across 4 ``torch.distributed`` ranks on the card (each rank a
     process of this script with ``--rank-worker``, one shard a rank, gloo
     on ``cuda:0``), as 4 x 1 and 2 x 2 index x query grids, every result
     field equal bit for bit to the one-process plan at 4 and 2 shards,
     each rank's query kernels launched, its index bytes and peak memory
     beside the one-process build's, and the ``[serve]`` stream through
     rank 0's queue (the other ranks follow) bit for bit; ``[srs]`` SRS (m = 8,
     T' = 400, the paper harness's SIFT setting) at k = 1 and 10, its
     distances on ``l2_distance_by_id``, its index bytes beside E2LSH's,
     held on 32 queries to the host run; and ``[qalsh]`` QALSH (K = 64) on
     16 queries at k = 1, held to the host run. ``[sharded_cli]``, after
     ``[serve_cli]``: the serve CLI under ``torch.distributed.run`` with 2
     ranks at n = 10^5 in a subprocess, its ``[sharded x2]`` line.
  8. with the SIFT1M indexes dropped: ``[lm]`` LM serving with the retrieval
     hook at deepseek-7b's full published config (30 layers, d_model 4096,
     vocab 102,400, bf16 activations over fp32 masters; random weights from
     seed 0): ``ServeEngine.generate`` of 2 prompts of 64 tokens for 8 steps,
     each step's logits probing an E2LSHoS index over 5,000 unit rows of
     width 102,400 (``launch.serve --mode lm``'s inputs and index settings):
     prefill and decode ms, tokens/s, the hook's ms, peak memory and the
     device busy share; 5 timed runs identical; every step's neighbours
     equal to a direct fused query; the three query kernels launched at
     least once a step and held to their plain versions at D = 102,400 and
     at D = 50,280 (mamba2-1.3b's vocab, [lm_cli]'s width); the
     same parameters in float32, prefill + 4 decode steps equal to the
     forward at 1e-3. ``[lm_reduced]``: each of the 10 archs at its reduced
     config on the card against the CPU (forward logits, a 4-step
     generate). ``[lm_cli]``, after ``[serve_cli]``: ``python -m
     repro_torch.launch.serve --mode lm --arch mamba2-1.3b --steps 8
     --retrieval`` (full width) in a subprocess on the card.
  9. with the LM serving state dropped: ``[train]`` LM training at
     h2o-danube-1.8b's full config (24 layers, d_model 2560, GQA 32/8,
     d_ff 6912, vocab 32,000, SWA 4096, bf16 activations over fp32
     masters, ``remat="full"``; 1.83 G parameters, 29.3 GB of state):
     ``make_train_step`` with AdamW on the reference's synthetic token
     pipeline at B = 4, T = 2,048, one warm-up step and 7 timed steps:
     step ms p50, tokens/s, model TFLOP/s and its share of the bf16 peak
     (the count printed), peak memory, the device busy and idle share of
     one profiled step with its time by kernel kind; every loss and grad
     norm finite, every leaf moved, no query kernel launched. Then 2 layers
     of it in float32 (0.30 G parameters, B = 1, T = 256): one step on the
     card against the same step on the CPU (loss, grad norm, every leaf's
     gradient, TF32 off), remat "full" against "none" and microbatch 1
     against 0 on the card. ``[train_reduced]``: the 10 archs at reduced
     config, one step, card against CPU. ``[train_dp]``: a one-rank nccl
     group, ``make_dp_train_step`` against ``make_train_step`` and
     ``compressed_psum`` against its formula. Then four ranks share the
     card over gloo on a (data 2, model 2) ``DeviceMesh`` (each a process
     of this script with ``--mesh-worker``): ``[train_mesh]`` runs
     build_cell's train cell of h2o-danube-1.8b at full width, 2 layers,
     fp32, held to the one-process step on the card (each leaf's gradient
     2e-4 of its max, the grad norm 1e-5 relative, loss 2e-5, every
     parameter 2e-4, every leaf's placements and its shards on the card;
     the gradient check must fail the gradients of half the batch), then
     times the full config at MESH_TRAIN_LAYERS of its 24 layers at
     [train]'s traffic (step ms, tokens/s, each rank's state bytes and peak
     memory, one step's collectives by kind with their bytes);
     ``[serve_mesh]`` holds deepseek-7b's prefill and decode cells (full
     width, 2 layers, fp32; 2 x 64 tokens, 4 greedy steps) to one process
     (2e-4 of the logits' max, tokens equal, caches placed by
     ``cache_specs``); ``[train_mesh_cli]`` sends SIGTERM to
     ``launch.train`` on 4 ranks after step 10 and resumes it on 2 (an
     elastic restore) to a one-process run's last loss. ``[train_cli]``, after
     ``[lm_cli]``: ``python -m repro_torch.launch.train --reduced`` for 40
     steps uninterrupted, and again sent SIGTERM after its step-10 line
     and rerun: it resumes and ends on the same loss.
 10. the dry run (``repro_torch.launch.dryrun``): ``[dryrun_ann]``,
     ``[dryrun_queue]`` and ``[dryrun_external]`` on the card after
     ``[qalsh]`` (hillclimb's C0 with its real 20,000-row shard, the
     queue's warm-up per rung over a 10^6-row index, the external store
     on aio), their kernel launches counted; ``[dryrun_lm]`` from a worker
     process (``--dryrun-worker``) started after the build and collected
     after the mesh phases: run_cell of h2o-danube-1.8b's train, prefill
     and decode cells at one layer and run_cell_extrapolated of its train
     cell and command-r-plus-104b's on a fake 16 x 16 CPU world (the train
     cell's argument bytes the reference's 143,419,400, its FLOPs x 256
     within 2 % of ``train_flops``); ``[dryrun_vs_mesh]``: the
     ``[train_mesh]`` cell's dry run on a fake world of 4 (a cuda mesh of
     fake tensors) equal, kind by kind in calls and operand bytes, to the
     collectives the real warm-up step tallied on rank 0.

Exits nonzero on any failure, without printing a result. The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import faulthandler
import gc
import glob
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time
import urllib.request

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
SERVE_REPEAT = 8            # the [serve] stream: the batch's queries, 8 times over
SERVE_LADDER = (8, 32, 128)  # the ANN server's default ladder; max_batch 128
SERVE_DEADLINE_MS = 5.0     # the QoS part's low-class deadline: tight, so some shed
SERVE_LOOSE_MS = 1000.0     # and its high class's: loose, so each class has a hit rate
SERVE_WARM_ROWS = 4096      # the external queue's cache-warming set
SERVE_CACHE_ROWS = 2048     # its store's cache arena, under the warm set: the
                            # idle warm pass must fetch on the prefetch lane
FIELDS = ("ids", "dists", "found", "radii_searched", "nio_table", "nio_blocks",
          "cands_checked")
SHARDS = 4                  # [sharded]: range shards of the database on the one card
RANK_LAYOUTS = ((4, 1), (2, 2))  # [sharded_ranks]: index x query grids of 4 ranks
RANK_TIMEOUT_S = 420        # [sharded_ranks]: the ranks' whole run, builds included
SHARDED_CLI_N = 100_000     # [sharded_cli]: the database of the two-rank serve CLI
SRS_M = 8                   # [srs]: SRS's projected dimensions
SRS_TPRIME = 400            # and its T' for SIFT, the paper harness's setting
SRS_PARITY_Q = 32           # queries held to the same SRS run on the host
QALSH_K = 64                # [qalsh]: lines, the paper harness's setting
QALSH_Q = 16                # queries (the harness times QALSH on 16: it is slow)
QUERY_KERNELS = ("lsh_hash", "bucket_probe", "l2_distance", "topk_merge")
LM_ARCH = "deepseek-7b"     # [lm]: its published config, nothing cut
LM_B, LM_T, LM_STEPS = 2, 64, 8   # launch.serve's LM defaults
LM_DSTORE = 5000            # datastore rows (launch.serve's default)
LM_K = 8                    # neighbours a decode step
LM_TIMED = 5                # timed generates after one warm-up
LM_FP32_TOL = 1e-3          # fp32 prefill/decode vs the forward over 30 layers
LM_CLI_ARCH = "mamba2-1.3b"  # [lm_cli]: the serve CLI's default arch
BF16_FLOPS = 989e12         # H100 SXM bf16 dense tensor-core peak, NVIDIA data sheet
TRAIN_ARCH = "h2o-danube-1.8b"  # [train]: its full config (remat="full"), nothing cut
TRAIN_B, TRAIN_T = 4, 2048  # 8,192 tokens a step
TRAIN_OPT = dict(lr=3e-4, total_steps=100, warmup_steps=10)
TRAIN_TIMED = 7             # timed steps after one warm-up
TRAIN_LOSS_RTOL = 1e-5      # card vs CPU, fp32: the loss and the grad norm, relative
TRAIN_GRAD_TOL = 1e-3       # card vs CPU, fp32 at full width: of each leaf's max |g|
TRAIN_REDUCED_GRAD_TOL = 2e-4   # card vs CPU at the reduced configs (the forward's bound)
TRAIN_CLI_LOSS_RTOL = 1e-3  # [train_cli]: resumed vs uninterrupted last loss
MESH_SHAPE = (2, 2)         # [train_mesh], [serve_mesh]: (data, model), four ranks on cuda:0
MESH_TIMEOUT_S = 400        # the mesh ranks' whole run
MESH_LOSS_TOL = 2e-5        # mesh vs one process (tests/test_distributed.py's bounds)
MESH_PARAM_TOL = 2e-4
MESH_OPT = dict(lr=1e-3, total_steps=10)   # that test's optimizer
MESH_GRAD_TOL = 2e-4        # mesh vs one process: each leaf's gradient, of its max |g|
MESH_GNORM_RTOL = 1e-5      # the global grad norm, relative
MESH_TRAIN_LAYERS = 8       # [train_mesh] timed: h2o-danube-1.8b's depth (of 24) over
                            # gloo: ~0.94 s a layer a step, so 24 would take ~26 s a step
MESH_TIMED = 3              # timed steps after one warm-up
MESH_LOGIT_TOL = 2e-4       # [serve_mesh]: of the one-process logits' max |.|
MESH_SERVE_B, MESH_SERVE_T, MESH_SERVE_STEPS = 2, 64, 4
MESH_CLI_STEPS, MESH_CLI_SIGTERM = 20, 10   # [train_mesh_cli]
DRYRUN_TIMEOUT_S = 700      # [dryrun_lm]'s worker (the fake worlds on the host's CPU)
DRYRUN_DEPTH = 1            # its run_cell records: one layer a cell (24 take minutes on
                            # the CPU); the extrapolated records fit the full depth
DRYRUN_FLOPS_RTOL = 0.02    # extrapolated per-device FLOPs x 256 vs train_flops
DRYRUN_TRAIN_ARGS = 143_419_400   # the reference's argument bytes, h2o train_4k, 16 x 16
DRYRUN_EXTRA_ARCH = "command-r-plus-104b"   # a train cell the head repair unblocked
DRYRUN_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")    # the reference's collective kinds


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


def ptxas_report(log: str):
    """Per kernel entry in an ``nvcc -Xptxas -v`` log: registers, static
    shared memory, spill bytes, and for an fp32_tile instantiation its
    ring's dynamic shared memory (STAGES * (BM + BN) * 32 * 4 bytes)."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(fn=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    names = [e["fn"] for e in out]
    try:
        dem = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        dem = names
    for e, d in zip(out, dem if len(dem) == len(names) else names):
        m = re.search(r"Tile<(\d+), (\d+), (\d+), (\d+), (\d+), (\d+)>, (true|false)", d)
        if m:
            bm, bn, tx, ty, stages, _ = map(int, m.groups()[:6])
            e["fn"] = f"tile{bm}x{bn}_threads{tx * ty}_stages{stages}_vec4={m.group(7)}"
            e["ring_smem"] = stages * (bm + bn) * 32 * 4
        else:
            e["fn"] = d.replace("(anonymous namespace)::", "").split("(")[0][-60:]
    return out


def profile_batches(torch, run, p50_s, n_prof=5, **labels):
    """Where a batch's time goes: device busy time from the profiler against
    the batch's wall p50 (single stream, so busy = sum of device events).
    Returns the device microseconds a run by kernel name."""
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
    say("profile", **{"batch": N_QUERIES, **labels}, device_busy_ms=f"{busy_ms:.4f}",
        device_events=len(dev_events) // n_prof,
        idle_share=f"{1 - busy_ms / (p50_s * 1e3):.4f}" if busy else "not measured",
        top_us=json.dumps({k[:60]: round(v, 2) for k, v in top}))
    return busy


def kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name: fp32 products (CUTLASS's
    ``sgemm`` and cuBLAS's ``f32f32`` kernels: TF32 is off), bf16 products
    (every other product kernel: cuBLAS's ``nvjet`` kernels carry no type in
    their name), casts and copies, reductions, other elementwise work."""
    n = name.lower()
    if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass")):
        if "sgemm" in n or "f32f32" in n:
            return "products_fp32"
        return "products_bf16"
    if "copy" in n:
        return "copy_cast"
    if "reduce" in n:
        return "reduce"
    if "elementwise" in n or "functor" in n:
        return "elementwise"
    return "other"


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
    return launches, dists


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

    fields = FIELDS + ("probe_sizes",)
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
    check(launches["topk_merge"] == launches["l2_distance"],
          f"plan=external did not fold each rung by one merge launch: {launches}")
    check(launches["bucket_probe"] == 0 and launches["l2_distance_dense"] == 0,
          f"plan=external launched a kernel off its path: {launches}")


def serve_stream(queries_np):
    """The [serve] request stream: the batch's queries SERVE_REPEAT times over
    in a seeded order, cut into requests of 1-32 rows as the serve CLI cuts
    them. Returns (order, requests): stream row i is query order[i]."""
    import numpy as np
    from repro_torch.launch.serve import _ragged_requests

    order = np.random.default_rng(3).permutation(
        np.tile(np.arange(queries_np.shape[0]), SERVE_REPEAT))
    return order, _ragged_requests(queries_np[order], max_batch=SERVE_LADDER[-1], seed=0)


def timed_direct(torch, fn, requests):
    """Each request dispatched alone at its own size (the queue's parity and
    throughput baseline): (results, seconds), each shape seen once first."""
    for r in requests:
        fn(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [fn(r) for r in requests]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def differing(got, want):
    """{field: rows that differ} between a queued and a direct result."""
    bad = {}
    for name in FIELDS:
        g, w = getattr(got, name).cpu(), getattr(want, name).cpu()
        if g.shape != w.shape:
            bad[name] = int(w.shape[0])
            continue
        same = (g == w) | (g.isnan() & w.isnan()) if g.is_floating_point() else g == w
        rows = int((~same.reshape(g.shape[0], -1).all(dim=1)).sum())
        if rows:
            bad[name] = rows
    return bad


def parity_report(phase, pairs):
    """Hold every (queued, direct) pair bit for bit; print what differed."""
    fields, requests, rows = {}, 0, 0
    for got, want in pairs:
        bad = differing(got, want)
        requests += bool(bad)
        rows += max(bad.values(), default=0)
        for name, n in bad.items():
            fields[name] = fields.get(name, 0) + n
    say(phase, parity="queued vs direct, bit for bit", compared=len(pairs),
        requests_differing=requests, rows_differing=rows,
        rows_differing_by_field=json.dumps(fields))
    check(requests == 0, f"{phase}: {requests} queued requests differ from their direct "
                         f"dispatch ({rows} rows; by field {fields})")


def queue_line(phase, s, **kv):
    say(phase, ticks=s["ticks"], dispatches=s["dispatches"], rows=s["rows_served"],
        occupancy=f"{s['occupancy_mean']:.4f}", pad_waste=f"{s['pad_waste']:.4f}",
        dispatch_p50_ms=f"{s['p50_dispatch_ms']:.4f}",
        dispatch_p99_ms=f"{s['p99_dispatch_ms']:.4f}",
        rung_hist=json.dumps(s["rung_hist"]), **kv)


def serve_phase(torch, engine, queries_np, gt_dists, kernels):
    """[serve]: the fused queue on the background loop, then the same stream
    under QoS. Every ticket equals its rows' direct plan="fused" dispatch bit
    for bit (or, under QoS, raises DeadlineExceeded); one dispatch per tick;
    the path's kernels launched by the queue's thread; no kernel library
    loaded after the warm-up."""
    from repro_torch.core import overall_ratio
    from repro_torch.kernels.build import CudaKernel
    from repro_torch.serving import BatchQueue, DeadlineExceeded

    order, requests = serve_stream(queries_np)
    rows = sum(r.shape[0] for r in requests)
    sizes = [r.shape[0] for r in requests]
    say("serve", plan="fused", stream_rows=rows, requests=len(requests),
        request_rows_min=min(sizes), request_rows_max=max(sizes),
        ladder=json.dumps(SERVE_LADDER), tick_us=200, k=K)
    for kern in kernels:
        kern.launches = 0
    # count kernel libraries loaded (and built if needed) from here on
    real_load, loads = CudaKernel._load, []
    CudaKernel._load = lambda kern: (loads.append(kern.name), real_load(kern))[1]
    try:
        t0 = time.perf_counter()
        queue = BatchQueue(engine, plan="fused", k=K, ladder=SERVE_LADDER,
                           max_batch=SERVE_LADDER[-1], tick_us=200.0)
        warm_s = time.perf_counter() - t0
        warm_loads = len(loads)
        after_warm = {kern.name: kern.launches for kern in kernels}
        t0 = time.perf_counter()
        with queue:
            tickets = [queue.submit(r) for r in requests]
            results = [t.result(timeout=120) for t in tickets]
        t_queued = time.perf_counter() - t0
        stream_loads = loads[warm_loads:]
    finally:
        CudaKernel._load = real_load
    launches = {kern.name: kern.launches for kern in kernels}
    grew = {n: launches[n] - after_warm[n] for n in launches}
    s = queue.stats_summary()
    say("serve", plan="fused", warmup_s=f"{warm_s:.3f}", loads_in_warmup=warm_loads,
        loads_after_warmup=len(stream_loads), launches=json.dumps(launches),
        launches_in_stream=json.dumps(grew))
    check(not stream_loads, f"kernel libraries loaded after the warm-up: {stream_loads}")
    check(all(grew[n] > 0 for n in QUERY_KERNELS),
          f"the fused queue did not launch its kernels: {grew}")
    check(grew["topk_merge"] == grew["bucket_probe"],
          f"the fused queue did not fold each radius by one merge launch: {grew}")
    check(grew["l2_distance_dense"] == 0, "the fused queue launched the dense kernel")
    check(s["dispatches"] == s["ticks"] == queue.dispatch_count,
          f"dispatches {s['dispatches']} != ticks {s['ticks']}")
    check(s["rows_served"] == rows, f"served {s['rows_served']} of {rows} rows")
    _, direct_fn = engine.make_plan_fn(plan="fused", k=K)
    direct, t_direct = timed_direct(torch, direct_fn, requests)
    parity_report("serve", list(zip(results, direct)))
    dists = torch.cat([r.dists for r in results]).numpy()
    ratio = overall_ratio(dists, gt_dists[order][:, :K])
    check(ratio < 1.5, f"queued overall ratio {ratio} is not an ANN result")
    queue_line("serve", s, plan="fused", queued_qps=f"{rows / t_queued:.1f}",
               direct_qps=f"{rows / t_direct:.1f}", queued_s=f"{t_queued:.4f}",
               direct_s=f"{t_direct:.4f}", overall_ratio=f"{ratio:.4f}")

    # QoS: half the requests at priority 1 under a tight deadline, the other
    # half at priority 0 under a loose one, all submitted at once
    queue.reset_stats()
    for kern in kernels:
        kern.launches = 0
    outcomes, t0 = [], time.perf_counter()
    with queue:
        tickets = [queue.submit(r, priority=i % 2,
                                deadline_ms=SERVE_DEADLINE_MS if i % 2 else SERVE_LOOSE_MS)
                   for i, r in enumerate(requests)]
        for t in tickets:
            try:
                outcomes.append(t.result(timeout=120))
            except DeadlineExceeded:
                outcomes.append(None)
    t_qos = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels}
    s = queue.stats_summary()
    shed = sum(o is None for o in outcomes)
    parity_report("serve", [(o, d) for o, d in zip(outcomes, direct) if o is not None])
    qos = s["qos"]
    by_class = {c: dict(tickets=v["tickets"], shed=v["shed"],
                        hit_rate=v.get("hit_rate"),
                        p99_latency_ms=round(v["p99_latency_ms"], 4))
                for c, v in qos["by_class"].items()}
    queue_line("serve", s, plan="fused", part="qos", deadline_ms=SERVE_DEADLINE_MS,
               shed=shed, qos_shed=qos["shed"], tickets=len(tickets),
               served_rows=s["rows_served"], queued_s=f"{t_qos:.4f}",
               deadline_hit_rate=qos.get("deadline_hit_rate"),
               by_class=json.dumps(by_class), launches=json.dumps(launches))
    check(shed == qos["shed"], f"{shed} tickets raised DeadlineExceeded, the queue counts "
                               f"{qos['shed']}")
    check(shed > 0, f"no request was shed under a {SERVE_DEADLINE_MS} ms deadline")
    check(all(launches[n] > 0 for n in QUERY_KERNELS),
          f"the QoS part did not launch its kernels: {launches}")
    check(s["dispatches"] == s["ticks"], "QoS: dispatches != ticks")


def external_serve_phase(torch, dev, path, queries_np, kernels):
    """[serve] over plan="external": the same stream from the spill file on
    the aio store with cache warming. Every ticket equals its rows' direct
    external dispatch bit for bit; the store's logical reads over the stream
    equal the served nio_blocks; the idle loop warms the cache from the probe
    trace; /metrics reports the queue's dispatches."""
    from repro_torch.core import SearchEngine
    from repro_torch.serving import BatchQueue
    from repro_torch.storage import load_external
    from repro_torch.telemetry import MetricsServer

    _, requests = serve_stream(queries_np)
    rows = sum(r.shape[0] for r in requests)
    ext = load_external(path, backend="aio", qd=QD, cache_rows=SERVE_CACHE_ROWS, device=dev)
    try:
        engine = SearchEngine(ext)
        for kern in kernels:
            kern.launches = 0
        queue = BatchQueue(engine, k=K, ladder=SERVE_LADDER, max_batch=SERVE_LADDER[-1],
                           tick_us=200.0, warm_cache_rows=SERVE_WARM_ROWS)
        check(queue.plan == "external" and ext.collect_row_hist,
              "the external queue does not collect the probe trace")
        warms, real_warm = [], queue.warm_cache

        def logged_warm(top=None):
            at, p0 = queue.dispatch_count, ext.store.stats.prefetch_reads
            n = real_warm(top)
            warms.append(dict(at=at, rows=n, prefetched=ext.store.stats.prefetch_reads - p0))
            return n

        queue.warm_cache = logged_warm
        base = ext.store.stats.snapshot()        # after the warm-up
        with MetricsServer(0) as server:
            t0 = time.perf_counter()
            with queue:
                tickets = [queue.submit(r) for r in requests]
                results = [t.result(timeout=300) for t in tickets]
                t_queued = time.perf_counter() - t0
                io = ext.store.stats.since(base)
                last = queue.dispatch_count
                deadline = time.perf_counter() + 30
                while (not any(w["at"] == last for w in warms)
                       and time.perf_counter() < deadline):
                    time.sleep(0.01)             # the idle interval
            with urllib.request.urlopen(server.url + "/metrics", timeout=30) as r:
                body = r.read().decode()
        launches = {kern.name: kern.launches for kern in kernels}
        nio = sum(int(r.nio_blocks.sum()) for r in results)
        idle = [w for w in warms if w["at"] == last]
        hot = ext.hot_rows()
        scraped = [line for line in body.splitlines()
                   if line.startswith('e2lsh_serve_dispatches_total{plan="external"}')]
        s = queue.stats_summary()
        say("serve", plan="external", backend=ext.store.name, qd=QD,
            cache_rows=SERVE_CACHE_ROWS, warm_cache_rows=SERVE_WARM_ROWS,
            launches=json.dumps(launches), store_reads=io.reads, nio_blocks=nio,
            reads_equal_nio=io.reads == nio, device_reads=io.device_reads,
            cache_hit_rate=f"{io.hit_rate:.4f}", prefetch_reads=io.prefetch_reads,
            idle_warm=json.dumps(idle[-1] if idle else None), warms=len(warms),
            hot_rows=int(hot.size), metrics_line=json.dumps(scraped))
        check(all(launches[n] > 0 for n in ("lsh_hash", "l2_distance")),
              f"the external queue did not launch its kernels: {launches}")
        check(launches["topk_merge"] == launches["l2_distance"],
              f"the external queue did not fold each rung by one merge launch: {launches}")
        check(launches["bucket_probe"] == 0 and launches["l2_distance_dense"] == 0,
              f"the external queue launched a kernel off its path: {launches}")
        check(s["dispatches"] == s["ticks"] == queue.dispatch_count,
              "external: dispatches != ticks")
        check(io.reads == nio, f"store reads {io.reads} != served nio_blocks {nio}")
        check(idle and idle[-1]["rows"] > 0 and idle[-1]["prefetched"] > 0,
              f"the idle loop did not warm the cache: {warms[-3:]}")
        check(hot.size > 0, "no probe trace was recorded")
        check(len(scraped) == 1 and float(scraped[0].rsplit(" ", 1)[1]) == queue.dispatch_count,
              f"/metrics dispatches {scraped} != the queue's {queue.dispatch_count}")
        _, direct_fn = engine.make_plan_fn(plan="external", k=K)
        direct, t_direct = timed_direct(torch, direct_fn, requests)
        parity_report("serve", list(zip(results, direct)))
        queue_line("serve", s, plan="external", queued_qps=f"{rows / t_queued:.1f}",
                   direct_qps=f"{rows / t_direct:.1f}", queued_s=f"{t_queued:.4f}",
                   direct_s=f"{t_direct:.4f}")
    finally:
        ext.close()


def timed_runs(torch, fn, repeats=REPEATS):
    """One warm-up call, then ``repeats`` timed calls, each ending in a
    device synchronize: (last result, seconds per call)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def sharded_phase(torch, dev, ds, queries, exact_dists, kernels):
    """[sharded]: the database in SHARDS range shards on the one card, each
    with its own sub-index under one family, queried through
    ``SearchEngine(sharded).query(plan="sharded")`` (the fused body per
    shard, merged). Held to the sharded oracle on every row whose kernel
    hashes equal the plain hashes, and through the BatchQueue to its direct
    dispatch, bit for bit. Returns the kernels' launches on the batch path
    and on the queue's stream."""
    from repro_torch.core import HashFamily, SearchEngine, build_index, overall_ratio
    from repro_torch.core.distributed import build_sharded_index
    from repro_torch.kernels import lsh_hash_all_radii, lsh_hash_all_radii_ref
    from repro_torch.serving import BatchQueue

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sh = build_sharded_index(ds.db, SHARDS, gamma=0.8, max_L=32, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    p = sh.params
    cap = max(4 * K, -(-p.S // SHARDS))
    say("sharded", shards=SHARDS, m=p.m, L=p.L, r=p.r, u=p.u, S=p.S, s_cap_per_shard=cap,
        block_objs=p.block_objs, build_s=f"{build_s:.3f}", device_bytes=sh.nbytes(),
        build_peak_bytes=build_peak,
        device_allocated_bytes=torch.cuda.memory_allocated())
    for s, ix in enumerate(sh.arrays):
        say("sharded", shard=s, offset=sh.shard_offsets[s], n=ix.db.shape[0],
            entries=ix.entries_id.shape[0], block_rows=ix.ids_blocks.shape[0],
            device_bytes=ix.nbytes())
    engine = SearchEngine(sh, device=dev)
    for kern in kernels:
        kern.launches = 0
    res, times = timed_runs(torch, lambda: engine.query(queries, plan="sharded", k=K))
    launches = {kern.name: kern.launches for kern in kernels}
    Q = queries.shape[0]
    ratio = overall_ratio(res.dists.cpu().numpy(), exact_dists)
    say("sharded", batch=Q, k=K, launches=json.dumps(launches),
        p50_ms=f"{statistics.median(times) * 1e3:.3f}",
        qps=f"{Q * len(times) / sum(times):.1f}", overall_ratio_vs_exact=f"{ratio:.4f}",
        found=f"{float(res.found.float().mean()):.4f}",
        nio_blocks_mean=f"{float(res.nio_blocks.float().mean()):.2f}",
        nio_mean=f"{float(res.nio.float().mean()):.2f}",
        cands_checked_mean=f"{float(res.cands_checked.float().mean()):.2f}",
        radii_mean=f"{float(res.radii_searched.float().mean()):.3f}")
    check(all(launches[n] > 0 for n in QUERY_KERNELS),
          f"a kernel of the sharded plan never launched: {launches}")
    check(launches["lsh_hash"] == SHARDS * (REPEATS + 1),
          f"the sharded plan hashed {launches['lsh_hash']} times, not once a shard a batch")
    check(launches["l2_distance_dense"] == 0, "the sharded plan launched the dense kernel")
    check(res.ids.shape == (Q, K) and bool(torch.isfinite(res.dists[res.found]).all()),
          "sharded results malformed")
    check(ratio < 1.5, f"sharded overall ratio {ratio} is not an ANN result")
    profile_batches(torch, lambda: engine.query(queries, plan="sharded", k=K),
                    statistics.median(times), plan="sharded")
    # the one-process result [sharded_ranks] is held to, with its build's bytes
    one_process = dict(result={f: getattr(res, f).cpu().numpy() for f in FIELDS},
                       device_bytes=sh.nbytes(), build_peak_bytes=build_peak,
                       p50_ms=statistics.median(times) * 1e3)

    # per-shard oracle bodies through the same merge
    ix0 = sh.arrays[0]
    hkw = dict(w=p.w, radii=p.radii, u=p.u, fp_bits=p.fp_bits)
    bk, fp = lsh_hash_all_radii(queries, ix0.a, ix0.b, ix0.rm, **hkw)
    bk_p, fp_p = lsh_hash_all_radii_ref(queries, ix0.a, ix0.b, ix0.rm, **hkw)
    agree = ((bk == bk_p) & (fp == fp_p)).all(dim=2).all(dim=0).cpu().numpy()
    t0 = time.perf_counter()
    oracle = engine.query(queries, plan="oracle", k=K)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    matched = res.rows_agree(oracle, tol=TOL) & agree
    swaps = int(((res.ids != oracle.ids).any(dim=1).cpu().numpy() & matched).sum())
    say("sharded", oracle_rows=Q, hashes_agree=int(agree.sum()), match=int(matched.sum()),
        tie_swaps=swaps, remaining_rows=int((~agree).sum()), oracle_s=f"{oracle_s:.3f}")
    check(bool((matched == agree).all()),
          f"{int((agree & ~matched).sum())} sharded rows with agreeing hashes differ from "
          "the sharded oracle")

    # the serving queue over the sharded plan
    order, requests = serve_stream(ds.queries)
    rows = sum(r.shape[0] for r in requests)
    queue = BatchQueue(engine, plan="sharded", k=K, ladder=SERVE_LADDER,
                       max_batch=SERVE_LADDER[-1], tick_us=200.0)
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    with queue:
        tickets = [queue.submit(r) for r in requests]
        results = [t.result(timeout=120) for t in tickets]
    t_queued = time.perf_counter() - t0
    queue_launches = {kern.name: kern.launches for kern in kernels}
    s = queue.stats_summary()
    check(all(queue_launches[n] > 0 for n in QUERY_KERNELS),
          f"the sharded queue did not launch its kernels: {queue_launches}")
    check(s["dispatches"] == s["ticks"] == queue.dispatch_count,
          f"sharded queue: dispatches {s['dispatches']} != ticks {s['ticks']}")
    check(s["rows_served"] == rows, f"sharded queue served {s['rows_served']} of {rows} rows")
    _, direct_fn = engine.make_plan_fn(plan="sharded", k=K)
    direct, t_direct = timed_direct(torch, direct_fn, requests)
    parity_report("sharded", list(zip(results, direct)))
    q_ratio = overall_ratio(torch.cat([r.dists for r in results]).numpy(),
                            exact_dists[order])
    queue_line("sharded", s, plan="sharded", launches=json.dumps(queue_launches),
               queued_qps=f"{rows / t_queued:.1f}", direct_qps=f"{rows / t_direct:.1f}",
               overall_ratio=f"{q_ratio:.4f}")

    # the global index the shards partition, against a direct build of the
    # whole database under the same family (the sharded index freed first)
    t0 = time.perf_counter()
    glob = sh.to_global()
    torch.cuda.synchronize()
    to_global_s = time.perf_counter() - t0
    family = HashFamily(a=glob.a, b=glob.b, rm=glob.rm, w=p.w, u=p.u, fp_bits=p.fp_bits)
    del engine, queue, direct_fn, sh, direct, results, res, oracle
    torch.cuda.empty_cache()
    direct_ix = build_index(ds.db, p, family=family, device=dev).arrays
    same = [f for f in direct_ix.array_fields()
            if torch.equal(getattr(glob, f), getattr(direct_ix, f))]
    say("sharded", to_global_s=f"{to_global_s:.3f}", global_block_rows=glob.ids_blocks.shape[0],
        global_entries=glob.entries_id.shape[0], leaves_equal_to_direct_build=len(same),
        leaves=len(direct_ix.array_fields()))
    check(len(same) == len(direct_ix.array_fields()),
          f"to_global() differs from a direct build in "
          f"{sorted(set(direct_ix.array_fields()) - set(same))}")
    return launches, queue_launches, one_process


def rank_worker(cfg: dict) -> int:
    """One rank of [sharded_ranks], in a process of its own (``chip_smoke.py
    --rank-worker CONFIG``): join the group as the serve CLI's ranks do
    (``launch.serve.join_ranks``), then run each index x query layout
    (``rank_layout_run``). Rank 0 prints one JSON line a layout with every
    rank's record."""
    import numpy as np
    faulthandler.dump_traceback_later(RANK_TIMEOUT_S, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.serve import join_ranks

    dev, transport = join_ranks("cuda")
    db = np.load(cfg["db"])
    queries_np = np.load(cfg["queries"])
    for i, ((shards, groups), want_path) in enumerate(zip(cfg["layouts"], cfg["want"])):
        rec = rank_layout_run(torch, dev, db, queries_np, shards, groups,
                              np.load(want_path), with_queue=i == 0)
        # the layout's shard, engine and queue die with its frame (the queue's
        # leading closure is a cycle: collect it) before the next layout builds
        gc.collect()
        torch.cuda.empty_cache()
        records = [None] * dist.get_world_size()
        dist.all_gather_object(records, rec)
        if dist.get_rank() == 0:
            print(json.dumps(dict(layout=f"{shards}x{groups}", transport=transport,
                                  device=str(dev), ranks=records)), flush=True)
        dist.barrier()
    dist.destroy_process_group()
    return 0


def rank_layout_run(torch, dev, db, queries_np, shards, groups, want, *, with_queue):
    """This rank's part of one layout: build its shard (the ranks in turn),
    time the batch through ``plan="sharded"`` (counts 0 just before, read
    just after), hold the result to the one-process result ``want`` bit for
    bit, and with ``with_queue`` serve the [serve] stream through the
    leader's queue (the others follow), every ticket against its direct
    dispatch. Returns the rank's record."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import SearchEngine
    from repro_torch.core.distributed import RankLayout, build_local_shard
    from repro_torch.kernels import KERNELS
    from repro_torch.serving import BatchQueue

    rank = dist.get_rank()
    layout = RankLayout.make(shards, groups)
    torch.cuda.reset_peak_memory_stats(dev)
    # one rank builds at a time and hands its build's transient memory back:
    # four concurrent 2 x 2 builds would peak at ~4 x 18 GB
    for turn in range(dist.get_world_size()):
        if turn == rank:
            t0 = time.perf_counter()
            local = build_local_shard(db, shards, layout.shard, gamma=0.8, max_L=32, seed=0,
                                      device=dev)
            torch.cuda.synchronize(dev)
            build_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
        dist.barrier()
    rec = dict(rank=rank, shard=layout.shard, query_group=layout.query,
               build_s=round(build_s, 3), index_bytes=local.nbytes(),
               build_peak_bytes=torch.cuda.max_memory_allocated(dev),
               device_free_bytes=torch.cuda.mem_get_info(dev)[0])
    engine = SearchEngine(local, device=dev, group=layout)
    queries = torch.from_numpy(queries_np).to(dev)
    dist.barrier()
    for kern in KERNELS:
        kern.launches = 0
    res, times = timed_runs(torch, lambda: engine.query(queries, plan="sharded", k=K))
    rec["launches"] = {kern.name: kern.launches for kern in KERNELS}
    rec["p50_ms"] = statistics.median(times) * 1e3
    rec["qps"] = queries.shape[0] * len(times) / sum(times)
    rec["fields_differing"] = [f for f in FIELDS if not np.array_equal(
        getattr(res, f).cpu().numpy(), want[f])]
    if with_queue:
        order, requests = serve_stream(queries_np)
        if rank == layout.leader:
            queue = BatchQueue(engine, plan="sharded", k=K, ladder=SERVE_LADDER,
                               max_batch=SERVE_LADDER[-1], tick_us=200.0)
            t0 = time.perf_counter()
            with queue:
                tickets = [queue.submit(r) for r in requests]
                got = [t.result(timeout=120) for t in tickets]
            t_queued = time.perf_counter() - t0
            queue.close()
            s = queue.stats_summary()
            rec["queue"] = dict(ticks=s["ticks"], dispatches=s["dispatches"],
                                rows=s["rows_served"], dispatch_p50_ms=s["p50_dispatch_ms"],
                                queued_qps=s["rows_served"] / t_queued)
        else:
            rec["follower_calls"] = BatchQueue.follow(engine, plan="sharded", k=K)
        _, direct_fn = engine.make_plan_fn(plan="sharded", k=K)
        direct, t_direct = timed_direct(torch, direct_fn, requests)
        if rank == layout.leader:
            rec["queue"]["direct_qps"] = sum(r.shape[0] for r in requests) / t_direct
            rec["queue"]["requests_differing"] = sum(
                bool(differing(g, w)) for g, w in zip(got, direct))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return rec


def sharded_ranks_phase(torch, dev, ds, queries, one4, kernels):
    """[sharded_ranks]: the sharded plan across 4 ``torch.distributed`` ranks
    on the card, one shard a rank (``RankLayout``, ``build_local_shard``),
    as 4 x 1 and 2 x 2 index x query grids, each held bit for bit to the
    one-process ``plan="sharded"`` at as many shards (4 from [sharded], 2
    built here). The kernels are built already, so no rank runs nvcc. The
    ranks build in turn (a build's transient peak is ~1.8x its shard).
    Returns every rank's launches summed (the 4 x 1 run)."""
    import numpy as np
    from repro_torch.core import SearchEngine
    from repro_torch.core.distributed import build_sharded_index

    work = ROOT / "build" / "ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    one = {4: one4}
    torch.cuda.reset_peak_memory_stats()
    sh2 = build_sharded_index(ds.db, 2, gamma=0.8, max_L=32, seed=0, device=dev)
    peak2 = torch.cuda.max_memory_allocated()
    res2, times2 = timed_runs(torch, lambda: SearchEngine(sh2, device=dev).query(
        queries, plan="sharded", k=K))
    one[2] = dict(result={f: getattr(res2, f).cpu().numpy() for f in FIELDS},
                  device_bytes=sh2.nbytes(), build_peak_bytes=peak2,
                  p50_ms=statistics.median(times2) * 1e3)
    del sh2, res2
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say("sharded_ranks", parent_allocated_bytes=torch.cuda.memory_allocated(),
        parent_reserved_bytes=torch.cuda.memory_reserved(), device_free_bytes=free,
        device_total_bytes=total)
    np.save(work / "db.npy", ds.db)
    np.save(work / "queries.npy", ds.queries)
    want = []
    for shards, _ in RANK_LAYOUTS:
        want.append(str(work / f"want{shards}.npz"))
        np.savez(want[-1], **one[shards]["result"])
    cfg = json.dumps(dict(db=str(work / "db.npy"), queries=str(work / "queries.npy"),
                          layouts=RANK_LAYOUTS, want=want))
    world = RANK_LAYOUTS[0][0] * RANK_LAYOUTS[0][1]
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker", cfg], cwd=ROOT,
            env=env, stdout=open(work / f"rank{r}.out", "w"),
            stderr=open(work / f"rank{r}.err", "w")))
    try:     # a rank that fails leaves the others waiting: stop them all then
        t_end = time.monotonic() + RANK_TIMEOUT_S + 30
        while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
            check(time.monotonic() < t_end, "the ranks outlived their budget")
            time.sleep(0.5)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    failed = {r: (work / f"rank{r}.err").read_text() for r, p in enumerate(procs)
              if p.returncode != 0}
    for r, err in failed.items():   # every failed rank's own last lines
        print(f"[sharded_ranks] rank {r} exited {procs[r].returncode}:\n{err[-2500:]}",
              file=sys.stderr, flush=True)
    check(not failed, f"ranks {sorted(failed)} failed (their errors above)")
    lines = [json.loads(line) for line in (work / "rank0.out").read_text().splitlines()
             if line.startswith("{")]
    check(len(lines) == len(RANK_LAYOUTS), f"rank 0 reported {len(lines)} layouts")
    say("sharded_ranks", world=world, ranks_s=f"{time.perf_counter() - t0:.3f}",
        transport=lines[0]["transport"], device=lines[0]["device"])
    launches = {}
    for line in lines:
        shards = int(line["layout"].split("x")[0])
        ref = one[shards]
        say("sharded_ranks", layout=line["layout"], one_process_shards=shards,
            one_process_device_bytes=ref["device_bytes"],
            one_process_build_peak_bytes=ref["build_peak_bytes"],
            one_process_p50_ms=f"{ref['p50_ms']:.3f}")
        for rec in line["ranks"]:
            say("sharded_ranks", layout=line["layout"], rank=rec["rank"], shard=rec["shard"],
                query_group=rec["query_group"], build_s=rec["build_s"],
                index_bytes=rec["index_bytes"], build_peak_bytes=rec["build_peak_bytes"],
                device_free_after_builds=rec["device_free_bytes"],
                peak_bytes=rec["peak_bytes"], p50_ms=f"{rec['p50_ms']:.3f}",
                qps=f"{rec['qps']:.1f}", launches=json.dumps(rec["launches"]),
                fields_differing=json.dumps(rec["fields_differing"]))
            check(all(rec["launches"][n] > 0 for n in QUERY_KERNELS),
                  f"{line['layout']} rank {rec['rank']}: a query kernel never launched: "
                  f"{rec['launches']}")
            check(rec["launches"]["l2_distance_dense"] == 0,
                  f"{line['layout']} rank {rec['rank']} launched the dense kernel")
            check(not rec["fields_differing"],
                  f"{line['layout']} rank {rec['rank']} differs from the one-process "
                  f"plan at {shards} shards in {rec['fields_differing']}")
            if line["layout"] == "{}x{}".format(*RANK_LAYOUTS[0]):
                for n, c in rec["launches"].items():
                    launches[n] = launches.get(n, 0) + c
            q = rec.get("queue")
            if q is not None:
                say("sharded_ranks", layout=line["layout"], queue_ticks=q["ticks"],
                    dispatches=q["dispatches"], rows=q["rows"],
                    dispatch_p50_ms=f"{q['dispatch_p50_ms']:.4f}",
                    queued_qps=f"{q['queued_qps']:.1f}", direct_qps=f"{q['direct_qps']:.1f}",
                    requests_differing=q["requests_differing"])
                check(q["requests_differing"] == 0,
                      f"{q['requests_differing']} queued requests over the ranks differ from "
                      "their direct dispatch")
                check(q["dispatches"] == q["ticks"] and q["rows"] == SERVE_REPEAT * N_QUERIES,
                      f"the queue over the ranks served {q}")
        followers = [rec["follower_calls"] for rec in line["ranks"] if "follower_calls" in rec]
        if followers:
            lead = next(rec["queue"] for rec in line["ranks"] if "queue" in rec)
            check(all(c == lead["dispatches"] + len(SERVE_LADDER) for c in followers),
                  f"the followers made {followers} calls for {lead['dispatches']} ticks")
    shutil.rmtree(work, ignore_errors=True)
    return launches


def sharded_cli_phase():
    """[sharded_cli]: the serve CLI's multi-rank branch as a user runs it, two
    ranks under ``torch.distributed.run`` on the card."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "repro_torch.launch.serve", "--mode", "ann",
           "--n-points", str(SHARDED_CLI_N), "--queries", "256", "--k", "10"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = [line for line in out.stdout.splitlines()
             if line.startswith(("[sharded x2]", "[ranks]"))]
    say("sharded_cli", cmd=json.dumps(" ".join(cmd[1:])), rc=out.returncode,
        seconds=f"{time.perf_counter() - t0:.3f}")
    for line in lines:
        print(f"[sharded_cli] {line}", flush=True)
    check(out.returncode == 0, f"the two-rank serve CLI exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    ratio = [float(line.split("ratio=")[1].split()[0]) for line in lines
             if line.startswith("[sharded x2]")]
    check(len(ratio) == 1 and ratio[0] < 1.5 and any("transport=" in line for line in lines),
          f"the two-rank serve CLI printed no [sharded x2] result: {out.stdout}")


def srs_phase(torch, dev, ds, queries, exact_dists, e2lsh_bytes, kernels):
    """[srs]: SRS (m = SRS_M, T' = SRS_TPRIME) over the whole database on the
    card at k = 1 and K, its T' true distances through ``l2_distance_by_id``;
    held on SRS_PARITY_Q queries to the same index run on the host. Returns
    the kernels' launches over the timed batches."""
    import numpy as np
    from repro_torch.baselines import SRSIndex, build_srs, srs_query
    from repro_torch.core import overall_ratio

    t0 = time.perf_counter()
    srs = build_srs(ds.db, m=SRS_M, device=dev)
    torch.cuda.synchronize()
    say("srs", m=SRS_M, t_prime=SRS_TPRIME, build_s=f"{time.perf_counter() - t0:.3f}",
        index_bytes=srs.index_bytes, e2lsh_index_storage_bytes=e2lsh_bytes["storage"],
        e2lsh_index_device_bytes=e2lsh_bytes["device"], db_bytes=int(ds.db.nbytes))
    for kern in kernels:
        kern.launches = 0
    Q = queries.shape[0]
    for k in (1, K):
        torch.cuda.reset_peak_memory_stats()
        (ids, dists, checked), times = timed_runs(
            torch, lambda: srs_query(srs, queries, k=k, t_prime=SRS_TPRIME))
        ratio = overall_ratio(dists.cpu().numpy(), exact_dists[:, :k])
        # the stop test certifies the best distance only, so a query may stop
        # with fewer than k candidates examined: its last slots stay +inf
        filled = torch.isfinite(dists).sum(dim=1)
        say("srs", batch=Q, k=k, p50_ms=f"{statistics.median(times) * 1e3:.3f}",
            qps=f"{Q * len(times) / sum(times):.1f}", overall_ratio_vs_exact=f"{ratio:.4f}",
            checked_mean=f"{float(checked.float().mean()):.2f}",
            checked_max=int(checked.max()), filled_share=f"{float(filled.sum()) / (Q * k):.4f}",
            peak_bytes=torch.cuda.max_memory_allocated())
        check(ids.shape == (Q, k) and bool((filled == checked.clamp(max=k)).all()),
              f"SRS results malformed at k={k}: finite slots != min(checked, k)")
        check(int(checked.max()) <= SRS_TPRIME, f"SRS checked past T' at k={k}")
        check(k > 1 or ratio < 1.5, f"SRS overall ratio {ratio} at k=1 is not an ANN result")
    launches = {kern.name: kern.launches for kern in kernels}
    say("srs", launches=json.dumps(launches))
    profile_batches(torch, lambda: srs_query(srs, queries, k=K, t_prime=SRS_TPRIME),
                    statistics.median(times), n_prof=3, plan="srs")
    check(launches["l2_distance"] == 2 * (REPEATS + 1),
          f"SRS did not run its distances through l2_distance_by_id once a batch: {launches}")
    # the same index on the host
    host = SRSIndex.from_numpy(proj=srs.proj.cpu().numpy(), db=ds.db, device="cpu")
    qs = queries[:SRS_PARITY_Q]
    got = [x.cpu().numpy() for x in srs_query(srs, qs, k=K, t_prime=SRS_TPRIME)]
    t0 = time.perf_counter()
    want = [x.numpy() for x in srs_query(host, qs.cpu(), k=K, t_prime=SRS_TPRIME)]
    fin = np.isfinite(want[1])
    check(bool((np.isfinite(got[1]) == fin).all()), "SRS filled other slots on the card")
    ok, swaps, rel = knn_agreement(got[0][fin], got[1][fin], want[0][fin], want[1][fin], TOL)
    tied = (got[0] == want[0]) | np.isclose(got[1], want[1], rtol=TOL, atol=TOL)
    say("srs", parity="card vs host", queries=SRS_PARITY_Q, k=K, host_s=f"{time.perf_counter() - t0:.3f}",
        tie_swaps=swaps, max_rel_err=f"{rel:.3e}",
        checked_equal=int((got[2] == want[2]).sum()))
    check(ok and bool(tied.all()), "SRS on the card differs from the host run beyond ties")
    return launches


def qalsh_phase(torch, dev, ds, queries, exact_dists, kernels):
    """[qalsh]: QALSH (K = QALSH_K lines) over the whole database, QALSH_Q
    queries at k = 1 on the card, held to the same index run on the host."""
    import numpy as np
    from repro_torch.baselines import QALSHIndex, build_qalsh, qalsh_query
    from repro_torch.core import overall_ratio

    t0 = time.perf_counter()
    qa = build_qalsh(ds.db, K=QALSH_K, device=dev)
    torch.cuda.synchronize()
    say("qalsh", K=QALSH_K, w=qa.w, collision_ratio=qa.collision_ratio,
        build_s=f"{time.perf_counter() - t0:.3f}", index_bytes=qa.index_bytes)
    qs = queries[:QALSH_Q]
    for kern in kernels:
        kern.launches = 0
    qalsh_query(qa, qs[:1], k=1)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [x.cpu().numpy() for x in qalsh_query(qa, qs, k=1)]
    t_card = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels}
    ratio = overall_ratio(got[1], exact_dists[:QALSH_Q, :1])
    say("qalsh", queries=QALSH_Q, k=1, ms_per_query=f"{t_card / QALSH_Q * 1e3:.3f}",
        overall_ratio_vs_exact=f"{ratio:.4f}", checked_mean=f"{got[2].mean():.1f}",
        rounds_mean=f"{got[3].mean():.3f}", rounds_max=int(got[3].max()),
        launches=json.dumps(launches))
    check(ratio < 1.5 and bool((got[3] >= 1).all()), f"QALSH overall ratio {ratio}")
    host = QALSHIndex.from_numpy(proj=qa.proj.cpu().numpy(),
                                 sorted_vals=qa.sorted_vals.cpu().numpy(),
                                 sorted_ids=qa.sorted_ids.cpu().numpy(), db=ds.db, w=qa.w,
                                 collision_ratio=qa.collision_ratio, device="cpu")
    t0 = time.perf_counter()
    want = [x.numpy() for x in qalsh_query(host, qs.cpu(), k=1)]
    same = {name: int((g == w).reshape(QALSH_Q, -1).all(axis=1).sum())
            for name, g, w in zip(("ids", "checked", "rounds"),
                                  (got[0], got[2], got[3]), (want[0], want[2], want[3]))}
    err = float(np.abs(got[1] - want[1]).max())
    say("qalsh", parity="card vs host", queries=QALSH_Q, host_s=f"{time.perf_counter() - t0:.3f}",
        rows_equal=json.dumps(same), max_abs_err=f"{err:.3e}")
    check(all(v == QALSH_Q for v in same.values()) and err <= TOL,
          f"QALSH on the card differs from the host run: {same}, dists {err}")


def serve_cli_phase():
    """[serve_cli]: the ANN entry point as a user runs it, on the card."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "ann", "--n", "20000",
           "--queries", "256", "--k", "10", "--queue"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = [line for line in out.stdout.splitlines() if line.startswith("[queue]")]
    say("serve_cli", cmd=json.dumps(" ".join(cmd[1:])), rc=out.returncode,
        seconds=f"{time.perf_counter() - t0:.3f}")
    for line in lines:
        print(f"[serve_cli] {line}", flush=True)
    check(out.returncode == 0, f"the serve CLI exited {out.returncode}: {out.stderr[-2000:]}")
    check(len(lines) == 3 and "dispatches" in lines[0] and "p99" in lines[1]
          and "queued vs" in lines[2], f"the serve CLI printed no [queue] report: {out.stdout}")


def hash_bound_ms(n, d, r, L, m):
    """lsh_hash's least time on the plans' route (``lsh_hash_lookup``): x, a,
    b, wR, rm read once; each hash's two table entries read as a 32-byte
    sector each (the buckets fall at random); cnt, head and fp written once.
    2*n*d*r*L*m flops (the algorithm's columns, not padded)."""
    rlm, nh = r * L * m, n * r * L
    return bound_ms(n * d * 4 + rlm * d * 4 + 3 * rlm * 4 + 2 * nh * 32 + 3 * nh * 4,
                    2 * n * d * rlm)


def probe_bound_ms(rows_read, Q, L, BLKp, sbuf):
    """probe_append's least time: the chain rows the gate reads (ids and
    fingerprints), the [Q, L] inputs and the mask; the buffer and the two
    counts out. Two compares and a select a slot."""
    return bound_ms(rows_read * 2 * BLKp * 4 + 3 * Q * L * 4 + Q + Q * sbuf * 4 + 2 * Q * 4,
                    rows_read * BLKp * 3)


def by_id_bound_ms(n_valid, Q, D, sbuf):
    """l2_distance_by_id's least time: a valid slot's row and norm; every
    slot's id in and distance out; the queries and their norms."""
    return bound_ms(n_valid * (D + 1) * 4 + 2 * Q * sbuf * 4 + Q * (D + 1) * 4,
                    n_valid * (2 * D + 3))


def hash_kernel_phase(torch, dev, ix, queries, hkw, launches, flush):
    """The hash kernel against its plain version, then its times, on the
    route the plans run: ``lsh_hash_lookup`` (the hashes of the schedule and
    the index's own table entries in one launch) on the index's family at
    N = 256, 2, 1 (the batch, a lone query as the plans pad it, a bare row),
    33 and 300 (database rows), cnt, head and fp against
    ``lsh_hash_lookup_ref``; and the bucket route (``lsh_hash_all_radii``,
    bucket and fp against ``lsh_hash_all_radii_ref``) on a ragged family
    (m = 13, D = 100), which has no tables. Every hash clear of a floor()
    boundary by MARGIN must agree. Returns the kernel's record: the lookup
    timed at N = 256 (and 2), its largest difference among those hashes
    (0 when all agree)."""
    from repro_torch.kernels import (lsh_hash_all_radii, lsh_hash_all_radii_ref,
                                     lsh_hash_lookup, lsh_hash_lookup_ref)
    from repro_torch.kernels.lsh_hash.ops import index_hash_pack
    from repro_torch.kernels.lsh_hash.ref import floor_margin

    # the index's pack and tables, as the plans pass them
    pack = index_hash_pack(ix, w=hkw["w"], radii=hkw["radii"])
    lkw = dict(u=hkw["u"], fp_bits=hkw["fp_bits"])
    tables = (ix.table_cnt, ix.blocks_head)
    gen = torch.Generator(device=dev).manual_seed(2)
    r13, L13, m13, d13 = 3, 8, 13, 100
    fam13 = (torch.randn((r13, L13, m13, d13), generator=gen, device=dev),
             torch.rand((r13, L13, m13), generator=gen, device=dev),
             torch.randint(-2**31, 2**31 - 1, (r13, L13, m13), generator=gen, device=dev,
                           dtype=torch.int32) | 1)
    kw13 = dict(w=4.0, radii=(1.0, 2.0, 4.0), u=18, fp_bits=14)
    cases = [(queries[:n], (ix.a, ix.b, ix.rm), hkw) for n in (queries.shape[0], 2, 1)]
    cases += [(ix.db[:n].contiguous(), (ix.a, ix.b, ix.rm), hkw) for n in (33, 300)]
    cases += [(torch.randn((n, d13), generator=gen, device=dev) * 3, fam13, kw13)
              for n in (1, 2, 33, 300)]
    worst = 0
    for x, (a, b, rm), kw in cases:
        if a is ix.a:
            route = "lookup"
            got = lsh_hash_lookup(x, pack, *tables, **lkw)
            want = lsh_hash_lookup_ref(x, pack, *tables, **lkw)
        else:
            route = "bucket"
            got = lsh_hash_all_radii(x, a, b, rm, **kw)
            want = lsh_hash_all_radii_ref(x, a, b, rm, **kw)
        safe = floor_margin(x, a, b, w=kw["w"], radii=kw["radii"]) > MARGIN
        same = torch.stack([g == w for g, w in zip(got, want)]).all(dim=0)
        bad = int((safe & ~same).sum())
        worst = max(worst, max(int(((g - w).abs() * safe).max()) for g, w in zip(got, want)))
        say("lsh_hash", route=route, rows=x.shape[0], m=a.shape[2], D=a.shape[3],
            hashes=same.numel(), clear_of_boundary=int(safe.sum()), disagree_clear=bad,
            flips_near_boundary=int((~safe & ~same).sum()))
        check(bad == 0, f"lsh_hash ({route}): {bad} hashes clear of a boundary disagree "
                        f"(N={x.shape[0]}, m={a.shape[2]}, D={a.shape[3]})")

    r, L, m, D = ix.a.shape
    Q = queries.shape[0]
    t_k = median_ms(torch, lambda: lsh_hash_lookup(queries, pack, *tables, **lkw), flush=flush)
    t_p = median_ms(torch, lambda: lsh_hash_lookup_ref(queries, pack, *tables, **lkw),
                    flush=flush)
    a2 = ix.a.reshape(r * L * m, D)
    t_y = median_ms(torch, lambda: queries @ a2.T, flush=flush)
    b_ms, b_by = hash_bound_ms(Q, D, r, L, m)
    say("lsh_hash", route="lookup", rows=Q, ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
        yardstick_projection_matmul_ms=f"{t_y:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        bound_share=f"{b_ms / t_k:.3f}", tflops=f"{2 * Q * D * r * L * m / t_k / 1e9:.2f}")
    q2 = queries[:2]
    t_k2 = median_ms(torch, lambda: lsh_hash_lookup(q2, pack, *tables, **lkw), flush=flush)
    b2_ms, b2_by = hash_bound_ms(2, D, r, L, m)
    say("lsh_hash", route="lookup", rows=2, ms=f"{t_k2:.4f}", bound_ms=f"{b2_ms:.4f}",
        bound_by=b2_by, bound_share=f"{b2_ms / t_k2:.3f}")
    return dict(name="lsh_hash", route="cuda", source="src/repro_torch/csrc/lsh_hash.cu",
                replaces="src/repro/kernels/lsh_hash/kernel.py:76",
                launches=launches["lsh_hash"], max_abs_err=float(worst), ms=t_k,
                plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def dense_kernel_phase(torch, dev, flush):
    """The dense kernel against its plain version at the exact scan's block
    shape plus ragged and float16 ones (Gaussian inputs, the reference's
    test), and its times."""
    from repro_torch.kernels import l2_distance, l2_distance_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for nq, nc, d, dtype in ((N_QUERIES, EXACT_BLOCK, 128, torch.float32),
                             (1, EXACT_BLOCK - 3, 128, torch.float32),
                             (129, EXACT_BLOCK - 3, 128, torch.float32),
                             (129, EXACT_BLOCK - 3, 100, torch.float32),
                             (1, EXACT_BLOCK, 130, torch.float32),
                             (129, EXACT_BLOCK - 3, 130, torch.float32),
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
        bound_share=f"{b_ms / t_k:.3f}", tflops=f"{2 * NQ * NC * D / t_k / 1e9:.2f}")
    return worst, t_k, t_p, t_l, b_ms, b_by


def merge_bound_ms(Q, k, sbuf, L):
    """topk_merge's least time: the running top-k (ids and distances) in
    and out, the candidates and their distances, the bucket sizes, the done
    flag and the six counters read once; one compare an entry."""
    return bound_ms(Q * (2 * k * 8 + sbuf * 8 + L * 4 + 2 + 10 * 4), Q * (k + sbuf))


def probe_kernel_phases(torch, dev, ix, queries, cfg, launches, flush):
    """``probe_append`` and ``l2_distance_by_id`` against their plain
    versions on radius 0 of the batch (the hash stage's real buckets, every
    query active, and the buffer the probe fills), plus ragged cases on
    radius 0 and the last radius: a lone query, inactive queries, L < 32, a
    budget that runs out inside a step, one and four chain steps, a strided
    and a narrower buffer. Times both at radius 0 of the batch, and
    ``topk_merge`` folding that radius into a fresh state (``merge_phase``).
    Returns the three kernels' records."""
    from repro_torch.core import query as tq
    from repro_torch.kernels import (INVALID, l2_distance_by_id, l2_distance_by_id_ref,
                                     probe_append, probe_append_ref)

    Q, D = queries.shape
    cnt_all, head_all, qfp_all = tq.hash_stage(ix, queries, cfg)
    cnt, head, qfp = cnt_all[0], head_all[0], qfp_all[0]
    active = torch.ones(Q, dtype=torch.bool, device=dev)
    sbuf, BLKp = tq._fused_sbuf(cfg), ix.ids_blocks.shape[1]
    pkw = dict(block_objs=cfg.block_objs, max_chain=cfg.max_chain, S=cfg.S, sbuf=sbuf)
    some = torch.arange(Q, device=dev) % 3 != 1
    # the ragged cases also run on the last radius' buckets, the largest,
    # where a budget of 13 runs out inside a step
    t = cnt_all.shape[0] - 1
    last = (cnt_all[t], head_all[t], qfp_all[t])
    cases = [("r0_batch", (cnt, head, qfp, active), pkw),
             ("r0_lone", (cnt[:1], head[:1], qfp[:1], active[:1]), pkw)]
    for r_label, (c_, h_, f_) in (("r0", (cnt, head, qfp)), (f"r{t}", last)):
        cases += [(f"{r_label}_inactive_third", (c_, h_, f_, some), pkw),
                  (f"{r_label}_L7",
                   tuple(x[:, :7].contiguous() for x in (c_, h_, f_)) + (active,), pkw),
                  (f"{r_label}_S13_sbuf21", (c_, h_, f_, active), dict(pkw, S=13, sbuf=21)),
                  (f"{r_label}_C1", (c_, h_, f_, some), dict(pkw, max_chain=1)),
                  (f"{r_label}_C4", (c_, h_, f_, some), dict(pkw, max_chain=4))]
    for label, args, kw in cases:
        got = probe_append(*args, ix.ids_blocks, ix.fps_blocks, **kw)
        want = probe_append_ref(*args, ix.ids_blocks, ix.fps_blocks, **kw)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        say("bucket_probe", case=label, Q=args[0].shape[0], L=args[0].shape[1],
            C=kw["max_chain"], S=kw["S"], sbuf=kw["sbuf"], exact=same,
            cands=int(got[1].sum()), blocks_read=int(got[2].sum()),
            full_budget=int((got[1] == kw["S"]).sum()))
        check(same, f"probe_append disagrees with its plain version ({label})")
    L = cnt.shape[1]

    def probe_bound(rows_read):
        return probe_bound_ms(rows_read, Q, L, BLKp, sbuf)

    pargs = (cnt, head, qfp, active, ix.ids_blocks, ix.fps_blocks)
    buf, count, blocks = probe_append(*pargs, **pkw)
    t_k = median_ms(torch, lambda: probe_append(*pargs, **pkw), flush=flush)
    t_p = median_ms(torch, lambda: probe_append_ref(*pargs, **pkw), flush=flush)
    rows_read = int(blocks.sum())
    b_ms, b_by = probe_bound(rows_read)
    say("bucket_probe", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}", rows_read=rows_read,
        cands=int(count.sum()), bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        bound_share=f"{b_ms / t_k:.3f}")
    largs = last + (active, ix.ids_blocks, ix.fps_blocks)
    buf_last, count_last, blocks_last = probe_append(*largs, **pkw)
    t_last = median_ms(torch, lambda: probe_append(*largs, **pkw), flush=flush)
    bl_ms, _ = probe_bound(int(blocks_last.sum()))
    say("bucket_probe", radius=t, ms=f"{t_last:.4f}", rows_read=int(blocks_last.sum()),
        cands=int(count_last.sum()), bound_ms=f"{bl_ms:.4f}",
        bound_share=f"{bl_ms / t_last:.3f}")
    records = [dict(name="bucket_probe", route="cuda",
                    source="src/repro_torch/csrc/bucket_probe.cu",
                    replaces="src/repro/kernels/bucket_probe/kernel.py:38",
                    launches=launches["bucket_probe"], max_abs_err=0.0, ms=t_k, plain_ms=t_p,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)]

    qn2 = (queries * queries).sum(-1)
    wide = torch.cat([buf, buf[:, :5]], dim=1)
    worst = 0.0
    for label, qs, ids, qq, whole in (
            ("r0_batch", queries, buf, qn2, buf), ("r0_lone", queries[:1], buf[:1], qn2[:1], buf),
            ("r0_strided", queries, wide[:, :sbuf], qn2, buf),
            ("r0_narrow", queries, buf[:, :sbuf - 3].contiguous(), qn2, buf),
            (f"r{t}_batch", queries, buf_last, qn2, buf_last)):
        got = l2_distance_by_id(qs, ids, ix.db, ix.db_norm2, qq)
        want = l2_distance_by_id_ref(qs, ids, ix.db, ix.db_norm2, qq)
        inf_same = bool(torch.equal(torch.isinf(got), ids == INVALID))
        err = float((got - want).abs().nan_to_num(posinf=0.0).max())
        worst = max(worst, err)
        # a slot's value depends on its (query, id) only
        batch = l2_distance_by_id(queries, whole, ix.db, ix.db_norm2, qn2)
        same_bits = bool(torch.equal(got, batch[: qs.shape[0], : ids.shape[1]]))
        say("l2_distance_gathered", case=label, Q=qs.shape[0], sbuf=ids.shape[1], D=D,
            valid_slots=int((ids != INVALID).sum()), max_abs_err=f"{err:.3e}",
            inf_on_invalid=inf_same, equal_to_batch=same_bits)
        check(inf_same and bool(torch.allclose(got, want, rtol=TOL, atol=TOL)),
              f"l2_distance_by_id disagrees with its plain version ({label})")
        check(same_bits, f"l2_distance_by_id: {label} differs from the batch's bits")
    def by_id_bound(n_valid):
        return by_id_bound_ms(n_valid, Q, D, sbuf)

    dargs = (queries, buf, ix.db, ix.db_norm2, qn2)
    valid = buf != INVALID
    n_valid = int(valid.sum())
    ids64 = torch.where(valid, buf, 0).to(torch.int64)
    base = (ix.db_norm2[ids64] + qn2[:, None]).unsqueeze(-1)
    qcol = queries.unsqueeze(-1)
    t_k = median_ms(torch, lambda: l2_distance_by_id(*dargs), flush=flush)
    t_p = median_ms(torch, lambda: l2_distance_by_id_ref(*dargs), flush=flush)
    t_l = median_ms(torch, lambda: torch.baddbmm(base, ix.db[ids64], qcol, alpha=-2.0),
                    flush=flush)
    b_ms, b_by = by_id_bound(n_valid)
    say("l2_distance_gathered", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}",
        library_gather_baddbmm_ms=f"{t_l:.4f}", valid_slots=n_valid, bound_ms=f"{b_ms:.4f}",
        bound_by=b_by, bound_share=f"{b_ms / t_k:.3f}")
    n_last = int((buf_last != INVALID).sum())
    t_last = median_ms(torch, lambda: l2_distance_by_id(queries, buf_last, ix.db, ix.db_norm2,
                                                        qn2), flush=flush)
    bl_ms, _ = by_id_bound(n_last)
    say("l2_distance_gathered", radius=t, ms=f"{t_last:.4f}", valid_slots=n_last,
        bound_ms=f"{bl_ms:.4f}", bound_share=f"{bl_ms / t_last:.3f}")
    records.append(dict(name="l2_distance_gathered", route="cuda",
                        source="src/repro_torch/csrc/l2_distance.cu",
                        replaces="src/repro/kernels/l2_distance/kernel.py:66",
                        launches=launches["l2_distance"], max_abs_err=worst, ms=t_k,
                        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l))
    d2 = l2_distance_by_id(*dargs)
    d2_last = l2_distance_by_id(queries, buf_last, ix.db, ix.db_norm2, qn2)
    records.append(merge_phase(torch, cfg, (buf, d2, cnt, blocks, count),
                               (buf_last, d2_last, last[0], blocks_last, count_last), t,
                               launches, flush))
    return records


def merge_phase(torch, cfg, radius0, radius_last, t_last, launches, flush):
    """``topk_merge`` against its plain version, bit for bit, on the batch's
    radius 0 (cand_id, cand_d2, cnt, blocks_read, count) folded into a fresh
    state, on the last radius folded into the state radius 0 left (a third
    of the rows done, the probe trace on), and on a lone row; then timed at
    radius 0 of the batch, each timed call on a fresh copy of the state (the
    kernel updates it in place). Returns its record."""
    from repro_torch.core import query as tq
    from repro_torch.kernels import topk_merge, topk_merge_ref

    Q, dev = radius0[0].shape[0], radius0[0].device
    thresh2 = tq._thresholds(cfg)
    fresh = tq._init_state(Q, cfg, dev)
    traced = tq._init_state(Q, cfg.replace(collect_probe_sizes=True), dev)
    after0 = topk_merge_ref(traced, *radius0, t=0, thresh2=thresh2[0])
    some_done = list(after0)
    some_done[2] = after0[2] | (torch.arange(Q, device=dev) % 3 == 1)
    cases = [("r0_batch", fresh, radius0, 0),
             (f"r{t_last}_after_r0_third_done", tuple(some_done), radius_last, t_last),
             ("r0_lone", tuple(x[:1] for x in fresh[:7]) + (fresh[7],),
              tuple(x[:1] for x in radius0), 0)]
    for label, state, radius, t in cases:
        want = topk_merge_ref(state, *radius, t=t, thresh2=thresh2[t])
        got = topk_merge(tuple(x.clone() for x in state), *radius, t=t, thresh2=thresh2[t])
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        say("topk_merge", case=label, Q=radius[0].shape[0], k=cfg.k, sbuf=radius[0].shape[1],
            exact=same, done_after=int(got[2].sum()),
            found_slots=int((got[0] != 2**31 - 1).sum()))
        check(same, f"topk_merge disagrees with its plain version ({label})")
    margs, mkw = radius0, dict(t=0, thresh2=thresh2[0])
    copies = [tuple(x.clone() for x in fresh) for _ in range(40)]
    t_k = median_ms(torch, lambda: topk_merge(copies.pop(), *margs, **mkw), flush=flush)
    t_p = median_ms(torch, lambda: topk_merge_ref(fresh, *margs, **mkw), flush=flush)
    L = radius0[2].shape[1]
    b_ms, b_by = merge_bound_ms(Q, cfg.k, radius0[0].shape[1], L)
    say("topk_merge", ms=f"{t_k:.4f}", plain_ms=f"{t_p:.4f}", Q=Q, k=cfg.k,
        sbuf=radius0[0].shape[1], L=L, bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        bound_share=f"{b_ms / t_k:.3f}")
    return dict(name="topk_merge", route="cuda", source="src/repro_torch/csrc/topk_merge.cu",
                replaces="none: the XLA merge of src/repro/core/query.py:355",
                launches=launches["topk_merge"], max_abs_err=0.0, ms=t_k, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def lm_kernel_checks(torch, dev, idx, hn, flush):
    """The three query kernels against their plain versions at the [lm]
    retrieval hook's shapes (Q = the decode batch, D = the vocab): the hash
    of the step's normalised logits, then radius 0 and the last radius of the
    probe and the distance epilogue, as the fused plan calls them. Times each
    at radius 0 beside its bound. Returns {kernel: max abs error}."""
    from repro_torch.core import SearchEngine
    from repro_torch.core import query as tq
    from repro_torch.kernels import (INVALID, l2_distance_by_id, l2_distance_by_id_ref,
                                     lsh_hash_lookup, lsh_hash_lookup_ref, probe_append,
                                     probe_append_ref)
    from repro_torch.kernels.lsh_hash.ops import index_hash_pack
    from repro_torch.kernels.lsh_hash.ref import floor_margin

    engine = SearchEngine(idx)
    cfg = engine.config(k=LM_K)
    ix = engine.arrays(cfg.block_objs)
    Q, D = hn.shape
    # Step 1 as the plans run it: the hashes and the index's table entries
    pack = index_hash_pack(ix, w=cfg.w, radii=cfg.radii)
    lkw = dict(u=cfg.u, fp_bits=cfg.fp_bits)
    tables = (ix.table_cnt, ix.blocks_head)
    h_got = lsh_hash_lookup(hn, pack, *tables, **lkw)
    h_want = lsh_hash_lookup_ref(hn, pack, *tables, **lkw)
    safe = floor_margin(hn, ix.a, ix.b, w=cfg.w, radii=cfg.radii) > MARGIN
    same = torch.stack([g == w for g, w in zip(h_got, h_want)]).all(dim=0)
    bad = int((safe & ~same).sum())
    r, L, m, _ = ix.a.shape
    t_h = median_ms(torch, lambda: lsh_hash_lookup(hn, pack, *tables, **lkw), flush=flush)
    a2 = ix.a.reshape(r * L * m, D)
    t_y = median_ms(torch, lambda: hn @ a2.T, flush=flush)
    b_h, by_h = hash_bound_ms(Q, D, r, L, m)
    say("lm", kernel="lsh_hash", route="lookup", Q=Q, D=D, r=r, L=L, m=m,
        hashes=same.numel(), clear_of_boundary=int(safe.sum()), disagree_clear=bad,
        flips_near_boundary=int((~safe & ~same).sum()), ms=f"{t_h:.4f}",
        yardstick_projection_matmul_ms=f"{t_y:.4f}", bound_ms=f"{b_h:.4f}", bound_by=by_h)
    check(bad == 0, f"lsh_hash: {bad} hashes clear of a boundary disagree at D={D}")
    queries, qnorm2 = tq._prep_queries(hn)
    cnt_all, head_all, qfp_all = tq.hash_stage(ix, queries, cfg)
    active = torch.ones(Q, dtype=torch.bool, device=dev)
    pkw = dict(block_objs=cfg.block_objs, max_chain=cfg.max_chain, S=cfg.S,
               sbuf=tq._fused_sbuf(cfg))
    worst = dict(lsh_hash=max(int(((g - w).abs() * safe).max()) for g, w in zip(h_got, h_want)),
                 bucket_probe=0.0,
                 l2_distance_gathered=0.0)
    for t in (0, cnt_all.shape[0] - 1):
        pargs = (cnt_all[t], head_all[t], qfp_all[t], active, ix.ids_blocks, ix.fps_blocks)
        got = probe_append(*pargs, **pkw)
        want = probe_append_ref(*pargs, **pkw)
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        buf = got[0]
        d2 = l2_distance_by_id(queries, buf, ix.db, ix.db_norm2, qnorm2)
        d2_p = l2_distance_by_id_ref(queries, buf, ix.db, ix.db_norm2, qnorm2)
        inf_same = bool(torch.equal(torch.isinf(d2), buf == INVALID))
        err = float((d2 - d2_p).abs().nan_to_num(posinf=0.0).max())
        worst["l2_distance_gathered"] = max(worst["l2_distance_gathered"], err)
        n_valid = int((buf != INVALID).sum())
        rows = int(got[2].sum())
        t_p = median_ms(torch, lambda: probe_append(*pargs, **pkw), flush=flush)
        t_d = median_ms(torch, lambda: l2_distance_by_id(queries, buf, ix.db, ix.db_norm2,
                                                         qnorm2), flush=flush)
        b_p, by_p = probe_bound_ms(rows, Q, L, ix.ids_blocks.shape[1], pkw["sbuf"])
        b_d, by_d = by_id_bound_ms(n_valid, Q, D, pkw["sbuf"])
        # the library yardstick: the rows gathered by id, then one batched
        # product with the norms folded in (as at the SIFT shape)
        ids64 = torch.where(buf != INVALID, buf, 0).to(torch.int64)
        base = (ix.db_norm2[ids64] + qnorm2[:, None]).unsqueeze(-1)
        qcol = queries.unsqueeze(-1)
        t_l = median_ms(torch, lambda: torch.baddbmm(base, ix.db[ids64], qcol, alpha=-2.0),
                        flush=flush)
        say("lm", kernel="bucket_probe", radius=t, Q=Q, exact=exact, rows_read=rows,
            cands=int(got[1].sum()), ms=f"{t_p:.4f}", bound_ms=f"{b_p:.4f}", bound_by=by_p)
        say("lm", kernel="l2_distance_gathered", radius=t, Q=Q, D=D, valid_slots=n_valid,
            max_abs_err=f"{err:.3e}", inf_on_invalid=inf_same, ms=f"{t_d:.4f}",
            library_gather_baddbmm_ms=f"{t_l:.4f}", bound_ms=f"{b_d:.4f}", bound_by=by_d)
        check(exact, f"probe_append disagrees with its plain version at D={D}, radius {t}")
        check(inf_same and bool(torch.allclose(d2, d2_p, rtol=TOL, atol=TOL)),
              f"l2_distance_by_id disagrees with its plain version at D={D}, radius {t}")
    return worst


def lm_kernel_checks_at_cli_vocab(torch, dev, flush):
    """lm_kernel_checks at [lm_cli]'s retrieval width, mamba2-1.3b's vocab
    (D = 50,280): LM_DSTORE unit rows made on the card from seed 1, indexed
    as [lm]'s datastore is, probed by LM_B unit rows that are datastore rows
    plus noise. Returns {kernel: max abs error}."""
    from repro_torch.configs import get_config
    from repro_torch.core import E2LSHoS

    D = get_config(LM_CLI_ARCH).vocab
    g = torch.Generator(dev).manual_seed(1)
    ds = torch.randn(LM_DSTORE, D, generator=g, device=dev)
    ds /= torch.linalg.vector_norm(ds, dim=1, keepdim=True)
    idx = E2LSHoS.build(ds, gamma=0.8, max_L=16, seed=0, device=dev)
    q = ds[:LM_B] + 0.5 * torch.randn(LM_B, D, generator=g, device=dev) / D ** 0.5
    hn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    p = idx.params
    say("lm", check="query kernels at the CLI arch's vocab", arch=LM_CLI_ARCH, D=D,
        dstore_rows=LM_DSTORE, m=p.m, L=p.L, r=p.r, S=p.S)
    return lm_kernel_checks(torch, dev, idx, hn, flush)


def lm_fp32_check(torch, model, params, batch):
    """The reference's test_prefill_decode_matches_forward at full width and
    depth: the same parameters in float32, prefill on the first T - 4 tokens
    and 4 decode steps against forward_train on all T, at LM_FP32_TOL."""
    import dataclasses
    from repro_torch.models import Model

    m32 = Model(dataclasses.replace(model.cfg, dtype="float32"), device=model.device)
    tokens = batch["tokens"]
    B, T = tokens.shape
    full, _ = m32.forward_train(params, batch)
    cache = m32.init_cache(B, T, torch.float32)
    lg, cache = m32.prefill(params, {"tokens": tokens[:, :T - 4]}, cache)
    steps = [lg[:, -1]]
    for i in range(T - 4, T):
        lg, cache = m32.decode_step(params, tokens[:, i:i + 1], cache)
        steps.append(lg[:, 0])
    got = torch.stack(steps, dim=1)                   # positions T-5 .. T-1
    want = full[:, T - 5:]
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=LM_FP32_TOL, atol=LM_FP32_TOL))
    say("lm", check="fp32 prefill + 4 decode steps vs forward_train", dtype="float32",
        positions=f"{T - 5}..{T - 1}", max_abs_diff=f"{err:.3e}", tol=LM_FP32_TOL,
        logits_abs_max=f"{float(want.abs().max()):.3f}")
    check(ok and bool(torch.isfinite(full).all()),
          f"fp32 prefill/decode differ from the forward by {err} (tol {LM_FP32_TOL})")


def lm_phase(torch, dev, kernels, flush):
    """[lm]: deepseek-7b at its full published config on the card, serving
    LM_B prompts of LM_T tokens through ``ServeEngine.generate`` with the
    retrieval hook over an E2LSHoS index of LM_DSTORE unit rows in the logits
    space (``launch.serve``'s inputs and index settings). Returns the query
    kernels' launches over the timed generates and their max errors at the
    hook's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core import E2LSHoS, SearchEngine
    from repro_torch.launch.serve import lm_inputs
    from repro_torch.models import Model
    from repro_torch.serving import ServeEngine

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 products")
    cfg = get_config(LM_ARCH)
    n_params = cfg.param_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(Model.param_count(params) == n_params, "deepseek-7b's parameter count")
    say("lm", arch=LM_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        d_ff=cfg.d_ff, vocab=cfg.vocab, activations=cfg.dtype, param_count=n_params,
        fp32_master_bytes=4 * n_params, init_s=f"{init_s:.3f}", reduced="none")
    t0 = time.perf_counter()
    batch, dstore = lm_inputs(cfg, batch=LM_B, seq=LM_T, dstore=LM_DSTORE, seed=0,
                              device=dev)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = E2LSHoS.build(dstore, gamma=0.8, max_L=16, seed=0, device=dev)
    torch.cuda.synchronize()
    p = idx.params
    say("lm", dstore_rows=dstore.shape[0], dstore_dim=dstore.shape[1],
        dstore_bytes=dstore.nbytes, host_data_s=f"{data_s:.3f}",
        index_build_s=f"{time.perf_counter() - t0:.3f}", m=p.m, L=p.L, r=p.r, S=p.S,
        index_device_bytes=idx.index.arrays.nbytes())
    del dstore
    hook = ServeEngine.make_retrieval_fn(idx, k=LM_K)
    seen = []

    def recording_hook(hidden):
        seen.append(hidden)
        return hook(hidden)

    eng = ServeEngine(model, params, max_seq=LM_T + LM_STEPS + 1, cache_dtype=torch.bfloat16,
                      retrieval_fn=recording_hook)
    t0 = time.perf_counter()
    warm = eng.generate(batch, steps=LM_STEPS)
    torch.cuda.synchronize()
    say("lm", warmup_generate_s=f"{time.perf_counter() - t0:.3f}")

    # the path's run: counts 0 just before, read just after; each phase of
    # a generate timed to the device's completion
    times = dict(prefill=[], decode=[], retrieval=[])

    def timed(fn, log):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            log.append(time.perf_counter() - t)
            return out
        return run

    # the engine calls model.prefill / model.decode_step: time them on this
    # instance (the class's methods are untouched)
    model.prefill = timed(model.prefill, times["prefill"])
    model.decode_step = timed(model.decode_step, times["decode"])
    eng.retrieval_fn = timed(recording_hook, times["retrieval"])
    for kern in kernels:
        kern.launches = 0
    outs, walls, grew = [], [], []
    for _ in range(LM_TIMED):
        before = {kern.name: kern.launches for kern in kernels}
        seen.clear()
        t0 = time.perf_counter()
        outs.append(eng.generate(batch, steps=LM_STEPS))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        grew.append({kern.name: kern.launches - before[kern.name] for kern in kernels})
    launches = {kern.name: kern.launches for kern in kernels}
    peak = torch.cuda.max_memory_allocated()
    del model.prefill, model.decode_step
    eng.retrieval_fn = recording_hook
    out = outs[-1]
    wall = statistics.median(walls)
    dec_ms = statistics.median(times["decode"]) * 1e3
    # a decode step's least time: every layer weight and the lm head read
    # once (the embedding table is gathered, not read whole); with the fp32
    # masters cast at each use, read 4 B, write 2 B and read 2 B a parameter
    n_read = n_params - cfg.vocab * cfg.d_model
    say("lm", timed_generates=LM_TIMED, batch=LM_B, prompt=LM_T, steps=LM_STEPS, k=LM_K,
        launches=json.dumps(launches), launches_per_generate=json.dumps(grew[-1]),
        prefill_ms_p50=f"{statistics.median(times['prefill']) * 1e3:.3f}",
        decode_ms_p50=f"{dec_ms:.3f}",
        decode_ms_min=f"{min(times['decode']) * 1e3:.3f}",
        decode_ms_max=f"{max(times['decode']) * 1e3:.3f}",
        retrieval_ms_p50=f"{statistics.median(times['retrieval']) * 1e3:.3f}",
        generate_s_p50=f"{wall:.4f}", tokens_per_s=f"{LM_B * LM_STEPS / wall:.2f}",
        decode_bound_cast_ms=f"{8 * n_read / HBM_BYTES_PER_S * 1e3:.3f}",
        decode_bound_bf16_ms=f"{2 * n_read / HBM_BYTES_PER_S * 1e3:.3f}", peak_bytes=peak)
    toks = out.tokens
    check(toks.shape == (LM_B, LM_STEPS) and out.neighbors.shape == (LM_B, LM_STEPS, LM_K)
          and bool(torch.isfinite(out.logits_last.float()).all()),
          "the [lm] generate's outputs are malformed")
    check(all(torch.equal(o.tokens, toks) and torch.equal(o.neighbors, out.neighbors)
              for o in outs + [warm]), "the timed generates differ in tokens or neighbours")
    check(all(g[n] >= LM_STEPS for g in grew for n in QUERY_KERNELS),
          f"a query kernel launched fewer than {LM_STEPS} times in a generate: {grew}")
    check(all(g["l2_distance_dense"] == 0 for g in grew), "[lm] launched the dense kernel")
    # every step's neighbours against a direct fused query on the same rows
    direct = SearchEngine(idx)
    found = 0
    for step, h in enumerate(seen):
        hf = h.float()
        hn = hf / torch.clamp_min(torch.linalg.vector_norm(hf, dim=1, keepdim=True), 1e-9)
        res = direct.query(hn, plan="fused", k=LM_K)
        check(torch.equal(res.ids, out.neighbors[:, step]),
              f"step {step}: the hook's neighbours differ from a direct fused query")
        found += int(res.found.sum())
    say("lm", check="hook ids == SearchEngine(idx).query(plan='fused') ids", steps=len(seen),
        rows_found=found, rows=LM_B * len(seen), sample_tokens=json.dumps(toks[0].tolist()),
        sample_neighbors=json.dumps(out.neighbors[0, 0].tolist()))
    profile_batches(torch, lambda: eng.generate(batch, steps=LM_STEPS), wall, n_prof=1,
                    path="lm", batch=LM_B)
    errs = lm_kernel_checks(torch, dev, idx, hn, flush)
    del idx, direct, eng, hook, recording_hook
    torch.cuda.empty_cache()
    narrow = lm_kernel_checks_at_cli_vocab(torch, dev, flush)
    errs = {name: max(err, narrow[name]) for name, err in errs.items()}
    lm_fp32_check(torch, model, params, batch)
    return launches, errs


def lm_reduced_phase(torch, dev):
    """[lm_reduced]: every arch at its reduced config, the same parameters on
    the card and on the CPU: forward_train logits at 2e-4 (3e-4 with a
    sliding window, the reference's bounds) and a 4-step generate's tokens."""
    import numpy as np
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServeEngine

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()

    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        tol = 3e-4 if cfg.swa_window else TOL
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32))}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(
                rng.normal(size=(2, cfg.enc_frames, cfg.d_model)).astype(np.float32))
        gpu_batch = {k: v.to(dev) for k, v in batch.items()}
        gpu = Model(cfg, device=dev)
        params = gpu.init(torch.Generator(dev).manual_seed(0))
        cpu, cparams = Model(cfg, device="cpu"), to_cpu(params)
        got, _ = gpu.forward_train(params, gpu_batch)
        want, _ = cpu.forward_train(cparams, batch)
        err = float((got.cpu() - want).abs().max())
        gen = {}
        for dev_, m, p_, b in (("cuda", gpu, params, gpu_batch), ("cpu", cpu, cparams, batch)):
            eng = ServeEngine(m, p_, max_seq=40, cache_dtype=torch.float32, device=dev_)
            gen[dev_] = eng.generate(b, steps=4).tokens.cpu()
        same = bool(torch.equal(gen["cuda"], gen["cpu"]))
        say("lm_reduced", arch=arch, family=cfg.family, forward_max_abs_err=f"{err:.3e}",
            tol=tol, generate_tokens_equal=same)
        check(bool(torch.allclose(got.cpu(), want, rtol=tol, atol=tol)),
              f"{arch}: forward logits on the card differ from the CPU's by {err}")
        check(same, f"{arch}: the card's generate differs from the CPU's")


def lm_cli_phase():
    """[lm_cli]: the LM entry point as a user runs it, on the card, at the
    reference CLI's default arch (mamba2-1.3b, full width) with retrieval."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm", "--arch",
           LM_CLI_ARCH, "--steps", "8", "--retrieval"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    say("lm_cli", cmd=json.dumps(" ".join(cmd[1:])), rc=out.returncode,
        seconds=f"{time.perf_counter() - t0:.3f}")
    for line in out.stdout.splitlines():
        print(f"[lm_cli] {line}", flush=True)
    check(out.returncode == 0, f"the LM serve CLI exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    lines = out.stdout.splitlines()
    check(any(line.startswith("generated (2, 8)") for line in lines)
          and "retrieved neighbors per step: (2, 8, 1)" in lines,
          f"the LM serve CLI printed no generated/neighbors lines: {out.stdout}")


def tree_cpu(tree):
    """A host copy of a parameter dict (a step updates its input in place)."""
    if isinstance(tree, dict):
        return {k: tree_cpu(v) for k, v in tree.items()}
    return tree.to("cpu", copy=True)


def grad_errors(got, want):
    """{leaf: |got - want| max / max(want's max |g|, 1e-3 of the largest
    leaf's)}: an attention key bias's gradient is zero in exact arithmetic,
    so both sides hold rounding noise there."""
    def named(t, p=""):
        if isinstance(t, dict):
            return {k2: v2 for k in sorted(t) for k2, v2 in named(t[k], f"{p}{k}/").items()}
        return {p[:-1]: t.float().cpu()}
    got, want = named(got), named(want)
    top = max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k] - want[k]).abs().max())
            / max(float(want[k].abs().max()), 1e-3 * top) for k in want}


def train_flops(cfg, B, T):
    """The step's floating-point operations, as counted for its TFLOP/s:
    6·N·P for the products (P: every parameter but the input embedding,
    the lm head included), 2·N·P_layers for remat's second forward of each
    layer, and the attention's QK^T and P·V over the causal (and window)
    band: 4·B·H·hd·pairs a layer and pass, for the forward, its recompute
    and the backward's two."""
    N = B * T
    P = cfg.param_count() - cfg.vocab * cfg.d_model
    P_layers = P - cfg.vocab * cfg.d_model - cfg.d_model     # less lm head, final norm
    w = cfg.swa_window or T
    pairs = sum(min(q + 1, w) for q in range(T))
    products = 6 * N * P
    remat = 2 * N * P_layers if cfg.remat != "none" else 0
    attn = (4 if cfg.remat != "none" else 3) * cfg.n_layers * 4 * B * cfg.n_heads * cfg.hd * pairs
    return dict(products=products, remat=remat, attention=attn,
                total=products + remat + attn, non_embedding_params=P)


def train_phase(torch, dev, kernels):
    """[train]: h2o-danube-1.8b at its full config on the card (24 layers,
    d_model 2560, GQA 32/8, d_ff 6912, vocab 32,000, SWA 4096, bf16
    activations over fp32 masters, remat="full"), AdamW on the reference's
    synthetic token pipeline at B = 4, T = 2,048: one warm-up step, then
    TRAIN_TIMED steps, each ended by reading its loss."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, TokenPipelineState
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16", "h2o-danube-1.8b's config")
    n_params = cfg.param_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    state = init_train_state(model, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    leaves = tree_leaves(state.params)
    check(Model.param_count(state.params) == n_params, "h2o-danube-1.8b's parameter count")
    say("train", arch=TRAIN_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_ff=cfg.d_ff, vocab=cfg.vocab,
        swa_window=cfg.swa_window, activations=cfg.dtype, remat=cfg.remat,
        param_count=n_params, leaves=len(leaves),
        state_bytes=16 * n_params, state="fp32 masters, grads, mu, nu",
        init_s=f"{time.perf_counter() - t0:.3f}", reduced="none")
    pipe = TokenPipeline(cfg.vocab, TRAIN_T, TRAIN_B, seed=0, device=dev)
    ps = TokenPipelineState()
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT))
    stride = [max(1, p.numel() // 65536) for p in leaves]
    before = [p.reshape(-1)[::s].clone() for p, s in zip(leaves, stride)]
    for kern in kernels:
        kern.launches = 0
    rows, times = [], []
    for i in range(1 + TRAIN_TIMED):
        batch, ps = pipe.next_batch(ps)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])           # the step ends when its loss is read
        times.append(time.perf_counter() - t)
        rows.append((loss, float(m["grad_norm"]), float(m["lr"])))
        say("train", step=i, timed=i > 0, loss=f"{loss:.6f}", grad_norm=f"{rows[-1][1]:.6f}",
            lr=f"{rows[-1][2]:.4e}", ms=f"{times[-1] * 1e3:.3f}")
    peak = torch.cuda.max_memory_allocated()
    launches = {kern.name: kern.launches for kern in kernels}
    p50 = statistics.median(times[1:])
    fl = train_flops(cfg, TRAIN_B, TRAIN_T)
    say("train", timed_steps=TRAIN_TIMED, batch=TRAIN_B, seq=TRAIN_T,
        tokens_per_step=TRAIN_B * TRAIN_T, step_ms_p50=f"{p50 * 1e3:.3f}",
        step_ms_min=f"{min(times[1:]) * 1e3:.3f}", step_ms_max=f"{max(times[1:]) * 1e3:.3f}",
        warmup_step_ms=f"{times[0] * 1e3:.3f}",
        tokens_per_s=f"{TRAIN_B * TRAIN_T / p50:.1f}",
        model_tflops=f"{fl['total'] / p50 / 1e12:.2f}",
        bf16_peak_share=f"{fl['total'] / p50 / BF16_FLOPS:.4f}",
        flop_bound_ms=f"{fl['total'] / BF16_FLOPS * 1e3:.3f}", peak_bytes=peak)
    say("train", flop_count=json.dumps({k: f"{v:.4e}" for k, v in fl.items()}),
        counted="6*N*P (P non-embedding, lm head in) + remat 2*N*P_layers + attention "
                "4*B*H*hd*causal pairs x (fwd, recompute, 2 bwd)")
    check(all(math.isfinite(v) for r in rows for v in r[:2]),
          f"a [train] loss or grad norm is not finite: {rows}")
    moved = [not torch.equal(p.reshape(-1)[::s], b) for p, s, b in zip(leaves, stride, before)]
    check(all(moved), f"{moved.count(False)} leaves did not move in {1 + TRAIN_TIMED} steps")
    check(not any(launches.values()), f"training launched a query kernel: {launches}")
    say("train", check="every loss and grad norm finite, every leaf moved",
        leaves_moved=sum(moved), query_kernel_launches=json.dumps(launches))

    def one_step():
        b, _ = pipe.next_batch(ps)
        step(state, b)
    busy = profile_batches(torch, one_step, p50, n_prof=1, path="train", batch=TRAIN_B)
    kinds = {}
    for name, us in busy.items():
        kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + us / 1e3
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:10]
    say("train", device_ms_by_kind=json.dumps({k: round(v, 3) for k, v in
                                               sorted(kinds.items(), key=lambda kv: -kv[1])}))
    say("train", top_kernels_ms=json.dumps([[n.replace("void at::native::", "")[:110],
                                             round(us / 1e3, 3)] for n, us in top]))
    del state, step, before, leaves, batch
    torch.cuda.empty_cache()


def train_fp32_check(torch, dev):
    """h2o-danube-1.8b at full width, 2 layers, float32 (about 0.30 G
    parameters), B = 1, T = 256: one step on the card and the same step on
    the CPU from the same parameters (loss, grad norm, every leaf's
    gradient), TF32 off; on the card remat "full" vs "none", and microbatch
    0 vs 1 at B = 2."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, TokenPipelineState
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, TrainState, init_opt_state,
                                      loss_and_grads, make_train_step)
    from repro_torch.training.optimizer import tree_leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2, dtype="float32")
    opt = AdamWConfig(**TRAIN_OPT)
    gpu, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on for float32 products")
    params = gpu.init(torch.Generator(dev).manual_seed(1))
    cparams = tree_cpu(params)

    def clone(t):
        return {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()

    def state_of(p):
        """A fresh TrainState on a copy of p (a step updates it in place)."""
        q = clone(p)
        return TrainState(params=q, opt=init_opt_state(q),
                          step=torch.zeros((), dtype=torch.int32, device=q["embed"]["table"].device))

    batch, _ = TokenPipeline(cfg.vocab, 256, 1, seed=1, device=dev).next_batch(
        TokenPipelineState())
    cbatch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    lg, gg = loss_and_grads(gpu, params, batch)
    lc, gc = loss_and_grads(cpu, cparams, cbatch)
    _, mg = make_train_step(gpu, opt)(state_of(params), batch)
    _, mc = make_train_step(cpu, opt)(state_of(cparams), cbatch)
    errs = grad_errors(gg, gc)
    worst = max(errs, key=errs.get)
    d_loss = abs(float(lg) - float(lc)) / abs(float(lc))
    d_gn = abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) / float(mc["grad_norm"])
    d_sl = abs(float(mg["loss"]) - float(mc["loss"])) / abs(float(mc["loss"]))
    say("train", check="fp32 full width, 2 layers: card vs CPU", params=Model.param_count(params),
        batch=1, seq=256, loss=f"{float(lg):.6f}", loss_rel_diff=f"{d_loss:.3e}",
        step_loss_rel_diff=f"{d_sl:.3e}", grad_norm_rel_diff=f"{d_gn:.3e}",
        loss_rtol=TRAIN_LOSS_RTOL, worst_leaf=worst, worst_grad_err=f"{errs[worst]:.3e}",
        grad_tol=TRAIN_GRAD_TOL, seconds=f"{time.perf_counter() - t0:.3f}")
    check(max(d_loss, d_sl, d_gn) <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_GRAD_TOL,
          f"the fp32 step on the card differs from the CPU's: loss {d_loss}, grad norm "
          f"{d_gn}, {worst} {errs[worst]}")

    # remat "full" against "none", on the card
    none = Model(dataclasses.replace(cfg, remat="none"), device=dev)
    ln, gn = loss_and_grads(none, params, batch)
    errs = grad_errors(gg, gn)
    worst = max(errs, key=errs.get)
    d_loss = abs(float(lg) - float(ln)) / abs(float(ln))
    say("train", check="remat full vs none, card, fp32", remat=cfg.remat,
        loss_rel_diff=f"{d_loss:.3e}", worst_leaf=worst, worst_grad_err=f"{errs[worst]:.3e}",
        loss_rtol=TRAIN_LOSS_RTOL, grad_tol=TRAIN_GRAD_TOL)
    check(cfg.remat == "full" and d_loss <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_GRAD_TOL,
          f"remat full differs from none: loss {d_loss}, {worst} {errs[worst]}")
    del gn, gc, cparams

    # microbatch 0 against 1 at B = 2, on the card
    b2, _ = TokenPipeline(cfg.vocab, 256, 2, seed=2, device=dev).next_batch(TokenPipelineState())
    s0, m0 = make_train_step(gpu, opt, microbatch=0)(state_of(params), b2)
    s1, m1 = make_train_step(gpu, opt, microbatch=1)(state_of(params), b2)
    d_loss = abs(float(m0["loss"]) - float(m1["loss"])) / abs(float(m0["loss"]))
    d_gn = abs(float(m0["grad_norm"]) - float(m1["grad_norm"])) / float(m0["grad_norm"])
    lr = float(m0["lr"])
    dp = max(float((a - b).abs().max()) for a, b in
             zip(tree_leaves(s0.params), tree_leaves(s1.params)))
    say("train", check="microbatch 1 vs 0, card, fp32, B=2", loss_rel_diff=f"{d_loss:.3e}",
        grad_norm_rel_diff=f"{d_gn:.3e}", rtol=TRAIN_LOSS_RTOL, max_param_diff=f"{dp:.3e}",
        param_bound=f"2*lr={2 * lr:.3e}")
    check(max(d_loss, d_gn) <= TRAIN_LOSS_RTOL and dp <= 2 * lr + 1e-6,
          f"microbatch 1 differs from 0: loss {d_loss}, grad norm {d_gn}, params {dp}")
    del params, gg, s0, s1
    torch.cuda.empty_cache()


def train_reduced_phase(torch, dev):
    """[train_reduced]: every arch at its reduced config, one step on the
    card and on the CPU from the same parameters: the loss and the step's
    grad norm at 1e-5 relative, every leaf's gradient at 2e-4 of its max."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import TokenPipeline, TokenPipelineState
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, TrainState, init_opt_state, loss_and_grads,
                                      make_train_step)
    import numpy as np

    def state_of(p, device):
        return TrainState(params=p, opt=init_opt_state(p),
                          step=torch.zeros((), dtype=torch.int32, device=device))

    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        gpu, cpu = Model(cfg, device=dev), Model(cfg, device="cpu")
        params = gpu.init(torch.Generator(dev).manual_seed(0))
        cparams = tree_cpu(params)
        cbatch, _ = TokenPipeline(cfg.vocab, 32, 2, seed=3, device="cpu").next_batch(
            TokenPipelineState())
        if cfg.family == "encdec":
            cbatch["frames"] = torch.from_numpy(np.random.default_rng(3).normal(
                size=(2, cfg.enc_frames, cfg.d_model)).astype(np.float32))
        batch = {k: v.to(dev) for k, v in cbatch.items()}
        lg, gg = loss_and_grads(gpu, params, batch)
        lc, gc = loss_and_grads(cpu, cparams, cbatch)
        errs = grad_errors(gg, gc)
        worst = max(errs, key=errs.get)
        _, mg = make_train_step(gpu, AdamWConfig())(state_of(params, dev), batch)
        _, mc = make_train_step(cpu, AdamWConfig())(state_of(cparams, "cpu"), cbatch)
        d_loss = abs(float(lg) - float(lc)) / abs(float(lc))
        d_gn = abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) / float(mc["grad_norm"])
        say("train_reduced", arch=arch, family=cfg.family, loss=f"{float(lc):.6f}",
            loss_rel_diff=f"{d_loss:.3e}", grad_norm_rel_diff=f"{d_gn:.3e}",
            rtol=TRAIN_LOSS_RTOL, worst_leaf=worst, worst_grad_err=f"{errs[worst]:.3e}",
            grad_tol=TRAIN_REDUCED_GRAD_TOL)
        check(max(d_loss, d_gn) <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_REDUCED_GRAD_TOL,
              f"{arch}: the card's step differs from the CPU's: loss {d_loss}, grad norm "
              f"{d_gn}, {worst} {errs[worst]}")


def train_dp_phase(torch, dev):
    """[train_dp]: a one-rank nccl group on the card. make_dp_train_step
    without compression equals make_train_step; compressed_psum of a card
    tensor equals its plain quantise/dequantise formula."""
    import socket
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, TokenPipelineState
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, compressed_psum, init_train_state,
                                      make_dp_train_step, make_train_step)
    from repro_torch.training.optimizer import tree_leaves

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        cfg = get_config(TRAIN_ARCH, reduced=True)
        model = Model(cfg, device=dev)
        batch, _ = TokenPipeline(cfg.vocab, 64, 4, seed=4, device=dev).next_batch(
            TokenPipelineState())
        opt = AdamWConfig(**TRAIN_OPT)
        sa, ma = make_train_step(model, opt)(
            init_train_state(model, torch.Generator(dev).manual_seed(0)), batch)
        out = {}
        for compress in (False, True):
            sb, mb = make_dp_train_step(model, opt, compress=compress)(
                init_train_state(model, torch.Generator(dev).manual_seed(0)), batch)
            out[compress] = (
                abs(float(ma["loss"]) - float(mb["loss"])) / abs(float(ma["loss"])),
                abs(float(ma["grad_norm"]) - float(mb["grad_norm"])) / float(ma["grad_norm"]),
                max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(sa.params), tree_leaves(sb.params))))
        lr = float(ma["lr"])
        x = torch.randn(4096, 257, generator=torch.Generator(dev).manual_seed(5), device=dev)
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        want = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8).float() * scale
        got = compressed_psum(x)
        exact = bool(torch.equal(got, want))
        say("train_dp", backend=dist.get_backend(), world=dist.get_world_size(),
            uncompressed_vs_train_step=json.dumps(
                dict(zip(("loss_rel", "grad_norm_rel", "max_param_diff"), out[False]))),
            compressed_vs_train_step=json.dumps(
                dict(zip(("loss_rel", "grad_norm_rel", "max_param_diff"), out[True]))),
            param_bound=f"2*lr={2 * lr:.3e}", rtol=TRAIN_LOSS_RTOL,
            compressed_psum_equals_formula=exact,
            compressed_psum_max_err=f"{float((got - x).abs().max()):.3e}",
            half_quantum=f"{float(scale) / 2:.3e}")
        u = out[False]
        check(u[0] <= TRAIN_LOSS_RTOL and u[1] <= TRAIN_LOSS_RTOL and u[2] <= 2 * lr + 1e-6,
              f"make_dp_train_step(compress=False) differs from make_train_step: {u}")
        check(out[True][0] <= TRAIN_LOSS_RTOL and exact,
              f"the compressed step or compressed_psum is off: {out[True]}, exact={exact}")
    finally:
        dist.destroy_process_group()


def train_cli_phase():
    """[train_cli]: the training entry point as a user runs it, on the card:
    reduced h2o-danube-1.8b for 40 steps uninterrupted (A), and again (B)
    sent SIGTERM after its step-10 line, then rerun: B checkpoints on the
    signal, resumes from that step and ends on A's last loss."""
    import signal
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def cmd(run):
        return [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
                "--reduced", "--steps", "40", "--batch", "8", "--seq", "128", "--ckpt-dir",
                str(root / run), "--ckpt-every", "10"]

    def last_loss(lines):
        return float([ln.split()[3] for ln in lines if ln.startswith("step ")][-1])

    t0 = time.perf_counter()
    try:
        a = subprocess.run(cmd("A"), cwd=ROOT, capture_output=True, text=True, timeout=300,
                           env=env)
        for line in a.stdout.splitlines():
            print(f"[train_cli] A: {line}", flush=True)
        check(a.returncode == 0, f"the train CLI exited {a.returncode}: {a.stderr[-2000:]}")
        b = subprocess.Popen(cmd("B"), cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env)
        b_lines = []
        try:
            for line in b.stdout:
                b_lines.append(line.rstrip("\n"))
                print(f"[train_cli] B: {b_lines[-1]}", flush=True)
                if line.startswith("step    10"):
                    b.send_signal(signal.SIGTERM)
            b_rc = b.wait(timeout=300)
            b_err = b.stderr.read()
        finally:
            b.kill()
        check(b_rc == 0, f"the SIGTERM'd train CLI exited {b_rc}: {b_err[-2000:]}")
        c = subprocess.run(cmd("B"), cwd=ROOT, capture_output=True, text=True, timeout=300,
                           env=env)
        for line in c.stdout.splitlines():
            print(f"[train_cli] B rerun: {line}", flush=True)
        check(c.returncode == 0, f"the resumed train CLI exited {c.returncode}: "
                                 f"{c.stderr[-2000:]}")
        resumed = [ln for ln in c.stdout.splitlines() if ln.startswith("resumed from step ")]
        la, lb = last_loss(a.stdout.splitlines()), last_loss(c.stdout.splitlines())
        rel = abs(la - lb) / abs(la)
        say("train_cli", sigterm=any(ln.startswith("SIGTERM:") for ln in b_lines),
            resumed=json.dumps(resumed), last_loss_A=la, last_loss_B=lb,
            rel_diff=f"{rel:.3e}", rtol=TRAIN_CLI_LOSS_RTOL,
            seconds=f"{time.perf_counter() - t0:.3f}")
        check(any(ln.startswith("SIGTERM: checkpointing") for ln in b_lines) and resumed
              and a.stdout.splitlines()[-1] == "done" == c.stdout.splitlines()[-1],
              "the SIGTERM'd run printed no SIGTERM line or its rerun did not resume")
        check(rel <= TRAIN_CLI_LOSS_RTOL,
              f"the resumed run's last loss {lb} differs from the uninterrupted {la}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the LM steps over a DeviceMesh: four ranks on the card
# ---------------------------------------------------------------------------

def mesh_phases(card: str) -> dict:
    """[train_mesh] and [serve_mesh] (one set of ranks runs both), then
    [train_mesh_cli], each with its seconds; rank 0's tally of the
    [train_mesh] warm-up step's collectives."""
    t_phase = time.perf_counter()
    records = mesh_ranks_phase(card)
    say("train_mesh", serve_mesh_included=True,
        seconds=f"{time.perf_counter() - t_phase:.3f}")
    t_phase = time.perf_counter()
    train_mesh_cli_phase()
    say("train_mesh_cli", seconds=f"{time.perf_counter() - t_phase:.3f}")
    return records[0]["timed"]["comm"]


def mesh_ranks_phase(card: str):
    """Four ranks of ``chip_smoke.py --mesh-worker`` on the card (gloo on
    cuda:0, joined by ``launch.serve.join_ranks``, a MESH_SHAPE mesh) run
    [train_mesh] then [serve_mesh]; rank 0 prints one JSON line with every
    rank's records, held here."""
    phase = "train_mesh/serve_mesh"
    import socket
    work = ROOT / "build" / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    conf = json.dumps({})
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker", conf], cwd=ROOT,
            env=env, stdout=open(work / f"rank{r}.out", "w"),
            stderr=open(work / f"rank{r}.err", "w")))
    try:     # a rank that fails leaves the others waiting: stop them all then
        t_end = time.monotonic() + MESH_TIMEOUT_S + 30
        while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
            check(time.monotonic() < t_end, f"the {phase} ranks outlived their budget")
            time.sleep(0.5)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    failed = {r: (work / f"rank{r}.err").read_text() for r, p in enumerate(procs)
              if p.returncode != 0}
    for r, err in failed.items():
        print(f"[{phase}] rank {r} exited {procs[r].returncode}:\n{err[-2500:]}",
              file=sys.stderr, flush=True)
    check(not failed, f"{phase}: ranks {sorted(failed)} failed (their errors above)")
    lines = [json.loads(line) for line in (work / "rank0.out").read_text().splitlines()
             if line.startswith("[")]
    check(len(lines) == 1, f"{phase}: rank 0 reported {len(lines)} records")
    shutil.rmtree(work, ignore_errors=True)
    train_mesh_report(lines[0], card)
    serve_mesh_report(lines[0], card)
    return lines[0]


def mesh_worker(cfg: dict) -> int:
    """One rank of [train_mesh] and [serve_mesh], in a process of its own
    (``chip_smoke.py --mesh-worker CONFIG``): join the group as the launchers'
    ranks do, build the (data, model) mesh (ranks sharing the card over gloo
    run the functional collectives synchronously: ``launch.mesh``), run the
    two phases, and gather every rank's record to rank 0, which prints them
    as one JSON line."""
    faulthandler.dump_traceback_later(MESH_TIMEOUT_S, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh, sync_collectives
    from repro_torch.launch.serve import join_ranks

    dev, transport = join_ranks("cuda")
    if transport == "gloo":
        sync_collectives("cuda")
    mesh = make_test_mesh(*MESH_SHAPE, device_type="cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    rec = dict(rank=dist.get_rank(), transport=transport, device=str(dev),
               coordinate=mesh.get_coordinate())
    rec["numerics"] = train_mesh_numerics(torch, dev, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    rec["timed"] = train_mesh_timed(torch, dev, mesh)
    rec["train_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rec["serve"] = serve_mesh_run(torch, dev, mesh)
    rec["serve"].update(peak_bytes=torch.cuda.max_memory_allocated(dev),
                        seconds=time.perf_counter() - t0)
    records = [None] * dist.get_world_size()
    dist.all_gather_object(records, rec)
    if dist.get_rank() == 0:
        print(json.dumps(records), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _local_bytes(leaves) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in leaves)


def train_mesh_numerics(torch, dev, mesh) -> dict:
    """h2o-danube-1.8b at full width, 2 layers, fp32, B = 2, T = 256, on the
    mesh: the gradients of the loss (``loss_and_grads``, the FSDP
    reduce-scatters included), then one step of build_cell's train cell.
    Rank 0 holds them to the one-process gradients and step on the card
    (each leaf's gradient, the global grad norm, the loss, every parameter
    after the step), and reads a planted fault the gradient check must
    catch: the one-process gradients of half the batch."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, TokenPipelineState
    from repro_torch.launch.steps import (build_cell, gather_tree, place_tree, run_cell,
                                          sharded_train_state)
    from repro_torch.models import Model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.sharding import on_mesh
    from repro_torch.training import (AdamWConfig, init_train_state, loss_and_grads,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2, dtype="float32")
    opt = AdamWConfig(**MESH_OPT)
    model = Model(cfg, device=dev)
    batch, _ = TokenPipeline(cfg.vocab, 256, 2, seed=1, device=dev).next_batch(
        TokenPipelineState())
    rank = dist.get_rank()
    one = m1 = g1 = planted = None
    if rank == 0:
        s1 = init_train_state(model, torch.Generator(dev).manual_seed(0))
        _, g1 = loss_and_grads(model, s1.params, batch)
        _, half = loss_and_grads(model, s1.params, {k: v[:1] for k, v in batch.items()})
        planted = grad_errors(half, g1)
        del half
        one, m1 = make_train_step(model, opt)(s1, batch)
    dist.barrier()
    cell = build_cell(cfg, "train_4k", mesh, shape=ShapeSpec("train_mesh", 256, 2, "train"),
                      opt_cfg=opt)
    state = sharded_train_state(model, 0, cell.in_shardings[0])
    with on_mesh(cell.rules):
        _, g2 = loss_and_grads(model, state.params, place_tree(batch, cell.in_shardings[1]))
    g2 = gather_tree(g2)
    errs = grad_errors(g2, g1) if rank == 0 else None
    del g2, g1
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, m2 = run_cell(cell, state, batch)
    loss = float(m2["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    want = cell.in_shardings[0]
    leaves = tree_leaves(state.params) + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)
    wants = tree_leaves(want.params) + tree_leaves(want.opt.mu) + tree_leaves(want.opt.nu)
    rec = dict(loss=loss, step_ms=step_ms, leaves=len(leaves),
               placements_equal=sum(tuple(a.placements) == tuple(w.placements)
                                    for a, w in zip(leaves, wants)),
               local_devices=sorted({a.to_local().device.type for a in leaves}
                                    | {state.step.to_local().device.type}),
               sharded_leaves=sum(any(p.is_shard() for p in a.placements) for a in leaves),
               demotions=len(cell.demotions))
    dparam = 0.0
    for a, b in zip(tree_leaves(state.params), tree_leaves(one.params) if one else
                    [None] * len(leaves)):
        full = a.full_tensor()
        if b is not None:
            dparam = max(dparam, float((full - b).abs().max()))
        del full
    if rank == 0:
        worst, fault = max(errs, key=errs.get), max(planted, key=planted.get)
        gn1, gn2 = float(m1["grad_norm"]), float(m2["grad_norm"])
        rec.update(one_process_loss=float(m1["loss"]), dloss=abs(float(m1["loss"]) - loss),
                   dparam=dparam, params=Model.param_count(one.params),
                   worst_leaf=worst, grad_err=errs[worst], planted_leaf=fault,
                   planted_err=planted[fault], grad_norm=gn1, dgnorm=abs(gn1 - gn2) / gn1)
    return rec


def train_mesh_timed(torch, dev, mesh) -> dict:
    """h2o-danube-1.8b at its full config (bf16 activations over fp32
    masters, remat "full"), MESH_TRAIN_LAYERS deep, at [train]'s traffic (B
    = 4 x T = 2,048) on the mesh: one warm-up step under a tally of its
    collectives, then MESH_TIMED timed (each placing its batch). The ranks
    build the state in turn."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, TokenPipelineState
    from repro_torch.launch.dryrun import CollectiveTally
    from repro_torch.launch.steps import build_cell, run_cell, sharded_train_state
    from repro_torch.models import Model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training import AdamWConfig
    from repro_torch.training.optimizer import tree_leaves

    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=MESH_TRAIN_LAYERS)
    model = Model(cfg, device=dev)
    cell = build_cell(cfg, "train_4k", mesh,
                      shape=ShapeSpec("train_mesh", TRAIN_T, TRAIN_B, "train"),
                      opt_cfg=AdamWConfig(**TRAIN_OPT))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = sharded_train_state(model, 0, cell.in_shardings[0])
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    state_bytes = _local_bytes(tree_leaves(state.params) + tree_leaves(state.opt.mu)
                               + tree_leaves(state.opt.nu))
    pipe = TokenPipeline(cfg.vocab, TRAIN_T, TRAIN_B, seed=0, device=dev)
    ps = TokenPipelineState()
    losses, times, tally = [], [], CollectiveTally()
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(1 + MESH_TIMED):
        batch, ps = pipe.next_batch(ps)
        torch.cuda.synchronize(dev)
        dist.barrier()
        t = time.perf_counter()
        # the warm-up step under the collectives' tally
        with tally if i == 0 else contextlib.nullcontext():
            state, m = run_cell(cell, state, batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t)
    return dict(layers=cfg.n_layers, full_layers=full.n_layers, init_s=init_s,
                init_peak_bytes=init_peak, state_bytes=state_bytes,
                params=cfg.param_count(), step_s=times, losses=losses,
                step_peak_bytes=torch.cuda.max_memory_allocated(dev),
                comm=tally.result())


def train_mesh_report(records, card):
    """[train_mesh]: hold the numerics and print the timed steps."""
    r0 = records[0]
    num = r0["numerics"]
    say("train_mesh", card=json.dumps(card), mesh=json.dumps(dict(zip(("data", "model"),
                                                                      MESH_SHAPE))),
        ranks=len(records), transport=r0["transport"], device=r0["device"])
    say("train_mesh", check="fp32 full width, 2 layers, B=2 T=256: mesh vs one process on "
        "the card", params=num["params"], loss=f"{num['loss']:.6f}",
        one_process_loss=f"{num['one_process_loss']:.6f}", dloss=f"{num['dloss']:.3e}",
        loss_tol=MESH_LOSS_TOL, dparam=f"{num['dparam']:.3e}", param_tol=MESH_PARAM_TOL,
        step_ms=f"{num['step_ms']:.3f}", demotions=num["demotions"])
    say("train_mesh", check="gradients: mesh vs one process, each leaf of its max |g|",
        worst_leaf=num["worst_leaf"], grad_err=f"{num['grad_err']:.3e}", grad_tol=MESH_GRAD_TOL,
        grad_norm=f"{num['grad_norm']:.6f}", grad_norm_rel_diff=f"{num['dgnorm']:.3e}",
        grad_norm_rtol=MESH_GNORM_RTOL, planted_fault="one-process gradients of half the batch",
        planted_leaf=num["planted_leaf"], planted_err=f"{num['planted_err']:.3e}")
    for rec in records:
        n = rec["numerics"]
        say("train_mesh", rank=rec["rank"], coordinate=json.dumps(rec["coordinate"]),
            leaves=n["leaves"], placements_equal=n["placements_equal"],
            sharded_leaves=n["sharded_leaves"], local_devices=json.dumps(n["local_devices"]))
        check(n["placements_equal"] == n["leaves"] and n["local_devices"] == ["cuda"],
              f"[train_mesh] rank {rec['rank']}: {n['leaves'] - n['placements_equal']} leaves "
              f"off their named_shardings_for placements, local shards on {n['local_devices']}")
    check(num["dloss"] < MESH_LOSS_TOL and num["dparam"] < MESH_PARAM_TOL
          and num["grad_err"] <= MESH_GRAD_TOL and num["dgnorm"] <= MESH_GNORM_RTOL,
          f"[train_mesh] the mesh step differs from the one-process step: {num}")
    check(num["planted_err"] > MESH_GRAD_TOL,
          f"[train_mesh] the gradient check passes a planted fault: {num['planted_err']}")
    t0 = r0["timed"]
    steps = t0["step_s"][1:]
    p50 = statistics.median(steps)
    cut = "none" if t0["layers"] == t0["full_layers"] else \
        f"depth {t0['layers']} of {t0['full_layers']} layers (the phase's time over gloo)"
    say("train_mesh", timed_steps=len(steps), layers=t0["layers"], reduced=json.dumps(cut),
        params=t0["params"], batch=TRAIN_B, seq=TRAIN_T, step_ms_p50=f"{p50 * 1e3:.3f}",
        step_ms=json.dumps([round(x * 1e3, 3) for x in steps]),
        warmup_step_ms=f"{t0['step_s'][0] * 1e3:.3f}",
        tokens_per_s=f"{TRAIN_B * TRAIN_T / p50:.1f}",
        losses=json.dumps([round(x, 6) for x in t0["losses"]]))
    for rec in records:
        t = rec["timed"]
        say("train_mesh", rank=rec["rank"], state_bytes=t["state_bytes"],
            init_s=f"{t['init_s']:.3f}", init_peak_bytes=t["init_peak_bytes"],
            step_peak_bytes=t["step_peak_bytes"], peak_bytes=rec["train_peak_bytes"])
    comm = t0["comm"]
    say("train_mesh", collectives_one_step_rank0=json.dumps(
        {k: {"calls": comm[f"n_{k}"], "operand_bytes": comm[k]} for k in DRYRUN_KINDS}),
        total_operand_bytes=comm["total"])
    say("train_mesh", collectives_by_site_rank0=json.dumps(comm["by_site"]))
    check(all(math.isfinite(x) for x in t0["losses"]), f"[train_mesh] losses {t0['losses']}")


def serve_mesh_run(torch, dev, mesh) -> dict:
    """deepseek-7b at full width, 2 layers, fp32: build_cell's prefill and
    decode cells on the mesh (B = 2 rows, a 64-token prompt, 4 greedy
    decode steps); rank 0 holds every step's logits and token to the
    one-process prefill and decode_step on the card. Each rank builds the
    parameters from the seed in turn and keeps its blocks."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_cell, place_in_turn, run_cell
    from repro_torch.models import Model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training.optimizer import tree_leaves

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2, dtype="float32")
    B, T, n = MESH_SERVE_B, MESH_SERVE_T, MESH_SERVE_STEPS
    S = T + n
    model = Model(cfg, device=dev)
    pre = build_cell(cfg, "prefill_32k", mesh, shape=ShapeSpec("prefill", S, B, "prefill"))
    dec = build_cell(cfg, "decode_32k", mesh, shape=ShapeSpec("decode", S, B, "decode"))
    rank = dist.get_rank()
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=torch.Generator(dev).manual_seed(5),
                           device=dev, dtype=torch.int32)
    want = []
    if rank == 0:    # the one-process prefill and greedy decode on the card
        params = model.init(torch.Generator(dev).manual_seed(0))
        lg, cache = model.prefill(params, {"tokens": tokens}, model.init_cache(B, S, torch.float32))
        want.append(lg)
        for _ in range(n):
            lg, cache = model.decode_step(params, want[-1].argmax(-1).int(), cache)
            want.append(lg)
        del params, cache
        torch.cuda.empty_cache()
    dist.barrier()
    params = place_in_turn(lambda: model.init(torch.Generator(dev).manual_seed(0)),
                           pre.in_shardings[0])
    cache = model.init_cache(B, S, torch.float32)
    torch.cuda.synchronize(dev)
    got, times = [], []
    t0 = time.perf_counter()
    lg, cache = run_cell(pre, params, {"tokens": tokens}, cache)
    full = lg.full_tensor()
    times.append(time.perf_counter() - t0)
    got.append(full)
    for _ in range(n):
        t0 = time.perf_counter()
        lg, cache = run_cell(dec, params, full.argmax(-1).int(), cache)
        full = lg.full_tensor()
        times.append(time.perf_counter() - t0)
        got.append(full)
    caches = [c.k for c in cache.attn] + [c.v for c in cache.attn]
    rec = dict(step_s=times, cache_placed=all(
        isinstance(c, DTensor) and tuple(c.placements) == tuple(w.k.placements)
        for c, w in zip(caches, pre.in_shardings[2].attn * 2)),
        cache_bytes=_local_bytes(caches),
        param_bytes=_local_bytes(tree_leaves(params)),
        local_devices=sorted({c.to_local().device.type for c in caches + tree_leaves(params)}))
    if rank == 0:
        rec["errs"] = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
        rec["tokens_equal"] = [bool(torch.equal(g.argmax(-1), w.argmax(-1)))
                               for g, w in zip(got, want)]
        rec["params"] = cfg.param_count()
    return rec


def serve_mesh_report(records, card):
    """[serve_mesh]: hold the prefill and decode cells to one process."""
    r0 = dict(records[0]["serve"], transport=records[0]["transport"])
    say("serve_mesh", card=json.dumps(card), arch=LM_ARCH, layers=2, width="full",
        dtype="float32", params=r0["params"], batch=MESH_SERVE_B, prompt=MESH_SERVE_T,
        decode_steps=MESH_SERVE_STEPS, transport=r0["transport"],
        prefill_ms=f"{r0['step_s'][0] * 1e3:.3f}",
        decode_ms=json.dumps([round(x * 1e3, 3) for x in r0["step_s"][1:]]),
        max_rel_err=f"{max(r0['errs']):.3e}", tol=MESH_LOGIT_TOL,
        tokens_equal=json.dumps(r0["tokens_equal"]), seconds=f"{r0['seconds']:.3f}")
    for rank in records:
        rec = dict(rank["serve"], rank=rank["rank"], coordinate=rank["coordinate"])
        say("serve_mesh", rank=rec["rank"], coordinate=json.dumps(rec["coordinate"]),
            param_bytes=rec["param_bytes"], cache_bytes=rec["cache_bytes"],
            cache_placed=rec["cache_placed"], local_devices=json.dumps(rec["local_devices"]),
            peak_bytes=rec["peak_bytes"])
        check(rec["cache_placed"] and rec["local_devices"] == ["cuda"],
              f"[serve_mesh] rank {rec['rank']}: caches off cache_specs or shards off the card")
    check(max(r0["errs"]) < MESH_LOGIT_TOL and all(r0["tokens_equal"]),
          f"[serve_mesh] the mesh cells differ from one process: {r0['errs']} "
          f"{r0['tokens_equal']}")


def train_mesh_cli_phase():
    """[train_mesh_cli]: the training entry point across world sizes, on the
    card. ``torch.distributed.run --nproc_per_node 4 -m
    repro_torch.launch.train --reduced --model-parallel 2`` (a (2, 2) mesh,
    gloo on cuda:0) is sent SIGTERM after its step-10 line and saves with
    every rank; two ranks (a (1, 2) mesh) resume from that checkpoint and
    end, rc 0, on an uninterrupted one-process run's last loss."""
    import signal
    root = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def cmd(ranks, *extra):
        run = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(ranks)] if ranks else [sys.executable])
        return run + ["-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--reduced",
                      "--steps", str(MESH_CLI_STEPS), "--batch", "8", "--seq", "128",
                      "--log-every", "5", *extra]

    def last_loss(lines):
        return float([ln.split()[3] for ln in lines if ln.startswith("step ")][-1])

    ckpt = ("--ckpt-dir", str(root), "--ckpt-every", "5")
    t0 = time.perf_counter()
    # the uninterrupted one-process run goes beside the four ranks
    a = subprocess.Popen(cmd(0), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
    try:
        b = subprocess.Popen(cmd(4, "--model-parallel", "2", *ckpt), cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        b_lines = []
        try:
            for line in b.stdout:
                b_lines.append(line.rstrip("\n"))
                print(f"[train_mesh_cli] 4 ranks: {b_lines[-1]}", flush=True)
                if line.startswith(f"step {MESH_CLI_SIGTERM:5d}"):
                    b.send_signal(signal.SIGTERM)
            b_rc = b.wait(timeout=300)
            b_err = b.stderr.read()
        finally:
            b.kill()
        saved = sorted(p.name for p in root.glob("step_*"))
        check(any(ln.startswith("SIGTERM: checkpointing") for ln in b_lines) and saved,
              f"the SIGTERM'd 4-rank run saved no checkpoint (rc {b_rc}): {b_err[-2000:]}")
        c = subprocess.run(cmd(2, *ckpt), cwd=ROOT, capture_output=True, text=True,
                           timeout=300, env=env)
        for line in c.stdout.splitlines():
            print(f"[train_mesh_cli] 2 ranks: {line}", flush=True)
        check(c.returncode == 0, f"the resumed 2-rank train CLI exited {c.returncode}: "
                                 f"{c.stderr[-2000:]}")
        c_lines = c.stdout.splitlines()
        resumed = [ln for ln in c_lines if ln.startswith("resumed from step ")]
        a_out, a_err = a.communicate(timeout=300)
        check(a.returncode == 0, f"the one-process train CLI exited {a.returncode}: "
                                 f"{a_err[-2000:]}")
        la, lc = last_loss(a_out.splitlines()), last_loss(c_lines)
        rel = abs(la - lc) / abs(la)
        say("train_mesh_cli", first_mesh=json.dumps(b_lines[0].split("mesh=")[1].split(" t")[0]),
            sigterm_rc=b_rc, saved=json.dumps(saved), resumed=json.dumps(resumed),
            resume_mesh=json.dumps(c_lines[0].split("mesh=")[1].split(" t")[0]),
            rc=c.returncode, last_loss_one_process=la, last_loss_resumed=lc,
            rel_diff=f"{rel:.3e}", rtol=TRAIN_CLI_LOSS_RTOL,
            seconds=f"{time.perf_counter() - t0:.3f}")
        check("mesh={'data': 2, 'model': 2}" in b_lines[0]
              and "mesh={'data': 1, 'model': 2}" in c_lines[0] and resumed
              and c_lines[-1] == "done",
              "the 4-rank run printed no 2 x 2 mesh, or the 2-rank rerun did not resume")
        check(rel <= TRAIN_CLI_LOSS_RTOL,
              f"the resumed run's last loss {lc} differs from the one-process {la}")
    finally:
        a.kill()
        a.wait()
        shutil.rmtree(root, ignore_errors=True)


def dryrun_worker() -> int:
    """[dryrun_lm]'s records, in a process of its own on the host's CPU
    (``chip_smoke.py --dryrun-worker``; its fake process groups must not
    meet the card's ranks): run_cell of h2o-danube-1.8b's train, prefill and
    decode cells on a fake 16 x 16 CPU world, run_cell_extrapolated of its
    train cell and of DRYRUN_EXTRA_ARCH's, then the [train_mesh] cell on a
    fake world of MESH_SHAPE's four ranks, its mesh on cuda as the real
    one is (fake tensors: no device memory; DTensor routes some
    redistributions by the mesh's device type). Prints one JSON line."""
    faulthandler.dump_traceback_later(DRYRUN_TIMEOUT_S, exit=True)
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import (fake_world, lower_cell, run_cell,
                                           run_cell_extrapolated)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training import AdamWConfig

    torch.set_num_threads(1)
    out = {"cells": [], "extrapolated": []}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        out["cells"].append(run_cell(TRAIN_ARCH, shape, False, depth=DRYRUN_DEPTH))
    for arch in (TRAIN_ARCH, DRYRUN_EXTRA_ARCH):
        out["extrapolated"].append(run_cell_extrapolated(arch, "train_4k", False))
    t0 = time.perf_counter()
    with fake_world(MESH_SHAPE[0] * MESH_SHAPE[1]):
        mesh = make_test_mesh(*MESH_SHAPE, device_type="cuda")
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_TRAIN_LAYERS)
        cell = build_cell(cfg, "train_4k", mesh,
                          shape=ShapeSpec("train_mesh", TRAIN_T, TRAIN_B, "train"),
                          opt_cfg=AdamWConfig(**TRAIN_OPT))
        out["mesh"] = lower_cell(cell)
    out["mesh"]["seconds"] = time.perf_counter() - t0
    for rec in out["cells"] + out["extrapolated"]:
        if rec.get("status") == "OK":
            rec.pop("traceback", None)
    print(json.dumps(out), flush=True)
    return 0


def dryrun_start():
    """Start [dryrun_lm]'s worker beside the card's phases (it runs on one
    host core); its output goes to build/dryrun_worker.*."""
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-worker"],
                            cwd=ROOT, env=env, stdout=open(work / "dryrun_worker.out", "w"),
                            stderr=open(work / "dryrun_worker.err", "w"))


def dryrun_lm_phase(proc, mesh_comm, card):
    """[dryrun_lm] and [dryrun_vs_mesh]: wait for the worker, then hold its
    records: the cells OK, h2o-danube-1.8b train_4k's argument bytes the
    reference's, its extrapolated FLOPs x 256 within DRYRUN_FLOPS_RTOL of
    ``train_flops``, and the [train_mesh] cell's dry-run collectives equal,
    kind by kind in calls and operand bytes, to what the real warm-up step
    tallied on rank 0."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    finally:
        proc.kill()
    waited = time.perf_counter() - t0
    work = ROOT / "build"
    err = (work / "dryrun_worker.err").read_text()
    lines = [ln for ln in (work / "dryrun_worker.out").read_text().splitlines()
             if ln.startswith("{")]
    if rc != 0 or len(lines) != 1:
        print(f"[dryrun_lm] worker exited {rc}:\n{err[-3000:]}", file=sys.stderr, flush=True)
    check(rc == 0 and len(lines) == 1, f"[dryrun_lm] the worker failed (rc {rc})")
    (work / "dryrun_worker.out").unlink()
    (work / "dryrun_worker.err").unlink()
    out = json.loads(lines[0])
    say("dryrun_lm", card=json.dumps(card), world="fake, 256 ranks (16 x 16) on the host CPU",
        waited_s=f"{waited:.3f}")
    for rec in out["cells"] + out["extrapolated"]:
        coll = rec.get("collectives", {})
        say("dryrun_lm", arch=rec["arch"], shape=rec["shape"], status=rec["status"],
            depth=rec.get("depth", "extrapolated" if rec.get("extrapolated") else None),
            seconds=rec.get("seconds"), argument_bytes=rec.get("memory", {}).get(
                "argument_bytes"), flops_per_device=rec.get("cost", {}).get("flops"),
            bytes_accessed=rec.get("cost", {}).get("bytes accessed"),
            collective_bytes=coll.get("total"), error=json.dumps(rec.get("error")))
        if coll.get("by_site"):
            say("dryrun_lm", arch=rec["arch"], shape=rec["shape"],
                collectives_by_site=json.dumps(coll["by_site"]))
    bad = [(r["arch"], r["shape"], r.get("error")) for r in out["cells"] + out["extrapolated"]
           if r["status"] != "OK"]
    check(not bad, f"[dryrun_lm] cells failed: {bad}")
    train = out["cells"][0]
    check(train["memory"]["argument_bytes"] == DRYRUN_TRAIN_ARGS,
          f"[dryrun_lm] {TRAIN_ARCH} train_4k argument bytes "
          f"{train['memory']['argument_bytes']} != {DRYRUN_TRAIN_ARGS}")
    want = train_flops(get_config(TRAIN_ARCH), 256, 4096)["total"]
    got = out["extrapolated"][0]["cost"]["flops"] * 256
    say("dryrun_lm", check="extrapolated per-device FLOPs x 256 vs train_flops",
        arch=TRAIN_ARCH, dry_run=f"{got:.6e}", analytic=f"{want:.6e}",
        rel_diff=f"{got / want - 1:.4e}", rtol=DRYRUN_FLOPS_RTOL)
    check(abs(got / want - 1) <= DRYRUN_FLOPS_RTOL,
          f"[dryrun_lm] FLOPs {got:.6e} vs analytic {want:.6e}")

    dry = out["mesh"]["collectives"]
    rows = {k: {"dry_calls": dry[f"n_{k}"], "card_calls": mesh_comm[f"n_{k}"],
                "dry_bytes": dry[k], "card_bytes": mesh_comm[k]} for k in DRYRUN_KINDS}
    say("dryrun_vs_mesh", cell=f"{TRAIN_ARCH} {MESH_TRAIN_LAYERS} layers B={TRAIN_B} "
        f"T={TRAIN_T} mesh={MESH_SHAPE}",
        world="fake, 4 ranks, a cuda mesh of fake tensors (host CPU) vs [train_mesh] warm-up "
        "step, rank 0 (card)", seconds=f"{out['mesh']['seconds']:.3f}",
        flops_per_device=out["mesh"]["flops"], kinds=json.dumps(rows))
    say("dryrun_vs_mesh", dry_by_site=json.dumps(dry["by_site"]),
        card_by_site=json.dumps(mesh_comm["by_site"]))
    check(all(r["dry_calls"] == r["card_calls"] and r["dry_bytes"] == r["card_bytes"]
              for r in rows.values()),
          f"[dryrun_vs_mesh] the dry run's collectives differ from the card's: {rows}")


def dryrun_device_phases(torch, dev, n, kernels) -> dict:
    """[dryrun_ann], [dryrun_queue], [dryrun_external] on the card: the
    hillclimb's C0 record (its real reduced shard), the queue's warm-up per
    rung at the script's n, the external-store cell on aio; each path's
    kernel launches (counts 0 before, read after)."""
    from repro_torch.launch.dryrun import run_ann_cell, run_external_store_cell, run_queue_cell

    by_path = {}
    for name, run in (
            ("dryrun_ann", lambda: run_ann_cell(False, tag="C0_baseline", device=dev)),
            ("dryrun_queue", lambda: run_queue_cell(n=n, device=dev)),
            ("dryrun_external", lambda: run_external_store_cell(store="aio", device=dev))):
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        rec = run()
        torch.cuda.synchronize()
        launches = {kern.name: kern.launches for kern in kernels}
        by_path[name] = launches
        rec.pop("rungs", None) if name != "dryrun_external" else None
        if rec["status"] != "OK":
            print(f"[{name}] {rec.get('traceback', '')}", file=sys.stderr, flush=True)
        check(rec["status"] == "OK", f"[{name}] {rec.get('error')}")
        brief = {k: rec[k] for k in ("arch", "shape", "mesh") if k in rec}
        say(name, record=json.dumps(brief), launches=json.dumps(launches),
            seconds=f"{time.perf_counter() - t0:.3f}")
        say(name, fields=json.dumps({k: v for k, v in rec.items()
                                     if k not in brief and k != "traceback"}))
        if name == "dryrun_ann":
            check(rec["result"]["rows"] == 1024 and rec["memory"]["temp_bytes"] is not None,
                  f"[dryrun_ann] {rec['result']} {rec['memory']}")
        elif name == "dryrun_queue":
            check(all(launches[k] > 0 for k in QUERY_KERNELS),
                  f"[dryrun_queue] the warm-ups launched {launches}")
        else:
            check(rec["io"]["counters_agree"] and launches["lsh_hash"] > 0
                  and launches["l2_distance"] > 0,
                  f"[dryrun_external] {rec['io']} {launches}")
    return by_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="database size")
    ap.add_argument("--spill-dir", default=str(ROOT / "build" / "spill"),
                    help="directory on local storage for the spill file (not a "
                         "tmpfs: /tmp may be RAM)")
    ap.add_argument("--rank-worker", dest="rank_worker", default=None,
                    help=argparse.SUPPRESS)   # one rank of [sharded_ranks]
    ap.add_argument("--mesh-worker", dest="mesh_worker", default=None,
                    help=argparse.SUPPRESS)   # one rank of [train_mesh] or [serve_mesh]
    ap.add_argument("--dryrun-worker", dest="dryrun_worker", action="store_true",
                    help=argparse.SUPPRESS)   # [dryrun_lm]'s fake worlds
    args = ap.parse_args(argv)
    if args.dryrun_worker:
        return dryrun_worker()
    if args.rank_worker is not None:
        return rank_worker(json.loads(args.rank_worker))
    if args.mesh_worker is not None:
        return mesh_worker(json.loads(args.mesh_worker))

    # a run that outlives its budget dumps every thread's stack and exits 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
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
    from repro_torch.data import make_dataset
    from repro_torch.kernels import KERNELS, lsh_hash_all_radii, lsh_hash_all_radii_ref
    from repro_torch.kernels.build import build_all, kernel_names, library_path

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
    for kname in kernel_names():
        for e in ptxas_report(library_path(kname).with_suffix(".log").read_text()):
            say("build", kernel=kname, **e)
    # [dryrun_lm]'s fake worlds run on the host beside the card's phases
    dry_proc = dryrun_start()
    atexit.register(dry_proc.kill)

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

    res, times = timed_runs(torch, lambda: engine.query(queries, plan="fused", k=K))
    per_batch = [kern.launches // (REPEATS + 1) for kern in KERNELS]
    res1, times1 = timed_runs(torch, lambda: engine.query(queries[:1], plan="fused", k=K))
    launches = {kern.name: kern.launches for kern in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    check(all(launches[k] > 0 for k in QUERY_KERNELS),
          f"a kernel of the main path never launched: {launches}")
    check(launches["topk_merge"] == launches["bucket_probe"],
          f"the fused plan did not fold each radius by one merge launch: {launches}")
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

    # ---- [serve]: the serving front end over the fused plan -----------------
    t_phase = time.perf_counter()
    serve_phase(torch, engine, ds.queries, ds.gt_dists, KERNELS)
    say("serve", seconds=f"{time.perf_counter() - t_phase:.3f}")

    # ---- [exact]: the exact k-NN baseline's path ----------------------------
    t_phase = time.perf_counter()
    exact_launches, exact_dists = exact_phase(torch, ix, queries, ds, res, KERNELS)
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
        t_phase = time.perf_counter()
        external_serve_phase(torch, dev, path, ds.queries, KERNELS)
        say("serve", plan="external", seconds=f"{time.perf_counter() - t_phase:.3f}")
    finally:
        path.unlink(missing_ok=True)
    del sp_idx, sp_engine
    t_phase = time.perf_counter()

    # ---- each kernel against its plain version at its path's shapes
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    record = []
    one = torch.zeros(1, device=dev)
    say("timing", method="median of 30, CUDA events, L2 flushed before each call",
        floor_one_element_add_ms=f"{median_ms(torch, lambda: one.add_(1), flush=flush):.4f}")

    # lsh_hash: the batch's Step 1 (hashes and table entries) as the plans run it
    record.append(hash_kernel_phase(torch, dev, ix, queries, hkw, launches, flush))

    # the fused probe (bucket_probe.cu), the distance epilogue
    # (l2_distance.cu) and the fold (topk_merge.cu) at radius 0 of the batch,
    # as the fused plan calls them
    record += probe_kernel_phases(torch, dev, ix, queries, cfg, launches, flush)

    # l2_distance (dense): one block of the exact scan
    worst, t_k, t_p, t_l, b_ms, b_by = dense_kernel_phase(torch, dev, flush)
    record.append(dict(name="l2_distance_dense", route="cuda",
                       source="src/repro_torch/csrc/l2_distance_dense.cu",
                       replaces="src/repro/kernels/l2_distance/kernel.py:31",
                       launches=exact_launches["l2_distance_dense"], max_abs_err=worst,
                       ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l))
    say("kernels", seconds=f"{time.perf_counter() - t_phase:.3f}")

    # ---- the sharded plan and the small-index baselines, after the main
    # index is dropped (the sharded index holds as many bytes again)
    e2lsh_bytes = dict(device=ix.nbytes(), storage=idx.index.stats.index_storage_bytes)
    del idx, engine, ix, flush, res, res1, oracle
    torch.cuda.empty_cache()
    by_path = dict(fused=launches, exact=exact_launches)
    t_phase = time.perf_counter()
    by_path["sharded"], by_path["sharded_queue"], one4 = sharded_phase(
        torch, dev, ds, queries, exact_dists, KERNELS)
    torch.cuda.empty_cache()
    say("sharded", seconds=f"{time.perf_counter() - t_phase:.3f}")
    t_phase = time.perf_counter()
    by_path["sharded_ranks"] = sharded_ranks_phase(torch, dev, ds, queries, one4, KERNELS)
    torch.cuda.empty_cache()
    say("sharded_ranks", seconds=f"{time.perf_counter() - t_phase:.3f}")
    t_phase = time.perf_counter()
    by_path["srs"] = srs_phase(torch, dev, ds, queries, exact_dists, e2lsh_bytes, KERNELS)
    torch.cuda.empty_cache()
    say("srs", seconds=f"{time.perf_counter() - t_phase:.3f}")
    t_phase = time.perf_counter()
    qalsh_phase(torch, dev, ds, queries, exact_dists, KERNELS)
    say("qalsh", seconds=f"{time.perf_counter() - t_phase:.3f}")
    torch.cuda.empty_cache()

    # ---- [dryrun_ann], [dryrun_queue], [dryrun_external]: the dry run's
    # device cells on the card --------------------------------------------
    t_phase = time.perf_counter()
    by_path.update(dryrun_device_phases(torch, dev, args.n, KERNELS))
    torch.cuda.empty_cache()
    say("dryrun_device", seconds=f"{time.perf_counter() - t_phase:.3f}")

    # ---- [lm] and [lm_reduced]: LM serving with the retrieval hook ----------
    t_phase = time.perf_counter()
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    by_path["lm"], lm_errs = lm_phase(torch, dev, KERNELS, flush)
    del flush
    torch.cuda.empty_cache()
    say("lm", seconds=f"{time.perf_counter() - t_phase:.3f}")
    t_phase = time.perf_counter()
    lm_reduced_phase(torch, dev)
    say("lm_reduced", seconds=f"{time.perf_counter() - t_phase:.3f}")
    torch.cuda.empty_cache()

    # ---- [train], [train_reduced], [train_dp]: LM training on the card ------
    t_phase = time.perf_counter()
    train_phase(torch, dev, KERNELS)
    train_fp32_check(torch, dev)
    say("train", seconds=f"{time.perf_counter() - t_phase:.3f}")
    t_phase = time.perf_counter()
    train_reduced_phase(torch, dev)
    say("train_reduced", seconds=f"{time.perf_counter() - t_phase:.3f}")
    t_phase = time.perf_counter()
    train_dp_phase(torch, dev)
    say("train_dp", seconds=f"{time.perf_counter() - t_phase:.3f}")
    torch.cuda.empty_cache()

    # ---- [train_mesh], [serve_mesh], [train_mesh_cli]: the LM steps over a
    # (data, model) DeviceMesh of four ranks sharing the card ---------------
    mesh_comm = mesh_phases(smi.stdout.strip().splitlines()[0])

    # ---- [dryrun_lm], [dryrun_vs_mesh]: the worker's fake worlds ----------
    t_phase = time.perf_counter()
    dryrun_lm_phase(dry_proc, mesh_comm, smi.stdout.strip().splitlines()[0])
    say("dryrun_lm", phase_seconds=f"{time.perf_counter() - t_phase:.3f}")
    kernel_of = dict(lsh_hash="lsh_hash", bucket_probe="bucket_probe",
                     l2_distance_gathered="l2_distance", l2_distance_dense="l2_distance_dense",
                     topk_merge="topk_merge")
    for rec in record:
        kernel = kernel_of[rec["name"]]
        rec["launches_by_path"] = {path: counts[kernel] for path, counts in by_path.items()
                                   if counts.get(kernel)}
        # the largest error over every shape checked, the [lm] hook's included
        rec["max_abs_err"] = max(rec["max_abs_err"], lm_errs.get(rec["name"], 0))

    # ---- [serve_cli]: the ANN entry point in a process of its own -----------
    t_phase = time.perf_counter()
    serve_cli_phase()
    say("serve_cli", phase_seconds=f"{time.perf_counter() - t_phase:.3f}")

    # ---- [sharded_cli]: the multi-rank ANN entry point, two ranks -----------
    t_phase = time.perf_counter()
    sharded_cli_phase()
    say("sharded_cli", phase_seconds=f"{time.perf_counter() - t_phase:.3f}")

    # ---- [lm_cli]: the LM entry point in a process of its own ---------------
    t_phase = time.perf_counter()
    lm_cli_phase()
    say("lm_cli", phase_seconds=f"{time.perf_counter() - t_phase:.3f}")

    # ---- [train_cli]: the training entry point in processes of its own ------
    t_phase = time.perf_counter()
    train_cli_phase()
    say("train_cli", phase_seconds=f"{time.perf_counter() - t_phase:.3f}")

    say("total", seconds=f"{time.perf_counter() - t_start:.3f}")
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
