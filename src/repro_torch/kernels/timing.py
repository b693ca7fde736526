"""Time the kernel wrappers of one checkout of the port on one GPU.

    python3 src/repro_torch/kernels/timing.py [--src DIR]

Imports ``repro_torch`` from DIR (default: the ``src`` directory this file
lies in), builds its kernels, and at each kernel's shape on the main path
(inputs made on the card from seed 0) holds the wrapper to its plain version
and times it: median of 30 calls by CUDA events, L2 flushed before each, as
``chip_smoke.py`` times. Prints the card's name and power limit, then one
JSON line per kernel and shape, labelled with DIR; exits 1 if a wrapper
disagrees or launched no kernel. It uses only the wrappers' public
signatures, so two checkouts (a parent and its change) are compared in one
call on one card, in turns, one process each:

    for s in parent/src src src parent/src; do
        python3 src/repro_torch/kernels/timing.py --src $s; done

A wrapper that takes the index's hash pack (``pack=``) is timed with one
built beforehand, as the plans call it.

Shapes, those of the SIFT1M configuration in ``chip_smoke.py``:
``lsh_hash`` with r = 7, L = 32, m = 23, D = 128 (u = 18, fp_bits = 14,
radii 1..64) at Q = 256 and 2; ``probe_append`` at radius 0 (Q = 256,
L = 32, two chain steps of 99 objects, S = 64) over synthetic block rows,
19,158,070 of 104 lanes; ``l2_distance_by_id`` over the buffer it fills,
ids into 10^6 rows of D = 128; ``topk_merge`` folding that buffer and its
distances into a batch's state (k = 10; no row gets within radius 0's
threshold, so every call merges every row, as the first radius does);
dense ``l2_distance`` at the exact scan's block, 256 x 16,384. A case
whose wrapper the checkout lacks is skipped.

The ``hash_stage`` cases time ``core.query.hash_stage`` (Step 1 of every
plan: the hashes of the whole schedule and each bucket's table entries) in
any checkout that has it with the signature ``(ix, queries, cfg)``, over a
synthetic index of the hash family and the two tables [r, L, 2^u]: at
Q = 256 on the SIFT1M family (m = 23, u = 18, fp_bits = 14) and at
Q = 65,536 on the BIGANN-10M shard's (m = 27, u = 20, fp_bits = 12), r = 7,
L = 32, D = 128. They print, beside the device span, the median host time
of one call (``host_us``: the call alone, the card idle before it) and the
device events one call runs. They are held to ``table_lookup`` over the
plain hashes on every hash clear of a floor() boundary. The ``lsh_hash`` and
``hash_stage`` lines carry ``digest``, a SHA-256 of the outputs (bucket and
fp, or cnt, head and fp, as [r, Q, L] int32): inputs come from fixed seeds,
so two checkouts whose digests match compute the same values bit for bit.

The ``stage`` case times ``core.query._probe_radius_fused``, one radius of
the fused plan, on the same inputs in any checkout that has that function
with the signature ``(ix, queries, qnorm2, cnt, head, qfp, cfg, active_q)``:
its median device span by CUDA events as above, its median wall time on the
host clock (call to ``synchronize``, no flush: the eager dispatch of its
operations counts), and the device events one call runs, with their summed
device time, from ``torch.profiler``. Its outputs are held to the same call
on the CPU (the checkout's plain path) over a compact copy of the rows the
call can read, output by output (a dict of outputs key by key).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time
import types

TOL = 2e-4      # the reference's kernel tolerance (tests/test_kernels.py)
MARGIN = 1e-4   # hashes this far from a floor() boundary must agree


def median_ms(torch, fn, flush, iters=30, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def wall_ms(torch, fn, iters=30, warmup=3):
    """Median host time of fn() through its device work (synchronized)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def host_us(torch, fn, iters=30, warmup=3):
    """Median host time of fn() alone, in microseconds: the card is idle
    before each call, and the time stops when fn returns (its launches
    queued, not run)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def digest(torch, *outs) -> str:
    """SHA-256 of int32 outputs laid out contiguous, in order."""
    h = hashlib.sha256()
    for o in outs:
        h.update(o.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def device_events(torch, fn):
    """(events, busy ms) on the device for one call of fn, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def probe_inputs(torch, gen, dev):
    """Radius 0 of the SIFT1M batch on synthetic block rows: every query
    active, bucket sizes 0..198 (chains of up to two 99-object chunks),
    fingerprints in [0, 64) on rows and queries, so a step of 32 rows holds
    ~37 matches and the budget S = 64 runs out in step 1 for most queries."""
    Q, L, C, BLK, NB, BLKp, N, D = 256, 32, 2, 99, 19_158_070, 104, 1_000_000, 128
    ids = torch.randint(0, N, (NB, BLKp), generator=gen, device=dev, dtype=torch.int32)
    fps = torch.randint(0, 64, (NB, BLKp), generator=gen, device=dev, dtype=torch.int32)
    ids[:, BLK:] = 2**31 - 1
    fps[:, BLK:] = -1
    ids[0], fps[0] = 2**31 - 1, -1
    cnt = torch.randint(0, C * BLK + 1, (Q, L), generator=gen, device=dev, dtype=torch.int32)
    head = torch.randint(1, NB - C, (Q, L), generator=gen, device=dev, dtype=torch.int32)
    qfp = torch.randint(0, 64, (Q, L), generator=gen, device=dev, dtype=torch.int32)
    db = torch.randn((N, D), generator=gen, device=dev)
    q = torch.randn((Q, D), generator=gen, device=dev)
    return dict(Q=Q, L=L, C=C, BLK=BLK, NB=NB, BLKp=BLKp, N=N, D=D, ids=ids, fps=fps,
                cnt=cnt, head=head, qfp=qfp, active=torch.ones(Q, dtype=torch.bool, device=dev),
                db=db, db_norm2=(db * db).sum(-1), q=q, qn2=(q * q).sum(-1))


def cases(torch, K, dev):
    """(kernel, libraries, shape, call, check) per timed case; check()
    returns the largest error, or a dict of fields (max_abs_err among them),
    and raises AssertionError on a disagreement.
    ``libraries`` are the kernel libraries the call must launch."""
    from repro_torch.kernels.lsh_hash.ops import hash_pack
    from repro_torch.kernels.lsh_hash.ref import floor_margin
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, L, m, D = 7, 32, 23, 128
    a, b = randn(r, L, m, D), torch.rand((r, L, m), generator=gen, device=dev)
    rm = torch.randint(-2**31, 2**31 - 1, (r, L, m), generator=gen, device=dev,
                       dtype=torch.int32) | 1
    hkw = dict(w=4.0, radii=tuple(2.0 ** t for t in range(r)), u=18, fp_bits=14)
    pack = hash_pack(a, b, rm, w=hkw["w"], radii=hkw["radii"])
    for n in (256, 2):
        x = randn(n, D) * 3

        def check_hash(x=x):
            bk, fp = K.lsh_hash_all_radii(x, a, b, rm, **hkw, pack=pack)
            bk_p, fp_p = K.lsh_hash_all_radii_ref(x, a, b, rm, **hkw)
            safe = floor_margin(x, a, b, w=hkw["w"], radii=hkw["radii"]) > MARGIN
            bad = int((safe & ((bk != bk_p) | (fp != fp_p))).sum())
            assert bad == 0, f"{bad} hashes clear of a boundary disagree"
            return dict(max_abs_err=0.0, digest=digest(torch, bk, fp))
        yield ("lsh_hash", ("lsh_hash",), dict(Q=n, r=r, L=L, m=m, D=D),
               lambda x=x: K.lsh_hash_all_radii(x, a, b, rm, **hkw, pack=pack), check_hash)

    yield from hash_stage_cases(torch, K, dev)

    P = probe_inputs(torch, gen, dev)
    pargs = (P["cnt"], P["head"], P["qfp"], P["active"], P["ids"], P["fps"])
    pkw = dict(block_objs=P["BLK"], max_chain=P["C"], S=64, sbuf=64)
    pshape = dict(Q=P["Q"], L=P["L"], C=P["C"], S=64, BLKp=P["BLKp"], NB=P["NB"])
    if hasattr(K, "probe_append"):
        def check_probe():
            got, want = K.probe_append(*pargs, **pkw), K.probe_append_ref(*pargs, **pkw)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            return 0.0
        yield ("probe_append", ("bucket_probe",), pshape,
               lambda: K.probe_append(*pargs, **pkw), check_probe)

    if hasattr(K, "l2_distance_by_id"):
        buf = K.probe_append_ref(*pargs, **pkw)[0]
        dargs = (P["q"], buf, P["db"], P["db_norm2"], P["qn2"])

        def check_by_id():
            got, want = K.l2_distance_by_id(*dargs), K.l2_distance_by_id_ref(*dargs)
            assert torch.equal(torch.isinf(got), torch.isinf(want))
            assert torch.allclose(got, want, rtol=TOL, atol=TOL)
            return float((got - want).abs().nan_to_num(posinf=0.0).max())
        yield ("l2_distance_by_id", ("l2_distance",),
               dict(Q=P["Q"], sbuf=64, D=P["D"], N=P["N"],
                    valid=int((buf != 2**31 - 1).sum())),
               lambda: K.l2_distance_by_id(*dargs), check_by_id)

    if hasattr(K, "topk_merge"):
        buf = K.probe_append_ref(*pargs, **pkw)[0]
        d2 = K.l2_distance_by_id_ref(P["q"], buf, P["db"], P["db_norm2"], P["qn2"])
        Q, k = P["Q"], 10
        i32 = dict(dtype=torch.int32, device=dev)
        state = (torch.full((Q, k), 2**31 - 1, **i32),
                 torch.full((Q, k), float("inf"), device=dev),
                 torch.zeros(Q, dtype=torch.bool, device=dev),
                 *(torch.zeros(Q, **i32) for _ in range(4)), torch.zeros(0, **i32))
        counts = P["cnt"].clamp(max=64).sum(1, dtype=torch.int32)
        margs = (buf, d2, P["cnt"], counts, counts)
        mkw = dict(t=0, thresh2=4.0)    # (c R_0)^2 at c = 2: no row is within it

        def check_merge():
            want = K.topk_merge_ref(state, *margs, **mkw)
            got = K.topk_merge(tuple(x.clone() for x in state), *margs, **mkw)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), "states differ"
            assert not bool(got[2].any()), "a row got done: the timed calls would skip it"
            return 0.0
        yield ("topk_merge", ("topk_merge",), dict(Q=Q, k=k, sbuf=64, L=P["L"]),
               lambda: K.topk_merge(state, *margs, **mkw), check_merge)

    q, xs = randn(256, D), randn(16384, D)

    def check_dense():
        got, want = K.l2_distance(q, xs), K.l2_distance_ref(q, xs)
        assert torch.allclose(got, want, rtol=TOL, atol=TOL)
        return float((got - want).abs().max())
    yield ("l2_distance_dense", ("l2_distance_dense",), dict(NQ=256, NC=16384, D=D),
           lambda: K.l2_distance(q, xs), check_dense)

    yield stage_case(torch, P, pshape)


class _Index:
    """The fields of an index that the hash stage reads (weakly referable,
    as the hash-pack cache needs)."""


def hash_stage_cases(torch, K, dev):
    """``core.query.hash_stage`` at the batch cell's Q and the sharded cell's."""
    from repro_torch.core import query as tq
    from repro_torch.kernels.lsh_hash.ref import floor_margin
    if not hasattr(tq, "hash_stage"):
        return
    r, L, D = 7, 32, 128
    for Q, m, u, fp_bits in ((256, 23, 18, 14), (65_536, 27, 20, 12)):
        gen = torch.Generator(device=dev).manual_seed(Q + m)
        ix = _Index()
        ix.a = torch.randn((r, L, m, D), generator=gen, device=dev)
        ix.b = torch.rand((r, L, m), generator=gen, device=dev)
        ix.rm = torch.randint(-2**31, 2**31 - 1, (r, L, m), generator=gen, device=dev,
                              dtype=torch.int32) | 1
        ix.table_cnt = torch.randint(0, 200, (r, L, 1 << u), generator=gen, device=dev,
                                     dtype=torch.int32)
        ix.blocks_head = torch.randint(1, 2**31 - 1, (r, L, 1 << u), generator=gen,
                                       device=dev, dtype=torch.int32)
        ix.blocks_head[ix.table_cnt == 0] = -1
        cfg = tq.QueryConfig(L=L, m=m, u=u, fp_bits=fp_bits, w=4.0, c=2.0,
                             radii=tuple(2.0 ** t for t in range(r)), S=64, block_objs=99,
                             k=10)
        x = torch.randn((Q, D), generator=gen, device=dev) * 3

        def check(ix=ix, cfg=cfg, x=x):
            cnt, head, fp = tq.hash_stage(ix, x, cfg)
            bk_p, fp_p = K.lsh_hash_all_radii_ref(x, ix.a, ix.b, ix.rm, w=cfg.w,
                                                  radii=cfg.radii, u=cfg.u,
                                                  fp_bits=cfg.fp_bits)
            cnt_p, head_p = tq.table_lookup(ix, bk_p, cfg)
            safe = floor_margin(x, ix.a, ix.b, w=cfg.w, radii=cfg.radii) > MARGIN
            bad = int((safe & ((cnt != cnt_p) | (head != head_p) | (fp != fp_p))).sum())
            assert bad == 0, f"{bad} lookups clear of a boundary disagree"
            return dict(max_abs_err=0.0, digest=digest(torch, cnt, head, fp))
        yield ("hash_stage", ("lsh_hash",),
               dict(Q=Q, r=r, L=L, m=m, D=D, u=u, fn="core.query.hash_stage"),
               lambda ix=ix, cfg=cfg, x=x: tq.hash_stage(ix, x, cfg), check)


def stage_case(torch, P, pshape):
    """One radius of the fused plan, ``core.query._probe_radius_fused``."""
    from repro_torch.core import query as tq
    cfg = tq.QueryConfig(L=P["L"], m=23, u=18, fp_bits=14, w=4.0, c=2.0,
                         radii=tuple(2.0 ** t for t in range(7)), S=64,
                         block_objs=P["BLK"], k=10, max_chain=P["C"])
    ix = types.SimpleNamespace(ids_blocks=P["ids"], fps_blocks=P["fps"], db=P["db"],
                               db_norm2=P["db_norm2"])
    args = (P["q"], P["qn2"], P["cnt"], P["head"], P["qfp"], cfg, P["active"])

    def call():
        return tq._probe_radius_fused(ix, *args)

    def check_stage():
        # the rows the call can read, compacted: row 1 + C*(q*L + l) + c is
        # row head[q, l] + c; row 0 stays the empty spare
        Q, L, C = P["Q"], P["L"], P["C"]
        rows = (P["head"][:, :, None] + torch.arange(C, device=P["head"].device)).reshape(-1)
        ids = torch.cat([P["ids"][:1], P["ids"][rows.long()]]).cpu()
        fps = torch.cat([P["fps"][:1], P["fps"][rows.long()]]).cpu()
        head = (1 + C * torch.arange(Q * L, dtype=torch.int32)).view(Q, L)
        ix_cpu = types.SimpleNamespace(ids_blocks=ids, fps_blocks=fps, db=P["db"].cpu(),
                                       db_norm2=P["db_norm2"].cpu())
        want = tq._probe_radius_fused(ix_cpu, P["q"].cpu(), P["qn2"].cpu(), P["cnt"].cpu(),
                                      head, P["qfp"].cpu(), cfg, P["active"].cpu())
        got = call()
        assert len(got) == len(want), "outputs differ in number"
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 1:
                continue
            if isinstance(w, dict):
                assert g.keys() == w.keys(), "stats differ"
                assert all(torch.equal(g[k].cpu(), w[k]) for k in w), "stats differ"
            else:
                assert torch.equal(g.cpu(), w), f"output {i} differs"
        d2, want_d2 = got[1].cpu(), want[1]
        assert torch.equal(torch.isinf(d2), torch.isinf(want_d2))
        assert torch.allclose(d2, want_d2, rtol=TOL, atol=TOL)
        return float((d2 - want_d2).abs().nan_to_num(posinf=0.0).max())
    return ("stage", ("bucket_probe", "l2_distance"),
            dict(pshape, fn="core.query._probe_radius_fused", radius=0), call, check_stage)


def main(argv=None) -> int:
    here = pathlib.Path(__file__).resolve()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(here.parents[2]),
                    help="the src directory of the checkout to time")
    args = ap.parse_args(argv)
    src = pathlib.Path(args.src).resolve()
    sys.path[0] = str(src)   # repro_torch from --src, not from this file's directory
    import torch
    if not torch.cuda.is_available():
        print("timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.kernels as K
    from repro_torch.kernels.build import build_all
    if pathlib.Path(K.__file__).resolve().parents[1] != src / "repro_torch":
        print(f"timing: imported {K.__file__}, not the package under {src}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none")
    build_all()
    dev = torch.device("cuda")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    ok = True
    launchers = {k.name: k for k in K.KERNELS}
    for kernel, libs, shape, call, check in cases(torch, K, dev):
        before = [launchers[n].launches for n in libs]
        try:
            checked = check()
            torch.cuda.synchronize()
            assert all(launchers[n].launches > b for n, b in zip(libs, before)), \
                f"no launch of {libs}"
        except AssertionError as e:
            print(f"timing: {kernel} {shape}: {e}", file=sys.stderr)
            ok = False
            continue
        out = dict(src=args.src, kernel=kernel, shape=shape,
                   ms=median_ms(torch, call, flush))
        out.update(checked if isinstance(checked, dict) else dict(max_abs_err=checked))
        if kernel in ("lsh_hash", "hash_stage"):
            out["host_us"] = host_us(torch, call)
        if kernel in ("stage", "hash_stage"):
            out["wall_ms"] = wall_ms(torch, call)
            out["device_events"], out["device_busy_ms"] = device_events(torch, call)
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
