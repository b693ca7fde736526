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
radii 1..64) at Q = 256 and 2; ``bucket_probe`` over 16,384 chain rows of
104 lanes out of 19,158,070; ``l2_distance_gathered`` at Q = 256, S = 64;
dense ``l2_distance`` at the exact scan's block, 256 x 16,384.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import statistics
import subprocess
import sys

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


def cases(torch, K, dev):
    """(kernel, shape, call, check) per timed case; check() returns the
    largest error and raises AssertionError on a disagreement."""
    from repro_torch.kernels.lsh_hash.ref import floor_margin
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, L, m, D = 7, 32, 23, 128
    a, b = randn(r, L, m, D), torch.rand((r, L, m), generator=gen, device=dev)
    rm = torch.randint(-2**31, 2**31 - 1, (r, L, m), generator=gen, device=dev,
                       dtype=torch.int32) | 1
    hkw = dict(w=4.0, radii=tuple(2.0 ** t for t in range(r)), u=18, fp_bits=14)
    if "pack" in inspect.signature(K.lsh_hash_all_radii).parameters:
        from repro_torch.kernels.lsh_hash.ops import hash_pack
        hkw_k = dict(hkw, pack=hash_pack(a, b, rm, w=hkw["w"], radii=hkw["radii"]))
    else:
        hkw_k = hkw
    for n in (256, 2):
        x = randn(n, D) * 3

        def check_hash(x=x):
            bk, fp = K.lsh_hash_all_radii(x, a, b, rm, **hkw_k)
            bk_p, fp_p = K.lsh_hash_all_radii_ref(x, a, b, rm, **hkw)
            safe = floor_margin(x, a, b, w=hkw["w"], radii=hkw["radii"]) > MARGIN
            bad = int((safe & ((bk != bk_p) | (fp != fp_p))).sum())
            assert bad == 0, f"{bad} hashes clear of a boundary disagree"
            return 0.0
        yield ("lsh_hash", dict(Q=n, r=r, L=L, m=m, D=D),
               lambda x=x: K.lsh_hash_all_radii(x, a, b, rm, **hkw_k), check_hash)

    G, NB, BLKp = 16384, 19_158_070, 104
    ids = torch.randint(0, 1_000_000, (NB, BLKp), generator=gen, device=dev,
                        dtype=torch.int32)
    fps = torch.randint(0, 1 << 14, (NB, BLKp), generator=gen, device=dev, dtype=torch.int32)
    rows = torch.randint(1, NB, (G,), generator=gen, device=dev, dtype=torch.int32)
    qfp = torch.randint(0, 1 << 14, (G,), generator=gen, device=dev, dtype=torch.int32)

    def check_probe():
        got = K.bucket_probe(rows, qfp, ids, fps)
        assert torch.equal(got, K.bucket_probe_ref(rows, qfp, ids, fps))
        return 0.0
    yield ("bucket_probe", dict(G=G, BLKp=BLKp, NB=NB),
           lambda: K.bucket_probe(rows, qfp, ids, fps), check_probe)

    Q, S = 256, 64
    q, coords = randn(Q, D), randn(Q, S, D)
    xn2, qn2 = (coords * coords).sum(-1), (q * q).sum(-1)

    def check_gathered():
        got = K.l2_distance_gathered(q, coords, xn2, qn2)
        want = K.l2_distance_gathered_ref(q, coords, xn2, qn2)
        assert torch.allclose(got, want, rtol=TOL, atol=TOL)
        return float((got - want).abs().max())
    yield ("l2_distance_gathered", dict(Q=Q, S=S, D=D),
           lambda: K.l2_distance_gathered(q, coords, xn2, qn2), check_gathered)

    NC = 16384
    xs = randn(NC, D)

    def check_dense():
        got, want = K.l2_distance(q, xs), K.l2_distance_ref(q, xs)
        assert torch.allclose(got, want, rtol=TOL, atol=TOL)
        return float((got - want).abs().max())
    yield ("l2_distance_dense", dict(NQ=Q, NC=NC, D=D),
           lambda: K.l2_distance(q, xs), check_dense)


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
    for kernel, shape, call, check in cases(torch, K, dev):
        counter = launchers["l2_distance" if kernel == "l2_distance_gathered" else kernel]
        before = counter.launches
        try:
            err = check()
            torch.cuda.synchronize()
            assert counter.launches > before, "no kernel launched"
        except AssertionError as e:
            print(f"timing: {kernel} {shape}: {e}", file=sys.stderr)
            ok = False
            continue
        print(json.dumps(dict(src=args.src, kernel=kernel, shape=shape,
                              ms=median_ms(torch, call, flush), max_abs_err=err)),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
