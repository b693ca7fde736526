"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference, beside its limit. The same numbers close standard error.

It needs as many CUDA devices as the cell asks for, and the program beside
it (``src/repro_torch``); without either it exits with code 2 and prints
no result. It exits with code 3, and prints no result, if JAX or the JAX
package was loaded by the time the window closed. A cell of more than one
chip runs one process a card (``portbench/ranks.py``); if a rank fails, the
command exits with its code and prints no result.
"""
from __future__ import annotations

import os
import pathlib
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()
ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the JAX
    package's, compared whole: ``repro_torch`` is the program, ``repro`` is
    not."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the program is not here: {ROOT / 'src' / 'repro_torch'} is missing",
              file=sys.stderr)
        return 2
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.pop("REPRO_STORE_BACKEND", None)   # the configuration names the store

    import torch

    from portbench.harness import load_cell, run_cell

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {have} available",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        from portbench.ranks import launch
        rc, out = launch(ROOT, args.workload, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), chips=cell.chips, device="cuda",
                         t_start=T_START)
        if rc:
            return rc
    else:
        out = run_cell(ROOT, args.workload, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded by the time the window closed: {bad}", file=sys.stderr)
        return 3
    out["device"]["power_limit"] = _power_limit()
    for name, c in out["checks"].items():
        print(f"check {name}={c['value']!r} limit={c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def _power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("" where it cannot)."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


if __name__ == "__main__":
    sys.exit(main())
