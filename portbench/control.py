"""The control of the check that decides ``correct``: the plain reference
put in the program's place and computed one precision below the float32
the configurations state (TF32 operands in the query's projections and the
candidate distances), judged by the same comparison. It has to come out
as not correct; its readings are the upper ends the limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed with the readings beside the limits. The
control answers the rows a run of the cell checks (``check_rows`` pool
rows); an answer of this
algorithm depends on its query alone, so no window is needed to produce
them. The benchmark's own runs never run it.
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch

if __package__ in (None, ""):
    _ROOT = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT / "src"), str(_ROOT)]

from portbench.compare import Answers, judge
from portbench.data import DataSpec, make_dataset
from portbench.harness import _limits, load_cell
from portbench.reference import Reference, RefParams, family_from_seed

__all__ = ["control_readings"]


def control_readings(root, workload: str, seed: int, device) -> dict:
    """(readings, limits) of the control on one seed."""
    cell = load_cell(root, workload)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    pool_n = int(tr["batch"]) * int(tr["pool_batches"])
    data = make_dataset(DataSpec.from_config(cfg), pool_n, int(seed), dev)
    p = RefParams.from_config(cfg)
    family = family_from_seed(int(seed) % (2**31 - 1), p)
    q = data.queries[:min(int(tr["check_rows"]), pool_n)]
    truth = Reference(data.db, family, p)
    control = Reference(data.db, family, p, precision="tf32")
    want = truth.answer(q)
    got = control.answer(q).cpu()
    answers = Answers(ids=got.ids.numpy(), dists=torch.sqrt(got.d2).float().numpy(),
                      found=got.found.numpy(), radii_searched=got.radii_searched.numpy(),
                      nio_table=got.nio_table.numpy(), nio_blocks=got.nio_blocks.numpy(),
                      cands_checked=got.cands_checked.numpy())
    reading = judge(answers, want, q, truth)
    return reading, _limits(cell)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="the control of the benchmark's check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[1]
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        reading, limits = control_readings(root, args.workload, seed, "cuda")
        fails = [k for k in ("rows_off", "dist_err") if not reading[k] <= limits[k]]
        print(json.dumps(dict(workload=args.workload, seed=seed, **reading,
                              limits={k: limits[k] for k in ("rows_off", "dist_err")},
                              control_fails=fails)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
