"""Perf hillclimb driver: the dry run's three selected cells again with one
lever flipped at a time, recording hypothesis -> change -> before -> after
(the port of ``repro.launch.hillclimb``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --out build/hillclimb.jsonl
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell C --device cpu

Cells (the reference's, in its order and with its tags):
  A. command-r-plus-104b train_4k  — largest model, largest collective term
  B. mixtral-8x22b prefill_32k     — the collective-dominated cell
  C. e2lshos-bigann1b ann          — the paper's own workload (memory-bound)

A and B are depth-extrapolated records on a fake 16 x 16 world
(``dryrun.run_cell_extrapolated``); C is ``dryrun.run_ann_cell``, whose
real shard runs on ``--device`` (cuda by default). The reference's third
lever of A, explicit out-shardings, pins the jitted step's outputs to its
input shardings. The port's steps update their state in place, so the
outputs already keep the input placements: A2 runs A0's cell and A3 A1's
levers with ``remat="dots"``, each record saying that lever has no
counterpart.
"""
from __future__ import annotations

import argparse
import json

from .dryrun import run_ann_cell, run_cell_extrapolated

NO_OUT_SHARDINGS = ("explicit out-shardings: no counterpart (the port's train step updates "
                    "its state in place, on the input placements)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="hillclimb.jsonl")
    ap.add_argument("--cell", default="all", choices=("A", "B", "C", "all"))
    ap.add_argument("--device", default=None,
                    help="device of cell C's real shard (default cuda)")
    args = ap.parse_args(argv)

    def emit(rec, note=None):
        if note:
            rec["note"] = note
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        brief = {k: rec.get(k) for k in ("arch", "shape", "tag", "status", "seconds")}
        if rec.get("status") == "OK":
            brief["flops"] = rec.get("cost", {}).get("flops")
            brief["bytes"] = rec.get("cost", {}).get("bytes accessed")
            brief["coll"] = rec.get("collectives", {}).get("total")
            brief["analytic_bytes"] = rec.get("analytic_bytes_per_chip")
        else:
            brief["error"] = rec.get("error")
        print(json.dumps(brief), flush=True)

    if args.cell in ("A", "all"):
        a = ("command-r-plus-104b", "train_4k", False)
        emit(run_cell_extrapolated(*a, tag="A0_baseline"))
        emit(run_cell_extrapolated(*a, cfg_overrides=dict(bf16_compute_weights=True),
                                   tag="A1_bf16_gathers"))
        emit(run_cell_extrapolated(*a, tag="A2_out_shardings"), NO_OUT_SHARDINGS)
        emit(run_cell_extrapolated(*a, cfg_overrides=dict(bf16_compute_weights=True,
                                                          remat="dots"),
                                   tag="A3_bf16+dots+outsh"), NO_OUT_SHARDINGS)

    if args.cell in ("B", "all"):
        b = ("mixtral-8x22b", "prefill_32k", False)
        emit(run_cell_extrapolated(*b, tag="B0_baseline"))
        emit(run_cell_extrapolated(*b, cfg_overrides=dict(moe_shard_capacity=True),
                                   tag="B1_shard_capacity"))
        emit(run_cell_extrapolated(*b, cfg_overrides=dict(moe_shard_capacity=True,
                                                          bf16_compute_weights=True),
                                   tag="B2_cap+bf16"))

    if args.cell in ("C", "all"):
        emit(run_ann_cell(False, tag="C0_baseline", device=args.device))
        emit(run_ann_cell(False, db_dtype="uint8", tag="C1_uint8_db", device=args.device))
        emit(run_ann_cell(False, db_dtype="uint8", s_cap_per_shard=16,
                          tag="C2_uint8+scap16", device=args.device))


if __name__ == "__main__":
    main()
