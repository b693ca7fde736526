"""Training launcher: the end-to-end entry point with fault tolerance (the
port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --reduced \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Features exercised here:
  * mesh-agnostic sharding: under ``torch.distributed.run`` the ranks form a
    (data, model) mesh (``launch.mesh.available_mesh``), the train state and
    each batch are DTensors placed by the logical-axis specs, and the step
    runs with the shard hints active; without a process group the mesh is
    1 x 1 and the step runs on plain tensors,
  * checkpoint/restart: auto-resume from the latest checkpoint, atomic saves,
    SIGTERM (preemption) triggers a final save before exit,
  * data-pipeline state restored with the model (no sample skew on restart),
  * microbatch gradient accumulation,
  * per-step wall-clock watchdog (straggler surfacing: slow steps are logged
    with their percentile against the running distribution).

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m repro_torch.launch.train --arch h2o-danube-1.8b --reduced --device cpu

Runs on the CUDA device unless ``--device cpu`` is given; without a card and
without that flag it raises instead of carrying on on the host. Its first
line names the device (on the card: its name and power limit) and the mesh,
as the reference prints it. Across ranks only rank 0 logs; on SIGTERM every
rank saves the checkpoint together, then exits.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import TokenPipeline, TokenPipelineState
from ..kernels.dispatch import resolve_device
from ..models import Model
from ..models.config import ShapeSpec
from ..models.sharding import AbstractMesh, AxisRules, on_mesh
from ..training import AdamWConfig, init_train_state, make_train_step
from .mesh import available_mesh, sync_collectives
from .steps import build_cell, place_tree, sharded_train_state

__all__ = ["main", "describe_device"]


def describe_device(device: torch.device) -> str:
    """``cpu``, or the card's index, name and power limit (``nvidia-smi``)."""
    if device.type != "cuda":
        return str(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    try:
        smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        limit = smi.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return f"cuda:{index} ({torch.cuda.get_device_name(index)}, power limit {limit})"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="ranks on the mesh's model dim (default: the first of 8, 4, 2, "
                         "1 that divides the world size, as the reference's mesh)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a card and without "
                         "--device cpu the launcher raises")
    args = ap.parse_args(argv)
    ranks = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if ranks:
        from .serve import join_ranks
        device, transport = join_ranks(args.device)
    else:
        device, transport = resolve_device(args.device), None
    try:
        train(args, device, transport)
    finally:
        if ranks:
            dist.destroy_process_group()


def train(args, device, transport):
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family == "ssm" or cfg.family == "hybrid":
        # chunked scan needs T % chunk == 0
        args.seq = max(args.seq, cfg.ssm_chunk) if args.seq % cfg.ssm_chunk else args.seq
    model = Model(cfg, device=device)
    if transport == "gloo" and device.type == "cuda":
        sync_collectives("cuda")      # ranks sharing the card (launch.mesh)
    mesh = available_mesh(device.type, model=args.model_parallel)
    sharded = not isinstance(mesh, AbstractMesh)
    lead = not sharded or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    rules = AxisRules.make(mesh)
    shape = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    log(f"arch={cfg.name} device={describe_device(device)} params~{cfg.param_count():,} "
        f"mesh={shape}" + (f" transport={transport}" if transport else ""), flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    state_sh = batch_sh = None
    if sharded:
        # the train cell of this traffic: the step, and the shardings of
        # the train state and of a batch
        cell = build_cell(cfg, "train", mesh, rules=rules, opt_cfg=opt_cfg,
                          microbatch=args.microbatch, device=device,
                          shape=ShapeSpec("train", args.seq, args.batch, "train"))
        step_fn, (state_sh, batch_sh) = cell.fn, cell.in_shardings
        state = sharded_train_state(model, args.seed, state_sh)
    else:
        step_fn = make_train_step(model, opt_cfg, microbatch=args.microbatch)
        state = init_train_state(model, torch.Generator(device).manual_seed(args.seed))

    pipe = TokenPipeline(cfg.vocab, args.seq, args.batch, seed=args.seed, device=device)
    pipe_state = TokenPipelineState()

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            state, meta = ckpt.restore(latest, state, shardings=state_sh, device=device)
            pipe_state = TokenPipelineState.from_dict(meta["extra"]["pipeline"])
            start_step = meta["step"]
            log(f"resumed from step {start_step}")

    stop = {"now": False}

    def _sigterm(signum, frame):
        log("SIGTERM: checkpointing before exit", flush=True)
        stop["now"] = True

    signal.signal(signal.SIGTERM, _sigterm)

    durations = []
    with on_mesh(rules) if sharded else contextlib.nullcontext():
        for step in range(start_step, args.steps):
            batch, pipe_state = pipe.next_batch(pipe_state)
            if sharded:
                batch = place_tree(batch, batch_sh)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])      # waits for the step, as the reference blocks
            dt = time.perf_counter() - t0
            durations.append(dt)
            if len(durations) > 20:
                med = float(np.median(durations[-100:]))
                if dt > 2.0 * med:
                    log(f"[watchdog] slow step {step}: {dt:.2f}s vs median {med:.2f}s",
                        flush=True)
            if step % args.log_every == 0 or step == args.steps - 1:
                log(f"step {step:5d} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f} "
                    f"({dt*1e3:.0f} ms)", flush=True)
            if sharded:
                # every rank stops together: any rank's signal stops them all
                flag = torch.tensor([float(stop["now"])], device=device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                stop["now"] = bool(flag.item())
            if ckpt is not None and (
                    (step + 1) % args.ckpt_every == 0 or stop["now"]
                    or step == args.steps - 1):
                ckpt.save(step + 1, state,
                          extra={"pipeline": pipe_state.to_dict()},
                          block=stop["now"])
            if stop["now"]:
                if ckpt is not None:
                    ckpt.wait()
                return
    if ckpt is not None:
        ckpt.wait()
    log("done")


if __name__ == "__main__":
    main()
