"""Training launcher: the end-to-end entry point with fault tolerance (the
port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --reduced \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Features exercised here:
  * checkpoint/restart: auto-resume from the latest checkpoint, atomic saves,
    SIGTERM (preemption) triggers a final save before exit,
  * data-pipeline state restored with the model (no sample skew on restart),
  * microbatch gradient accumulation,
  * per-step wall-clock watchdog (straggler surfacing: slow steps are logged
    with their percentile against the running distribution).

Runs on the CUDA device unless ``--device cpu`` is given; without a card and
without that flag it raises instead of carrying on on the host. Where the
reference prints its mesh, this prints the device (on the card: its name
and power limit).
"""
from __future__ import annotations

import argparse
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import TokenPipeline, TokenPipelineState
from ..kernels.dispatch import resolve_device
from ..models import Model
from ..training import AdamWConfig, init_train_state, make_train_step

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
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a card and without "
                         "--device cpu the launcher raises")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family == "ssm" or cfg.family == "hybrid":
        # chunked scan needs T % chunk == 0
        args.seq = max(args.seq, cfg.ssm_chunk) if args.seq % cfg.ssm_chunk else args.seq
    model = Model(cfg, device=device)
    print(f"arch={cfg.name} device={describe_device(device)} params~{cfg.param_count():,}")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    step_fn = make_train_step(model, opt_cfg, microbatch=args.microbatch)
    state = init_train_state(model, torch.Generator(device).manual_seed(args.seed))

    pipe = TokenPipeline(cfg.vocab, args.seq, args.batch, seed=args.seed, device=device)
    pipe_state = TokenPipelineState()

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            state, meta = ckpt.restore(latest, state, device=device)
            pipe_state = TokenPipelineState.from_dict(meta["extra"]["pipeline"])
            start_step = meta["step"]
            print(f"resumed from step {start_step}")

    stop = {"now": False}

    def _sigterm(signum, frame):
        print("SIGTERM: checkpointing before exit", flush=True)
        stop["now"] = True

    signal.signal(signal.SIGTERM, _sigterm)

    durations = []
    for step in range(start_step, args.steps):
        batch, pipe_state = pipe.next_batch(pipe_state)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])      # waits for the step, as the reference blocks
        dt = time.perf_counter() - t0
        durations.append(dt)
        if len(durations) > 20:
            med = float(np.median(durations[-100:]))
            if dt > 2.0 * med:
                print(f"[watchdog] slow step {step}: {dt:.2f}s vs median {med:.2f}s",
                      flush=True)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
        if ckpt is not None and (
                (step + 1) % args.ckpt_every == 0 or stop["now"]
                or step == args.steps - 1):
            ckpt.save(step + 1, state,
                      extra={"pipeline": pipe_state.to_dict()},
                      block=stop["now"])
        if stop["now"]:
            ckpt and ckpt.wait()
            sys.exit(0)
    if ckpt is not None:
        ckpt.wait()
    print("done")


if __name__ == "__main__":
    main()
