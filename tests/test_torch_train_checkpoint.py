"""Checkpoints and the training launcher of the port
(``repro_torch.checkpoint``, ``python -m repro_torch.launch.train``), on the
CPU at reduced configs.

* ``CheckpointManager``: round trip, a save that snapshots before it
  returns, keep-k, resume continuity (10 steps straight == 5 + save +
  restore + 5, bit for bit: the port's CPU step is deterministic), and
  checkpoints written by either package restore into the other (the same
  ``arrays.npz`` keys, the same leaves, the same next step).
* ``python -m repro_torch.launch.train --device cpu``: SIGTERM, then resume
  to the same last loss as an uninterrupted run.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenPipeline, TokenPipelineState
from repro_torch.training import (AdamWConfig, OptState, TrainState, init_train_state,
                                  make_train_step)
from test_torch_training import (ROOT, TRAJ_OPT, _port_state, _Reference, flat,
                                 flat_tensors, torch_batch, train_batch)


@pytest.fixture(scope="module")
def ref():
    return _Reference()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    model, state = _port_state(seed=2)
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    mgr.save(5, state, extra={"pipeline": {"step": 7}})
    restored, meta = mgr.restore(5, state, device="cpu")
    assert meta == {"step": 5, "extra": {"pipeline": {"step": 7}}}
    assert isinstance(restored, TrainState) and isinstance(restored.opt, OptState)
    for a, b in zip(flat_tensors(dataclasses.asdict(state)),
                    flat_tensors(dataclasses.asdict(restored))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(6, {"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_checkpoint_save_snapshots_before_returning(tmp_path):
    """An async save copies every leaf before it returns: the in-place
    update right after it does not reach the file."""
    model, state = _port_state(seed=2)
    before = {k: v.copy() for k, v in flat(state.params).items()}
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, state)
    for p in flat_tensors(state.params):
        p.add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(1, state, device="cpu")
    for k, v in flat(restored.params).items():
        np.testing.assert_array_equal(v, before[k])


def test_checkpoint_keep_k(tmp_path):
    _, state = _port_state(seed=3)
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert not list(tmp_path.glob(".tmp_*"))
    assert CheckpointManager(tmp_path / "empty").restore_latest(state) == (None, None)


def test_checkpoint_resume_training_continuity(tmp_path):
    """Train 10 steps straight vs 5 + checkpoint + restore + 5: identical."""
    model, sA = _port_state(seed=4)
    step = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=20))
    pipe = TokenPipeline(model.cfg.vocab, 32, 4, seed=0, device="cpu")
    psA = TokenPipelineState()
    for _ in range(10):
        batch, psA = pipe.next_batch(psA)
        sA, _ = step(sA, batch)

    _, sB = _port_state(seed=4)
    psB = TokenPipelineState()
    for _ in range(5):
        batch, psB = pipe.next_batch(psB)
        sB, _ = step(sB, batch)
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(5, sB, extra={"pipeline": psB.to_dict()})
    _, fresh = _port_state(seed=99)
    sB, meta = mgr.restore(5, fresh, device="cpu")
    psB2 = TokenPipelineState.from_dict(meta["extra"]["pipeline"])
    for _ in range(5):
        batch, psB2 = pipe.next_batch(psB2)
        sB, _ = step(sB, batch)
    for a, b in zip(flat_tensors(dataclasses.asdict(sA)), flat_tensors(dataclasses.asdict(sB))):
        assert torch.equal(a, b)


def test_checkpoints_cross_between_the_packages(ref, tmp_path):
    """The reference saves and the port restores the same leaves and
    continues as the reference does; the port saves and the reference
    restores the same leaves. Both write the same 38 keys for reduced
    h2o-danube-1.8b."""
    jax, jnp, RT = ref.jax, ref.jnp, ref.RT
    from repro.checkpoint import CheckpointManager as RefManager
    arch = "h2o-danube-1.8b"
    rmodel, _, _ = ref.model(arch)
    model, _ = ref.port(arch)
    opt = TRAJ_OPT
    rstep = ref.train_step(arch, **opt)
    rstate = RT.init_train_state(rmodel, jax.random.PRNGKey(0))
    batches = [train_batch(model.cfg, 8, 32, step=i) for i in range(3)]
    for b in batches[:2]:
        rstate, _ = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
    RefManager(tmp_path / "ref", async_save=False).save(2, rstate, extra={"pipeline": {"step": 2}})

    like = init_train_state(model, torch.Generator().manual_seed(7))
    state, meta = CheckpointManager(tmp_path / "ref").restore(2, like, device="cpu")
    assert meta == {"step": 2, "extra": {"pipeline": {"step": 2}}}
    keys = np.load(tmp_path / "ref" / "step_00000002" / "arrays.npz").files
    assert len(keys) == 38 and {".params/embed/table", ".opt/.mu/layers/attn/wq",
                                ".opt/.step", ".step"} <= set(keys)
    want = flat(jax.tree.map(np.asarray, dataclasses.asdict(rstate)))
    got = flat(dataclasses.asdict(state))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batches[2].items()})
    state, m = make_train_step(model, AdamWConfig(**opt))(state, torch_batch(batches[2]))
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
    assert int(state.step) == int(rstate.step) == 3

    CheckpointManager(tmp_path / "port", async_save=False).save(
        3, state, extra={"pipeline": {"step": 3}})
    assert sorted(np.load(tmp_path / "port" / "step_00000003" / "arrays.npz").files) == \
        sorted(keys)
    back, rmeta = RefManager(tmp_path / "port").restore(3, jax.eval_shape(lambda: rstate))
    assert rmeta == {"step": 3, "extra": {"pipeline": {"step": 3}}}
    got = flat(jax.tree.map(np.asarray, dataclasses.asdict(back)))
    want = flat(dataclasses.asdict(state))
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _train_cmd(ckpt_dir, steps=30):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "h2o-danube-1.8b",
            "--reduced", "--steps", str(steps), "--batch", "4", "--seq", "64",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "10", "--device", "cpu"]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")


def _last_loss(stdout):
    return [line.split()[3] for line in stdout.splitlines() if line.startswith("step ")][-1]


def test_launch_train_cpu_survives_sigterm_and_resumes(tmp_path):
    """An uninterrupted run, and one sent SIGTERM after its step-10 line
    then rerun: it checkpoints on the signal, resumes from that step with
    the pipeline's state, and ends on the same loss (the CPU is
    deterministic)."""
    a = subprocess.Popen(_train_cmd(tmp_path / "A"), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, cwd=ROOT, env=_env())
    b = subprocess.Popen(_train_cmd(tmp_path / "B"), stdout=subprocess.PIPE, text=True,
                         cwd=ROOT, env=_env())
    seen = []
    try:
        for line in b.stdout:
            seen.append(line)
            if line.startswith("step    10"):
                b.send_signal(signal.SIGTERM)
        assert b.wait(timeout=60) == 0
        a_out, a_err = a.communicate(timeout=120)
    finally:
        a.kill()
        b.kill()
    assert a.returncode == 0, a_err
    lines = a_out.splitlines()
    assert lines[0].startswith("arch=h2o-danube-1.8b device=cpu params~119,104")
    assert lines[-1] == "done" and "resumed" not in a_out
    assert any(line.startswith("SIGTERM: checkpointing") for line in seen), seen
    saved = CheckpointManager(tmp_path / "B").latest_step()
    assert 10 < saved < 30
    c = subprocess.run(_train_cmd(tmp_path / "B"), capture_output=True, text=True,
                       cwd=ROOT, env=_env(), timeout=120)
    assert c.returncode == 0, c.stderr
    assert f"resumed from step {saved}" in c.stdout.splitlines()
    assert _last_loss(c.stdout) == _last_loss(a_out)
    meta = json.loads((tmp_path / "B" / "step_00000030" / "meta.json").read_text())
    assert meta == {"step": 30, "extra": {"pipeline": {"step": 30}}}
