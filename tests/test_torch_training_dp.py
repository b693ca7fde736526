"""The port's data-parallel training pieces on a 2-rank ``gloo`` group (two
processes on the CPU, rendezvous through a file):

* ``compressed_psum`` of each rank's tensor equals the reference's
  ``compressed_psum`` under ``jax.vmap(..., axis_name="i")`` over the same
  two tensors (one device, no fake XLA devices), on both ranks, bit for bit.
* ``make_dp_train_step`` on half the batch a rank: uncompressed, the loss
  and grad norm equal single-process ``make_train_step`` on the whole
  batch, and the parameters agree but for Adam's sign steps (at most
  2 lr + 1e-6 apart: a gradient near zero that differs in its last bits
  can flip ``mhat / sqrt(vhat)``); compressed, within the int8 bound the
  reference's own test holds (tests/test_distributed.py: loss within 1e-5
  relative, parameters within 5% of their scale). Both ranks end on the
  same parameters, bit for bit.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.training import AdamWConfig, make_train_step
from test_torch_training import _port_state, flat, torch_batch, train_batch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
OPT = dict(lr=1e-3, total_steps=10)

_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline, TokenPipelineState
from repro_torch.models import Model
from repro_torch.training import (AdamWConfig, compressed_psum, init_train_state,
                                  make_dp_train_step)

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
res = {}
x = np.random.default_rng(10 + rank).normal(size=(3, 257)).astype(np.float32) * (rank + 1)
res["psum"] = compressed_psum(torch.from_numpy(x)).numpy()
model = Model(get_config("deepseek-7b", reduced=True), device="cpu")
batch, _ = TokenPipeline(model.cfg.vocab, 32, 8, seed=0, device="cpu").next_batch(
    TokenPipelineState())
n = 8 // world
local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
for compress in (False, True):
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_dp_train_step(model, AdamWConfig(lr=1e-3, total_steps=10), compress=compress)
    state, m = step(state, local)
    tag = "c" if compress else "u"
    for k in ("loss", "grad_norm", "lr"):
        res[f"{tag}:{k}"] = m[k].numpy()

    def walk(t, p):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], f"{p}{k}/")
            else:
                res[f"{tag}:{p}{k}"] = t[k].numpy()
    walk(state.params, "")
dist.destroy_process_group()
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results: the psum, and both DP steps' metrics and params."""
    tmp = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(WORLD),
                               f"file://{tmp / 'rendezvous'}", str(tmp / f"rank{r}.npz")],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def test_compressed_psum_matches_the_reference_on_two_ranks(ranks):
    jax = pytest.importorskip("jax")
    from repro.training import compressed_psum as ref_psum
    xs = np.stack([np.random.default_rng(10 + r).normal(size=(3, 257)).astype(np.float32)
                   * (r + 1) for r in range(WORLD)])
    want = np.asarray(jax.vmap(lambda v: ref_psum(v, "i"), axis_name="i")(xs))
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["psum"], want[r])
    # the int8 grid's error: at most half a quantum a rank
    quantum = np.abs(xs).max() / 127.0
    assert np.abs(ranks[0]["psum"] - xs.sum(0)).max() <= WORLD * quantum / 2 * (1 + 1e-6)


def _params(res, tag):
    return {k.split(":", 1)[1]: v for k, v in res.items()
            if k.startswith(tag + ":") and k.split(":", 1)[1] not in ("loss", "grad_norm", "lr")}


def test_dp_step_matches_the_single_process_step(ranks):
    model, state = _port_state("deepseek-7b", seed=0)    # the ranks' init
    batch = torch_batch(train_batch(model.cfg, 8, 32))
    state, m = make_train_step(model, AdamWConfig(**OPT))(state, batch)
    single = flat(state.params)
    for tag in ("u", "c"):
        p0, p1 = _params(ranks[0], tag), _params(ranks[1], tag)
        assert p0.keys() == p1.keys() == single.keys()
        assert all(np.array_equal(p0[k], p1[k]) for k in p0), "ranks diverged"
    u, c = ranks[0], _params(ranks[0], "c")
    np.testing.assert_allclose(float(u["u:loss"]), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(u["u:grad_norm"]), float(m["grad_norm"]), rtol=1e-5)
    lr = float(m["lr"])
    np.testing.assert_allclose(float(u["u:lr"]), lr, rtol=1e-6)
    pu = _params(u, "u")
    dmax = max(float(np.abs(pu[k] - single[k]).max()) for k in single)
    print(f"uncompressed DP vs single process: max |dparam| {dmax:.3e} (lr {lr:.3e})")
    assert dmax <= 2 * lr + 1e-6
    rel = abs(float(u["c:loss"]) - float(m["loss"])) / abs(float(m["loss"]))
    dmax = max(float(np.abs(c[k] - single[k]).max()) for k in single)
    pscale = max(float(np.abs(v).max()) for v in single.values())
    print(f"compressed DP: rel loss {rel:.2e}, max |dparam| / scale {dmax / pscale:.3e}")
    assert rel < 1e-5 and dmax / pscale < 0.05
