"""The shard hints and the two sharding levers in one process, on the CPU.

* The hint sites (the embedding's output and the logits in stack, hybrid
  and encdec, the MoE dispatch buffer under ``moe_shard_capacity``, the
  table's gather, the gold logit's reduction, the local blocks of
  attention, mamba2 and the MoE experts) leave the one-process forward and
  the train step's loss and gradients bit-equal: with the rules of a 2 x 2
  mesh active (``on_mesh``) and with every hint and local map patched to
  the identity, on plain tensors, the outputs are ``torch.equal``.
* ``bf16_compute_weights`` (the layer parameters cast to bf16 once before
  the layer loop) and ``moe_shard_capacity``: the port's bf16 forward with
  the lever on equals the reference's forward with the lever on within the
  bf16 bounds of tests/test_torch_models_bf16_forward.py (MoE rows up to
  their first router near-tie), and its own forward with the lever off bit
  for bit where the lever changes no arithmetic (the dense archs' weights
  meet bf16 at each use anyway; ``moe_shard_capacity`` is a hint).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import stack as ST
from repro_torch.models.sharding import AbstractMesh, AxisRules, on_mesh
from repro_torch.training import loss_and_grads
from repro_torch.training import train_step as TS
from repro_torch.training.optimizer import tree_leaves
from test_torch_models import _batch, _Reference, _t
from test_torch_models_bf16_forward import _before_router_tie, _hold_bf16, router_gaps  # noqa: F401

FAMILY_ARCHS = ("h2o-danube-1.8b", "granite-moe-3b-a800m", "mamba2-1.3b", "zamba2-2.7b",
                "whisper-tiny")
RULES = AxisRules.make(AbstractMesh((2, 2), ("data", "model")))


def _run(model, params, batch):
    logits, aux = model.forward_train(params, batch)
    loss, grads = loss_and_grads(model, params, {**batch, "targets": batch["tokens"]})
    return [logits, aux, loss] + tree_leaves(grads)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_hint_sites_leave_the_one_process_step_bit_equal(arch, monkeypatch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), moe_shard_capacity=True)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    T = 64 if cfg.family in ("ssm", "hybrid") else 32
    batch = _t(_batch(cfg, 2, T, seed=4))
    plain = _run(model, params, batch)
    calls = []
    import repro_torch.models.sharding as SH
    real = SH.shard_hint

    def counting(x, *axes, **kw):
        calls.append(axes)
        return real(x, *axes, **kw)

    for mod in (ST, ED, MOE, TS):
        monkeypatch.setattr(mod, "shard_hint", counting)
    with on_mesh(RULES):
        hinted = _run(model, params, batch)
    assert calls, "no hint site was reached"
    identity = lambda x, *a, **k: x     # noqa: E731
    for mod in (ST, ED, MOE, TS):
        monkeypatch.setattr(mod, "shard_hint", identity)
    monkeypatch.setattr(ST, "replicated", lambda x, **k: x)
    for mod in (L, M2, MOE):
        monkeypatch.setattr(mod, "local_map", lambda fn, args, *a, **k: fn(*args))
    monkeypatch.setattr(MOE, "rows_local", lambda fn, *args, **k: fn(*args))
    bare = _run(model, params, batch)
    for a, b, c in zip(plain, hinted, bare):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.fixture(scope="module")
def ref():
    return _Reference()


@pytest.mark.parametrize("arch,lever", [("deepseek-7b", "bf16_compute_weights"),
                                        ("h2o-danube-1.8b", "bf16_compute_weights"),
                                        ("mixtral-8x22b", "bf16_compute_weights"),
                                        ("mixtral-8x22b", "moe_shard_capacity"),
                                        ("granite-moe-3b-a800m", "moe_shard_capacity")])
def test_sharding_levers_match_the_reference(ref, arch, lever, router_gaps):  # noqa: F811
    model, params = ref.port(arch, dtype="bfloat16", **{lever: True})
    assert getattr(model.cfg, lever)
    off = Model(dataclasses.replace(model.cfg, **{lever: False}), device="cpu")
    batch = _batch(model.cfg, 2, 32, seed=0)
    want, want_aux = ref.forward(arch, batch, dtype="bfloat16", **{lever: True})
    want32, _ = ref.forward(arch, batch)
    logits, aux = model.forward_train(params, _t(batch))
    n = len(router_gaps)
    logits_off, aux_off = off.forward_train(params, _t(batch))
    del router_gaps[n:]
    if lever == "moe_shard_capacity" or not model.cfg.is_moe:
        # every weight the dense layers read meets bf16 at its use anyway;
        # the MoE router reads its weight in fp32 unless the lever casts it
        assert torch.equal(logits, logits_off) and torch.equal(aux, aux_off)
    keep = (_before_router_tie(router_gaps, model.cfg.n_layers) if model.cfg.is_moe
            else np.ones((2, 32), bool))
    _hold_bf16(logits.float().numpy(), want.astype(np.float32), want32, keep,
               f"{arch} {lever}")
    if model.cfg.is_moe:
        assert abs(float(aux) - want_aux) < 1e-2 * want_aux
