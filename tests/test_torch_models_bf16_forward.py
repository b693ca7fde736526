"""bfloat16, the served arithmetic, whole models: the port's LM stack
against the reference's on the CPU, each arch's reduced config with
``dtype="bfloat16"`` over the same fp32 masters.

Within BF16_ULPS of the reference: the forward logits of all 10 archs, and
prefill + 4 decode steps from bf16 caches on the five decode archs, whose
caches hold the reference's dtypes (bf16 K/V and conv windows, fp32 SSM
states). The port's error against the fp32 reference lies between half and
BF16_ERR_RATIO times the reference's own. An MoE arch routes by a top-k over
bf16 activations, so the elementwise bound holds each row up to its first
router near-tie (ROUTER_TIE); the error ratio holds every position. The
blocks: tests/test_torch_models_bf16.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.models import moe as MOE
from repro_torch.models.moe import top_k_lower_index
from test_torch_models import DECODE_ARCHS, _batch, _port_prefill_decode, _Reference, _t
from test_torch_models_bf16 import BF16_ERR_RATIO, _bf16_bound

ROUTER_TIE = 1e-2      # top-k router probabilities closer than this may swap


@pytest.fixture(scope="module")
def ref():
    return _Reference()


@pytest.fixture
def router_gaps(monkeypatch):
    """Each port MoE layer's [B, T] gap between the K-th and (K+1)-th router
    probability, in call order: a gap under ROUTER_TIE is a near-tie that a
    bf16 rounding upstream may flip to another expert."""
    gaps = []

    def recording(x, k):
        s = torch.sort(x.float(), dim=-1, descending=True).values
        gaps.append(s[..., k - 1] - s[..., k] if k < x.shape[-1]
                    else torch.full(x.shape[:-1], torch.inf))
        return top_k_lower_index(x, k)

    monkeypatch.setattr(MOE, "top_k_lower_index", recording)
    return gaps


def _before_router_tie(gaps, n_layers):
    """[B, T] True where no MoE layer met a near-tie at this position or an
    earlier one of its row (attention and the per-row capacity carry a
    flipped route forward only). ``gaps`` holds n_layers [B, t] entries per
    call, for calls over consecutive positions."""
    calls = [torch.stack(gaps[i:i + n_layers]).amin(0) for i in range(0, len(gaps), n_layers)]
    tie = torch.cat(calls, dim=1) < ROUTER_TIE
    return (torch.cumsum(tie.int(), dim=1) == 0).numpy()


def _float_leaves(tree):
    """The floating tensors of a cache (dataclasses, lists, tensors)."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _float_leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _float_leaves(t)]
    return []


def _hold_bf16(got, want, want32, keep, what):
    """got, want: the port's and the reference's bf16 outputs; want32: the
    fp32 reference on the same inputs; keep: [B, T] positions to bound."""
    bound = _bf16_bound(want)
    diff = np.abs(got - want)
    err_port = float(np.abs(got - want32).mean())
    err_ref = float(np.abs(want - want32).mean())
    print(f"[bf16] {what}: max|d| {diff[keep].max(initial=0):.4f} bound {bound:.4f} "
          f"positions {int(keep.sum())}/{keep.size} err vs fp32: port {err_port:.5f} "
          f"reference {err_ref:.5f}")
    np.testing.assert_array_less(diff[keep], bound, err_msg=what)
    assert 0.5 * err_ref <= err_port <= BF16_ERR_RATIO * err_ref, (what, err_port, err_ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_forward_matches_reference(ref, arch, router_gaps):
    """forward_train in bf16 on the reference's parameters: bf16 logits
    within BF16_ULPS of the reference's (MoE archs: up to each row's first
    router near-tie), and the port's error against the fp32 reference of
    the reference's own size."""
    model, params = ref.port(arch, dtype="bfloat16")
    batch = _batch(model.cfg, 2, 32, seed=0)
    want, want_aux = ref.forward(arch, batch, dtype="bfloat16")
    want32, _ = ref.forward(arch, batch)
    logits, aux = model.forward_train(params, _t(batch))
    assert logits.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    keep = (_before_router_tie(router_gaps, model.cfg.n_layers) if model.cfg.is_moe
            else np.ones((2, 32), bool))
    _hold_bf16(logits.float().numpy(), want.astype(np.float32), want32, keep,
               f"{arch} forward")
    if model.cfg.is_moe:
        assert abs(float(aux) - want_aux) < 1e-2 * want_aux


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_bf16_prefill_decode_matches_reference(ref, arch, router_gaps):
    """Prefill 28 tokens into bf16 caches, then 4 decode steps: every
    step's logits within BF16_ULPS of the reference's on its bf16 caches
    (MoE: up to the row's first router near-tie)."""
    model, params = ref.port(arch, dtype="bfloat16")
    batch = _batch(model.cfg, 2, 32, seed=1)
    want = ref.prefill_decode(arch, batch, 28, cache_dtype="bfloat16", dtype="bfloat16")
    want32 = ref.prefill_decode(arch, batch, 28)
    got = _port_prefill_decode(model, params, batch, 28, cache_dtype=torch.bfloat16)
    keep = np.ones((2, 5), bool)
    if model.cfg.is_moe:
        keep = _before_router_tie(router_gaps, model.cfg.n_layers)[:, 27:]
    _hold_bf16(got, want, want32, keep, f"{arch} prefill + decode")
    # the caches' floating leaves: bf16 K/V and conv windows, fp32 SSM states
    rmodel, _, _ = ref.model(arch, dtype="bfloat16")
    want_sizes = {}
    for x in ref.jax.tree.leaves(rmodel.init_cache(2, 32, ref.jnp.bfloat16)):
        if ref.jnp.issubdtype(x.dtype, ref.jnp.floating):
            want_sizes[str(x.dtype)] = want_sizes.get(str(x.dtype), 0) + x.size
    sizes = {}
    for x in _float_leaves(model.init_cache(2, 32, torch.bfloat16)):
        name = str(x.dtype).removeprefix("torch.")
        sizes[name] = sizes.get(name, 0) + x.numel()
    assert sizes == want_sizes
