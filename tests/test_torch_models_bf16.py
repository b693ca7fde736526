"""bfloat16, the served arithmetic, block by block: the port's LM stack
against the reference's on the CPU, each arch's reduced config with
``dtype="bfloat16"`` over the same fp32 masters (carried across by
``params_from_jax``).

Bit-equal in 99% of elements and within one bf16 spacing of the output's
scale in the rest (fp32 sums in another order): the attention block (norm,
the master casts, rope, fp32 scores and P.V with P rounded to V's dtype, the
bf16 KV cache and its ring) in train, prefill and decode; the embedding,
final norm and lm head; the MLP and MoE blocks against the reference with
its silu/gelu rounded once, as the port's are. Within BF16_ULPS of the
reference as it is: the MLP and MoE blocks. Whole models in bf16:
tests/test_torch_models_bf16_forward.py; greedy generate in bf16:
tests/test_torch_lm_serving.py.

Inputs come from numpy seeds; the reference runs jitted, once per arch and
dtype (test_torch_models.py's ``_Reference``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model, params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.stack import unstack
from test_torch_models import TOL, _batch, _Reference, _t

# bfloat16. torch rounds each bf16 silu/gelu once; XLA's CPU backend
# evaluates jax.nn.silu/gelu on bf16 less exactly and keeps excess precision
# in fused bf16 chains, so past the attention block (bit-equal but for a
# rare one-spacing rounding of an fp32 sum) the two sides differ by a few
# bf16 spacings.
BF16_ULPS = 8          # bound: this many bf16 spacings at the output's largest |value|
BF16_ERR_RATIO = 1.25  # port's bf16 error vs fp32 <= this x the reference's own
STACK_ARCHS = tuple(a for a in ARCH_IDS if get_config(a, reduced=True).family in ("dense", "moe"))


@pytest.fixture(scope="module")
def ref():
    return _Reference()


def _bf16_bound(want):
    """BF16_ULPS bf16 spacings (8 significant bits) at want's largest |value|."""
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


@pytest.mark.parametrize("arch", STACK_ARCHS)
def test_bf16_attention_block_is_bit_equal(ref, arch):
    """Layer 0's norm and attention block in bf16 over fp32 masters: a
    40-token prefill into a bf16 cache of 44 slots (a 32-slot ring for the
    window archs), then 4 decode steps. Outputs and cache contents equal the
    reference's bit for bit in at least 99% of elements and within one bf16
    spacing at the tensor's largest |value| in the rest; so does the
    train-mode output."""
    RL = pytest.importorskip("repro.models.layers")
    jnp = ref.jnp
    rmodel, rparams, _ = ref.model(arch)
    _, params = ref.port(arch)
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")
    rcfg = dataclasses.replace(rmodel.cfg, dtype="bfloat16")
    rp = ref.jax.tree.map(lambda a: a[0], rparams["layers"])
    p = unstack(params["layers"])[0]
    rng = np.random.default_rng(7)
    B, T, S = 2, 44, 44
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    xb, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()

    def ref_block(xb, cache, mode):
        h = RL.norm_apply(rp["norm1"], xb, rcfg)
        pos = jnp.broadcast_to(jnp.arange(xb.shape[1]), xb.shape[:2])
        return RL.attn_apply(rp["attn"], h, rcfg, positions=pos, mode=mode, cache=cache)

    def port_block(tx, cache, mode):
        h = L.norm_apply(p["norm1"], tx, cfg)
        pos = torch.arange(tx.shape[1])[None].expand(tx.shape[:2])
        return L.attn_apply(p["attn"], h, cfg, positions=pos, mode=mode, cache=cache)

    def equal(got, want, what):
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16", what
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        spacing = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        same = float(np.mean(g == w))
        print(f"[bf16] {arch} attention {what}: bit-equal {same:.5f} "
              f"max|d|/spacing {float(np.max(np.abs(g - w) / spacing)):.1f}")
        assert same >= 0.99 and bool(np.all(np.abs(g - w) <= spacing)), what

    equal(port_block(tx, None, "train")[0],
          ref.jax.jit(lambda a: ref_block(a, None, "train")[0])(xb), "train")
    rcache = RL.init_attn_cache(rcfg, B, S, jnp.bfloat16, window=cfg.swa_window)
    cache = L.init_attn_cache(cfg, B, S, torch.bfloat16, window=cfg.swa_window)
    assert cache.window == rcache.window and cache.k.shape == rcache.k.shape
    ry, rcache = ref.jax.jit(lambda a, c: ref_block(a, c, "prefill"))(xb[:, :40], rcache)
    y, cache = port_block(tx[:, :40], cache, "prefill")
    equal(y, ry, "prefill")
    step = ref.jax.jit(lambda a, c: ref_block(a, c, "decode"))
    for t in range(40, T):
        ry, rcache = step(xb[:, t:t + 1], rcache)
        y, cache = port_block(tx[:, t:t + 1], cache, "decode")
        equal(y, ry, f"decode step at {t}")
    equal(cache.k, rcache.k, "k cache")
    equal(cache.v, rcache.v, "v cache")


def _once_rounded_act(x, kind):
    """silu/gelu in fp32, rounded once to x's dtype (the port's ``act``)."""
    jax = pytest.importorskip("jax")
    xf = x.astype(jax.numpy.float32)
    return (jax.nn.silu(xf) if kind == "silu" else jax.nn.gelu(xf)).astype(x.dtype)


def test_bf16_act_is_rounded_once():
    """The port's silu and tanh-gelu on bf16 are the fp32 functions rounded
    once to bf16 (a rounded sigmoid times x would not be)."""
    x = torch.from_numpy(np.random.default_rng(9).normal(size=100_000).astype(np.float32) * 4)
    xb = x.bfloat16()
    for kind in ("silu", "gelu"):
        got = L.act(xb, kind)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, L.act(xb.float(), kind).bfloat16()), kind
    assert not torch.equal(L.act(xb, "silu"), xb * torch.sigmoid(xb))


@pytest.mark.parametrize("arch", STACK_ARCHS)
def test_bf16_ffn_block_matches_reference(ref, arch, monkeypatch):
    """Layer 0's MLP or MoE block on one bf16 input (MoE: capacity_factor
    1.0, with drops, over 32 tokens, and the T == 1 dense path). Against the
    reference as it is: within BF16_ULPS. Against the reference with its
    silu/gelu rounded once, as the port's are: bit-equal in 99% of elements
    and within one bf16 spacing of the output's scale. The MoE aux loss at
    2e-4 (the fp32 router sees the same input on both sides)."""
    RLm = pytest.importorskip("repro.models.layers")
    RM = pytest.importorskip("repro.models.moe")
    rmodel, rparams, _ = ref.model(arch)
    _, params = ref.port(arch)
    name = "moe" if rmodel.cfg.is_moe else "mlp"
    rp = ref.jax.tree.map(lambda a: a[0], rparams["layers"])[name]
    p = unstack(params["layers"])[0][name]
    x = np.random.default_rng(8).normal(size=(2, 32, rmodel.cfg.d_model)).astype(np.float32)
    cases = ((1.0, 32), (1.25, 1)) if name == "moe" else ((1.25, 32),)
    for cf, T in cases:
        cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16",
                                  capacity_factor=cf)
        rcfg = dataclasses.replace(rmodel.cfg, dtype="bfloat16", capacity_factor=cf)
        xb = ref.jnp.asarray(x[:, :T], ref.jnp.bfloat16)
        if name == "moe":
            got, aux = MOE.moe_apply(p, torch.from_numpy(x[:, :T]).bfloat16(), cfg)
            fn = lambda a: RM.moe_apply(rp, a, rcfg)                      # noqa: E731
        else:
            got = L.mlp_apply(p, torch.from_numpy(x[:, :T]).bfloat16(), cfg)
            fn = lambda a: (RLm.mlp_apply(rp, a, rcfg), 0.0)              # noqa: E731
        want, want_aux = ref.jax.jit(fn)(xb)
        with monkeypatch.context() as m:
            m.setattr(RLm, "_act", _once_rounded_act)
            m.setattr(RM, "_act", _once_rounded_act)
            want_once, _ = ref.jax.jit(lambda a: fn(a))(xb)   # a new trace, patched
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        g = got.float().numpy()
        want, want_once = np.asarray(want, np.float32), np.asarray(want_once, np.float32)
        diff, bound = np.abs(g - want), _bf16_bound(want)
        spacing = 2.0 ** (np.floor(np.log2(np.abs(want_once).max())) - 7)
        same = float(np.mean(g == want_once))
        print(f"[bf16] {arch} {name} T={T} cf={cf}: max|d| {diff.max():.4f} bound {bound:.4f}; "
              f"once-rounded act: bit-equal {same:.5f} "
              f"max|d| {np.abs(g - want_once).max():.4f} spacing {spacing:.4f}")
        np.testing.assert_array_less(diff, bound)
        assert same >= 0.99 and bool(np.all(np.abs(g - want_once) <= spacing))
        if name == "moe":
            np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a, reduced=True).family in ("dense", "moe", "ssm")])
def test_bf16_embedding_and_head_are_bit_equal(ref, arch):
    """The model with its layers cut to none: the embedding gather cast to
    bf16, the final norm and the (tied or separate) lm head over the fp32
    master, against the reference's: bit-equal in 99% of elements and within
    one bf16 spacing of the logits' scale."""
    from repro.models import Model as RefModel

    rmodel, rparams, _ = ref.model(arch)
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16", n_layers=0)
    rcfg = dataclasses.replace(rmodel.cfg, dtype="bfloat16", n_layers=0)
    rp = dict(rparams, layers=ref.jax.tree.map(lambda a: a[:0], rparams["layers"]))
    batch = _batch(cfg, 2, 32, seed=10)
    want, _ = ref.jax.jit(RefModel(rcfg).forward_train)(
        rp, {k: ref.jnp.asarray(v) for k, v in batch.items()})
    got, _ = Model(cfg, device="cpu").forward_train(params_from_jax(rp, cfg, device="cpu"),
                                                    _t(batch))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    spacing = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    same = float(np.mean(g == w))
    print(f"[bf16] {arch} embedding + head: bit-equal {same:.5f} max|d| {np.abs(g - w).max():.2e}")
    assert same >= 0.99 and bool(np.all(np.abs(g - w) <= spacing))
