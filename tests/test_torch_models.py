"""The port's LM stack (``repro_torch.models``) against the reference's
(``repro.models``), on the CPU at each architecture's reduced config.

* Parameters: the reference's ``Model.init`` pytree carried across by
  ``params_from_jax`` (every name and shape checked), the same leaf count,
  the same ``param_count``; the analytic counts equal the reference's.
* ``forward_train`` logits and the MoE aux loss equal the reference's at
  rtol = atol = 2e-4 for all 10 archs (the reference's own bound,
  tests/test_models_smoke.py).
* Prefill then 4 decode steps equal the reference's prefill and decode
  logits on its five decode archs, at 2e-4; the sliding-window ring buffer
  past its window at 3e-4; MoE at capacity_factor 1.0, where tokens drop.
* Library cases: gelu's tanh form, GQA head order, the fully-masked-row
  guard, mamba2's prefill-length error, ``lax.top_k``'s tie order and
  ``jax.nn.softplus`` past torch's threshold.
* bfloat16 cases: tests/test_torch_models_bf16.py.
* ``cuda``-marked: the card against the CPU at reduced size (skip here).

Inputs come from numpy seeds. The reference runs once per arch (a
module-scoped cache), jitted, with no train step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model, params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.moe import top_k_lower_index
from repro_torch.models.stack import unstack

TOL = 2e-4
SWA_TOL = 3e-4
DECODE_ARCHS = ("deepseek-7b", "mixtral-8x22b", "mamba2-1.3b", "zamba2-2.7b", "whisper-tiny")


def _batch(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class _Reference:
    """The reference model per (arch, config changes, key): its parameters
    made once, and each jitted function traced once."""

    def __init__(self):
        self.jax = pytest.importorskip("jax")
        self.jnp = self.jax.numpy
        from repro.configs import get_config as ref_get_config
        from repro.models import Model as RefModel
        self._get_config, self._Model, self._memo = ref_get_config, RefModel, {}

    def model(self, arch, key=0, **changes):
        """(model, params, jitted fns). The changes here (capacity_factor)
        leave the parameters' shapes alone, so each arch inits once."""
        memo_key = (arch, key, tuple(sorted(changes.items())))
        if memo_key not in self._memo:
            if (arch, key) not in self._memo:
                model = self._Model(self._get_config(arch, reduced=True))
                self._memo[arch, key] = self.jax.jit(model.init)(self.jax.random.PRNGKey(key))
            model = self._Model(dataclasses.replace(self._get_config(arch, reduced=True),
                                                    **changes))
            fns = dict(forward=self.jax.jit(model.forward_train),
                       prefill=self.jax.jit(model.prefill),
                       decode=self.jax.jit(model.decode_step))
            self._memo[memo_key] = (model, self._memo[arch, key], fns)
        return self._memo[memo_key]

    def port(self, arch, key=0, **changes):
        """The port's model on the CPU with the reference's parameters."""
        _, params, _ = self.model(arch, key, **changes)
        cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
        return Model(cfg, device="cpu"), params_from_jax(params, cfg, device="cpu")

    def forward(self, arch, batch, key=0, **changes):
        _, params, fns = self.model(arch, key, **changes)
        logits, aux = fns["forward"](params, {k: self.jnp.asarray(v) for k, v in batch.items()})
        return np.asarray(logits), float(aux)

    def prefill_decode(self, arch, batch, n_prefill, key=0, cache_dtype="float32", **changes):
        """The reference's prefill logits on the first n_prefill tokens, then
        one decode step per remaining token: [B, n_steps + 1, V]."""
        model, params, fns = self.model(arch, key, **changes)
        jnp = self.jnp
        B, T = batch["tokens"].shape
        cache = model.init_cache(B, T, jnp.dtype(cache_dtype))
        pre = {k: jnp.asarray(v) for k, v in batch.items()}
        pre["tokens"] = pre["tokens"][:, :n_prefill]
        lg, cache = fns["prefill"](params, pre, cache)
        out = [np.asarray(lg[:, -1])]
        for i in range(n_prefill, T):
            lg, cache = fns["decode"](params, jnp.asarray(batch["tokens"][:, i:i + 1]), cache)
            out.append(np.asarray(lg[:, 0]))
        return np.stack(out, axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    return _Reference()


def _port_prefill_decode(model, params, batch, n_prefill, cache_dtype=torch.float32):
    """The port's counterpart of ``_Reference.prefill_decode``, on the host."""
    B, T = batch["tokens"].shape
    cache = model.init_cache(B, T, cache_dtype)
    pre = _t(batch)
    pre["tokens"] = pre["tokens"][:, :n_prefill]
    lg, cache = model.prefill(params, pre, cache)
    out = [lg[:, -1].cpu()]
    for i in range(n_prefill, T):
        lg, cache = model.decode_step(params, torch.from_numpy(batch["tokens"][:, i:i + 1]),
                                      cache)
        out.append(lg[:, 0].cpu())
    return torch.stack(out, dim=1).float().numpy()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(ref, arch):
    """forward_train logits (and the MoE aux loss) equal the reference's on
    its own parameters."""
    model, params = ref.port(arch)
    batch = _batch(model.cfg, 2, 32, seed=0)
    want, want_aux = ref.forward(arch, batch)
    logits, aux = model.forward_train(params, _t(batch))
    assert logits.shape == (2, 32, model.cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), want_aux, rtol=TOL, atol=TOL)
    if model.cfg.is_moe:
        assert want_aux > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_numbers_equal_the_reference(arch):
    """Every field of the port's ArchConfig holds the reference's value, in
    the published config and in ``reduced()``; the registries list the
    same archs in the same order."""
    rc = pytest.importorskip("repro.configs")
    assert tuple(ARCH_IDS) == tuple(rc.ARCH_IDS)
    for reduced in (False, True):
        cfg, rcfg = get_config(arch, reduced=reduced), rc.get_config(arch, reduced=reduced)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), (arch, reduced, f.name)


def test_params_carry_across_leaf_for_leaf(ref):
    """Every leaf of every arch's reference params has a place of the same
    shape in the port's own init; the counts agree, actual and analytic."""
    jax = ref.jax
    from repro.configs import get_config as ref_get_config
    for arch in ARCH_IDS:
        rmodel, rparams, _ = ref.model(arch)
        model, params = ref.port(arch)
        leaves = jax.tree.leaves(rparams)
        own = model.init(torch.Generator().manual_seed(0))

        def flat(t):
            return [x for v in t.values() for x in flat(v)] if isinstance(t, dict) else [t]

        assert len(flat(params)) == len(flat(own)) == len(leaves), arch
        assert [tuple(x.shape) for x in flat(own)] == [tuple(x.shape) for x in flat(params)]
        assert Model.param_count(params) == Model.param_count(own) == rmodel.param_count(rparams)
        for reduced in (True, False):
            cfg, rcfg = get_config(arch, reduced=reduced), ref_get_config(arch, reduced=reduced)
            assert cfg.param_count() == rcfg.param_count(), (arch, reduced)
            assert cfg.active_param_count() == rcfg.active_param_count(), (arch, reduced)
            assert cfg.supports_shape("long_500k") == rcfg.supports_shape("long_500k")
        # the reference's own bound on the analytic count
        actual = Model.param_count(params)
        assert abs(actual - model.cfg.param_count()) / actual < 0.05
    assert get_config("deepseek-7b").param_count() == 6_910_365_696


def test_params_from_jax_rejects_a_wrong_layout(ref):
    _, rparams, _ = ref.model("deepseek-7b")
    cfg = get_config("deepseek-7b", reduced=True)
    bad = {k: v for k, v in rparams.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(bad, cfg, device="cpu")
    bad = dict(rparams, final_norm={"scale": np.ones(cfg.d_model + 1, np.float32)})
    with pytest.raises(ValueError, match=r"\['final_norm'\]\['scale'\]"):
        params_from_jax(bad, cfg, device="cpu")


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_decode_matches_reference(ref, arch):
    """The reference's test_prefill_decode_matches_forward, held to the
    reference's own prefill and decode logits as well as to the forward."""
    changes = dict(capacity_factor=8.0) if arch == "mixtral-8x22b" else {}   # no drops
    model, params = ref.port(arch, **changes)
    batch = _batch(model.cfg, 2, 32, seed=1)
    want = ref.prefill_decode(arch, batch, 28, **changes)
    got = _port_prefill_decode(model, params, batch, 28)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    full, _ = model.forward_train(params, _t(batch))
    np.testing.assert_allclose(got, full[:, 27:].numpy(), rtol=TOL, atol=TOL)


def test_swa_ring_buffer_decode(ref):
    """Past its 32-token window the SWA cache is a ring: a 40-token prefill
    rolls the last 32 keys into ring order, then 4 decode steps write
    slot = pos % 32. Logits equal the reference's and the window-masked
    forward's at 3e-4."""
    model, params = ref.port("h2o-danube-1.8b")
    assert model.cfg.swa_window == 32
    batch = _batch(model.cfg, 1, 48, seed=2)
    want = ref.prefill_decode("h2o-danube-1.8b", batch, 40)
    got = _port_prefill_decode(model, params, batch, 40)
    np.testing.assert_allclose(got, want, rtol=SWA_TOL, atol=SWA_TOL)
    full, _ = model.forward_train(params, _t(batch))
    np.testing.assert_allclose(got, full[:, 39:].numpy(), rtol=SWA_TOL, atol=SWA_TOL)
    cache = model.init_cache(1, 48, torch.float32)
    assert cache.attn[0].window == 32 and cache.attn[0].k.shape[1] == 32


def test_moe_capacity_drops_match_reference(ref):
    """At capacity_factor 1.0 tokens overflow their experts and drop; the
    logits and the aux loss still equal the reference's, and differ from a
    run with room for every token."""
    model, params = ref.port("mixtral-8x22b", capacity_factor=1.0)
    batch = _batch(model.cfg, 2, 64, seed=3)
    want, want_aux = ref.forward("mixtral-8x22b", batch, capacity_factor=1.0)
    logits, aux = model.forward_train(params, _t(batch))
    np.testing.assert_allclose(logits.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), want_aux, rtol=TOL, atol=TOL)
    roomy = Model(dataclasses.replace(model.cfg, capacity_factor=8.0), device="cpu")
    no_drop, _ = roomy.forward_train(params, _t(batch))
    assert float((no_drop - logits).abs().max()) > 1e-3
    assert bool(torch.isfinite(logits).all()) and float(aux) > 0


# ---------------------------------------------------------------------------
# library cases
# ---------------------------------------------------------------------------

def test_gelu_is_the_tanh_form():
    jax = pytest.importorskip("jax")

    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = L.act(torch.from_numpy(x), "gelu").numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - got).max() > 1e-4


def test_gqa_head_order_and_masked_row_guard():
    """Query head h reads KV head h // G (``jnp.repeat``'s order) in both
    attentions; a key chunk that masks a whole row (window 2, chunks of 4)
    leaves no NaN, and a decode row with no valid slot comes out 0. All
    equal the reference."""
    RL = pytest.importorskip("repro.models.layers")
    rng = np.random.default_rng(4)
    B, T, H, KV, hd = 2, 8, 4, 2, 8
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for window in (0, 2):
        got = L.flash_attention(tq, tk, tv, causal=True, window=window, chunk_q=4, chunk_k=4)
        want = RL.flash_attention(q, k, v, causal=True, window=window, chunk_q=4, chunk_k=4)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # dense check of the head order: head h against KV head h // 2
    s = torch.einsum("bqhk,bshk->bhqs", tq, tk.repeat_interleave(2, dim=2)) / hd ** 0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -torch.inf)
    dense = torch.einsum("bhqs,bshk->bqhk", s.softmax(-1), tv.repeat_interleave(2, dim=2))
    np.testing.assert_allclose(L.flash_attention(tq, tk, tv).numpy(), dense.numpy(),
                               rtol=1e-5, atol=1e-5)
    valid = np.ones((B, T), bool)
    valid[1] = False
    got = L.decode_attention(tq[:, :1], tk, tv, torch.from_numpy(valid))
    want = RL.decode_attention(q[:, :1], k, v, valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert bool((got[1] == 0).all())


def test_cache_update_and_valid_mask():
    """The mask is taken before the update, with <=; a full cache clamps
    its slot to S - 1; a ring writes slot = pos % S."""
    cfg = get_config("deepseek-7b", reduced=True)
    c = L.init_attn_cache(cfg, 1, 4, torch.float32)
    assert c.window == 0 and L.cache_valid_mask(c)[0].tolist() == [True, False, False, False]
    kv = torch.ones(1, 1, cfg.n_kv, cfg.hd)
    for n in range(6):
        c = L.cache_update(c, kv * (n + 1), kv * (n + 1))
    assert c.length == 6 and float(c.k[0, 3, 0, 0]) == 6.0 and float(c.k[0, 2, 0, 0]) == 3.0
    ring = L.init_attn_cache(cfg, 1, 8, torch.float32, window=4)
    assert ring.window == 4 and ring.k.shape[1] == 4
    for n in range(6):
        ring = L.cache_update(ring, kv * (n + 1), kv * (n + 1))
    assert ring.k[0, :, 0, 0].tolist() == [5.0, 6.0, 3.0, 4.0]
    assert L.cache_valid_mask(ring)[0].all()


def test_mamba2_prefill_length_error(ref):
    """A prefill whose length is not a multiple of ssm_chunk raises, in both
    packages (padding would corrupt the carried state)."""
    model, params = ref.port("mamba2-1.3b")
    cfg = model.cfg
    batch = _batch(cfg, 1, 40, seed=5)             # ssm_chunk 32: 40 pads to 64
    with pytest.raises(ValueError, match="multiple of ssm_chunk"):
        model.prefill(params, _t(batch), model.init_cache(1, 48, torch.float32))
    rmodel, rparams, _ = ref.model("mamba2-1.3b")
    with pytest.raises(ValueError, match="multiple of ssm_chunk"):
        rmodel.prefill(rparams, {"tokens": ref.jnp.asarray(batch["tokens"])},
                       rmodel.init_cache(1, 48, ref.jnp.float32))
    # the same length trains (the pad is harmless without a carried state)
    logits, _ = model.forward_train(params, _t(batch))
    assert logits.shape == (1, 40, cfg.vocab)
    with pytest.raises(ValueError, match="one token"):
        M2.mamba2_apply(unstack(params["layers"])[0]["mamba"],
                        torch.zeros(1, 2, cfg.d_model), cfg, mode="decode",
                        cache=M2.init_ssm_cache(cfg, 1))


def test_top_k_tie_order_and_softplus():
    jax = pytest.importorskip("jax")

    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]], np.float32)
    vals, idx = top_k_lower_index(torch.from_numpy(x), 4)
    rv, ri = jax.lax.top_k(x, 4)
    assert idx.tolist() == np.asarray(ri).tolist() == [[1, 2, 4, 3]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    z = np.linspace(-30, 60, 901, dtype=np.float32)
    np.testing.assert_allclose(M2._softplus(torch.from_numpy(z)).numpy(),
                               np.asarray(jax.nn.softplus(z)), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-7b", "mixtral-8x22b", "mamba2-1.3b",
                                  "zamba2-2.7b", "whisper-tiny", "h2o-danube-1.8b"])
def test_cuda_forward_and_decode_match_the_cpu(arch):
    """The same parameters on the card and on the CPU: forward_train logits
    at 2e-4 (3e-4 with a sliding window), prefill + 4 decode steps too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(arch, reduced=True)
    tol = SWA_TOL if cfg.swa_window else TOL
    gpu = Model(cfg, device="cuda")
    params = gpu.init(torch.Generator("cuda").manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cparams = tree_map(lambda x: x.cpu(), params)
    batch = _batch(cfg, 2, 32, seed=6)
    got, _ = gpu.forward_train(params, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    want, _ = cpu.forward_train(cparams, _t(batch))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=tol, atol=tol)
    got = _port_prefill_decode(gpu, params, batch, 28)
    want = _port_prefill_decode(cpu, cparams, batch, 28)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)
