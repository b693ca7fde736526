"""LM training in the port (``repro_torch.data``, ``repro_torch.training``,
``repro_torch.checkpoint``, ``repro_torch.launch.train``) against the
reference's, on the CPU at reduced configs in fp32, both sides on the same
parameters.

* ``TokenPipeline``: batches equal the reference's bit for bit.
* ``loss_and_grads``: the loss and every leaf's gradient equal
  ``jax.value_and_grad`` of the reference's ``loss_fn`` within 2e-4 of the
  leaf's max |g| (the forward's bound, tests/test_torch_models.py), floored
  at 1e-3 of the largest leaf's max: an attention key bias has a zero
  gradient in exact arithmetic (it shifts every score of a query equally),
  so both sides hold rounding noise there. The flash loop's gradients
  through key chunks that mask a whole row (its ``-inf`` guards) too.
* ``adamw_update`` on identical gradients equals the reference's (params,
  moments, lr, grad norm within 1e-6 of each leaf's max), clipping on and
  off. Whole runs are held by their loss trajectory, not by parameters:
  Adam's first steps are about ``lr * sign(g)``, so a gradient near zero
  that differs in its last bits can move a parameter by 2 lr.
* ``make_train_step``: 5 steps' losses against the reference's jitted step;
  microbatch 4 == 0 (1e-5, as tests/test_training.py); ``remat="full"``
  equal to ``"none"``; bf16 gradients no further from fp32 than 1.5x the
  reference's own bf16 error.

Checkpoints and the launcher are in ``test_torch_train_checkpoint.py``, the
per-arch one-step checks in ``test_torch_train_archs_*.py`` and the
data-parallel step in ``test_torch_training_dp.py``.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline, TokenPipelineState
from repro_torch.models import Model, params_from_jax
from repro_torch.models import layers as L
from repro_torch.training import (AdamWConfig, TrainState, adamw_update,
                                  init_opt_state, init_train_state, loss_and_grads,
                                  make_train_step)
from repro_torch.training.optimizer import global_norm, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-4          # gradients, per leaf, of the leaf's max |g| (the forward's bound)
ZERO_GRAD_FLOOR = 1e-3   # of the largest leaf's max: leaves whose gradient is 0 exactly
ADAM_TOL = 1e-6     # adamw_update on identical gradients


# ---------------------------------------------------------------------------
# shared with test_torch_train_archs_*.py
# ---------------------------------------------------------------------------

def train_batch(cfg, B, T, *, seed=0, step=0):
    """The port's pipeline batch as numpy (equal to the reference's), plus
    frames from a numpy seed for the encoder-decoder."""
    batch, _ = TokenPipeline(cfg.vocab, T, B, seed=seed, device="cpu").next_batch(
        TokenPipelineState(step))
    out = {k: v.numpy() for k, v in batch.items()}
    if cfg.family == "encdec":
        out["frames"] = np.random.default_rng(seed).normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def flat(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict, keys sorted (jax's leaf order)."""
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor)
                                    else tree)}


def grad_errors(got, want):
    """{leaf: |Δ|max / max(leaf's max |g|, floor)} of two gradient trees."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - want[k]).max())
            / max(float(np.abs(want[k]).max()), ZERO_GRAD_FLOOR * top) for k in want}


def assert_grads_close(got, want, tol=TOL, label=""):
    errs = grad_errors(got, want)
    worst = max(errs, key=errs.get)
    print(f"{label} worst gradient leaf {worst}: {errs[worst]:.3e} of its max (tol {tol})")
    assert errs[worst] <= tol, (label, worst, errs[worst])
    return errs[worst]


class _Reference:
    """The reference's model per (arch, config changes, key): the params
    made once per (arch, key) and held by both sides (the port's init as
    numpy: tracing the reference's init would cost seconds an arch), its
    ``value_and_grad`` of ``loss_fn`` jitted once per config."""

    def __init__(self):
        self.jax = pytest.importorskip("jax")
        self.jnp = self.jax.numpy
        from repro.configs import get_config as ref_get_config
        from repro.models import Model as RefModel
        import repro.training as RT
        self.RT, self._get_config, self._Model, self._memo = RT, ref_get_config, RefModel, {}

    def model(self, arch, key=0, **changes):
        memo_key = (arch, key, tuple(sorted(changes.items())))
        if memo_key not in self._memo:
            if (arch, key) not in self._memo:
                own = Model(get_config(arch, reduced=True), device="cpu").init(
                    torch.Generator().manual_seed(key))
                self._memo[arch, key] = tree_map(lambda t: t.numpy(), own)
            model = self._Model(dataclasses.replace(self._get_config(arch, reduced=True),
                                                    **changes))
            vg = self.jax.jit(self.jax.value_and_grad(
                lambda p, b: self.RT.loss_fn(model, p, b)))
            self._memo[memo_key] = (model, self._memo[arch, key], vg)
        return self._memo[memo_key]

    def value_and_grad(self, arch, batch, key=0, **changes):
        _, params, vg = self.model(arch, key, **changes)
        loss, grads = vg(params, {k: self.jnp.asarray(v) for k, v in batch.items()})
        return float(loss), self.jax.tree.map(np.asarray, grads)

    def port(self, arch, key=0, **changes):
        """The port's model on the CPU with the same parameters, carried by
        ``params_from_jax`` (every name and shape checked)."""
        _, params, _ = self.model(arch, key, **changes)
        cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
        return Model(cfg, device="cpu"), params_from_jax(params, cfg, device="cpu")

    def train_step(self, arch, **opt):
        """The reference's jitted ``make_train_step`` at the given AdamW
        settings (traced once per arch and settings)."""
        memo_key = ("step", arch, tuple(sorted(opt.items())))
        if memo_key not in self._memo:
            model, _, _ = self.model(arch)
            self._memo[memo_key] = self.jax.jit(
                self.RT.make_train_step(model, self.RT.AdamWConfig(**opt)))
        return self._memo[memo_key]

    def global_norm(self, grads):
        return float(self.RT.optimizer.global_norm(grads))


@pytest.fixture(scope="module")
def ref():
    return _Reference()


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,num_shards,shard", [(0, 0, 1, 0), (9, 3, 1, 0),
                                                         (9, 3, 2, 1), (5, 17, 4, 2)])
def test_pipeline_batches_equal_the_reference_bit_for_bit(seed, step, num_shards, shard):
    from repro.data import TokenPipeline as RefPipeline
    from repro.data import TokenPipelineState as RefState

    want, ws = RefPipeline(1000, 32, 8, seed=seed, num_shards=num_shards,
                           shard=shard).next_batch(RefState(step))
    got, gs = TokenPipeline(1000, 32, 8, seed=seed, num_shards=num_shards, shard=shard,
                            device="cpu").next_batch(TokenPipelineState(step))
    assert gs.to_dict() == ws.to_dict() == {"step": step + 1}
    for k in ("tokens", "targets", "mask"):
        assert got[k].dtype == {"mask": torch.float32}.get(k, torch.int32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert TokenPipelineState.from_dict(gs.to_dict()) == gs
    with pytest.raises(ValueError, match="multiple"):
        TokenPipeline(1000, 32, 7, num_shards=2, device="cpu")


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,T", [("deepseek-7b", 32), ("h2o-danube-1.8b", 64)])
def test_loss_and_grads_match_the_reference(ref, arch, T):
    """h2o at T = 64 runs its 32-token sliding window past its end."""
    model, params = ref.port(arch)
    batch = train_batch(model.cfg, 2, T, seed=1)
    want_loss, want = ref.value_and_grad(arch, batch)
    loss, grads = loss_and_grads(model, params, torch_batch(batch))
    assert loss.dtype == torch.float32 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert all(g.dtype == torch.float32 for g in flat_tensors(grads))
    assert_grads_close(grads, want, label=arch)
    np.testing.assert_allclose(float(global_norm(grads)), ref.global_norm(want), rtol=1e-5)
    # the masters gained no requires_grad and no .grad
    assert not any(p.requires_grad or p.grad is not None
                   for p in flat_tensors(params))


def flat_tensors(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_tensors(tree[k])]
    return [tree]


def test_flash_attention_grads_through_fully_masked_chunk_rows(ref):
    """Chunks of 8 with an 8-token window: the last rows of each query chunk
    find every key of the chunk before masked (the m_safe / corr guards).
    Gradients are finite and equal the reference's (its unroll_q=True path)."""
    jax, jnp = ref.jax, ref.jnp
    from repro.models import layers as RL
    rng = np.random.default_rng(3)
    q, k, v, cot = (rng.normal(size=s).astype(np.float32) for s in
                    ((2, 32, 4, 8), (2, 32, 2, 8), (2, 32, 2, 8), (2, 32, 4, 8)))
    kw = dict(causal=True, window=8, chunk_q=8, chunk_k=8)

    def ref_loss(q, k, v):
        return jnp.sum(RL.flash_attention(q, k, v, unroll_q=True, **kw) * cot)
    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = L.flash_attention(qt, kt, vt, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (qt, kt, vt))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the optimizer on shared gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip_norm", [1e3, 0.05])
def test_adamw_update_matches_the_reference_on_the_same_grads(ref, clip_norm):
    """Four updates through warm-up into the cosine, each on the same fresh
    gradients on both sides; at clip_norm 0.05 every step clips."""
    jax = ref.jax
    RO = ref.RT.optimizer
    rng = np.random.default_rng(4)
    shapes = flat(Model(get_config("deepseek-7b", reduced=True), device="cpu").init(
        torch.Generator().manual_seed(0)))
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip_norm)

    def nest(d):
        out = {}
        for k, v in d.items():
            node = out
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
        return out

    params = nest({k: rng.normal(size=v.shape).astype(np.float32) for k, v in shapes.items()})
    rparams, rstate = params, RO.init_opt_state(params)
    pparams = tree_map(torch.from_numpy, params)
    pstate = init_opt_state(pparams)
    ref_update = jax.jit(RO.adamw_update, static_argnums=3)
    for _ in range(4):
        grads = nest({k: (rng.normal(size=v.shape) * 0.1).astype(np.float32)
                      for k, v in shapes.items()})
        rparams, rstate, rm = ref_update(rparams, grads, rstate, RO.AdamWConfig(**cfg))
        # adamw_update clips its gradients in place: hand it copies (jax may
        # read the numpy buffers after its call returns)
        pparams, pstate, pm = adamw_update(pparams, tree_map(torch.tensor, grads), pstate,
                                           AdamWConfig(**cfg))
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), rtol=ADAM_TOL)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=ADAM_TOL)
        assert int(pstate.step) == int(rstate.step) and pstate.step.dtype == torch.int32
        for got, want in ((pparams, rparams), (pstate.mu, rstate.mu), (pstate.nu, rstate.nu)):
            g, w = flat(got), flat(jax.tree.map(np.asarray, want))
            for key in w:
                assert np.abs(g[key] - w[key]).max() <= ADAM_TOL * np.abs(w[key]).max(), key
    if clip_norm < 1:
        assert float(rm["grad_norm"]) > clip_norm


def test_global_norm_holds_on_a_large_leaf():
    """A 16 M-element fp32 leaf: the global norm within 1e-6 of float64 (the
    CPU's fp32 ``torch.linalg.vector_norm`` is ~7e-4 off here, and ~1e-2 at
    an 82 M-element embedding table's gradient)."""
    g = torch.randn(4096, 4096, generator=torch.Generator().manual_seed(0)) * 1e-3
    tree = {"big": g, "small": {"w": g[:3, :5].clone()}}
    want = float(torch.sqrt((g.double() ** 2).sum() + (g[:3, :5].double() ** 2).sum()))
    assert abs(float(global_norm(tree)) - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

TRAJ_OPT = dict(lr=2e-3, total_steps=40, warmup_steps=5)


def test_five_step_loss_trajectory_matches_the_reference(ref):
    RT = ref.RT
    arch = "h2o-danube-1.8b"
    _, rparams, _ = ref.model(arch)
    model, params = ref.port(arch)
    opt = TRAJ_OPT
    rstep = ref.train_step(arch, **opt)
    rstate = RT.TrainState(params=rparams, opt=RT.init_opt_state(rparams),
                           step=ref.jnp.zeros((), ref.jnp.int32))
    step = make_train_step(model, AdamWConfig(**opt))
    state = TrainState(params=params, opt=init_opt_state(params),
                       step=torch.zeros((), dtype=torch.int32))
    got, want = [], []
    for i in range(5):
        batch = train_batch(model.cfg, 8, 32, step=i)
        rstate, rm = rstep(rstate, {k: ref.jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, torch_batch(batch))
        want.append([float(rm[k]) for k in ("loss", "grad_norm", "lr")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    print("loss trajectory", [g[0] for g in got], [w[0] for w in want])
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)
    assert int(state.step) == int(state.opt.step) == 5
    assert got[-1][0] < got[0][0]


def _port_state(arch="deepseek-7b", seed=1, **changes):
    model = Model(dataclasses.replace(get_config(arch, reduced=True), **changes), device="cpu")
    return model, init_train_state(model, torch.Generator().manual_seed(seed))


def test_microbatch_equals_the_whole_batch():
    model, s1 = _port_state()
    _, s2 = _port_state()
    batch = torch_batch(train_batch(model.cfg, 8, 64))
    opt = AdamWConfig(lr=1e-3, total_steps=10)
    s1, m1 = make_train_step(model, opt, microbatch=0)(s1, batch)
    s2, m2 = make_train_step(model, opt, microbatch=4)(s2, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    diffs = [float((a - b).abs().max()) for a, b in
             zip(flat_tensors(s1.params), flat_tensors(s2.params))]
    assert max(diffs) < 1e-5
    with pytest.raises(ValueError, match="multiple"):
        make_train_step(model, opt, microbatch=3)(s1, batch)


def test_remat_full_equals_none():
    """Activation checkpointing changes no number: the loss, every gradient
    and the updated parameters are equal, on a dense, a hybrid and an
    encoder-decoder arch (the three checkpointed bodies); "dots" on the
    dense one."""
    for arch in ("h2o-danube-1.8b", "zamba2-2.7b", "whisper-tiny"):
        out = {}
        modes = ("none", "full", "dots") if arch == "h2o-danube-1.8b" else ("none", "full")
        for remat in modes:
            model, state = _port_state(arch, remat=remat)
            batch = torch_batch(train_batch(model.cfg, 2, 32))
            loss, grads = loss_and_grads(model, state.params, batch)
            state, _ = make_train_step(model, AdamWConfig(lr=1e-3))(state, batch)
            out[remat] = (loss, flat_tensors(grads), flat_tensors(state.params))
        for remat in set(out) - {"none"}:
            assert torch.equal(out[remat][0], out["none"][0]), (arch, remat)
            for a, b in zip(out[remat][1] + out[remat][2], out["none"][1] + out["none"][2]):
                assert torch.equal(a, b), (arch, remat)
    with pytest.raises(ValueError, match="remat"):
        model, state = _port_state(remat="some")
        loss_and_grads(model, state.params, torch_batch(train_batch(model.cfg, 2, 8)))


def test_bf16_gradients_no_further_from_fp32_than_the_reference(ref):
    """deepseek-7b's reduced config with bf16 activations: the port's
    gradients against its own fp32 run, leaf by leaf, no further than 1.5x
    the reference's bf16 gradients from the reference's fp32 run."""
    arch = "deepseek-7b"
    model32, params = ref.port(arch)
    model16, _ = ref.port(arch, dtype="bfloat16")
    batch = train_batch(model32.cfg, 2, 32, seed=2)
    _, want32 = ref.value_and_grad(arch, batch)
    _, want16 = ref.value_and_grad(arch, batch, dtype="bfloat16")
    _, got32 = loss_and_grads(model32, params, torch_batch(batch))
    _, got16 = loss_and_grads(model16, params, torch_batch(batch))
    port_err = max(grad_errors(got16, got32).values())
    ref_err = max(grad_errors(want16, want32).values())
    print(f"bf16 gradient error vs fp32: port {port_err:.4e}, reference {ref_err:.4e}")
    assert 0 < port_err <= 1.5 * ref_err


# ---------------------------------------------------------------------------
# shared with test_torch_train_archs_*.py: one step per arch
# ---------------------------------------------------------------------------

def one_step_matches_the_reference(ref, arch, T=32):
    """One step at the arch's reduced config on the reference's params: the
    loss and every gradient against ``jax.value_and_grad``, and the step's
    loss, grad norm and lr against the reference's."""
    model, params = ref.port(arch)
    batch = train_batch(model.cfg, 2, T, seed=5)
    want_loss, want = ref.value_and_grad(arch, batch)
    loss, grads = loss_and_grads(model, params, torch_batch(batch))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert_grads_close(grads, want, label=arch)
    state = TrainState(params=params, opt=init_opt_state(params),
                       step=torch.zeros((), dtype=torch.int32))
    state, m = make_train_step(model, AdamWConfig())(state, torch_batch(batch))
    got = [float(m[k]) for k in ("loss", "grad_norm", "lr")]
    lr = float(ref.RT.optimizer.lr_at(ref.jnp.ones((), ref.jnp.int32),
                                      ref.RT.AdamWConfig()))
    np.testing.assert_allclose(got, [want_loss, ref.global_norm(want), lr], rtol=1e-5)
    assert int(state.step) == 1


def card_step_matches_the_cpu(arch, T=32):
    """The same parameters and batch on the card and on the CPU: the loss,
    every gradient (2e-4 of each leaf's max) and the step's grad norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(arch, reduced=True)
    gpu = Model(cfg, device="cuda")
    params = gpu.init(torch.Generator("cuda").manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cparams = tree_map(lambda x: x.cpu(), params)
    batch = train_batch(cfg, 2, T, seed=6)
    lg, gg = loss_and_grads(gpu, params, torch_batch(batch, "cuda"))
    lc, gc = loss_and_grads(cpu, cparams, torch_batch(batch))
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    assert_grads_close(gg, gc, label=f"{arch} card vs cpu")
    np.testing.assert_allclose(float(global_norm(gg)), float(global_norm(gc)), rtol=1e-5)
