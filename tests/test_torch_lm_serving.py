"""LM serving in the port (``repro_torch.serving.ServeEngine``) against the
reference's (``repro.serving.ServeEngine``), on the CPU at reduced configs.

* ``generate``: greedy tokens equal the reference's on its own parameters
  (carried across by ``params_from_jax``), on mamba2-1.3b and
  h2o-danube-1.8b, and equal run to run.
* The retrieval hook (``make_retrieval_fn``, over the fused plan) on the
  reference's index carried across by ``IndexArrays.from_numpy``: each decode
  step's neighbour ids equal the reference hook's on every row whose query
  hashes agree on both sides; the flip rate (rows whose fp32 projections
  land across a floor() boundary) is reported. The port's hook equals a
  direct fused query on the same normalised rows.
* ``python -m repro_torch.launch.serve --mode lm --device cpu`` in a
  subprocess.
* ``cuda``-marked: generate with retrieval on the card against the CPU.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import E2LSHIndex, E2LSHoS, HashFamily, IndexArrays, LSHParams
from repro_torch.kernels import lsh_hash_all_radii_ref
from repro_torch.models import Model, params_from_jax
from repro_torch.serving import GenerationResult, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


def _carry_index(ref_idx) -> E2LSHoS:
    """The reference's E2LSHoS as the port's (params, family, leaves)."""
    ri = ref_idx.index
    ra, f = ri.arrays, ri.family
    arrays = IndexArrays.from_numpy(
        {n: np.asarray(getattr(ra, n)) for n in IndexArrays.array_fields()},
        block_objs=ra.block_objs, lane_pad=ra.lane_pad, device="cpu")
    family = HashFamily.from_numpy(np.asarray(f.a), np.asarray(f.b), np.asarray(f.rm),
                                   w=f.w, u=f.u, fp_bits=f.fp_bits, device="cpu")
    return E2LSHoS(E2LSHIndex(params=LSHParams(**dataclasses.asdict(ri.params)),
                              family=family, arrays=arrays, stats=None))


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.models import Model as RefModel
    from repro.configs import get_config as ref_get_config
    return jax, RefModel, ref_get_config


@pytest.fixture(scope="module")
def dstore_index(ref):
    """A 2,000-row unit-norm datastore in the reduced vocab's logits space,
    indexed by the reference, and the same index carried into the port."""
    from repro.core import E2LSHoS as RefE2LSHoS

    rng = np.random.default_rng(2)
    ds = rng.normal(size=(2000, 256)).astype(np.float32)
    ds /= np.linalg.norm(ds, axis=1, keepdims=True)
    ref_idx = RefE2LSHoS.build(ds, gamma=0.8, max_L=8, seed=1)
    return ref_idx, _carry_index(ref_idx)


def _engines(ref, arch, *, ref_hook=None, hook=None, dtype="float32"):
    """The reference's and the port's engines on the same parameters, with
    activations and caches in ``dtype``."""
    jax, RefModel, ref_get_config = ref
    from repro.serving import ServeEngine as RefServeEngine

    rcfg = dataclasses.replace(ref_get_config(arch, reduced=True), dtype=dtype)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    params = params_from_jax(rparams, cfg, device="cpu")
    reng = RefServeEngine(RefModel(rcfg), rparams, max_seq=64,
                          cache_dtype=jax.numpy.dtype(dtype), retrieval_fn=ref_hook)
    eng = ServeEngine(Model(cfg, device="cpu"), params, max_seq=64,
                      cache_dtype=getattr(torch, dtype), retrieval_fn=hook, device="cpu")
    return reng, eng


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "h2o-danube-1.8b"])
def test_generate_matches_reference(ref, arch):
    reng, eng = _engines(ref, arch)
    toks = _tokens(eng.model.cfg, 2, 16, seed=0)
    want = reng.generate({"tokens": ref[0].numpy.asarray(toks)}, steps=6)
    got = eng.generate({"tokens": torch.from_numpy(toks)}, steps=6)
    assert isinstance(got, GenerationResult) and got.neighbors is None
    assert got.tokens.shape == (2, 6) and got.tokens.dtype == torch.int32
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits_last.numpy(), np.asarray(want.logits_last),
                               rtol=2e-4, atol=2e-4)
    again = eng.generate({"tokens": torch.from_numpy(toks)}, steps=6)
    assert torch.equal(again.tokens, got.tokens)


@pytest.mark.parametrize("arch", ["deepseek-7b", "mixtral-8x22b", "mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_bf16_generate_matches_reference(ref, arch, capsys):
    """bf16 activations and caches, as served: greedy tokens equal the
    reference's over 6 steps, and the last logits are within 8 bf16 spacings
    of their scale (the bound of tests/test_torch_models.py)."""
    reng, eng = _engines(ref, arch, dtype="bfloat16")
    toks = _tokens(eng.model.cfg, 2, 16, seed=0)
    batch = {"tokens": toks}
    if eng.model.cfg.family == "encdec":
        batch["frames"] = np.random.default_rng(1).normal(
            size=(2, eng.model.cfg.enc_frames, eng.model.cfg.d_model)).astype(np.float32)
    want = reng.generate({k: ref[0].numpy.asarray(v) for k, v in batch.items()}, steps=6)
    got = eng.generate({k: torch.from_numpy(v) for k, v in batch.items()}, steps=6)
    assert got.logits_last.dtype == torch.bfloat16 and str(want.logits_last.dtype) == "bfloat16"
    w = np.asarray(want.logits_last, np.float32)
    diff = float(np.abs(got.logits_last.float().numpy() - w).max())
    bound = 8 * 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    with capsys.disabled():
        print(f"\n[bf16 generate] {arch}: tokens equal "
              f"{bool((got.tokens.numpy() == np.asarray(want.tokens)).all())} "
              f"logits_last max|d| {diff:.4f} bound {bound:.4f}")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert diff < bound


def test_retrieval_hook_matches_reference(ref, dstore_index, capsys):
    """Each decode step's neighbours equal the reference hook's on rows
    whose query hashes agree on both sides; the flip rate is reported."""
    import jax.numpy as jnp
    from repro.kernels.lsh_hash.ops import lsh_hash_all_radii as ref_hash
    from repro.serving import ServeEngine as RefServeEngine

    ref_idx, idx = dstore_index
    seen = []
    hook = ServeEngine.make_retrieval_fn(idx, k=4, device="cpu")

    def recording_hook(hidden):
        seen.append(hidden.clone())
        return hook(hidden)

    reng, eng = _engines(ref, "h2o-danube-1.8b",
                         ref_hook=RefServeEngine.make_retrieval_fn(ref_idx, k=4),
                         hook=recording_hook)
    toks = _tokens(eng.model.cfg, 4, 16, seed=1)
    want = reng.generate({"tokens": jnp.asarray(toks)}, steps=5)
    got = eng.generate({"tokens": torch.from_numpy(toks)}, steps=5)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.neighbors.shape == (4, 5, 4) and got.neighbors.dtype == torch.int32
    # which rows hashed alike: the port's plain hash vs the reference's
    h = torch.stack(seen, dim=1).reshape(-1, 256)                  # [B * steps, V]
    hn = h / torch.clamp_min(torch.linalg.vector_norm(h, dim=1, keepdim=True), 1e-9)
    p, fam = ref_idx.params, ref_idx.index.family
    kw = dict(w=p.w, radii=p.radii, u=fam.u, fp_bits=fam.fp_bits)
    bk, fp = lsh_hash_all_radii_ref(hn, idx.index.family.a, idx.index.family.b,
                                    idx.index.family.rm, **kw)
    rbk, rfp = ref_hash(jnp.asarray(hn.numpy()), fam.a, fam.b, fam.rm, **kw)
    agree = ((bk.numpy() == np.asarray(rbk)) & (fp.numpy() == np.asarray(rfp))).all(axis=(0, 2))
    ids = got.neighbors.reshape(-1, 4).numpy()
    want_ids = np.asarray(want.neighbors).reshape(-1, 4)
    with capsys.disabled():
        print(f"\n[retrieval parity] rows={agree.size} hashes_agree={int(agree.sum())} "
              f"flip_rate={1 - agree.mean():.4f} "
              f"ids_equal_overall={int((ids == want_ids).all(axis=1).sum())}")
    assert agree.mean() > 0.5
    np.testing.assert_array_equal(ids[agree], want_ids[agree])
    # the hook is a fused query on the normalised rows
    direct = idx.engine.query(hn, plan="fused", k=4)
    np.testing.assert_array_equal(ids, direct.ids.numpy())


@pytest.mark.parametrize("argv,lines", [
    (["--arch", "mamba2-1.3b", "--steps", "4", "--batch", "2", "--seq", "16", "--retrieval",
      "--dstore", "2000", "--k", "4"],
     ["generated (2, 4)", "retrieved neighbors per step: (2, 4, 4)"]),
    (["--arch", "whisper-tiny", "--steps", "3", "--batch", "1", "--seq", "8"],
     ["generated (1, 3)"]),
])
def test_serve_cli_lm_mode_on_the_cpu(argv, lines):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm", "--device", "cpu",
           "--reduced"] + argv
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    for line in lines:
        assert line in out.stdout, out.stdout
    assert "sample:" in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-1.3b"])
def test_cuda_generate_with_retrieval_matches_the_cpu(arch):
    """The same parameters and datastore on the card and on the CPU: equal
    tokens; equal neighbours on every step whose kernel hashes equal the
    plain hashes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import lsh_hash_all_radii

    cfg = get_config(arch, reduced=True)
    gpu = Model(cfg, device="cuda")
    params = gpu.init(torch.Generator("cuda").manual_seed(0))

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()

    rng = np.random.default_rng(3)
    ds = rng.normal(size=(2000, cfg.vocab)).astype(np.float32)
    ds /= np.linalg.norm(ds, axis=1, keepdims=True)
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=4))
    outs, seen = {}, []
    for dev, p in (("cuda", params), ("cpu", to_cpu(params))):
        idx = E2LSHoS.build(ds, gamma=0.8, max_L=8, seed=1, device=dev)
        hook = ServeEngine.make_retrieval_fn(idx, k=4, device=dev)
        if dev == "cuda":
            def hook(hidden, _hook=hook):
                seen.append(hidden.float())
                return _hook(hidden)
            fam, p_idx = idx.index.family, idx.params
        eng = ServeEngine(Model(cfg, device=dev), p, max_seq=32, cache_dtype=torch.float32,
                          retrieval_fn=hook, device=dev)
        outs[dev] = eng.generate({"tokens": toks.to(dev)}, steps=4)
    assert torch.equal(outs["cuda"].tokens.cpu(), outs["cpu"].tokens)
    h = torch.stack(seen, dim=1).reshape(-1, cfg.vocab)
    h = h / torch.clamp_min(torch.linalg.vector_norm(h, dim=1, keepdim=True), 1e-9)
    kw = dict(w=p_idx.w, radii=p_idx.radii, u=fam.u, fp_bits=fam.fp_bits)
    bk, fp = lsh_hash_all_radii(h, fam.a, fam.b, fam.rm, **kw)
    bk_p, fp_p = lsh_hash_all_radii_ref(h, fam.a, fam.b, fam.rm, **kw)
    agree = ((bk == bk_p) & (fp == fp_p)).all(dim=2).all(dim=0).cpu().numpy()
    ids = outs["cuda"].neighbors.reshape(-1, 4).cpu().numpy()
    want = outs["cpu"].neighbors.reshape(-1, 4).numpy()
    np.testing.assert_array_equal(ids[agree], want[agree])
