"""The LM train step over a ``torch.distributed`` mesh (``repro_torch.launch.steps``
``place_tree``, the shard hints, ``models.sharding.on_mesh``), on a (data 2,
model 2) mesh of four ``gloo`` ranks on the CPU: one spawn of four processes
(a ``file://`` rendezvous, as tests/test_torch_training_dp.py) runs every
check in turn and rank 0 writes the results. ``_RANK`` also serves
tests/test_torch_mesh_cells.py (build_cell's cells, the elastic checkpoint).

* Meshes whose model dim does not divide a head count ((1, 4) and (2, 2)
  against 4/2, 6/6 and 3/3 heads): train, prefill and decode against one
  process at the same bounds.
* ``launch.dryrun.CollectiveTally`` counts the same before and after
  ``launch.mesh.sync_collectives`` swaps c10d calls in, and the dry run of a
  train cell on a fake world counts what a real step of it tallied.

* The train step of one reduced arch per family (h2o-danube-1.8b,
  granite-moe-3b-a800m, mamba2-1.3b, zamba2-2.7b, whisper-tiny), on the
  state and batch placed by their logical-axis specs (FSDP over data, TP
  over model), equals the port's one-process step at the reference's
  bounds (tests/test_distributed.py: |d loss| < 2e-5, max |d param| <
  2e-4; the global grad norm within 1e-5 relative; each leaf's gradient
  within 2e-4 of its max |g|, a bound the gradients of half the batch
  exceed), with remat "full", with "dots", and with microbatch 2; every
  leaf keeps the placements ``named_shardings_for`` gives it, on the
  mesh's device.

A ``cuda``-marked case runs the numerics part of chip_smoke.py's
``[train_mesh]`` (h2o-danube-1.8b at full width, 2 layers, fp32) on four
ranks sharing the card.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
FAMILY_ARCHS = ("h2o-danube-1.8b", "granite-moe-3b-a800m", "mamba2-1.3b", "zamba2-2.7b",
                "whisper-tiny")
VARIANTS = ("full", "dots", "microbatch")
LOSS_TOL = 2e-5            # the reference's bounds (tests/test_distributed.py)
PARAM_TOL = 2e-4
GNORM_RTOL = 1e-5          # the global grad norm, summed in another order
GRAD_TOL = 2e-4            # each leaf's gradient, of its max |g|

_RANK = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline, TokenPipelineState
from repro_torch.launch.mesh import make_test_mesh, sync_collectives
from repro_torch.launch.steps import (batch_logical, build_cell, gather_tree,
                                      named_shardings_for, place_tree, run_cell,
                                      train_state_logical)
from repro_torch.models import Model
from repro_torch.models.config import ShapeSpec
from repro_torch.models.sharding import AxisRules, on_mesh
from repro_torch.training import AdamWConfig, init_train_state, loss_and_grads, make_train_step
from repro_torch.training.optimizer import tree_leaves

rank, world, init, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
conf = json.loads(sys.argv[5])
dev = torch.device(conf["device"], 0) if conf["device"] == "cuda" else torch.device("cpu")
if dev.type == "cuda":
    torch.cuda.set_device(dev)
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
if dev.type == "cuda":
    sync_collectives("cuda")     # four ranks sharing the card over gloo
mesh = make_test_mesh(2, 2, device_type=dev.type)
rules = AxisRules.make(mesh)
OPT = AdamWConfig(lr=1e-3, total_steps=10)
res = {}


def batch_for(cfg, B, T, seed):
    batch, _ = TokenPipeline(cfg.vocab, T, B, seed=seed, device=dev).next_batch(
        TokenPipelineState())
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)).to(dev)
    return batch


def grad_err(got, want):
    # max over leaves of |got - want| max / max(want's max |g|, 1e-3 of the
    # largest leaf's): a leaf whose gradient is zero in exact arithmetic
    # holds rounding noise on both sides
    top = max(float(w.abs().max()) for w in tree_leaves(want))
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3 * top)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def train_case(name, cfg, B, T, microbatch=0, planted=False, mesh=mesh):
    # one process's gradients and step, then the same on the mesh, from
    # seed 0's state; the gradients of half the batch are the planted fault.
    # Under microbatch the whole batch's gradients are remat "full"'s: not
    # taken again
    model = Model(cfg, device=dev)
    batch = batch_for(cfg, B, T, seed=1)
    s1 = init_train_state(model, torch.Generator(dev).manual_seed(0))
    whole = not microbatch
    g1 = loss_and_grads(model, s1.params, batch)[1] if whole else None
    half = planted and loss_and_grads(model, s1.params,
                                      {k: v[:B // 2] for k, v in batch.items()})[1]
    one, m1 = make_train_step(model, OPT, microbatch=microbatch)(s1, batch)
    state = init_train_state(model, torch.Generator(dev).manual_seed(0))
    rules = AxisRules.make(mesh)
    sh = named_shardings_for(state, train_state_logical(model.param_specs(
        rules.mesh_size("tp", mesh))), mesh, rules)
    state = place_tree(state, sh)
    placed = place_tree(batch, named_shardings_for(batch, batch_logical(batch), mesh, rules))
    with on_mesh(rules):
        g2 = loss_and_grads(model, state.params, placed)[1] if whole else None
        state, m2 = make_train_step(model, OPT, microbatch=microbatch)(state, placed)
    leaves = tree_leaves(state.params) + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)
    want = tree_leaves(sh.params) + tree_leaves(sh.opt.mu) + tree_leaves(sh.opt.nu)
    res[name] = dict(
        dloss=abs(float(m1["loss"]) - float(m2["loss"])),
        dparam=max(float((a.full_tensor() - b).abs().max())
                   for a, b in zip(tree_leaves(state.params), tree_leaves(one.params))),
        dgnorm=abs(float(m1["grad_norm"]) - float(m2["grad_norm"])),
        gnorm=float(m1["grad_norm"]),
        dgrad=grad_err(gather_tree(g2), g1) if whole else None,
        planted=grad_err(half, g1) if planted else None,
        placements=all(isinstance(a, DTensor) and tuple(a.placements) == tuple(s.placements)
                       for a, s in zip(leaves, want)),
        sharded=sum(any(p.is_shard() for p in a.placements) for a in leaves),
        devices=sorted({a.to_local().device.type for a in leaves}))
    return state


for arch in conf.get("family_archs", []):
    for variant in conf["variants"]:
        cfg = get_config(arch, reduced=True)
        cfg = dataclasses.replace(cfg, remat="full" if variant == "microbatch" else variant)
        T = max(64, cfg.ssm_chunk) if cfg.family in ("ssm", "hybrid") else 64
        state = train_case(f"{arch}:{variant}", cfg, 4, T, 2 if variant == "microbatch" else 0,
                           planted=variant == "full")
        if arch == "h2o-danube-1.8b" and variant == "full" and conf.get("checkpoint"):
            saved = state

if conf.get("full_width"):
    # chip_smoke.py's [train_mesh] numerics: full width, 2 layers, fp32
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), n_layers=2, dtype="float32")
    train_case("full_width", cfg, 2, 256, planted=True)

if conf.get("cells"):
    cfg = dataclasses.replace(get_config("mixtral-8x22b", reduced=True), dtype="bfloat16",
                              remat="full")
    cell = build_cell(cfg, "train_4k", mesh, shape=ShapeSpec("train_4k", 256, 8, "train"))
    model = Model(cfg, device=dev)
    _, m = run_cell(cell, init_train_state(model, torch.Generator(dev).manual_seed(0)),
                    batch_for(cfg, 8, 256, seed=2))
    res["mixtral_train_cell"] = dict(loss=float(m["loss"]), name=cell.name,
                                     demotions=len(cell.demotions))

    cfg = get_config("deepseek-7b", reduced=True)
    B, T, S = 4, 64, 80
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    pre = build_cell(cfg, "prefill_32k", mesh, shape=ShapeSpec("prefill", S, B, "prefill"))
    dec = build_cell(cfg, "decode_32k", mesh, shape=ShapeSpec("decode", S, B, "decode"))
    batch = {"tokens": batch_for(cfg, B, T, seed=3)["tokens"]}
    lg, cache = model.prefill(params, batch, model.init_cache(B, S, torch.float32))
    got, dcache = run_cell(pre, params, batch, model.init_cache(B, S, torch.float32))
    errs, same = [float((got.full_tensor() - lg).abs().max() / lg.abs().max())], []
    cache_placed = all(isinstance(c.k, DTensor) and tuple(c.k.placements) == tuple(s.k.placements)
                       for c, s in zip(dcache.attn, pre.in_shardings[2].attn))
    dparams = place_tree(params, dec.in_shardings[0])
    tok = lg.argmax(-1).int()
    for _ in range(4):
        lg, cache = model.decode_step(params, tok, cache)
        got, dcache = run_cell(dec, dparams, tok, dcache)
        full = got.full_tensor()
        errs.append(float((full - lg).abs().max() / lg.abs().max()))
        same.append(bool(torch.equal(full.argmax(-1), lg.argmax(-1))))
        tok = lg.argmax(-1).int()
    res["serve_cells"] = dict(err=max(errs), tokens_equal=all(same), cache_placed=cache_placed)

def serve_case(name, cfg, mesh, B=4, T=64, S=80):
    # prefill and 4 greedy decode steps of build_cell's cells against one
    # process: logits of their max |.|, tokens equal
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    pre = build_cell(cfg, "prefill_32k", mesh, shape=ShapeSpec("prefill", S, B, "prefill"))
    dec = build_cell(cfg, "decode_32k", mesh, shape=ShapeSpec("decode", S, B, "decode"))
    batch = {"tokens": batch_for(cfg, B, T, seed=3)["tokens"]}
    if cfg.family == "encdec":
        batch["frames"] = batch_for(cfg, B, T, seed=3)["frames"]
    lg, cache = model.prefill(params, batch, model.init_cache(B, S, torch.float32))
    got, dcache = run_cell(pre, params, batch, model.init_cache(B, S, torch.float32))
    errs, same = [float((got.full_tensor() - lg).abs().max() / lg.abs().max())], []
    dparams = place_tree(params, dec.in_shardings[0])
    tok = lg[:, -1:].argmax(-1).int()
    for _ in range(4):
        lg, cache = model.decode_step(params, tok, cache)
        got, dcache = run_cell(dec, dparams, tok, dcache)
        full = got.full_tensor()
        errs.append(float((full - lg).abs().max() / lg.abs().max()))
        same.append(bool(torch.equal(full.argmax(-1), lg.argmax(-1))))
        tok = lg.argmax(-1).int()
    res[name] = dict(err=max(errs), tokens_equal=all(same))


if conf.get("narrow"):
    # meshes whose tp does not divide a head count (the projections' local
    # blocks): (1, 4) against the reduced h2o-danube-1.8b (4 heads, 2 KV)
    # and 6 x 6 heads; (2, 2) against 3 x 3 heads, which DTensor's einsum
    # could not unflatten before
    narrow = {"1x4": make_test_mesh(1, 4, device_type=dev.type), "2x2": mesh}
    six = dict(n_heads=6, n_kv=6)
    three = dict(n_heads=3, n_kv=3, head_dim=16)
    for tag, arch, heads in (("1x4", "h2o-danube-1.8b", {}), ("1x4", "whisper-tiny", six),
                             ("2x2", "granite-moe-3b-a800m", three)):
        cfg = dataclasses.replace(get_config(arch, reduced=True), **heads)
        name = f"narrow:{tag}:{arch}"
        train_case(name + ":train", cfg, 4, 64, planted=True, mesh=narrow[tag])
        serve_case(name + ":serve", cfg, narrow[tag])

if conf.get("tally"):
    # the collective tally: DTensor's functional collectives, then the same
    # redistributions with sync_collectives' c10d kernels swapped in (last:
    # the swap lasts for the process), count alike
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import CollectiveTally

    def tallied():
        x = distribute_tensor(torch.ones(16, 8), mesh, [Shard(0), Shard(1)], src_data_rank=None)
        z = DTensor.from_local(torch.ones(16, 8), mesh, [Partial(), Replicate()])
        with CollectiveTally() as t:
            y = x.redistribute(mesh, [Replicate(), Replicate()])     # two all-gathers
            z.redistribute(mesh, [Shard(0), Replicate()])             # a reduce-scatter
        return t.result(), float(y.to_local().sum())

    res["tally"] = dict(functional=tallied())
    # one train step of a cell, tallied: the dry run of the same cell on a
    # fake world of 4 must count the same
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    cell = build_cell(cfg, "train_4k", mesh, shape=ShapeSpec("t", 64, 4, "train"), opt_cfg=OPT)
    state = init_train_state(Model(cfg, device=dev), torch.Generator(dev).manual_seed(0))
    with CollectiveTally() as t:
        run_cell(cell, state, batch_for(cfg, 4, 64, seed=1))
    res["tally"]["step"] = t.result()
    sync_collectives("cpu")
    res["tally"]["c10d"] = tallied()

if conf.get("checkpoint"):
    ck = CheckpointManager(out_dir + "/ckpt", async_save=False)
    ck.save(1, saved, extra={"pipeline": {"step": 1}})
    want = gather_tree(saved)
    mesh41 = make_test_mesh(4, 1, device_type=dev.type)
    rules41 = AxisRules.make(mesh41)
    model = Model(get_config("h2o-danube-1.8b", reduced=True), device=dev)
    sh41 = named_shardings_for(saved, train_state_logical(model.param_specs(1)), mesh41,
                               rules41)
    got, meta = ck.restore(1, saved, shardings=sh41)
    placements = [tuple(a.placements) == tuple(s.placements)
                  for a, s in zip(tree_leaves(got.params), tree_leaves(sh41.params))]
    leaves = lambda t: tree_leaves(t.params) + tree_leaves(t.opt.mu) + tree_leaves(t.opt.nu) + [
        t.opt.step, t.step]
    equal41 = all(torch.equal(a.full_tensor(), b) for a, b in zip(leaves(got), leaves(want)))
    res["checkpoint"] = dict(equal_4x1=equal41, placements_4x1=all(placements),
                             meta=meta, sharded_4x1=sum(
                                 any(p.is_shard() for p in a.placements)
                                 for a in tree_leaves(got.params)))
    if rank == 0:
        plain, _ = ck.restore(1, want, device="cpu")
        res["checkpoint"]["equal_one_process"] = all(
            torch.equal(a, b.cpu()) for a, b in zip(leaves(plain), leaves(want)))
        from repro_torch.checkpoint.manager import _flatten_with_paths
        np.savez(out_dir + "/want.npz", **{k: t.cpu().numpy()
                                            for k, t in _flatten_with_paths(want).items()})

dist.barrier()
if rank == 0:
    with open(out_dir + "/res.json", "w") as f:
        json.dump(res, f)
dist.destroy_process_group()
"""


def spawn(tmp, conf, timeout=300):
    """Four ranks of ``_RANK`` with ``conf``; rank 0's results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(WORLD),
                               f"file://{tmp / 'rendezvous'}", str(tmp), json.dumps(conf)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return json.loads((tmp / "res.json").read_text())


NARROW = ("1x4:h2o-danube-1.8b", "1x4:whisper-tiny", "2x2:granite-moe-3b-a800m")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("mesh"),
                  dict(device="cpu", family_archs=FAMILY_ARCHS, variants=VARIANTS, narrow=True,
                       tally=True))


def hold_step(r, what):
    assert r["dloss"] < LOSS_TOL and r["dparam"] < PARAM_TOL, (what, r)
    assert r["dgnorm"] <= GNORM_RTOL * r["gnorm"], (what, r)
    assert r["placements"] and r["sharded"] > 0, (what, r)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_on_the_mesh_matches_one_process(ranks, arch, variant):
    r = ranks[f"{arch}:{variant}"]
    hold_step(r, (arch, variant))
    assert r["devices"] == ["cpu"], r
    if variant != "microbatch":      # its whole-batch gradients are "full"'s
        assert r["dgrad"] <= GRAD_TOL, r


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_gradient_check_fails_a_planted_fault(ranks, arch):
    """The gradients of half the batch, held to the whole batch's, exceed
    the gradient bound: the check can fail."""
    r = ranks[f"{arch}:full"]
    assert r["planted"] > GRAD_TOL, r


@pytest.mark.parametrize("case", NARROW)
def test_heads_tp_does_not_divide_match_one_process(ranks, case):
    """Meshes whose model dim does not divide a projection's head count: the
    train step (gradients, grad norm, step) and the prefill and decode cells
    equal one process, and the planted fault fails the gradient check."""
    r = ranks[f"narrow:{case}:train"]
    hold_step(r, case)
    assert r["dgrad"] <= GRAD_TOL < r["planted"], r
    s = ranks[f"narrow:{case}:serve"]
    assert s["err"] < 2e-4 and s["tokens_equal"], s


def test_collective_tally_counts_c10d_swap_as_functional(ranks):
    """CollectiveTally counts the explicit c10d calls of
    launch.mesh.sync_collectives as the functional collectives they stand
    for: the same kinds, calls and operand bytes."""
    (fn, fsum), (c10d, csum) = ranks["tally"]["functional"], ranks["tally"]["c10d"]
    assert fn == c10d and fsum == csum == 128.0, (fn, c10d)
    # [8, 4] fp32 gathered over one mesh dim, then [16, 4] or [8, 8] over the
    # other; [16, 8] reduce-scattered
    assert fn["n_all-gather"] == 2 and fn["n_reduce-scatter"] == 1, fn
    assert fn["all-gather"] == 8 * 4 * 4 + 16 * 4 * 4 and fn["total"] == 896, fn


def test_dry_run_counts_the_collectives_of_a_real_step(ranks):
    """The dry run of a train cell (fake tensors on a fake world of 4) counts
    the collectives, kind by kind in calls and operand bytes, that rank 0 of
    the same cell's real step on four gloo ranks tallied."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import KINDS, fake_world, lower_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training import AdamWConfig

    with fake_world(WORLD):
        mesh = make_test_mesh(2, 2, device_type="cpu")
        cell = build_cell(get_config("h2o-danube-1.8b", reduced=True), "train_4k", mesh,
                          shape=ShapeSpec("t", 64, 4, "train"),
                          opt_cfg=AdamWConfig(lr=1e-3, total_steps=10))
        dry = lower_cell(cell)["collectives"]
    real = ranks["tally"]["step"]
    assert real["total"] > 0
    assert {k: (dry[f"n_{k}"], dry[k]) for k in KINDS} == \
        {k: (real[f"n_{k}"], real[k]) for k in KINDS}


@pytest.mark.cuda
def test_train_mesh_numerics_on_four_ranks_sharing_the_card(tmp_path):
    """chip_smoke.py's [train_mesh] numerics: h2o-danube-1.8b at full width,
    2 layers, fp32, B = 2, T = 256, one step on the (2, 2) mesh of four gloo
    ranks on cuda:0 against the one-process step on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = spawn(tmp_path, dict(device="cuda", variants=[], full_width=True), timeout=600)
    r = r["full_width"]
    hold_step(r, "full width")
    assert r["devices"] == ["cuda"] and r["dgrad"] <= GRAD_TOL < r["planted"], r
