"""The LM stack's logical-axis sharding layer (``repro_torch.models.sharding``,
``launch.mesh``, ``launch.steps``, the spec functions and
``configs.common.input_specs``), held to the reference's on the CPU:

* ``AxisRules`` on no mesh, (data, model) and (pod, data, model): rules,
  ``resolve``, ``mesh_size`` and ``logical_spec`` equal the reference's
  (``jax.sharding.AbstractMesh``, no devices);
* ``param_specs`` and ``cache_specs`` of the 10 archs at full config for
  tp_size 0, 1, 4 and 16, leaf for leaf (the port's caches are per-layer
  lists: each layer's spec is the reference's stacked spec without its
  leading layer axes);
* ``named_shardings_for`` over every arch x ``SHAPES`` cell as the
  reference's ``build_cell`` resolves it (batch, train state or bf16
  parameters, cache, decode tokens), on 16 x 16 and 2 x 16 x 16: the port
  on a ``DeviceMesh`` over a fake process group in a subprocess, the
  reference on an ``AbstractMesh``; the physical axes of every leaf and the
  demotion lists equal;
* ``batch_logical`` and ``input_specs``'s shapes and dtypes;
* placements over tuple axes give every device the block the reference's
  ``NamedSharding.devices_indices_map`` gives it on a (2, 2, 2) mesh (one
  JAX subprocess with 8 host devices).
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.common import input_specs
from repro_torch.launch.steps import batch_logical
from repro_torch.models import Model
from repro_torch.models.sharding import (AbstractMesh, AxisRules, SINGLE_DEVICE_RULES,
                                         divisible, logical_spec, named_sharding,
                                         placements_for)

jax = pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGICAL = ("dp", "fsdp", "tp", "sp", "shard")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TP_SIZES = (0, 1, 4, 16)
# tuple-axis cases on the (2, 2, 2) ("pod", "data", "model") mesh
BLOCK_CASES = (
    ((8, 12), (("pod", "data"), "model")),
    ((16, 6), (("pod", "data", "model"), None)),
    ((4, 8), ("data", ("pod", "model"))),
    ((6, 8, 2), (None, ("data", "model"), None)),
    ((2, 4), ("pod", None)),
)


def _ref_mesh(name):
    from jax.sharding import AbstractMesh as JaxAbstractMesh
    shape, names = MESHES[name]
    return JaxAbstractMesh(shape, names)


@pytest.mark.parametrize("fsdp_over_pod", [False, True])
@pytest.mark.parametrize("mesh_name", [None, *MESHES])
def test_axis_rules_match_the_reference(mesh_name, fsdp_over_pod):
    from repro.models.sharding import AxisRules as RefRules
    if mesh_name is None:
        ref, port, mesh, ref_mesh = RefRules.make(None), AxisRules.make(None), None, None
        assert port == SINGLE_DEVICE_RULES
    else:
        ref_mesh = _ref_mesh(mesh_name)
        mesh = AbstractMesh(*MESHES[mesh_name])
        ref = RefRules.make(ref_mesh, fsdp_over_pod=fsdp_over_pod)
        port = AxisRules.make(mesh, fsdp_over_pod=fsdp_over_pod)
    assert port.rules == ref.rules
    for ax in LOGICAL:
        assert port.resolve(ax) == ref.resolve(ax), ax
        if mesh is not None:
            assert port.mesh_size(ax, mesh) == ref.mesh_size(ax, ref_mesh), ax
    from repro.models.sharding import logical_spec as ref_logical_spec
    for axes in (("fsdp", "tp", None), ("dp", None, "sp", "tp"), ("shard",), ()):
        assert logical_spec(axes, port) == tuple(ref_logical_spec(axes, ref))
    from repro.models.sharding import divisible as ref_divisible
    for dim in (1, 8, 32, 48):
        for ax in ("dp", "tp", "fsdp"):
            assert divisible(dim, ax, mesh, port) == ref_divisible(dim, ax, ref_mesh, ref)
    if mesh is not None:
        ns = named_sharding(mesh, ("dp", "tp"), port)
        assert ns.spec == (port.resolve("dp"), "model")


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh(*MESHES["2x16x16"])
    assert placements_for(mesh, (("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert placements_for(mesh, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements_for(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="shards two dims"):
        placements_for(mesh, ("model", "model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.models.model import Model as RefModel
    ref, port = RefModel(ref_config(arch)), Model(get_config(arch), device="cpu")
    for tp in TP_SIZES:
        assert port.param_specs(tp) == ref.param_specs(tp), tp


def _check_attn(ref, layers, lead):
    assert all(c.k == ref.k[lead:] and c.v == ref.v[lead:] and c.length == ()
               and c.window == ref.window for c in layers)


def _check_ssm(ref, layers, lead):
    assert all(c.state == ref.state[lead:] and c.conv == ref.conv[lead:] and c.length == ()
               for c in layers)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_the_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.models.model import Model as RefModel
    cfg = get_config(arch)
    ref, port = RefModel(ref_config(arch)), Model(cfg, device="cpu")
    for tp in TP_SIZES:
        for seq in (0, 2048, 32768):
            r, p = ref.cache_specs(tp, seq), port.cache_specs(tp, seq)
            if cfg.family == "hybrid":
                assert len(p.attn) == len(p.ssm) == cfg.n_layers // cfg.shared_attn_every
                _check_attn(r.attn, p.attn, 1)
                _check_ssm(r.ssm, [c for group in p.ssm for c in group], 2)
            elif cfg.family == "encdec":
                assert len(p.self_attn) == cfg.n_layers
                _check_attn(r.self_attn, p.self_attn, 1)
                assert p.cross_k == p.cross_v == [r.cross_k[1:]] * cfg.n_layers
            else:
                for name, check in (("attn", _check_attn), ("ssm", _check_ssm)):
                    rr, pp = getattr(r, name), getattr(p, name)
                    assert (rr is None) == (pp is None), name
                    if rr is not None:
                        assert len(pp) == cfg.n_layers
                        check(rr, pp, 1)


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_input_specs_and_batch_logical_match_the_reference(shape_name):
    from repro.configs import get_config as ref_config
    from repro.configs.common import input_specs as ref_input_specs
    from repro.launch.steps import batch_logical as ref_batch_logical
    for arch in ARCH_IDS:
        port = input_specs(get_config(arch), shape_name)
        ref = ref_input_specs(ref_config(arch), shape_name)
        assert sorted(port) == sorted(ref)
        for k, v in port.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), (arch, k)
            assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), (arch, k)
        assert batch_logical(port) == ref_batch_logical(ref)


# --------------------------------------------------------------------------
# named_shardings_for on the production meshes, and per-device blocks
# --------------------------------------------------------------------------

_PORT = """
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.common import input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (abstract_cache, abstract_params, batch_logical,
                                      named_shardings_for)
from repro_torch.models import Model
from repro_torch.models.sharding import AxisRules, NamedSharding, placements_for
from repro_torch.training.optimizer import OptState
from repro_torch.training.train_step import TrainState


def flat(tree, path=""):
    if isinstance(tree, NamedSharding):
        yield path, [list(a) if isinstance(a, tuple) else a for a in tree.spec]
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat(v, f"{path}/{i}")
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            yield from flat(getattr(tree, f), f"{path}/{f}")


def cell(mesh, rules, cfg, shape_name):
    spec = SHAPES[shape_name]
    model = Model(cfg, device="cpu")
    tp = rules.mesh_size("tp", mesh)
    out = {}

    def part(name, tensors, logical):
        demo = []
        tree = named_shardings_for(tensors, logical, mesh, rules, demo)
        out[name] = dict(specs=dict(flat(tree)), demotions=demo)

    batch = input_specs(cfg, shape_name)
    part("batch", batch, batch_logical(batch))
    params, pspec = abstract_params(cfg), model.param_specs(tp)
    if spec.kind == "train":
        step = torch.empty((), dtype=torch.int32, device="meta")
        part("state", TrainState(params=params, opt=OptState(mu=params, nu=params, step=step),
                                 step=step),
             TrainState(params=pspec, opt=OptState(mu=pspec, nu=pspec, step=()), step=()))
        return out
    part("params", params, pspec)
    B, T = spec.global_batch, spec.seq_len
    part("cache", abstract_cache(cfg, B, T, cfg.activation_dtype), model.cache_specs(tp, T))
    if spec.kind == "decode":
        part("tokens", {"t": batch["tokens"]}, {"t": ("dp", None)})
    return out


res = {"cells": {}, "blocks": []}
for name, multi_pod in (("16x16", False), ("2x16x16", True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = AxisRules.make(mesh)
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            res["cells"][f"{name}:{arch}:{shape_name}"] = cell(mesh, rules, get_config(arch),
                                                               shape_name)
    dist.destroy_process_group()
cases = json.loads(sys.argv[1])
for r in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=r, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    for shape, spec in cases:
        spec = [tuple(a) if isinstance(a, list) else a for a in spec]
        size, off = compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                          placements_for(mesh, spec))
        res["blocks"].append(dict(coord=list(mesh.get_coordinate()), shape=shape,
                                  block=[[o, o + s] for o, s in zip(off, size)]))
    if r == 0:   # shard_hint: the identity without rules, a redistribute with them
        from torch.distributed.tensor import Replicate, distribute_tensor
        from repro_torch.models.sharding import set_active_rules, shard_hint
        x = distribute_tensor(torch.zeros(8, 12), mesh, [Replicate()] * 3)
        res["hint_inactive"] = shard_hint(x, "dp", "tp") is x
        set_active_rules(AxisRules.make(mesh))
        y = shard_hint(x, "dp", "tp")
        res["hint"] = dict(placements=[repr(p) for p in y.placements],
                           local=list(y.to_local().shape),
                           replicated_is_identity=shard_hint(x, None, None) is x,
                           plain_is_identity=shard_hint(torch.zeros(3), "dp").shape == (3,))
        set_active_rules(None)
    dist.destroy_process_group()
print(json.dumps(res))
"""

_REF_BLOCKS = """
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
devices = np.array(jax.devices()).reshape(2, 2, 2)
mesh = Mesh(devices, ("pod", "data", "model"))
out = []
for shape, spec in json.loads(sys.argv[1]):
    spec = [tuple(a) if isinstance(a, list) else a for a in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    for coord in np.ndindex(2, 2, 2):
        sl = idx[devices[coord]]
        out.append(dict(coord=list(coord), shape=shape,
                        block=[[s.start or 0, s.stop if s.stop is not None else n]
                               for s, n in zip(sl, shape)]))
print(json.dumps(out))
"""


def _run(code, *args, env=None):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  OMP_NUM_THREADS="1", **(env or {})))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_run():
    return _run(_PORT, json.dumps(BLOCK_CASES))


def _paths(tree, is_leaf=None):
    """(path, leaf) of a reference tree, paths written as the port's."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return [("".join("/" + str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", ""))))
                     for k in kp), leaf) for kp, leaf in leaves]


def _ref_cell(mesh, rules, arch, shape_name):
    """The reference's build_cell sharding sequence, part by part."""
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.configs.common import input_specs as ref_input_specs
    from repro.launch.steps import batch_logical as ref_batch_logical
    from repro.launch.steps import named_shardings_for as ref_named
    from repro.models.config import SHAPES as REF_SHAPES
    from repro.models.model import Model as RefModel
    from repro.training.optimizer import OptState
    from repro.training.train_step import TrainState, init_train_state

    cfg = ref_config(arch)
    spec = REF_SHAPES[shape_name]
    model = RefModel(cfg)
    tp = rules.mesh_size("tp", mesh)
    key = jax.random.PRNGKey(0)
    out = {}

    def part(name, sds, logical):
        demo = []
        tree = ref_named(sds, logical, mesh, rules, demo)
        out[name] = dict(tree=tree, sds=sds, logical=logical,
                         demotions=[[list(s), a, list(p) if isinstance(p, tuple) else p, d]
                                    for s, a, p, d in demo])

    batch = ref_input_specs(cfg, shape_name)
    part("batch", batch, ref_batch_logical(batch))
    pspec = model.param_specs(tp)
    if spec.kind == "train":
        state = jax.eval_shape(lambda k: init_train_state(model, k), key)
        part("state", state, TrainState(params=pspec, opt=OptState(mu=pspec, nu=pspec, step=()),
                                        step=()))
        return out
    params = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, cfg.activation_dtype)
                          if s.dtype == jnp.float32 else s, jax.eval_shape(model.init, key))
    part("params", params, pspec)
    B, T = spec.global_batch, spec.seq_len
    part("cache", jax.eval_shape(lambda: model.init_cache(B, T, cfg.activation_dtype)),
         model.cache_specs(tp, T))
    if spec.kind == "decode":
        part("tokens", {"t": batch["tokens"]}, {"t": ("dp", None)})
    return out


def _specs_by_path(tree, sds):
    """{path: physical axes per dim} of a reference sharding tree (the spec
    padded with None to the leaf's rank, as the port writes it)."""
    from jax.sharding import NamedSharding as RefNamed
    shapes = jax.tree_util.tree_leaves(sds)
    out = {}
    for (path, ns), s in zip(_paths(tree, is_leaf=lambda x: isinstance(x, RefNamed)), shapes):
        spec = tuple(ns.spec) + (None,) * (len(s.shape) - len(ns.spec))
        out[path] = [list(a) if isinstance(a, tuple) else a for a in spec]
    return out


def _leaf_demotions(sds, logical, mesh, rules):
    """{path: the reference's demotions of that leaf alone}."""
    from repro.launch.steps import named_shardings_for as ref_named
    specs = dict(_paths(logical, is_leaf=lambda x: isinstance(x, tuple)))
    out = {}
    for path, leaf in _paths(sds):
        demo = []
        ref_named({"x": leaf}, {"x": specs[path]}, mesh, rules, demo)
        out[path] = [[list(s), a, list(p) if isinstance(p, tuple) else p, d]
                     for s, a, p, d in demo]
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_named_shardings_match_the_reference(port_run, mesh_name):
    from repro.models.sharding import AxisRules as RefRules
    ref_mesh = _ref_mesh(mesh_name)
    rules = RefRules.make(ref_mesh)
    cells, demoted = 0, {"cache": 0, "other": 0}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            ref = _ref_cell(ref_mesh, rules, arch, shape_name)
            port = port_run["cells"][f"{mesh_name}:{arch}:{shape_name}"]
            assert sorted(port) == sorted(ref), (arch, shape_name)
            for name, r in ref.items():
                p = port[name]
                want = _specs_by_path(r["tree"], r["sds"])
                where = (mesh_name, arch, shape_name, name)
                demoted["cache" if name == "cache" else "other"] += len(p["demotions"])
                if name != "cache":
                    assert p["specs"] == want, where
                    assert p["demotions"] == r["demotions"], where
                    continue
                # per-layer lists: the reference's /f/leaf stacks the port's
                # /f/i/leaf (hybrid SSM: /ssm/g/l/leaf) under as many leading
                # axes as list indices; lengths are host ints in the port
                per_leaf = _leaf_demotions(r["sds"], r["logical"], ref_mesh, rules)
                want = {k: v for k, v in want.items() if not k.endswith("/length")}
                seen, expect = set(), []
                for path, spec in p["specs"].items():
                    parts = path.split("/")[1:]
                    n = 2 if (cfg.family == "hybrid" and parts[0] == "ssm") else 1
                    key = "/" + "/".join([parts[0]] + parts[1 + n:])
                    seen.add(key)
                    assert spec == want[key][n:], (where, path)
                    expect += [[s[n:], a, ph, d] for s, a, ph, d in per_leaf[key]]
                assert seen == set(want), where
                assert p["demotions"] == expect, where
                assert sum(len(v) for v in per_leaf.values()) == len(r["demotions"]), where
            cells += 1
    assert cells == len(ARCH_IDS) * len(SHAPES)
    assert demoted["cache"] > 0 and demoted["other"] > 0, demoted   # both paths exercised


def test_tuple_axis_blocks_match_the_reference(port_run):
    ref = _run(_REF_BLOCKS, json.dumps(BLOCK_CASES),
               env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
                    "JAX_PLATFORMS": "cpu"})
    key = lambda b: (b["shape"], b["coord"])   # noqa: E731
    assert sorted(port_run["blocks"], key=key) == sorted(ref, key=key)
    assert len(ref) == 8 * len(BLOCK_CASES)


def test_shard_hint_redistributes_a_dtensor_only_under_active_rules(port_run):
    from torch.distributed.tensor import Shard
    assert port_run["hint_inactive"]
    h = port_run["hint"]
    assert h["placements"] == [repr(Shard(0)), repr(Shard(0)), repr(Shard(1))]
    assert h["local"] == [2, 6]          # 8 rows over pod x data, 12 columns over model
    assert h["replicated_is_identity"] and h["plain_is_identity"]
