"""``launch.steps.build_cell`` and the elastic checkpoint over a mesh.

* ``build_cell``'s in_shardings, leaf for leaf, and its demotions equal the
  reference's ``build_cell`` for the 10 archs x 4 shapes on an abstract
  16 x 16 mesh (no process group: an ``AbstractMesh`` on both sides). The
  port's caches are per-layer lists: each layer's spec is the reference's
  stacked spec without its leading layer axes, and the demotions follow
  the layers (as tests/test_torch_sharding.py holds ``named_shardings_for``).
* On four gloo ranks on the CPU (tests/test_torch_mesh_ranks.py's
  ``_RANK``, a (data 2, model 2) mesh): build_cell's mixtral train cell
  (reduced, bf16, remat "full", a 256 x 8 train shape: the counterpart of
  tests/test_distributed.py's test_build_cell_lowers_on_test_mesh) runs one
  step with a finite loss; build_cell's prefill and decode cells for
  deepseek-7b (reduced): a 64-token prefill and 4 decode steps within 2e-4
  of their max |.| of the one-process prefill and decode_step, greedy
  tokens equal, the caches placed by ``cache_specs``; a checkpoint saved
  from the mesh restores with ``shardings=`` onto a (4, 1) mesh and in one
  process, equal leaf for leaf, and the reference's ``CheckpointManager``
  reads the file to the same leaves.
"""
import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.steps import build_cell
from repro_torch.models.sharding import AbstractMesh, NamedSharding
from test_torch_mesh_ranks import spawn

LOGIT_TOL = 2e-4           # of the logits' max |.|


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cells")
    return tmp, spawn(tmp, dict(device="cpu", family_archs=["h2o-danube-1.8b"],
                                variants=["full"], cells=True, checkpoint=True))


def test_build_cell_mixtral_train_cell_runs_one_step(ranks):
    r = ranks[1]["mixtral_train_cell"]
    assert np.isfinite(r["loss"]) and r["name"] == "mixtral-8x22b:train_4k:train", r


def test_prefill_and_decode_cells_match_one_process(ranks):
    r = ranks[1]["serve_cells"]
    assert r["err"] < LOGIT_TOL and r["tokens_equal"] and r["cache_placed"], r


def test_checkpoint_from_the_mesh_restores_elsewhere(ranks):
    """Onto a (4, 1) mesh and in one process, equal leaf for leaf; the
    reference's manager reads the file to the same leaves."""
    tmp, res = ranks
    r = res["checkpoint"]
    assert r["equal_4x1"] and r["placements_4x1"] and r["sharded_4x1"] > 0, r
    assert r["equal_one_process"] and r["meta"] == {"step": 1, "extra": {"pipeline": {"step": 1}}}
    jax = pytest.importorskip("jax")
    from repro.checkpoint import CheckpointManager as RefManager
    from repro.checkpoint.manager import _flatten_with_paths
    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    from repro.training import init_train_state

    like = jax.eval_shape(lambda k: init_train_state(
        RefModel(ref_config("h2o-danube-1.8b", reduced=True)), k), jax.random.PRNGKey(0))
    got, meta = RefManager(tmp / "ckpt").restore(1, like)
    assert meta["step"] == 1
    got = _flatten_with_paths(got)
    want = np.load(tmp / "want.npz")
    assert sorted(got) == sorted(want.files)
    for k in want.files:
        assert np.array_equal(np.asarray(got[k]), want[k]), k


# --------------------------------------------------------------------------
# build_cell against the reference's, on an abstract 16 x 16 mesh
# --------------------------------------------------------------------------

def _flat(tree, path=""):
    """(path, physical axes per dim) of a port sharding tree, in the order
    ``named_shardings_for`` walks it."""
    if isinstance(tree, NamedSharding):
        yield path, [list(a) if isinstance(a, tuple) else a for a in tree.spec]
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            yield from _flat(getattr(tree, f), f"{path}/{f}")


def _demotion(d):
    s, a, p, dim = d
    return [list(s), a, list(p) if isinstance(p, tuple) else p, dim]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_cell_shardings_match_the_reference(arch):
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh as JaxAbstractMesh
    from repro.configs import get_config as ref_config
    from repro.launch.steps import build_cell as ref_build_cell
    from repro.models.sharding import AxisRules as RefRules
    from test_torch_sharding import _leaf_demotions, _ref_cell, _specs_by_path

    ref_mesh = JaxAbstractMesh((16, 16), ("data", "model"))
    mesh = AbstractMesh((16, 16), ("data", "model"))
    rules = RefRules.make(ref_mesh)
    cfg = get_config(arch)
    for shape_name, spec in SHAPES.items():
        cell = build_cell(cfg, shape_name, mesh)
        rcell = ref_build_cell(ref_config(arch), shape_name, ref_mesh)
        parts = _ref_cell(ref_mesh, rules, arch, shape_name)   # each part's demotions
        names = (("state", "batch") if spec.kind == "train" else
                 ("params", "batch" if spec.kind == "prefill" else "tokens", "cache"))
        assert cell.name == rcell.name and len(cell.in_shardings) == len(rcell.in_shardings)
        expect_demotions = []
        for name, got, want_sh, want_sds in zip(names, cell.in_shardings, rcell.in_shardings,
                                                rcell.in_sds):
            where = (arch, shape_name, name)
            if name == "tokens":
                got, want_sh, want_sds = {"t": got}, {"t": want_sh}, {"t": want_sds}
            want = _specs_by_path(want_sh, want_sds)
            got = dict(_flat(got))
            if name != "cache":
                assert got == want, where
                continue
            per_leaf = _leaf_demotions(parts["cache"]["sds"], parts["cache"]["logical"],
                                       ref_mesh, rules)
            want = {k: v for k, v in want.items() if not k.endswith("/length")}
            seen = set()
            for path, sp in got.items():
                bits = path.split("/")[1:]
                n = 2 if (cfg.family == "hybrid" and bits[0] == "ssm") else 1
                key = "/" + "/".join([bits[0]] + bits[1 + n:])
                seen.add(key)
                assert sp == want[key][n:], (where, path)
                expect_demotions.append([[s[n:], a, ph, d] for s, a, ph, d in per_leaf[key]])
            assert seen == set(want), where
        # demotions in build order: batch, then the state or params, cache, tokens
        order = ["batch", "state"] if spec.kind == "train" else ["batch", "params", "cache"]
        if spec.kind == "decode":
            order.append("tokens")
        want_demotions = []
        for part in order:
            if part == "cache":
                want_demotions += [d for leaf in expect_demotions for d in leaf]
            else:
                want_demotions += parts[part]["demotions"]
        assert [_demotion(d) for d in cell.demotions] == want_demotions, (arch, shape_name)
