"""Import and device hygiene of the port: it never loads JAX or the
reference package, and it never runs on the CPU unless asked to."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
                        r"|from\s+repro\b(?!_))", re.MULTILINE)

_SCRIPT = """
import sys
import numpy as np
from repro_torch.core import E2LSHoS, SearchEngine
import repro_torch.baselines, repro_torch.storage, repro_torch.telemetry
import repro_torch.serving, repro_torch.launch.serve, repro_torch.telemetry.http
rng = np.random.default_rng(0)
db = rng.normal(size=(500, 8)).astype(np.float32)
idx = E2LSHoS.build(db, gamma=0.7, max_L=4, device="cpu")
res = SearchEngine(idx, device="cpu").query(db[:5], plan="fused", k=2)
assert res.ids.shape == (5, 2) and res.found.all(), res
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
print("ok")
"""


def test_port_runs_without_importing_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_sources_never_import_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "retrieval_decode_torch.py",
        ROOT / "examples" / "train_lm_torch.py"]
    assert len(files) > 10
    offenders = {str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
                 for f in files}
    assert not {k: v for k, v in offenders.items() if v}
    # the pattern is word-bounded: the port's own name passes, the reference's does not
    assert not _FORBIDDEN.search("from repro_torch.core import x\nimport repro_torch\n")
    assert _FORBIDDEN.search("from repro.core import x")
    assert _FORBIDDEN.search("import jax.numpy as jnp")


def test_default_device_is_cuda_and_never_falls_back():
    from repro_torch.core import E2LSHoS, SearchEngine, build_index, solve_params
    from repro_torch.kernels.dispatch import resolve_device

    db = np.random.default_rng(1).normal(size=(300, 4)).astype(np.float32)
    params = solve_params(300, 4, max_L=2)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert not torch.backends.cuda.matmul.allow_tf32
        return
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        build_index(db, params)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        E2LSHoS.build(db)
    idx = E2LSHoS.build(db, max_L=2, device="cpu")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        SearchEngine(idx)


def test_storage_and_exact_entry_points_default_to_cuda(tmp_path):
    """load_external and exact_knn run on the card by default; without one
    they raise rather than carry on on the host."""
    from repro_torch.baselines import exact_knn
    from repro_torch.core import E2LSHoS
    from repro_torch.storage import load_arrays, load_external

    db = np.random.default_rng(2).normal(size=(300, 4)).astype(np.float32)
    E2LSHoS.build(db, max_L=2, device="cpu").index.spill(tmp_path / "ix.e2l")
    if torch.cuda.is_available():
        with load_external(tmp_path / "ix.e2l", backend="mem") as ext:
            assert ext.device.type == "cuda"
        return
    for call in (lambda: load_external(tmp_path / "ix.e2l", backend="mem"),
                 lambda: load_arrays(tmp_path / "ix.e2l"),
                 lambda: exact_knn(db, db[:3], k=2)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()


def test_serving_entry_points_default_to_cuda(monkeypatch):
    """The queue over a default-device engine and the serve CLI without
    ``--device`` run on the card; without one they raise before doing any
    work on the host."""
    from repro_torch.core import E2LSHoS
    from repro_torch.launch import serve
    from repro_torch.serving import BatchQueue

    if torch.cuda.is_available():
        return
    db = np.random.default_rng(3).normal(size=(300, 4)).astype(np.float32)
    idx = E2LSHoS.build(db, max_L=2, device="cpu")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        BatchQueue(idx, ladder=(4,))
    made = []
    monkeypatch.setattr(serve, "make_dataset", lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        serve.main(["--mode", "ann", "--n", "300", "--queries", "4", "--queue"])
    assert not made


_NEW_MODULES_SCRIPT = """
import sys
import numpy as np
import repro_torch.baselines, repro_torch.core.distributed
from repro_torch.baselines import build_qalsh, build_srs, qalsh_query, srs_query
from repro_torch.core import SearchEngine
from repro_torch.core.distributed import build_sharded_index
rng = np.random.default_rng(0)
db = rng.normal(size=(500, 8)).astype(np.float32)
ids, _, _ = srs_query(build_srs(db, device="cpu"), db[:5], k=2)
assert (ids[:, 0].numpy() == np.arange(5)).all(), ids
ids, _, _, _ = qalsh_query(build_qalsh(db, K=32, device="cpu"), db[:3], k=1)
assert (ids[:, 0].numpy() == np.arange(3)).all(), ids
sh = build_sharded_index(db, 2, gamma=0.7, max_L=4, device="cpu")
res = SearchEngine(sh, device="cpu").query(db[:5], k=2)
assert res.ids.shape == (5, 2) and res.found.all(), res
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
print("ok")
"""


def test_baselines_and_sharded_plan_run_without_importing_jax():
    """``repro_torch.baselines`` (SRS, QALSH) and ``repro_torch.core.distributed``
    import and answer queries with neither JAX nor the reference loaded."""
    out = subprocess.run([sys.executable, "-c", _NEW_MODULES_SCRIPT], capture_output=True,
                         text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_baselines_and_sharded_build_default_to_cuda():
    """SRS, QALSH and the sharded build run on the card by default; without
    one they raise rather than carry on on the host."""
    from repro_torch.baselines import QALSHIndex, SRSIndex, build_qalsh, build_srs
    from repro_torch.core.distributed import build_sharded_index

    db = np.random.default_rng(4).normal(size=(300, 4)).astype(np.float32)
    if torch.cuda.is_available():
        assert build_srs(db).db.device.type == "cuda"
        return
    for call in (lambda: build_srs(db), lambda: build_qalsh(db, K=8),
                 lambda: build_sharded_index(db, 2, max_L=2),
                 lambda: SRSIndex.from_numpy(proj=np.ones((4, 2), np.float32), db=db),
                 lambda: QALSHIndex.from_numpy(proj=np.ones((4, 2), np.float32),
                                               sorted_vals=np.zeros((2, 300), np.float32),
                                               sorted_ids=np.zeros((2, 300), np.int32),
                                               db=db, w=2.0, collision_ratio=0.5)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()


_LM_SCRIPT = """
import sys
import numpy as np
import torch
import repro_torch.configs, repro_torch.models
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import E2LSHoS
from repro_torch.models import Model
from repro_torch.serving import GenerationResult, ServeEngine
cfg = get_config("mamba2-1.3b", reduced=True)
model = Model(cfg, device="cpu")
params = model.init(torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
ds = rng.normal(size=(300, cfg.vocab)).astype(np.float32)
idx = E2LSHoS.build(ds / np.linalg.norm(ds, axis=1, keepdims=True), max_L=4, device="cpu")
eng = ServeEngine(model, params, max_seq=24, cache_dtype=torch.float32, device="cpu",
                  retrieval_fn=ServeEngine.make_retrieval_fn(idx, k=2, device="cpu"))
out = eng.generate({"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))}, steps=3)
assert isinstance(out, GenerationResult) and out.neighbors.shape == (2, 3, 2), out
assert len(ARCH_IDS) == 10
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
print("ok")
"""


def test_lm_stack_runs_without_importing_jax():
    """``repro_torch.models``, ``repro_torch.configs`` and the LM half of
    ``repro_torch.serving`` import and generate (with the retrieval hook)
    with neither JAX nor the reference loaded."""
    out = subprocess.run([sys.executable, "-c", _LM_SCRIPT], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_lm_entry_points_default_to_cuda(monkeypatch):
    """Model, params_from_jax, ServeEngine, make_retrieval_fn and ``--mode lm``
    run on the card by default; without one they raise before doing any work
    on the host."""
    from repro_torch.configs import get_config
    from repro_torch.core import E2LSHoS
    from repro_torch.launch import serve
    from repro_torch.models import Model, params_from_jax
    from repro_torch.serving import ServeEngine

    cfg = get_config("deepseek-7b", reduced=True)
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
        return
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    tree = {k: v for k, v in params.items()}
    db = np.random.default_rng(5).normal(size=(300, 4)).astype(np.float32)
    idx = E2LSHoS.build(db, max_L=2, device="cpu")
    for call in (lambda: Model(cfg), lambda: params_from_jax(tree, cfg),
                 lambda: ServeEngine(cpu_model, params),
                 lambda: ServeEngine.make_retrieval_fn(idx)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
    made = []
    monkeypatch.setattr(serve, "get_config", lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        serve.main(["--mode", "lm", "--arch", "deepseek-7b", "--reduced", "--steps", "2"])
    assert not made


_TRAIN_SCRIPT = """
import sys, tempfile
import torch
import repro_torch.checkpoint, repro_torch.data, repro_torch.training
import repro_torch.launch.train
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline, TokenPipelineState
from repro_torch.models import Model
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
cfg = get_config("h2o-danube-1.8b", reduced=True)
model = Model(cfg, device="cpu")
state = init_train_state(model, torch.Generator().manual_seed(0))
batch, _ = TokenPipeline(cfg.vocab, 16, 2, device="cpu").next_batch(TokenPipelineState())
state, m = make_train_step(model, AdamWConfig())(state, batch)
assert torch.isfinite(m["loss"]) and int(state.step) == 1, m
with tempfile.TemporaryDirectory() as d:
    CheckpointManager(d, async_save=False).save(1, state)
    back, meta = CheckpointManager(d).restore(1, state, device="cpu")
assert meta["step"] == 1 and torch.equal(back.params["embed"]["table"],
                                         state.params["embed"]["table"])
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
print("ok")
"""


def test_training_runs_without_importing_jax():
    """``repro_torch.training``, ``repro_torch.checkpoint``, ``repro_torch.data``
    and ``repro_torch.launch.train`` import, take a CPU step and checkpoint
    it with neither JAX nor the reference loaded."""
    out = subprocess.run([sys.executable, "-c", _TRAIN_SCRIPT], capture_output=True,
                         text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """TokenPipeline, init_train_state's model, CheckpointManager.restore and
    ``launch.train`` without ``--device`` run on the card by default;
    without one they raise before doing any work on the host."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.training import init_train_state

    cfg = get_config("h2o-danube-1.8b", reduced=True)
    if torch.cuda.is_available():
        assert TokenPipeline(cfg.vocab, 8, 2).device.type == "cuda"
        return
    state = init_train_state(Model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, state)
    for call in (lambda: TokenPipeline(cfg.vocab, 8, 2),
                 lambda: init_train_state(Model(cfg), torch.Generator()),
                 lambda: mgr.restore(1, state)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
    made = []
    monkeypatch.setattr(train, "get_config", lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        train.main(["--arch", "h2o-danube-1.8b", "--reduced", "--steps", "2"])
    assert not made


_SHARDING_SCRIPT = """
import sys
import numpy as np
import torch
import repro_torch.configs.common, repro_torch.launch.mesh, repro_torch.launch.steps
import repro_torch.models.sharding
from repro_torch.configs import get_config
from repro_torch.configs.common import input_specs
from repro_torch.core.distributed import RankLayout, build_local_shard, sharded_query_result
from repro_torch.launch.mesh import available_mesh
from repro_torch.launch.steps import abstract_params, batch_logical, named_shardings_for
from repro_torch.models import Model
from repro_torch.models.sharding import AxisRules
mesh = available_mesh()
assert tuple(mesh.shape) == (1, 1), mesh
cfg = get_config("deepseek-7b")
rules, demo = AxisRules.make(mesh), []
tree = named_shardings_for(abstract_params(cfg), Model(cfg, device="cpu").param_specs(1),
                           mesh, rules, demo)
assert tree["embed"]["table"].spec == ("model", "data") and not demo
batch = input_specs(cfg, "train_4k")
assert batch_logical(batch)["tokens"] == ("dp", None)
db = np.random.default_rng(0).normal(size=(400, 8)).astype(np.float32)
local = build_local_shard(db, 2, 1, max_L=4, device="cpu")
assert local.shard_offset == 200 and local.arrays.db.shape[0] == 200
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
print("ok")
"""


def test_sharding_layer_and_ranks_run_without_importing_jax():
    """``models.sharding``, ``launch.mesh``, ``launch.steps``, ``configs.common``
    and the rank-parallel half of ``core.distributed`` import and resolve
    (a full-size parameter tree on meta tensors, a rank's local shard) with
    neither JAX nor the reference loaded."""
    out = subprocess.run([sys.executable, "-c", _SHARDING_SCRIPT], capture_output=True,
                         text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_available_mesh_without_a_group_is_one_device():
    import torch.distributed as dist
    from repro_torch.launch.mesh import available_mesh
    from repro_torch.models.sharding import AxisRules

    assert not dist.is_initialized()
    mesh = available_mesh()
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    rules = AxisRules.make(mesh)
    assert all(rules.mesh_size(ax, mesh) == 1 for ax in ("dp", "fsdp", "tp", "sp"))


def test_multi_rank_serve_needs_a_card_unless_cpu(monkeypatch):
    """Under ``torch.distributed.run`` (WORLD_SIZE > 1) ``--mode ann`` raises
    without a card and without ``--device cpu``, before it joins a group or
    makes any data; ``--store`` other than ram is refused across ranks."""
    import torch.distributed as dist
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        return
    for k, v in dict(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    made = []
    monkeypatch.setattr(serve, "make_dataset", lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        serve.main(["--mode", "ann", "--n", "100"])
    with pytest.raises(ValueError, match="--store ram"):
        serve.main(["--mode", "ann", "--n", "100", "--device", "cpu", "--store", "mem"])
    assert not made and not dist.is_initialized()


_DRYRUN = """
import os, sys
env = dict(os.environ)
import repro_torch.launch.dryrun, repro_torch.launch.hillclimb
assert dict(os.environ) == env, sorted(set(os.environ.items()) ^ set(env.items()))
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
print("ok")
"""


def test_dry_run_modules_load_no_jax_and_set_no_environment():
    """launch.dryrun and launch.hillclimb import neither JAX nor the reference,
    and set no environment variable on import (the reference's dry run sets
    XLA_FLAGS there)."""
    out = subprocess.run([sys.executable, "-c", _DRYRUN], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_dry_run_device_cells_never_fall_back_to_the_host():
    """The queue, external-store and ANN-shard cells run on the card unless
    asked for the CPU; without one they raise instead of recording a run."""
    from repro_torch.launch import dryrun

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is taken")
    for cell in (lambda: dryrun.run_queue_cell(n=1000),
                 lambda: dryrun.run_external_store_cell(store="mem"),
                 lambda: dryrun.run_ann_cell(False, shard_n=1000)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            cell()
