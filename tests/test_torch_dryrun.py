"""The dry run of the port (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), on the CPU.

* ``CollectiveTally`` on a fake world of 4: a ``Shard(0)`` -> ``Replicate()``
  redistribute of a bf16 [128 * 4, 256] DTensor is one all-gather of
  128 * 256 * 2 operand bytes (tests/test_dryrun_unit.py's case for the
  reference's HLO parser).
* ``_depth_variant``'s units and depths, one config of each family, equal
  the reference's.
* Hillclimb cell C's formula fields (C0-C2: ``index_params``,
  ``s_cap_per_shard``, ``analytic_bytes_per_chip``) equal the reference's,
  and C2's real reduced shard serves a uint8 db.
* ``run_external_store_cell(store="mmap")`` on the reference's spilled index
  equals the reference's record in every integer field.

The reference runs in ONE module-scoped subprocess: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for its process. Its ANN cell is
stopped after its formulas (``jax.jit`` raises there), so it compiles
nothing.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILY_ARCHS = ("h2o-danube-1.8b", "granite-moe-3b-a800m", "mamba2-1.3b", "zamba2-2.7b",
                "whisper-tiny")
C_CELLS = (("C0_baseline", "float32", None), ("C1_uint8_db", "uint8", None),
           ("C2_uint8+scap16", "uint8", 16))

_REF = r"""
import json, sys
import jax
from repro.configs import get_config
from repro.launch import dryrun

C = json.loads(sys.argv[1])
out = {"depth": {}, "ann": {}}
for arch in json.loads(sys.argv[2]):
    for k in (1, 2):
        cfg, units = dryrun._depth_variant(get_config(arch), k)
        out["depth"][f"{arch}:{k}"] = [cfg.n_layers, cfg.enc_layers, units]


def stop(*a, **kw):
    raise RuntimeError("formulas only")


jit = jax.jit
jax.jit = stop
for tag, db_dtype, scap in C:
    rec = dryrun.run_ann_cell(False, db_dtype=db_dtype, s_cap_per_shard=scap, tag=tag)
    out["ann"][tag] = {k: rec.get(k) for k in ("index_params", "s_cap_per_shard",
                                               "analytic_bytes_per_chip")}
jax.jit = jit
rec = dryrun.run_external_store_cell(store="mmap")
assert rec["status"] == "OK", rec
out["external"] = rec
# the cell's index, spilled for the port to serve (the families differ)
import numpy as np
from repro.core import E2LSHoS
rng = np.random.default_rng(0)
centers = rng.normal(size=(16, 16)).astype(np.float32)
db = (centers[rng.integers(0, 16, 6000)] + 0.15 * rng.normal(size=(6000, 16))).astype(np.float32)
s = float(np.median(np.linalg.norm(db - db.mean(0), axis=1))) / 3
E2LSHoS.build(db / s, gamma=0.7, s_scale=2.0, max_L=16, seed=0).index.spill(sys.argv[3])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    spill = tmp_path_factory.mktemp("dryrun") / "ref.e2l"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF, json.dumps(C_CELLS),
                           json.dumps(FAMILY_ARCHS), str(spill)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["spill_path"] = str(spill)
    return out


def test_collective_tally_counts_one_all_gather_of_operand_bytes():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.dryrun import CollectiveTally, fake_world

    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        x = distribute_tensor(torch.zeros(128 * 4, 256, dtype=torch.bfloat16), mesh,
                              [Shard(0)], src_data_rank=None)
        with CollectiveTally() as tally:
            y = x.redistribute(mesh, [Replicate()])
        got = tally.result()
    assert tuple(y.to_local().shape) == (512, 256)
    assert got["all-gather"] == 128 * 256 * 2 and got["n_all-gather"] == 1, got
    assert got["total"] == 128 * 256 * 2, got
    assert all(got[f"n_{k}"] == 0 for k in ("all-reduce", "reduce-scatter", "all-to-all",
                                            "collective-permute")), got
    assert got["by_site"] == {"propagation": {"calls": 1, "bytes": 128 * 256 * 2}}, got


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_depth_variant_units_equal_the_reference(reference, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _depth_variant

    for k in (1, 2):
        cfg, units = _depth_variant(get_config(arch), k)
        assert [cfg.n_layers, cfg.enc_layers, units] == reference["depth"][f"{arch}:{k}"]


@pytest.mark.parametrize("tag,db_dtype,scap", C_CELLS)
def test_ann_cell_formulas_equal_the_reference(reference, tag, db_dtype, scap):
    from repro_torch.launch.dryrun import ann_formulas

    got = ann_formulas(1_000_000_000, 128, 256, n_queries=1024, k=10, db_dtype=db_dtype,
                       s_cap_per_shard=scap, fp_dtype="uint16")
    assert {k: got[k] for k in reference["ann"][tag]} == reference["ann"][tag]


def test_ann_cell_serves_a_uint8_shard(reference):
    """Cell C2's record: the reference's formula fields, and its reduced real
    shard (uint8 rows) answered by the sharded oracle plan."""
    from repro_torch.launch.dryrun import run_ann_cell

    tag, db_dtype, scap = C_CELLS[2]
    rec = run_ann_cell(False, db_dtype=db_dtype, s_cap_per_shard=scap, tag=tag,
                       shard_n=2000, device="cpu")
    assert rec["status"] == "OK", rec.get("traceback")
    assert {k: rec[k] for k in reference["ann"][tag]} == reference["ann"][tag]
    assert rec["result"]["db_dtype_served"] == "uint8" and rec["result"]["rows"] == 1024
    assert rec["reduced"]["shard_n"] == 2000 and rec["collectives"]["n_all-gather"] == 1


def test_external_store_cell_equals_the_reference(reference):
    """On the reference's own index (its spill file: the two packages draw
    their hash families from different generators), every integer field of
    the port's record equals the reference's."""
    from repro_torch.launch.dryrun import run_external_store_cell

    want = reference["external"]
    got = run_external_store_cell(store="mmap", device="cpu", spilled=reference["spill_path"])
    assert got["status"] == "OK", got.get("traceback")
    assert got["spill"]["bytes"] == want["spill"]["bytes"]
    assert got["backend_resolved"] == want["backend_resolved"] == "mmap"
    ints = ("measured_nio_blocks", "counters_agree", "device_reads", "prefetch_reads",
            "nio_mean")
    assert {k: got["io"][k] for k in ints} == {k: want["io"][k] for k in ints}
    assert got["io"]["counters_agree"]
    fields = ("t", "active", "blocks", "prefetch_rows")
    assert [{k: r[k] for k in fields} for r in got["rungs"]] == \
        [{k: r[k] for k in fields} for r in want["rungs"]]
