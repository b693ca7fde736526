"""The dry run's LM cells (``repro_torch.launch.dryrun.run_cell``) on a fake
16 x 16 world of 256 ranks, on the CPU.

* h2o-danube-1.8b ``train_4k``: its inputs' bytes on a rank, from the
  placements alone at full depth, are the reference's
  ``memory.argument_bytes`` (143,419,400); ``decode_32k``'s are the
  reference's less its 24 cache lengths (4 bytes each), which the port keeps
  as host ints.
* ``run_cell`` at one layer reads OK: its per-device FLOPs times 256 are
  within 2 % of the analytic count of chip_smoke.py's ``train_flops`` at one
  layer, and the collectives split by site add up to their total.
"""
import dataclasses
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "h2o-danube-1.8b"


def _train_flops():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.train_flops


@pytest.mark.parametrize("shape,want", [("train_4k", 143_419_400),
                                        ("decode_32k", 149_601_408 - 24 * 4)])
def test_argument_bytes_from_the_placements(shape, want):
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cell_argument_bytes, fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell

    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        assert cell_argument_bytes(build_cell(get_config(ARCH), shape, mesh)) == want


def test_train_cell_at_one_layer():
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.sharding import SITES

    rec = run_cell(ARCH, "train_4k", False, depth=1)
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["depth"] == 1
    assert rec["memory"]["argument_bytes"] == 143_419_400
    cfg = dataclasses.replace(get_config(ARCH), n_layers=1)
    want = _train_flops()(cfg, 256, 4096)["total"]
    assert abs(rec["cost"]["flops"] * 256 / want - 1) < 0.02, (rec["cost"], want)
    coll = rec["collectives"]
    assert coll["total"] == sum(s["bytes"] for s in coll["by_site"].values()) > 0
    # the attention core gets its heads from the projections already placed
    assert {"embed_table", "head_projection", "mlp_block", "row_parallel", "grad_placement",
            "grad_norm"} <= set(coll["by_site"]) <= set(SITES) | {"propagation"}, coll["by_site"]
