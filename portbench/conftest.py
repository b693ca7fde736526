"""Fixtures of the benchmark's tests: a copy of the benchmark's data files in a
temporary root, with small cells added from new files alone, which the
harness runs on the host (``run_cell(..., device="cpu")``)."""
from __future__ import annotations

import json
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"

# A small SIFT-shaped deployment: the build rule at n = 3,000, d = 32 gives
# these parameters (m and u follow from n; max_L 8 keeps the walk small).
TINY = {
    "name": "tiny", "source": "a small SIFT-shaped deployment for the tests",
    "n": 3000, "d": 32, "k": 10, "tier": "memory", "plan": "fused",
    "data": {"generator": "sift", "clusters": 20, "spread": 0.15,
             "easy_share": 0.75, "jitter": 0.105, "nn_target": 1.2},
    "build": {"c": 2.0, "w": 4.0, "gamma": 0.8, "max_L": 8, "block_bytes": 512},
    "index": {"m": 13, "L": 8, "r": 7, "S": 16, "u": 10, "fp_bits": 16, "w": 4.0,
              "c": 2.0, "block_objs": 99, "max_chain": 2},
}
TINY_TRAFFIC = {
    "batch": {"loop": "closed", "batch": 64, "pool_batches": 4, "repeat": True,
              "warm_calls": 1, "check_rows": 128},
    "fresh": {"loop": "closed", "batch": 64, "pool_batches": 64, "repeat": False,
              "warm_calls": 1, "check_rows": 128},
    "batch256": {"loop": "closed", "batch": 256, "pool_batches": 2, "repeat": True,
                 "warm_calls": 1, "check_rows": 1024},
}
TINY_CELLS = {
    "tiny.batch": ("tiny", "tiny-batch", ("qps", "peak_mem_gb", "setup_s")),
    "tiny-spill.batch": ("tiny-spill", "tiny-fresh", ("external_qps", "peak_mem_gb", "setup_s")),
    "tiny.batch256": ("tiny", "tiny-batch256", ("qps", "peak_mem_gb", "setup_s")),
}


def add_cell(root: pathlib.Path, name: str, config: str, traffic: str, metrics) -> None:
    """Add a cell to ``root``'s manifest: an entry in ``workloads``, and its
    name in the ``workloads`` of each metric in ``metrics``."""
    path = root / "BENCHMARK.json"
    m = json.loads(path.read_text())
    m["workloads"].append({"name": name, "config": config, "traffic": traffic,
                           "chips": 1, "why": "a test cell"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if metric["name"] in metrics and "workloads" in metric:
            metric["workloads"].append(name)
    path.write_text(json.dumps(m, indent=2))


def add_config(root: pathlib.Path, cfg: dict) -> None:
    (root / "portbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    path = root / "BENCHMARK.json"
    m = json.loads(path.read_text())
    m["configs"].append({"name": cfg["name"], "source": cfg["source"],
                         "file": f"portbench/configs/{cfg['name']}.json",
                         "reduced": [], "why": "a test configuration"})
    path.write_text(json.dumps(m, indent=2))


def make_bench_root(tmp_path: pathlib.Path) -> pathlib.Path:
    """A root holding BENCHMARK.json and the benchmark's data files, plus the
    small configurations and cells above."""
    root = tmp_path / "root"
    (root / "portbench").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics", "tiers"):
        shutil.copytree(BENCH / sub, root / "portbench" / sub)
    shutil.copy(BENCH / "limits.json", root / "portbench" / "limits.json")
    add_config(root, TINY)
    spill = dict(TINY, name="tiny-spill", tier="spill", plan="external",
                 store={"backend": "aio", "qd": 8})
    add_config(root, spill)
    for name, body in TINY_TRAFFIC.items():
        (root / "portbench" / "traffic" / f"tiny-{name}.json").write_text(json.dumps(body))
    for name, (config, traffic, metrics) in TINY_CELLS.items():
        add_cell(root, name, config, traffic, metrics)
    return root


@pytest.fixture
def bench_root(tmp_path):
    return make_bench_root(tmp_path)
