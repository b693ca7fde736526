"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module name (the program's ``repro_torch`` begins with ``repro``),
and the command refuses to run without the program or without a card."""
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_SCRIPT = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import portbench.run, portbench.harness, portbench.control, portbench.trace
import portbench.reference, portbench.compare, portbench.data, portbench.roofline
import portbench.ranks, portbench.spans, portbench.program
import repro_torch.core, repro_torch.storage, repro_torch.serving, repro_torch.telemetry
import repro_torch.core.distributed
from portbench.harness import load_cell, load_reader, load_tier
for cell in {cells!r}:
    c = load_cell({root!r}, cell)
    load_tier(c.bench_dir, c.config["tier"])
    for name in c.end_to_end + c.per_layer:
        load_reader(c.bench_dir, name)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return env


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    import json
    cells = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    script = _SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT), cells=cells)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "portbench" in top
    assert not top & FORBIDDEN, sorted(top & FORBIDDEN)


def test_forbidden_modules_compares_whole_names():
    from portbench.run import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.core", "reprox", "jaxtyping"]) == []
    assert forbidden_modules(["repro.core.query", "jax.numpy", "flax"]) == ["flax", "jax", "repro"]


def test_the_command_refuses_without_the_program(tmp_path):
    # a directory holding only BENCHMARK.json and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sift1m.batch256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, env=_env(), timeout=120)
    assert out.returncode not in (0, None)
    assert out.stdout.strip() == ""


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sift1m.batch256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == "" and "CUDA" in out.stderr
