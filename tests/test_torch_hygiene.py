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
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
