"""Small cells run end to end on the host: the closed loop over the index in
memory and from a spill file, and a cell added from new files alone."""
import json

import pytest

from portbench.conftest import TINY, add_cell
from portbench.harness import run_cell

SEED = 2**31 + 77


@pytest.mark.parametrize("cell,metric", [("tiny.batch", "qps"),
                                         ("tiny-spill.batch", "external_qps")])
def test_a_small_cell_runs_and_is_correct(bench_root, tmp_path, cell, metric):
    out = run_cell(bench_root, cell, seed=SEED, seconds=0.5, trace=False, device="cpu",
                   work_dir=tmp_path / "work")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {metric, "setup_s"}
    assert out["metrics"][metric]["value"] > 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["rows_off"]["value"] == 0.0
    assert not list((tmp_path / "work").glob("*.e2l"))    # the spill is deleted at exit


def test_a_cell_is_added_from_new_files_alone(bench_root, tmp_path):
    bench = bench_root / "portbench"
    (bench / "traffic" / "tiny-batch8.json").write_text(json.dumps(
        {"loop": "closed", "batch": 8, "pool_batches": 16, "repeat": True,
         "warm_calls": 1, "check_rows": 32}))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx['attempted'] / 8 / ctx['window_s']\n")
    manifest = json.loads((bench_root / "BENCHMARK.json").read_text())
    manifest["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                                   "better": "higher", "bound": 0.05,
                                   "source": "host_clock", "workloads": []})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    add_cell(bench_root, "tiny.batch8", TINY["name"], "tiny-batch8", ("calls_per_s",))
    out = run_cell(bench_root, "tiny.batch8", seed=SEED, seconds=0.3, trace=False,
                   device="cpu", work_dir=tmp_path / "work")
    assert out["correct"], out["checks"]
    # peak_mem_gb reads the card's allocator: nothing to read on the host
    assert set(out["metrics"]) == {"calls_per_s", "setup_s"}
    assert out["metrics"]["calls_per_s"]["unit"] == "calls/s"


@pytest.mark.cuda
def test_a_small_cell_is_correct_on_the_card(bench_root, tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run_cell(bench_root, "tiny.batch", seed=SEED, seconds=0.5, trace=True,
                   device="cuda", work_dir=tmp_path / "work")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0


def test_every_reader_reads_its_context_and_returns_none_without_one():
    import pathlib
    from types import SimpleNamespace

    from portbench.harness import load_reader
    from portbench.trace import TraceSummary

    bench = pathlib.Path(__file__).resolve().parent
    full = dict(window_s=2.0, attempted=100, rows=100, setup_s=3.0, peak_bytes=2e9,
                trace=TraceSummary(busy_s=0.5, window_s=2.0, device_ops=[], idle_gaps=[]),
                plan_totals=SimpleNamespace(calls=3, fetch_ms=1000.0),
                store=SimpleNamespace(device_reads=250), least_s=0.05)
    want = {"qps": 50.0, "external_qps": 50.0, "peak_mem_gb": 2.0, "setup_s": 3.0,
            "device.idle_share.batch": 0.75, "device.idle_share.external": 0.75,
            "kernels_roofline.batch": 10.0, "storage.fetch_share": 0.5,
            "storage.reads_per_query": 2.5}
    assert {p.stem for p in (bench / "metrics").glob("*.py")} == set(want)
    empty = dict(full, trace=None, plan_totals=None, store=None, least_s=None, peak_bytes=0)
    for name, value in want.items():
        reader = load_reader(bench, name)
        assert reader.read(full) == pytest.approx(value), name
        if name not in ("qps", "external_qps", "setup_s"):
            assert reader.read(empty) is None, name
