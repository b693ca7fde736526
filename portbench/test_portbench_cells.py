"""Small cells run end to end on the host: the closed loop over the index in
memory and from a spill file, a cell and a whole deployment added from new
files alone, and the readers held to the set that BENCHMARK.json names."""
import json
import pathlib
import shutil
from types import SimpleNamespace

import pytest

from portbench.conftest import TINY, add_cell, add_config
from portbench.harness import load_cell, load_reader, run_cell
from portbench.spans import ProgramSpan
from portbench.trace import TraceSummary

SEED = 2**31 + 77
ROOT = pathlib.Path(__file__).resolve().parents[1]
MS = 1_000_000


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


# A tier, its reference, a traffic mix and a reader that exist only here: the
# index served by the oracle plan, judged by the reference of this tier, which
# leaves a mark beside itself when it is asked.
_TIER = '''
import pathlib

from portbench.program import Served, build_index
from portbench.reference import RefParams, Reference, family_from_seed


def build(cfg, data, family_seed, device, work_dir, layout):
    from repro_torch.core import SearchEngine
    idx, params, params_off = build_index(cfg, data.db, family_seed, device)
    return Served(SearchEngine(idx, device=device), cfg, params, params_off)


def reference(cfg, db, family_seed, device, layout):
    (pathlib.Path(__file__).parent / "asked").write_text(str(layout))
    p = RefParams.from_config(cfg)
    return Reference(db, family_from_seed(family_seed, p), p)
'''
_READER = '''
def read(ctx):
    if ctx["counters"] is None:
        return None
    calls = ctx["counters"]["e2lsh_query_calls_total"]["samples"]
    return sum(s["value"] for s in calls if s["labels"] == {"plan": "oracle"})
'''


def test_a_deployment_is_added_from_new_files_alone(bench_root, tmp_path):
    bench = bench_root / "portbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "tiers" / "oracle_memory.py").write_text(_TIER)
    (bench / "traffic" / "tiny-oracle32.json").write_text(json.dumps(
        {"loop": "closed", "batch": 32, "pool_batches": 8, "repeat": True,
         "warm_calls": 1, "check_rows": 64}))
    (bench / "metrics" / "oracle_calls.py").write_text(_READER)
    add_config(bench_root, dict(TINY, name="tiny-oracle", tier="oracle_memory", plan="oracle"))
    manifest = json.loads((bench_root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({"name": "oracle_calls", "unit": "calls", "better": "lower",
                                  "source": "program_counter", "layer": "query",
                                  "moves": "qps", "workloads": []})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    add_cell(bench_root, "tiny-oracle.batch32", "tiny-oracle", "tiny-oracle32",
             ("qps", "oracle_calls"))
    assert all(p.read_bytes() == b for p, b in before.items())   # nothing edited
    out = run_cell(bench_root, "tiny-oracle.batch32", seed=SEED, seconds=0.3, trace=True,
                   device="cpu", work_dir=tmp_path / "work")
    assert out["correct"], out["checks"]
    assert (bench / "tiers" / "asked").read_text() == "None"   # its own reference judged
    # the registry's calls over the window: one for each batch the client sent
    assert out["metrics"] == {"oracle_calls": {"value": out["attempted"] / 32,
                                               "unit": "calls"}}


def test_a_traced_cell_hands_the_readers_the_programs_spans(bench_root, tmp_path):
    names = [f"query.{s}_share" for s in ("upload", "hash", "init", "probe", "merge",
                                            "sync")] + ["query.syncs_per_call"]
    add_cell(bench_root, "tiny.batch-traced", TINY["name"], "tiny-batch", ("qps", *names))
    out = run_cell(bench_root, "tiny.batch-traced", seed=SEED, seconds=0.5, trace=True,
                   device="cpu", work_dir=tmp_path / "work")
    assert out["correct"], out["checks"]
    got = {n: m["value"] for n, m in out["metrics"].items()}
    assert set(got) == set(names)         # the device's readers find no trace on the host
    assert 0 < sum(got[n] for n in names[:6]) <= 1.0
    assert all(got[n] > 0 for n in names[:6])
    assert 1 <= got["query.syncs_per_call"] <= 8


@pytest.mark.parametrize("what,fix,match", [
    ("tier", lambda cfg: dict(cfg, tier="nowhere"), r"tiers/nowhere\.py"),
    ("generator", lambda cfg: dict(cfg, data=dict(cfg["data"], generator="gist")),
     r"configs/tiny\.json.*'gist'"),
])
def test_an_unknown_tier_or_generator_fails_before_any_work(bench_root, what, fix, match):
    path = bench_root / "portbench" / "configs" / "tiny.json"
    path.write_text(json.dumps(fix(json.loads(path.read_text()))))
    with pytest.raises((FileNotFoundError, ValueError), match=match):
        load_cell(bench_root, "tiny.batch")


def test_a_missing_configuration_file_is_named(bench_root):
    (bench_root / "portbench" / "configs" / "tiny.json").unlink()
    with pytest.raises(FileNotFoundError, match=r"configs/tiny\.json"):
        load_cell(bench_root, "tiny.batch")


@pytest.mark.cuda
def test_a_small_cell_is_correct_on_the_card(bench_root, tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run_cell(bench_root, "tiny.batch", seed=SEED, seconds=0.5, trace=True,
                   device="cuda", work_dir=tmp_path / "work")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0


# -- the readers: one file for each metric that BENCHMARK.json names -------------

def _call_spans(t0: int, sid: int) -> list:
    """One query call of 1 s from t0 (ns): two early-exit reads, one radius."""
    parts = [("query.upload", 0, 100), ("query.hash", 100, 300), ("query.init", 300, 350),
             ("query.sync", 350, 400), ("query.probe", 400, 600),
             ("query.merge", 600, 700), ("query.sync", 700, 750)]
    return [ProgramSpan("query", t0, t0 + 1000 * MS, sid, None, {"plan": "fused", "k": 10})] + [
        ProgramSpan(n, t0 + a * MS, t0 + b * MS, sid + 1 + i, sid, {})
        for i, (n, a, b) in enumerate(parts)]


FULL = dict(window_s=2.0, attempted=100, rows=100, setup_s=3.0, peak_bytes=2e9,
            trace=TraceSummary(busy_s=0.5, window_s=2.0, device_ops=[], idle_gaps=[]),
            plan_totals=SimpleNamespace(calls=3, fetch_ms=1000.0),
            store=SimpleNamespace(device_reads=250), least_s=0.05,
            spans=_call_spans(0, 1) + _call_spans(1000 * MS, 100), counters={})
WANT = {"qps": 50.0, "external_qps": 50.0, "peak_mem_gb": 2.0, "setup_s": 3.0,
        "device.idle_share.batch": 0.75, "device.idle_share.external": 0.75,
        "kernels_roofline.batch": 10.0, "storage.fetch_share": 0.5,
        "storage.reads_per_query": 2.5,
        "query.upload_share": 0.1, "query.hash_share": 0.2, "query.init_share": 0.05,
        "query.probe_share": 0.2, "query.merge_share": 0.1, "query.sync_share": 0.1,
        "query.syncs_per_call": 2.0}


def _manifest_metrics(root) -> set:
    m = json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())
    return {x["name"] for x in m["end_to_end"] + m["per_layer"]}


def _reader_set_faults(root) -> list:
    """What breaks the rule that the readers are the manifest's metrics, one
    file each, each returning None on the empty context."""
    m = json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())
    bench = pathlib.Path(root) / m["paths"][0]
    files = {p.stem for p in (bench / "metrics").glob("*.py")}
    named = _manifest_metrics(root)
    faults = [f"{n}: no reader file" for n in sorted(named - files)]
    faults += [f"{n}: not in BENCHMARK.json" for n in sorted(files - named)]
    for n in sorted(files & named):
        if load_reader(bench, n).read(dict.fromkeys(FULL)) is not None:
            faults.append(f"{n}: reads something from the empty context")
    return faults


def test_the_readers_are_the_manifests_metrics():
    assert _reader_set_faults(ROOT) == []


def test_a_reader_is_added_with_its_manifest_entry_alone(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "portbench" / "metrics" / "query.calls_per_s.py").write_text(
        "from portbench.spans import count\n\n\ndef read(ctx):\n"
        "    n = count(ctx, 'query', root=True)\n"
        "    return None if n is None else n / ctx['window_s']\n")
    assert _reader_set_faults(root) == ["query.calls_per_s: not in BENCHMARK.json"]
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["per_layer"].append({"name": "query.calls_per_s", "unit": "calls/s", "better": "higher",
                           "source": "program_span", "layer": "query", "moves": "qps",
                           "workloads": ["sift1m.batch256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert _reader_set_faults(root) == []
    reader = load_reader(root / "portbench", "query.calls_per_s")
    assert reader.read(FULL) == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_reads_its_context(name):
    reader = load_reader(ROOT / "portbench", name)
    assert reader.read(FULL) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(_manifest_metrics(ROOT)))
def test_every_reader_returns_none_on_the_empty_context(name):
    reader = load_reader(ROOT / "portbench", name)
    assert reader.read(dict.fromkeys(FULL)) is None
