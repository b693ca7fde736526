"""The sharded tier (``tiers/sharded.py``) at a small size: two gloo ranks on
the host through the launcher that ``run.py`` starts for a cell of more than
one chip, judged by the tier's own reference. A wrapper tier, which exists
only here, runs the real tier and keeps each rank's first calls, the spans
its tracer recorded and the bytes its all-gathers counted; on request it
plants a fault on rank 0, or makes rank 0 lag after each call."""
import json

import pytest
import torch

from portbench.conftest import BENCH, TINY, TINY_TRAFFIC, add_cell, add_config
from portbench.data import DataSpec, make_dataset
from portbench.harness import load_reader, load_tier
from portbench.ranks import launch
from portbench.spans import ProgramSpan
from portbench.trace import TraceSummary

SEED = 2**31 + 4242
KEEP = 3          # calls each rank keeps
FIELDS = ("ids", "dists", "found", "radii_searched", "nio_table", "nio_blocks",
          "cands_checked")

_WRAPPER = '''
import pathlib
import time

import torch

from portbench.harness import load_tier

_REAL = load_tier(pathlib.Path(__file__).parent.parent, "sharded")
reference = _REAL.reference


class Kept:
    """The real tier's program, keeping its first calls; at close() it writes
    them, with the tracer's span counts and the gather counter, beside the
    work directory."""

    def __init__(self, prog, shard, out):
        self.prog, self.shard, self.out, self.calls = prog, shard, out, []
        self.lag = 0.0
        self.params, self.params_off = prog.params, prog.params_off

    def query(self, rows):
        res = self.prog.query(rows)
        time.sleep(self.lag)
        if len(self.calls) < {keep}:
            self.calls.append((torch.as_tensor(rows).clone(),
                               {{f: getattr(res, f).clone() for f in {fields}}}))
        return res

    def close(self):
        from repro_torch import telemetry
        names = [s.name for s in telemetry.get_tracer().spans()]
        counter = telemetry.snapshot().get("e2lsh_sharded_gather_bytes_total")
        self.out.mkdir(parents=True, exist_ok=True)
        torch.save(dict(calls=self.calls,
                        spans={{n: names.count(n) for n in set(names)}},
                        gather_bytes=None if counter is None
                        else sum(s["value"] for s in counter["samples"])),
                   self.out / f"rank{{self.shard}}.pt")
        self.prog.close()


def build(cfg, data, family_seed, device, work_dir, layout):
    if cfg.get("drop_part_on_rank_0") and layout.shard == 0:
        import repro_torch.core.distributed as d
        merge = d._merge
        d._merge = lambda parts, k: merge(parts[:-1], k)   # the last shard's part is lost
    kept = Kept(_REAL.build(cfg, data, family_seed, device, work_dir, layout), layout.shard,
                pathlib.Path(work_dir) / "kept")
    if layout.shard == 0:
        kept.lag = cfg.get("lag_on_rank_0", 0.0)
    return kept
'''.format(keep=KEEP, fields=FIELDS)

# what the build rule gives at n = 3,000 in two range shards: the parameters
# follow the whole n, the table width the largest shard
SHARDED = dict(TINY, name="tiny-sharded", tier="sharded_kept", plan="sharded", shards=2,
               index=dict(TINY["index"], u=9))
METRICS = ("qps", "sharded.collective_share", "sharded.merge_share",
           "sharded.gather_bytes_per_query")


def _root(root, **extra):
    (root / "portbench" / "tiers" / "sharded_kept.py").write_text(_WRAPPER)
    add_config(root, dict(SHARDED, **extra))
    add_cell(root, "tiny-sharded.batch", "tiny-sharded", "tiny-batch", METRICS)
    path = root / "BENCHMARK.json"
    m = json.loads(path.read_text())
    next(w for w in m["workloads"] if w["name"] == "tiny-sharded.batch")["chips"] = 2
    path.write_text(json.dumps(m))
    return root


def _run(root, tmp_path, trace=False, seconds=0.5):
    rc, out = launch(root, "tiny-sharded.batch", seed=SEED, seconds=seconds, trace=trace,
                     chips=2, device="cpu", work_dir=tmp_path / "work", wait_s=60, run_s=240)
    assert rc == 0 and out is not None
    kept = [torch.load(tmp_path / "work" / "kept" / f"rank{r}.pt") for r in range(2)]
    return out, kept


def test_two_ranks_are_correct_and_equal_the_one_process_plan(bench_root, tmp_path):
    from repro_torch.core import SearchEngine
    from repro_torch.core.distributed import build_sharded_index
    out, kept = _run(_root(bench_root), tmp_path)
    assert out["correct"], out["checks"]
    assert out["checks"]["rows_off"]["value"] == 0.0
    assert out["checks"]["params_off"]["value"] == 0.0
    assert set(out["metrics"]) == {"qps", "setup_s"}
    tr = TINY_TRAFFIC["batch"]
    data = make_dataset(DataSpec.from_config(SHARDED),
                        tr["batch"] * (tr["pool_batches"] + tr["warm_calls"]), SEED, "cpu")
    b = SHARDED["build"]
    one = SearchEngine(build_sharded_index(data.db, 2, c=b["c"], w=b["w"], gamma=b["gamma"],
                                           max_L=b["max_L"], seed=SEED % (2**31 - 1),
                                           device="cpu"), device="cpu")
    for rank in kept:
        assert len(rank["calls"]) == KEEP
        for rows, got in rank["calls"]:
            want = one.query(rows, plan="sharded", k=SHARDED["k"])
            for f in FIELDS:
                assert torch.equal(got[f], getattr(want, f)), f


def test_rank_0_lagging_after_each_call_leaves_every_rank_in_the_window(bench_root,
                                                                         tmp_path):
    # the other ranks read rank 0's stop decision for the first calls while
    # rank 0 still sleeps: they must wait for it, not stop on the barrier's keys
    out, _ = _run(_root(bench_root, lag_on_rank_0=0.2), tmp_path, seconds=2.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 * TINY_TRAFFIC["batch"]["batch"]


def test_a_lost_shard_part_is_not_correct(bench_root, tmp_path):
    out, _ = _run(_root(bench_root, drop_part_on_rank_0=True), tmp_path)
    assert not out["correct"]
    assert out["checks"]["rows_off"]["value"] > out["checks"]["rows_off"]["limit"]


def test_a_traced_rank_spans_its_gather_and_merge_once_a_call(bench_root, tmp_path):
    out, kept = _run(_root(bench_root), tmp_path, trace=True)
    assert out["correct"], out["checks"]
    k = SHARDED["k"]
    row_bytes = (2 * k + 5) * 4          # one packed row: ids, dists and five counts
    for rank in kept:
        calls = rank["spans"]["query"]
        assert calls > 0
        assert rank["spans"]["query.gather"] == calls
        assert rank["spans"]["query.shard_merge"] == calls
        assert rank["gather_bytes"] == calls * TINY_TRAFFIC["batch"]["batch"] * row_bytes * 2
    got = {n: m["value"] for n, m in out["metrics"].items()}
    # no device trace on the host: the collective share finds nothing to read
    assert set(got) == {"sharded.merge_share", "sharded.gather_bytes_per_query"}
    assert 0 < got["sharded.merge_share"] < 1
    assert got["sharded.gather_bytes_per_query"] == row_bytes * 2


def test_the_tier_refuses_a_layout_other_than_a_rank_a_shard():
    from repro_torch.core.distributed import RankLayout
    tier = load_tier(BENCH, "sharded")
    cfg = dict(SHARDED, tier="sharded")
    for layout in (None, RankLayout(shards=4, query_groups=1, position=0, ranks=(0, 1, 2, 3)),
                   RankLayout(shards=2, query_groups=2, position=0, ranks=(0, 1, 2, 3))):
        with pytest.raises(ValueError, match="one a shard"):
            tier.build(cfg, None, 1, "cpu", None, layout)


def test_the_tf32_control_through_the_sharded_reference_is_refused():
    tier = load_tier(BENCH, "sharded")
    cfg = dict(SHARDED, tier="sharded")
    from portbench.compare import Answers, judge
    data = make_dataset(DataSpec.from_config(cfg), 256, SEED, "cpu")
    truth = tier.reference(cfg, data.db, 5, "cpu", None)
    control = tier.reference(cfg, data.db, 5, "cpu", None, precision="tf32")
    want, got = truth.answer(data.queries), control.answer(data.queries)
    as_answers = Answers(ids=got.ids.numpy(), dists=torch.sqrt(got.d2).float().numpy(),
                         **{f: getattr(got, f).numpy() for f in FIELDS[2:]})
    same = Answers(ids=want.ids.numpy(), dists=torch.sqrt(want.d2).float().numpy(),
                   **{f: getattr(want, f).numpy() for f in FIELDS[2:]})
    assert judge(same, want, data.queries, truth)["rows_off"] == 0.0
    reading = judge(as_answers, want, data.queries, truth)
    limits = json.loads((BENCH / "limits.json").read_text())
    assert reading["rows_off"] > limits["rows_off"]["limit"]
    assert reading["dist_err"] > limits["dist_err"]["limit"]


def _span(name, a, b, sid, parent):
    return ProgramSpan(name, a * 1_000_000, b * 1_000_000, sid, parent, {})


@pytest.mark.parametrize("name,want", [
    ("sharded.collective_share", 0.25),
    ("sharded.merge_share", 0.1),
    ("sharded.gather_bytes_per_query", 400.0),
])
def test_a_sharded_reader_reads_its_context(name, want):
    spans = []
    for c in range(2):        # two calls of 1 s, each merging for 100 ms
        t0, sid = 1000 * c, 10 * c + 1
        spans += [_span("query", t0, t0 + 1000, sid, None),
                  _span("query.gather", t0 + 700, t0 + 800, sid + 1, sid),
                  _span("query.shard_merge", t0 + 800, t0 + 900, sid + 2, sid)]
    ops = [["ncclDevKernel_AllGather_RING_LL", 0.4], ["probe_append_kernel", 0.9],
           ["ncclDevKernel_Broadcast_RING_LL", 0.1]]
    ctx = dict(window_s=2.0, attempted=100, rows=100, setup_s=3.0, peak_bytes=2e9,
               trace=TraceSummary(busy_s=1.5, window_s=2.0, device_ops=ops, idle_gaps=[]),
               plan_totals=None, store=None, least_s=None, spans=spans,
               counters={"e2lsh_sharded_gather_bytes_total": {
                   "type": "counter", "help": "",
                   "samples": [{"labels": {}, "value": 40_000}]}})
    reader = load_reader(BENCH, name)
    assert reader.read(ctx) == pytest.approx(want)
    # a program without the spans or the counter: nothing to read, and no error
    bare = dict(ctx, spans=[s for s in spans if s.name == "query"], counters={})
    if name != "sharded.collective_share":
        assert reader.read(bare) is None


def test_the_configuration_states_the_deployment_the_cell_runs():
    cfg = json.loads((BENCH / "configs" / "bigann10m-4shard.json").read_text())
    tr = json.loads((BENCH / "traffic" / "batch64k.json").read_text())
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in manifest["workloads"] if w["name"] == "bigann10m-4shard.batch64k")
    assert cell["chips"] == cfg["shards"] == 4 and cfg["tier"] == "sharded"
    assert cfg["plan"] == "sharded" and tr["batch"] == 65536
    # the per-shard budget the deployment states: max(4k, ceil(S / shards))
    assert max(4 * cfg["k"], -(-cfg["index"]["S"] // cfg["shards"])) == 40
    # the sharded plan's rows of 2k + 5 int32 values, under 2^31 bytes a gather
    assert tr["batch"] * (2 * cfg["k"] + 5) * 4 * cfg["shards"] < 2**31
