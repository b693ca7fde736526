"""A cell of more than one chip: two rank processes through the launcher that
``run.py`` starts for ``chips > 1``, over gloo on the host (and over NCCL
on two cards, where there are two). The tier exists only here: the port's
``build_local_shard`` behind ``SearchEngine(local, group=layout)``, judged
by a reference that answers each shard with the plain reference and merges
as the sharded plan does."""
import json
import time

import pytest

from portbench.conftest import BENCH, TINY, add_cell, add_config
from portbench.harness import load_tier
from portbench.ranks import launch

SEED = 2**31 + 9001

_TIER = '''
import dataclasses
import sys
import time
import types

import numpy as np
import torch

from portbench.program import Served
from portbench.reference import INVALID, RefParams, RefResult, Reference, family_from_seed


def build(cfg, data, family_seed, device, work_dir, layout):
    from repro_torch.core import SearchEngine
    from repro_torch.core.distributed import build_local_shard
    from repro_torch.core.query import QueryConfig
    if cfg.get("fail_on_shard") == layout.shard:
        raise RuntimeError(f"shard {layout.shard} fails, as its configuration asks")
    time.sleep(cfg.get("sleep_on_shard", {}).get(str(layout.shard), 0))
    if cfg.get("load_on_shard") == layout.shard:   # the JAX package's name, held to the end
        sys.modules.setdefault("repro", types.ModuleType("repro"))
    b = cfg["build"]
    local = build_local_shard(data.db, layout.shards, layout.shard, c=float(b["c"]),
                              w=float(b["w"]), gamma=float(b["gamma"]),
                              max_L=int(b["max_L"]), seed=family_seed, device=device)
    p = local.params
    got = dict(m=p.m, L=p.L, r=p.r, S=p.S, u=p.u, fp_bits=p.fp_bits, w=p.w, c=p.c,
               block_objs=p.block_objs,
               max_chain=QueryConfig.from_params(p, k=int(cfg["k"])).max_chain)
    off = sum(1 for k, v in got.items() if float(v) != float(cfg["index"][k]))
    return Served(SearchEngine(local, device=device, group=layout), cfg, got, off)


class Sharded:
    """Each range shard answered by the plain reference under the one family
    and the per-shard S budget max(4k, ceil(S / shards)), then merged as the
    sharded plan merges: squared distances in shard order, a stable sort,
    the first k; counters summed, found on any shard, radii the deepest."""

    def __init__(self, cfg, db, family_seed, shards):
        p = RefParams.from_config(cfg)
        family = family_from_seed(family_seed, p)
        whole = Reference(db, family, p)
        self.db, self.dev, self.db_norm = whole.db, whole.dev, whole.db_norm
        self.exact_d2 = whole.exact_d2
        self.k = p.k
        part = dataclasses.replace(p, S=max(4 * p.k, -(-p.S // shards)))
        bounds = np.linspace(0, db.shape[0], shards + 1).astype(np.int64)
        self.parts = [(int(lo), Reference(db[lo:hi], family, part))
                      for lo, hi in zip(bounds[:-1], bounds[1:])]

    def answer(self, queries):
        got = [(lo, ref.answer(queries)) for lo, ref in self.parts]
        ids = torch.cat([torch.where(a.ids == INVALID, INVALID, a.ids + lo) for lo, a in got], 1)
        d2 = torch.cat([a.d2 for _, a in got], 1)
        order = torch.sort(d2, dim=1, stable=True).indices[:, :self.k]
        res = [a for _, a in got]

        def total(name):
            return sum(getattr(a, name) for a in res)

        def anyof(name):
            return torch.stack([getattr(a, name) for a in res]).any(0)

        return RefResult(ids=torch.gather(ids, 1, order), d2=torch.gather(d2, 1, order),
                         found=anyof("found"),
                         radii_searched=torch.stack([a.radii_searched for a in res]).amax(0),
                         nio_table=total("nio_table"), nio_blocks=total("nio_blocks"),
                         cands_checked=total("cands_checked"), ambiguous=anyof("ambiguous"),
                         active=anyof("active"), blocks=total("blocks"), cands=total("cands"))


def reference(cfg, db, family_seed, device, layout):
    return Sharded(cfg, db, family_seed, layout.shards)
'''

# what the build rule gives at n = 3,000 in two range shards: the parameters
# follow the whole n, the table width the largest shard
SHARDED = dict(TINY, name="tiny-sharded", tier="sharded_ranks", plan="sharded",
               index=dict(TINY["index"], u=9))


def _two_rank_root(root, **extra):
    (root / "portbench" / "tiers" / "sharded_ranks.py").write_text(_TIER)
    add_config(root, dict(SHARDED, **extra))
    add_cell(root, "tiny-sharded.batch", "tiny-sharded", "tiny-batch", ("qps",))
    path = root / "BENCHMARK.json"
    m = json.loads(path.read_text())
    next(w for w in m["workloads"] if w["name"] == "tiny-sharded.batch")["chips"] = 2
    path.write_text(json.dumps(m))
    return root


def _launch(root, tmp_path, device="cpu", **kw):
    return launch(root, "tiny-sharded.batch", seed=SEED, seconds=0.5, trace=False, chips=2,
                  device=device, work_dir=tmp_path / "work", **kw)


def test_two_ranks_run_one_cell_and_rank_0_reports_it(bench_root, tmp_path, capfd):
    rc, out = _launch(_two_rank_root(bench_root), tmp_path, wait_s=60, run_s=240)
    assert rc == 0 and out is not None
    assert out["correct"], out["checks"]
    assert out["checks"]["rows_off"]["value"] == 0.0
    assert out["device"]["count"] == 2 and out["attempted"] > 0
    assert set(out["metrics"]) == {"qps", "setup_s"}
    # both ranks' answers are judged: twice the rows one rank keeps
    assert out["info"]["rows_checked"] == 2 * min(128, out["attempted"])
    assert capfd.readouterr().out == ""      # the ranks print nothing on standard output


@pytest.mark.parametrize("extra,why", [
    ({"fail_on_shard": 1}, "rank 1 raises in its build"),
    ({"sleep_on_shard": {"1": 60}}, "rank 0 waits past the timeout for rank 1"),
    ({"load_on_shard": 1}, "rank 1 holds a module named repro once its window has closed"),
])
def test_a_failing_or_stalled_rank_ends_the_run_without_a_result(bench_root, tmp_path,
                                                                  extra, why):
    t0 = time.monotonic()
    rc, out = _launch(_two_rank_root(bench_root, **extra), tmp_path, wait_s=8, run_s=120)
    assert rc != 0 and out is None, why
    assert time.monotonic() - t0 < 50, why


def test_the_spill_tier_refuses_a_cell_of_several_ranks(tmp_path):
    from repro_torch.core.distributed import RankLayout
    spill = load_tier(BENCH, "spill")
    with pytest.raises(ValueError, match="serves one chip"):
        spill.build(dict(TINY, name="tiny-spill"), None, 1, "cpu", tmp_path,
                    RankLayout(shards=2, query_groups=1, position=1, ranks=(0, 1)))
    assert not list(tmp_path.iterdir())


@pytest.mark.cuda
def test_two_ranks_over_nccl_on_two_cards(bench_root, tmp_path):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    rc, out = _launch(_two_rank_root(bench_root), tmp_path, device="cuda", wait_s=300,
                      run_s=600)
    assert rc == 0 and out is not None
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2 and out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
