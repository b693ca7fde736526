"""The sharded plan across ``torch.distributed`` ranks (``gloo`` on the CPU),
held to the one-process ``sharded_query_result`` at the same shards, bit
for bit in every ``QueryResult`` field (the one-process plan is held to the
reference's ``shard_map`` plan in ``test_torch_distributed.py``):

* four ranks as subprocesses with a ``file://`` rendezvous run the
  layouts 2 x 1 (on ranks 0-1), 4 x 1 and 2 x 2 (index x query) over
  n = 3,001 points (uneven shards), d = 24: each rank's ``LocalShard``
  against shard s of ``build_sharded_index``, leaf for leaf; the fused and
  oracle plans on 16 queries, and on ragged batches with a ``valid`` mask;
  the ``BatchQueue`` over the 2 x 1 engine (rank 0 leads, rank 1 follows),
  every ticket against its direct dispatch;
* the serve CLI under ``torch.distributed.run --nproc_per_node 2 ...
  --device cpu``: ``[sharded x2]`` with the one-process ratio.
"""
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core import SearchEngine, overall_ratio
from repro_torch.core.distributed import build_sharded_index, sharded_query_result
from repro_torch.data import make_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
N, D, Q, K = 3001, 24, 16, 5
BUILD = dict(gamma=0.8, max_L=16, seed=3)
LAYOUTS = {"2x1": (2, 1), "4x1": (4, 1), "2x2": (2, 2)}
FIELDS = ("ids", "dists", "found", "radii_searched", "nio_table", "nio_blocks",
          "cands_checked")
RAGGED_Q = 13                 # 13 rows: over 2 query groups, one padding row
REQUEST_SIZES = (1, 3, 5, 2, 4, 1)    # the 16 queries, ragged

_RANK = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core import SearchEngine
from repro_torch.core.distributed import RankLayout, build_local_shard
from repro_torch.serving import BatchQueue

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg = json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
rng = np.random.default_rng(0)
db = rng.normal(size=(cfg["N"], cfg["D"])).astype(np.float32)
qs = rng.normal(size=(cfg["Q"], cfg["D"])).astype(np.float32)
valid = np.arange(cfg["RAGGED_Q"]) % 3 != 1
res = {}
for name, (sh, qg) in cfg["LAYOUTS"].items():
    layout = RankLayout.make(sh, qg, ranks=range(sh * qg))
    if layout is None:
        continue
    local = build_local_shard(db, sh, layout.shard, device="cpu", **cfg["BUILD"])
    for f in local.arrays.array_fields():
        res[f"{name}/local/{f}"] = getattr(local.arrays, f).numpy()
    engine = SearchEngine(local, device="cpu", group=layout)
    for plan in ("sharded", "oracle"):
        for tag, (q, v) in {"full": (qs, None),
                            "ragged": (qs[:cfg["RAGGED_Q"]], valid)}.items():
            r = engine.query(q, plan=plan, k=cfg["K"], valid=v)
            for f in cfg["FIELDS"]:
                res[f"{name}/{plan}/{tag}/{f}"] = getattr(r, f).numpy()
    if name != "2x1":
        continue
    # the queue over the two ranks: rank 0 leads, rank 1 follows
    lo = np.cumsum((0,) + tuple(cfg["REQUEST_SIZES"]))
    requests = [qs[a:b] for a, b in zip(lo[:-1], lo[1:])]
    if rank == layout.leader:
        queue = BatchQueue(engine, plan="sharded", k=cfg["K"], ladder=(4, 8), max_batch=8)
        with queue:
            tickets = [queue.submit(r) for r in requests]
            got = [t.result(timeout=120) for t in tickets]
        queue.close()
        res["queue/dispatches"] = np.asarray(queue.dispatch_count)
    else:
        res["queue/follower_calls"] = np.asarray(
            BatchQueue.follow(engine, plan="sharded", k=cfg["K"]))
    _, direct = engine.make_plan_fn(plan="sharded", k=cfg["K"])
    want = [direct(r) for r in requests]
    if rank == layout.leader:
        for i, (g, w) in enumerate(zip(got, want)):
            for f in cfg["FIELDS"]:
                res[f"queue/{i}/ticket/{f}"] = getattr(g, f).numpy()
                res[f"queue/{i}/direct/{f}"] = getattr(w, f).numpy()
dist.destroy_process_group()
np.savez(out, **res)
"""


def _data():
    rng = np.random.default_rng(0)
    db = rng.normal(size=(N, D)).astype(np.float32)
    return db, rng.normal(size=(Q, D)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's saved arrays, keyed ``layout/...`` and ``queue/...``."""
    import json
    tmp = tmp_path_factory.mktemp("ranks")
    cfg = json.dumps(dict(N=N, D=D, Q=Q, K=K, BUILD=BUILD, LAYOUTS=LAYOUTS, FIELDS=FIELDS,
                          RAGGED_Q=RAGGED_Q, REQUEST_SIZES=REQUEST_SIZES))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(WORLD),
                               f"file://{tmp / 'rendezvous'}", str(tmp / f"rank{r}.npz"), cfg],
                              cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=logs[r])
             for r in range(WORLD)]
    try:   # a rank that fails leaves the others waiting: stop them all then
        t_end = time.monotonic() + 240
        while time.monotonic() < t_end and any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        logs[r].seek(0)
        assert p.wait() == 0, f"rank {r}: rc {p.returncode}\n{logs[r].read()[-4000:]}"
        logs[r].close()
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process():
    """The one-process sharded index at 2 and 4 shards."""
    db, _ = _data()
    return {sh: build_sharded_index(db, sh, device="cpu", **BUILD) for sh in (2, 4)}


def _members(name):
    sh, qg = LAYOUTS[name]
    return range(sh * qg)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_local_shard_equals_the_one_process_shard(ranks, one_process, name):
    sh, qg = LAYOUTS[name]
    for r in _members(name):
        shard = one_process[sh].arrays[r // qg]
        for f in shard.array_fields():
            np.testing.assert_array_equal(ranks[r][f"{name}/local/{f}"],
                                          getattr(shard, f).numpy(), err_msg=f"rank {r}: {f}")


@pytest.mark.parametrize("plan", ["sharded", "oracle"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_rank_parallel_equals_one_process(ranks, one_process, name, plan):
    sh, _ = LAYOUTS[name]
    _, qs = _data()
    want = sharded_query_result(one_process[sh], qs, k=K,
                                local_plan="fused" if plan == "sharded" else "oracle")
    assert bool(want.found.any())
    for r in _members(name):
        for f in FIELDS:
            np.testing.assert_array_equal(ranks[r][f"{name}/{plan}/full/{f}"],
                                          getattr(want, f).numpy(), err_msg=f"rank {r}: {f}")


@pytest.mark.parametrize("plan", ["sharded", "oracle"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_ragged_masked_batch_equals_one_process(ranks, one_process, name, plan):
    sh, _ = LAYOUTS[name]
    _, qs = _data()
    valid = np.arange(RAGGED_Q) % 3 != 1
    want = sharded_query_result(one_process[sh], qs[:RAGGED_Q], k=K, valid=valid,
                                local_plan="fused" if plan == "sharded" else "oracle")
    assert not bool(want.found[~torch.from_numpy(valid)].any())   # masked rows inert
    for r in _members(name):
        for f in FIELDS:
            np.testing.assert_array_equal(ranks[r][f"{name}/{plan}/ragged/{f}"],
                                          getattr(want, f).numpy(), err_msg=f"rank {r}: {f}")


def test_queue_over_two_ranks_matches_direct_dispatch(ranks):
    lead = ranks[0]
    # one dispatch per tick on the leader, the same calls on the follower
    # (the ladder warm-up's two rungs included)
    assert int(lead["queue/dispatches"]) >= -(-sum(REQUEST_SIZES) // 8)
    assert int(ranks[1]["queue/follower_calls"]) == int(lead["queue/dispatches"]) + 2
    for i, size in enumerate(REQUEST_SIZES):
        for f in FIELDS:
            got, want = lead[f"queue/{i}/ticket/{f}"], lead[f"queue/{i}/direct/{f}"]
            assert got.shape[0] == size
            np.testing.assert_array_equal(got, want, err_msg=f"request {i}: {f}")


def test_serve_cli_on_two_ranks_prints_the_one_process_ratio():
    n, q = 3000, 16
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "repro_torch.launch.serve", "--mode", "ann", "--device", "cpu",
         "--n", str(n), "--queries", str(q)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "[ranks] world=2 transport=gloo device=cpu" in out.stdout, out.stdout
    line = re.search(r"\[sharded x2\] ratio=(\S+) nio/query=(\d+) t/query=\d+us", out.stdout)
    assert line, out.stdout
    ds = make_dataset("sift", n=n, n_queries=q, seed=0)
    sh = build_sharded_index(ds.db, 2, gamma=0.8, max_L=32, seed=0, device="cpu")
    res = SearchEngine(sh, device="cpu").query(ds.queries, plan="sharded", k=1)
    assert line.group(1) == f"{overall_ratio(res.dists.numpy(), ds.gt_dists[:, :1]):.4f}"
    assert line.group(2) == f"{float(res.nio.float().mean()):.0f}"
