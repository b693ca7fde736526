"""The port's QoS tick router: deadlines, priority classes, shedding, the
adaptive ladder, cache warming, and the queue over the external plans.

The reference's contracts (tests/test_serving_qos.py), on the port:
  * all-default submissions reduce exactly to the FIFO packer;
  * packing is strict across priority classes, EDF within a class, and
    head-of-line;
  * a segment whose deadline expired at pack time is shed — its ticket fails
    fast with ``DeadlineExceeded``, sibling segments drop with it, and the
    shed never occupies tick rows;
  * queued results stay bit for bit the direct dispatch whatever the pack
    order, over ``plan="external"`` on every block store (uring where the
    capability probe allows) and over ``plan="sharded_external"``;
  * ``warm_cache_rows`` collects the external plan's probe-trace row
    histogram and prefetches its hottest rows without touching the logical
    read ledger.
"""
import time

import numpy as np
import pytest

from repro_torch import storage as st
from repro_torch.core import E2LSHoS, SearchEngine
from repro_torch.serving import BatchQueue, DeadlineExceeded, QueryTicket

_EXACT_FIELDS = ("ids", "dists", "found", "radii_searched", "nio_table",
                 "nio_blocks", "cands_checked")


def _assert_same(got, want, msg=""):
    for name in _EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name).cpu().numpy(),
                                      err_msg=f"{msg}: {name}")


def _require_uring(path) -> None:
    caps = st.capabilities(str(path))
    if not caps["uring_store"]:
        pytest.skip(f"io_uring unavailable: {caps['io_uring_reason']}")


@pytest.fixture(scope="module")
def qos_env():
    rng = np.random.default_rng(29)
    n, d = 1500, 12
    centers = rng.normal(size=(24, d)).astype(np.float32)
    db = (centers[rng.integers(0, 24, n)]
          + 0.18 * rng.normal(size=(n, d))).astype(np.float32)
    qs = (db[rng.choice(n, 32, replace=False)]
          + 0.05 * rng.normal(size=(32, d))).astype(np.float32)
    s = float(np.median(np.linalg.norm(db - db.mean(0), axis=1))) / 3
    idx = E2LSHoS.build(db / s, gamma=0.7, s_scale=2.0, max_L=8, seed=3, device="cpu")
    return dict(idx=idx, engine=SearchEngine(idx, device="cpu"), qs=qs / s, d=d)


@pytest.fixture(scope="module")
def spill(qos_env, tmp_path_factory):
    path = tmp_path_factory.mktemp("qos_spill") / "index.e2l"
    qos_env["idx"].index.spill(path)
    return path


@pytest.fixture(scope="module")
def sharded_spill(qos_env, tmp_path_factory):
    path = tmp_path_factory.mktemp("qos_sharded") / "index"
    idx = qos_env["idx"]
    st.spill_index_sharded(path, idx.index.arrays, 2, params=idx.params,
                           stats=idx.index.stats)
    return path


def _queue(env, **kw):
    kw.setdefault("ladder", (4, 8))
    kw.setdefault("max_batch", 8)
    kw.setdefault("k", 2)
    return BatchQueue(env["engine"], plan="fused", **kw)


# --------------------------------------------------------------------------
# Pack order
# --------------------------------------------------------------------------

def test_defaults_reduce_to_fifo(qos_env):
    q = _queue(qos_env)
    qs = qos_env["qs"]
    t1, t2, t3 = q.submit(qs[:3]), q.submit(qs[3:5]), q.submit(qs[5:9])
    s = q.tick()
    # t1 (3) + t2 (2) fit; t3 (4) would overflow 8 -> head-of-line stop
    assert (s.segments, s.rows, s.shed) == (2, 5, 0)
    assert t1.done() and t2.done() and not t3.done()
    s = q.tick()
    assert (s.segments, s.rows) == (1, 4) and t3.done()


def test_priority_strict_across_classes(qos_env):
    q = _queue(qos_env)
    qs = qos_env["qs"]
    tlow = q.submit(qs[:6], priority=1)
    thigh = q.submit(qs[6:12], priority=0)
    s = q.tick()
    assert (s.segments, s.rows) == (1, 6)
    assert thigh.done() and not tlow.done()
    q.tick()
    assert tlow.done()


def test_edf_within_class(qos_env):
    q = _queue(qos_env)
    qs = qos_env["qs"]
    t_none = q.submit(qs[:6])
    t_loose = q.submit(qs[6:12], deadline_ms=60_000)
    t_tight = q.submit(qs[12:18], deadline_ms=10_000)
    s = q.tick()
    assert (s.segments, s.rows) == (1, 6)
    assert t_tight.done() and not t_loose.done() and not t_none.done()
    q.tick()
    assert t_loose.done() and not t_none.done()
    q.tick()
    assert t_none.done()


def test_qos_reorder_stays_bit_exact(qos_env):
    q = _queue(qos_env)
    qs = qos_env["qs"]
    _, direct = qos_env["engine"].make_plan_fn(plan="fused", k=2)
    reqs = [qs[:3], qs[3:4], qs[4:10], qs[10:12]]
    prios = [1, 0, 1, 0]
    deadlines = [None, 50_000.0, 60_000.0, None]
    tickets = [q.submit(r, priority=p, deadline_ms=dl)
               for r, p, dl in zip(reqs, prios, deadlines)]
    q.drain()
    for t, r in zip(tickets, reqs):
        _assert_same(t.result(0), direct(r), "QoS-reordered request")


def test_submit_validation(qos_env):
    q = _queue(qos_env, warmup=False)
    qs = qos_env["qs"]
    with pytest.raises(ValueError, match="priority"):
        q.submit(qs[:2], priority=-1)
    with pytest.raises(ValueError, match="deadline_ms"):
        q.submit(qs[:2], deadline_ms=0.0)


# --------------------------------------------------------------------------
# Shedding
# --------------------------------------------------------------------------

def test_expired_request_sheds_with_typed_error(qos_env):
    q = _queue(qos_env)
    qs = qos_env["qs"]
    texp = q.submit(qs[:2], deadline_ms=1.0)
    time.sleep(0.01)
    tok = q.submit(qs[2:5])
    s = q.tick()
    assert s.shed == 1 and s.segments == 1 and s.rows == 3
    with pytest.raises(DeadlineExceeded, match="shed"):
        texp.result(0)
    assert tok.result(0) is not None
    assert q.shed_count == 1


def test_shed_drops_sibling_segments(qos_env):
    q = _queue(qos_env)
    qs = qos_env["qs"]
    tbig = q.submit(qs[:12], deadline_ms=1.0)      # 2 segments at max_batch 8
    time.sleep(0.01)
    tok = q.submit(qs[12:14])
    s = q.tick()
    assert s.shed == 1 and s.rows == 2
    with pytest.raises(DeadlineExceeded):
        tbig.result(0)
    assert q.depth == 0 and tok.done()


def test_all_expired_tick_dispatches_nothing(qos_env):
    q = _queue(qos_env)
    qs = qos_env["qs"]
    before = q.dispatch_count
    t1 = q.submit(qs[:2], deadline_ms=1.0)
    t2 = q.submit(qs[2:4], deadline_ms=1.0)
    time.sleep(0.01)
    assert q.tick() is None
    assert q.dispatch_count == before and q.shed_count == 2
    for t in (t1, t2):
        with pytest.raises(DeadlineExceeded):
            t.result(0)


def test_dispatch_failure_still_runtime_error(qos_env):
    """DeadlineExceeded is the only error a ticket raises bare."""
    q = _queue(qos_env, warmup=False)

    def boom(qs, valid):
        raise RuntimeError("injected")

    q._fn = boom
    t = q.submit(qos_env["qs"][:2])
    with pytest.raises(RuntimeError, match="injected"):
        q.tick()
    with pytest.raises(RuntimeError, match="failed in its serving tick"):
        t.result(0)
    assert not isinstance(t._error, DeadlineExceeded)


# --------------------------------------------------------------------------
# Observability: windowed stats, rung histogram, QoS block
# --------------------------------------------------------------------------

def test_stats_summary_window_and_rung_hist(qos_env):
    q = _queue(qos_env)
    qs = qos_env["qs"]
    for lo, hi in ((0, 2), (2, 4), (4, 10)):       # shapes 4, 4, 8
        q.submit(qs[lo:hi])
        q.tick()
    full = q.stats_summary()
    assert full["ticks"] == 3 and full["rung_hist"] == {4: 2, 8: 1}
    last = q.stats_summary(window=1)
    assert last["ticks"] == 1 and last["rung_hist"] == {4: 0, 8: 1}
    assert last["dispatches"] == 3                 # counters stay cumulative
    with pytest.raises(ValueError, match="window"):
        q.stats_summary(window=0)


def test_qos_block_hit_rates_by_class(qos_env):
    q = _queue(qos_env)
    qs = qos_env["qs"]
    q.submit(qs[:2], priority=0, deadline_ms=60_000)
    q.submit(qs[2:4], priority=1, deadline_ms=1.0)
    q.submit(qs[4:6])                              # untracked (no deadline)
    time.sleep(0.01)
    q.drain()
    qos = q.stats_summary()["qos"]
    assert qos["tickets"] == 3 and qos["tracked"] == 2 and qos["shed"] == 1
    assert qos["by_class"][0]["hit_rate"] == 1.0
    assert qos["by_class"][1]["shed"] == 1 and qos["by_class"][1]["hit_rate"] == 0.0
    assert qos["deadline_hit_rate"] == 0.5


# --------------------------------------------------------------------------
# Adaptive ladder
# --------------------------------------------------------------------------

def test_adaptive_ladder_stops_at_preferred_rung(qos_env):
    q = _queue(qos_env, adaptive_ladder=True, window=8)
    qs = qos_env["qs"]
    for _ in range(8):                             # history: 2-row ticks
        q.submit(qs[:2])
        q.tick()
    assert q._target_rows() == 4
    tickets = [q.submit(qs[i:i + 2]) for i in range(0, 12, 2)]  # 12 rows deep
    s = q.tick()
    assert s.shape == 4 and s.rows == 4
    q.drain()
    assert all(t.done() for t in tickets)


def test_adaptive_ladder_fills_for_urgent_deadline(qos_env):
    q = _queue(qos_env, adaptive_ladder=True, window=8, tick_us=1e6)
    qs = qos_env["qs"]
    for _ in range(8):
        q.submit(qs[:2])
        q.tick()
    q.submit(qs[:2], priority=0)
    q.submit(qs[2:4], priority=0)
    turgent = q.submit(qs[4:6], priority=1, deadline_ms=500.0)
    s = q.tick()
    assert s.rows == 6 and turgent.done()


def test_adaptive_off_by_default(qos_env):
    q = _queue(qos_env, warmup=False)
    assert q._target_rows() == q.max_batch


# --------------------------------------------------------------------------
# The queue over the external plans, and cache warming
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["mem", "mmap", "aio", "uring"])
def test_queue_over_external_parity(qos_env, spill, backend):
    """Queued ragged requests over plan="external" equal direct external
    dispatch bit for bit on every store, and stats_summary carries the
    store's ledger and provenance."""
    if backend == "uring":
        _require_uring(spill)
    qs = qos_env["qs"]
    with st.load_external(spill, backend=backend, qd=8, device="cpu") as ext:
        engine = SearchEngine(ext)
        queue = BatchQueue(engine, k=2, ladder=(4, 8), tick_us=50.0)
        assert queue.plan == "external"
        _, direct = engine.make_plan_fn(plan="external", k=2)
        reqs = [qs[:1], qs[1:6], qs[6:17], qs[3:7]]   # incl. a > max_batch spill
        base = ext.store.stats.snapshot()
        tickets = [queue.submit(r, deadline_ms=60_000) for r in reqs]
        queue.drain()
        io = ext.store.stats.since(base)
        results = [t.result(0) for t in tickets]
        assert io.reads == sum(int(r.nio_blocks.sum()) for r in results)
        for r, got in zip(reqs, results):
            _assert_same(got, direct(r), f"queued external ({backend})")
        s = queue.stats_summary()
        assert s["dispatches"] == s["ticks"]
        es = s["external_store"]
        assert es["backend"] == ext.store.name and es["reads"] > 0
        assert "fallback_from" in es and "num_shards" not in es


def test_queue_over_sharded_external_parity(qos_env, sharded_spill):
    """Queued QoS traffic over plan="sharded_external" equals direct
    dispatch bit for bit; the external_store block carries the provenance
    and the per-shard ledgers."""
    qs = qos_env["qs"]
    with st.load_external_sharded(sharded_spill, backend="aio", qd=8, device="cpu") as ext:
        engine = SearchEngine(ext)
        queue = BatchQueue(engine, k=2, ladder=(4, 8), tick_us=50.0)
        assert queue.plan == "sharded_external"
        _, direct = engine.make_plan_fn(plan="sharded_external", k=2)
        reqs = [qs[:1], qs[1:6], qs[6:17], qs[3:7]]
        tickets = [queue.submit(r, priority=i % 2, deadline_ms=60_000)
                   for i, r in enumerate(reqs)]
        queue.drain()
        for t, r in zip(tickets, reqs):
            _assert_same(t.result(0), direct(r), "queued sharded_external")
        s = queue.stats_summary()
        es = s["external_store"]
        assert es["backend"] == "aio" and es["fallback_from"] is None
        assert es["num_shards"] == 2 and len(es["per_shard"]) == 2
        assert sum(p["reads"] for p in es["per_shard"]) == es["reads"] > 0
        assert s["qos"]["deadline_hit_rate"] == 1.0


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_cache_warming_from_probe_trace(qos_env, spill, sharded_spill, layout):
    """warm_cache_rows=N: served traffic fills the probe-trace histogram;
    warming prefetches hot rows into the cache (each shard's own arena when
    striped) on the prefetch lane, never the logical ledger; results stay
    exact. The tiny arena guarantees served rows were evicted, so the warm
    pass must fetch."""
    qs = qos_env["qs"]
    if layout == "single":
        opened = st.load_external(spill, backend="aio", qd=8, cache_rows=8, device="cpu")
    else:
        opened = st.load_external_sharded(sharded_spill, backend="aio", qd=8, cache_rows=8,
                                          device="cpu")
    with opened as ext:
        engine = SearchEngine(ext)
        queue = BatchQueue(engine, k=1, ladder=(4, 8), warm_cache_rows=64)
        assert ext.collect_row_hist
        t0 = queue.submit(qs[:6])
        queue.drain()
        ref = t0.result(0)
        assert ext.row_hist, "served traffic left no probe trace"
        hot = ext.hot_rows()
        counts = [ext.row_hist[int(g)] for g in hot]
        assert counts == sorted(counts, reverse=True)
        assert len(ext.hot_rows(5)) == 5
        reads_before = ext.store.stats.reads
        pf_before = ext.store.stats.prefetch_reads
        warmed = queue.warm_cache()
        assert 0 < warmed <= 64
        assert ext.store.stats.reads == reads_before      # ledger untouched
        assert ext.store.stats.prefetch_reads > pf_before
        if layout == "sharded":
            assert all(s.prefetch_reads > 0 for s in ext.store.per_shard_stats())
        t1 = queue.submit(qs[:6])
        queue.drain()
        _assert_same(t1.result(0), ref, "re-served after warming")


def test_background_loop_warms_when_idle(qos_env, spill):
    """The loop re-warms the store cache from the probe trace once the queue
    goes idle after serving."""
    qs = qos_env["qs"]
    with st.load_external(spill, backend="aio", qd=8, cache_rows=8, device="cpu") as ext:
        queue = BatchQueue(SearchEngine(ext), k=1, ladder=(4, 8), tick_us=100.0,
                           warm_cache_rows=32)
        pf = ext.store.stats.prefetch_reads
        with queue:
            queue.submit(qs[:6]).result(timeout=60)
            deadline = time.monotonic() + 30
            while queue._warmed_at != queue.dispatch_count and time.monotonic() < deadline:
                time.sleep(0.01)
        assert queue._warmed_at == queue.dispatch_count > 0
        assert ext.store.stats.prefetch_reads > pf


def test_warm_cache_noop_on_in_memory_engine(qos_env):
    q = _queue(qos_env, warm_cache_rows=32, warmup=False)
    assert q.warm_cache() == 0


def test_hot_rows_empty_without_a_trace(spill):
    with st.load_external(spill, backend="mem", device="cpu") as ext:
        assert not ext.collect_row_hist
        SearchEngine(ext).query(np.zeros((2, ext.db.shape[1]), np.float32), k=1)
        assert ext.row_hist is None and ext.hot_rows().size == 0
        assert ext.warm_cache() == 0


def test_deadline_exceeded_is_exported():
    import repro_torch.serving as serving

    assert issubclass(serving.DeadlineExceeded, RuntimeError)
    t = QueryTicket(1, deadline=None)
    assert t.deadline is None and t.priority == 0
