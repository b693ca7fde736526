"""The port's serving front end held against the reference's.

* One seeded submission sequence (sizes, priorities, deadlines, and when the
  clock moves and a tick runs) goes into the reference's ``BatchQueue`` and
  the port's, over the same index (the port loads the reference's ``.npz``),
  with each engine module's ``time.monotonic`` on one fixed, hand-advanced
  clock: the tick logs (shape, rows, segments, pad rows, shed) and the shed
  tickets are identical; every served request's integer fields are equal and
  its distances allclose at 2e-4 on the rows whose query hashes agree (the
  bucket-flip rate is reported).
* Over one spill file and one request stream, the external plan's
  probe-trace histogram (``row_hist``) and ``hot_rows`` equal the
  reference's (the stream holds only queries whose hashes agree).
* ``render_prometheus`` of one snapshot gives the reference's text byte for
  byte, and ``spans_to_chrome`` of one span list the reference's events.

The reference is imported lazily: these tests skip where JAX is absent.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import storage as st
from repro_torch import telemetry
from repro_torch.core import E2LSHIndex, SearchEngine
from repro_torch.kernels import lsh_hash_all_radii
from repro_torch.serving import BatchQueue, DeadlineExceeded
from repro_torch.serving import engine as port_engine

_INT_FIELDS = ("ids", "found", "radii_searched", "nio_table", "nio_blocks",
               "cands_checked")


@pytest.fixture(scope="module")
def ref():
    """The reference's packages (JAX)."""
    pytest.importorskip("jax")
    import repro.core
    import repro.serving
    import repro.serving.engine
    import repro.storage
    import repro.telemetry
    return types.SimpleNamespace(core=repro.core, serving=repro.serving,
                                 engine=repro.serving.engine, storage=repro.storage,
                                 telemetry=repro.telemetry)


@pytest.fixture(scope="module")
def env(ref, tmp_path_factory):
    """A small index built by the reference (the QoS tests' sizing), its
    ``.npz`` loaded by the port, its spill file, a query pool, and which
    pool rows hash alike on both sides."""
    import jax.numpy as jnp
    from repro.kernels.lsh_hash.ops import lsh_hash_all_radii as ref_hash

    rng = np.random.default_rng(29)
    n, d = 1500, 12
    centers = rng.normal(size=(24, d)).astype(np.float32)
    db = (centers[rng.integers(0, 24, n)] + 0.18 * rng.normal(size=(n, d))).astype(np.float32)
    qs = (db[rng.choice(n, 64, replace=False)]
          + 0.05 * rng.normal(size=(64, d))).astype(np.float32)
    s = float(np.median(np.linalg.norm(db - db.mean(0), axis=1))) / 3
    db, qs = db / s, qs / s
    ref_idx = ref.core.E2LSHoS.build(db, gamma=0.7, s_scale=2.0, max_L=8, seed=3)
    root = tmp_path_factory.mktemp("serving_parity")
    ref_idx.index.save(root / "ix.npz")
    ref_idx.index.spill(root / "ix.e2l")
    port_index = E2LSHIndex.load(root / "ix.npz", device="cpu")
    p = port_index.params
    kw = dict(w=p.w, radii=tuple(p.radii), u=p.u, fp_bits=p.fp_bits)
    ra, pa = ref_idx.index.arrays, port_index.arrays
    bk_r, fp_r = ref_hash(jnp.asarray(qs), ra.a, ra.b, ra.rm, **kw)
    bk_p, fp_p = lsh_hash_all_radii(torch.from_numpy(qs), pa.a, pa.b, pa.rm, **kw)
    agree = ((np.asarray(bk_r) == bk_p.numpy()) & (np.asarray(fp_r) == fp_p.numpy()))
    agree = agree.all(axis=2).all(axis=0)
    return dict(ref_idx=ref_idx, port_index=port_index, spill=root / "ix.e2l", qs=qs,
                agree=agree, d=d)


class _Clock:
    """A stand-in for the ``time`` module: ``monotonic`` is the hand-moved
    clock, ``perf_counter`` (dispatch timing) the real one."""

    def __init__(self):
        import time
        self.now = 1000.0
        self.perf_counter = time.perf_counter

    def monotonic(self):
        return self.now


def _script(seed, n_requests, pool):
    """(sizes, starts, priorities, deadlines_ms, events): events are
    ("submit", i), ("advance", ms) and ("tick",), drawn from a numpy seed;
    ticks then run 1 ms apart until the queue is empty."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 13, n_requests)
    starts = rng.integers(0, pool - 12, n_requests)
    prios = rng.integers(0, 3, n_requests)
    deadlines = [None if rng.random() < 0.4 else float(rng.choice([3.0, 8.0, 50.0]))
                 for _ in range(n_requests)]
    events = []
    for i in range(n_requests):
        events.append(("submit", i))
        if rng.random() < 0.5:
            events.append(("advance", float(rng.choice([1.0, 2.0, 5.0]))))
        if rng.random() < 0.35:
            events.append(("tick",))
    return sizes, starts, prios, deadlines, events


def _run_script(queue, clock, script, qs):
    sizes, starts, prios, deadlines, events = script
    tickets, ticks = {}, []
    for ev in events:
        if ev[0] == "submit":
            i = ev[1]
            tickets[i] = queue.submit(qs[starts[i]:starts[i] + sizes[i]],
                                      priority=int(prios[i]), deadline_ms=deadlines[i])
        elif ev[0] == "advance":
            clock.now += ev[1] * 1e-3
        else:
            s = queue.tick()
            ticks.append(None if s is None else
                         (s.shape, s.rows, s.segments, s.pad_rows, s.shed))
    while queue.depth:                 # the tail: 1 ms of clock per tick
        clock.now += 1e-3
        s = queue.tick()
        ticks.append(None if s is None else (s.shape, s.rows, s.segments, s.pad_rows, s.shed))
    return tickets, ticks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tick_log_and_shed_set_match_reference(ref, env, monkeypatch, seed):
    clock = _Clock()
    monkeypatch.setattr(ref.engine, "time", clock)
    monkeypatch.setattr(port_engine, "time", clock)
    script = _script(seed, 28, env["qs"].shape[0])
    kw = dict(plan="fused", k=3, ladder=(4, 8), max_batch=8)
    ref_q = ref.serving.BatchQueue(ref.core.SearchEngine(env["ref_idx"]), **kw)
    port_q = BatchQueue(SearchEngine(env["port_index"], device="cpu"), **kw)
    clock.now = 1000.0
    ref_t, ref_ticks = _run_script(ref_q, clock, script, env["qs"])
    clock.now = 1000.0
    port_t, port_ticks = _run_script(port_q, clock, script, env["qs"])
    assert port_ticks == ref_ticks
    assert any(t is not None and t[4] > 0 for t in ref_ticks), "the script shed nothing"
    sizes, starts = script[0], script[1]
    compared = flips = 0
    for i in sorted(ref_t):
        try:
            want = ref_t[i].result(0)
        except ref.serving.DeadlineExceeded:
            with pytest.raises(DeadlineExceeded):
                port_t[i].result(0)
            continue
        got = port_t[i].result(0)
        rows = env["agree"][starts[i]:starts[i] + sizes[i]]
        flips += int((~rows).sum())
        compared += int(rows.sum())
        for name in _INT_FIELDS:
            np.testing.assert_array_equal(getattr(got, name).numpy()[rows],
                                          np.asarray(getattr(want, name))[rows],
                                          err_msg=f"request {i}: {name}")
        np.testing.assert_allclose(got.dists.numpy()[rows], np.asarray(want.dists)[rows],
                                   rtol=2e-4, atol=2e-4, err_msg=f"request {i}: dists")
    assert port_q.shed_count == ref_q.shed_count > 0
    assert port_q.stats_summary()["qos"]["by_class"].keys() == \
        ref_q.stats_summary()["qos"]["by_class"].keys()
    print(f"[parity] seed {seed}: {compared} served rows compared, {flips} skipped for a "
          f"bucket flip (flip rate {flips / max(compared + flips, 1):.4f})")
    assert compared > 0


def test_probe_trace_histogram_matches_reference(ref, env):
    """The external plan's row histogram and hot rows over one spill file and
    one request stream (warm-up rows excluded on both sides)."""
    qs = env["qs"][env["agree"]]
    requests = [qs[i:i + b] for i, b in zip(range(0, 40, 5), (5, 1, 3, 5, 2, 5, 4, 5))]
    kw = dict(k=2, ladder=(4, 8), max_batch=8, warm_cache_rows=16)
    with ref.storage.load_external(env["spill"], backend="mem") as rext, \
            st.load_external(env["spill"], backend="mem", device="cpu") as pext:
        queues = (ref.serving.BatchQueue(ref.core.SearchEngine(rext), **kw),
                  BatchQueue(SearchEngine(pext), **kw))
        for ext, queue in zip((rext, pext), queues):
            assert ext.collect_row_hist
            ext.row_hist = None                  # the warm-up's dummy rows
            for r in requests:
                queue.submit(r)
            queue.drain()
        assert pext.row_hist and pext.row_hist == rext.row_hist
        np.testing.assert_array_equal(pext.hot_rows(), rext.hot_rows())
        np.testing.assert_array_equal(pext.hot_rows(7), rext.hot_rows(7))
        assert pext.store.stats.reads == rext.store.stats.reads


def test_prometheus_text_and_chrome_trace_match_reference(ref, env):
    """The exporters are the reference's: one snapshot renders to the same
    Prometheus text, one span list to the same chrome-trace events."""
    telemetry.reset()
    telemetry.enable(sampling=1.0)
    try:
        queue = BatchQueue(SearchEngine(env["port_index"], device="cpu"), k=2,
                           ladder=(4, 8), max_batch=8)
        queue.submit(env["qs"][:3], deadline_ms=60_000)
        queue.submit(env["qs"][3:9], priority=1)
        queue.drain()
        snap = telemetry.snapshot()
        spans = telemetry.get_tracer().spans()
    finally:
        telemetry.disable()
        telemetry.get_tracer().clear()
    assert "e2lsh_serve_dispatches_total" in snap
    assert snap["e2lsh_serve_dispatch_ms"]["type"] == "histogram"
    text = telemetry.render_prometheus(snap)
    assert text == ref.telemetry.render_prometheus(snap)
    assert 'e2lsh_serve_rows_total{plan="fused"} 9' in text.splitlines()
    assert telemetry.spans_to_chrome(spans) == ref.telemetry.spans_to_chrome(spans)
    assert {"serve.tick", "tick.pack", "tick.dispatch", "tick.scatter"} <= \
        {sp.name for sp in spans}
