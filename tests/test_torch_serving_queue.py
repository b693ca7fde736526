"""The port's micro-batching queue (``repro_torch.serving.BatchQueue``):
parity, tick semantics, the dispatch probe, and its telemetry.

The contract is the reference's (tests/test_serving_queue.py): requests of
any batch size, packed FIFO into padded ladder-shaped ticks, come back bit
for bit what calling the plan directly on each request gives — padding rows
are inert by the core.query mask contract, and a Q = 1 dispatch is padded to
Q = 2. Steady state is ONE plan call per tick, and the warm-up leaves nothing
to load: no kernel library is loaded or built after it.

Also here: loading a kernel library is thread-safe (the queue's loop is a
second thread that launches kernels), the stats window-vs-reset race, and
the live ``/metrics`` server under load. CUDA cases (marker ``cuda``) run
the queue over the fused plan on the card.
"""
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

try:  # property-based sweep when the dev dep is present, fixed grid otherwise
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro_torch import storage as rst
from repro_torch import telemetry
from repro_torch.core import E2LSHoS, SearchEngine
from repro_torch.kernels import build as kbuild
from repro_torch.serving import BatchQueue, TickStats
from repro_torch.telemetry import MetricsServer

_EXACT_FIELDS = ("ids", "dists", "found", "radii_searched", "nio_table",
                 "nio_blocks", "cands_checked")

LADDER = (4, 8, 16)
MAX_BATCH = 16


def _assert_same(got, want, msg=""):
    for name in _EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name).cpu().numpy(),
                                      err_msg=f"{msg}: {name}")


@pytest.fixture(scope="module")
def queue_env():
    """Small index + engine + a direct fused baseline (the reference's
    queue-test sizing)."""
    rng = np.random.default_rng(11)
    n, d = 2500, 12
    centers = rng.normal(size=(24, d)).astype(np.float32)
    db = (centers[rng.integers(0, 24, n)]
          + 0.18 * rng.normal(size=(n, d))).astype(np.float32) / 1.5
    idx = E2LSHoS.build(db, gamma=0.7, s_scale=2.0, max_L=8, seed=3, device="cpu")
    engine = SearchEngine(idx, device="cpu")
    _, direct = engine.make_plan_fn(plan="fused", k=2)
    rng_q = np.random.default_rng(5)

    def make_request(b):
        base = db[rng_q.choice(n, b, replace=False)]
        return (base + 0.05 * rng_q.normal(size=base.shape)).astype(np.float32)

    return dict(idx=idx, engine=engine, direct=direct, make_request=make_request, d=d)


def _fresh_queue(env, **kw):
    kw.setdefault("ladder", LADDER)
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("k", 2)
    return BatchQueue(env["engine"], plan="fused", **kw)


def _assert_queued_matches_direct(env, queue, sizes):
    requests = [env["make_request"](b) for b in sizes]
    tickets = [queue.submit(r) for r in requests]
    queue.drain()
    for b, req, ticket in zip(sizes, requests, tickets):
        got = ticket.result(timeout=0)
        assert tuple(got.ids.shape) == (b, 2)
        _assert_same(got, env["direct"](req), f"queued request of size {b}")


def test_queued_bit_exact_across_ragged_sizes(queue_env):
    """Size 1, ladder-boundary sizes, an exact max-batch request and one
    that spills across ticks — all bit for bit the direct dispatch."""
    queue = _fresh_queue(queue_env)
    _assert_queued_matches_direct(
        queue_env, queue, sizes=(1, LADDER[0], LADDER[1], MAX_BATCH, MAX_BATCH + 9, 3))


def test_one_plan_call_per_tick_and_nothing_loads_after_warmup(queue_env, monkeypatch):
    """The dispatch probe: after the warm-up every tick is exactly one plan
    call, and no kernel library is loaded or built (the port's counterpart
    of the reference's jit-cache probe)."""
    loads = []
    monkeypatch.setattr(kbuild.CudaKernel, "_load",
                        lambda self: loads.append(("load", self.name)))
    monkeypatch.setattr(kbuild, "build_all",
                        lambda names=None: loads.append(("build", names)) or 0.0)
    queue = _fresh_queue(queue_env)
    calls = []
    real_fn = queue._fn

    def counting(qs, valid):
        calls.append(tuple(qs.shape))
        return real_fn(qs, valid)

    queue._fn = counting
    assert queue.dispatch_count == 0          # the warm-up is not counted
    for sizes in ((1, 2), (7,), (5, 5, 5), (2,)):
        for b in sizes:
            queue.submit(queue_env["make_request"](b))
        queue.tick()
    assert queue.dispatch_count == 4 == len(queue.tick_log)
    assert calls == [(4, queue_env["d"]), (8, queue_env["d"]), (16, queue_env["d"]),
                     (4, queue_env["d"])]
    assert not loads, loads


def test_tick_packs_fifo_and_pads_to_smallest_rung(queue_env):
    queue = _fresh_queue(queue_env)
    for b in (3, 2, 9):                        # 14 rows -> rung 16
        queue.submit(queue_env["make_request"](b))
    s = queue.tick()
    assert isinstance(s, TickStats)
    assert (s.rows, s.shape, s.segments) == (14, 16, 3)
    assert s.pad_rows == 2 and s.occupancy == pytest.approx(14 / 16)
    assert queue.tick() is None                # queue drained
    queue.submit(queue_env["make_request"](5))  # 5 rows -> rung 8
    s = queue.tick()
    assert (s.rows, s.shape) == (5, 8)


def test_head_of_line_request_spills_not_reorders(queue_env):
    queue = _fresh_queue(queue_env)
    t1 = queue.submit(queue_env["make_request"](10))
    t2 = queue.submit(queue_env["make_request"](9))   # 19 > max_batch
    assert queue.tick().rows == 10 and t1.done() and not t2.done()
    assert queue.tick().rows == 9 and t2.done()


def test_oversize_request_segments_reassemble_in_order(queue_env):
    b = 2 * MAX_BATCH + 5                      # 3 segments across 3 ticks
    req = queue_env["make_request"](b)
    queue = _fresh_queue(queue_env)
    ticket = queue.submit(req)
    assert queue.drain() == 3 and queue.dispatch_count == 3
    _assert_same(ticket.result(timeout=0), queue_env["direct"](req), "spilled request")


def test_background_loop_serves_tickets(queue_env):
    queue = _fresh_queue(queue_env, tick_us=100.0)
    with queue:
        tickets = [queue.submit(queue_env["make_request"](b)) for b in (1, 4, 7, 2)]
        results = [t.result(timeout=60.0) for t in tickets]
    assert [r.ids.shape[0] for r in results] == [1, 4, 7, 2]
    assert queue.dispatch_count == len(queue.tick_log) > 0
    assert queue._thread is None


def test_concurrent_synchronous_callers(queue_env):
    """Several caller threads driving query() at once, including a spilling
    request: ticks are serialized, every ticket resolves bit for bit, and the
    probe still counts one dispatch per tick."""
    queue = _fresh_queue(queue_env)
    sizes = (1, MAX_BATCH + 3, 5, 2, 9, MAX_BATCH, 4, 7)
    requests = [queue_env["make_request"](b) for b in sizes]
    results = [None] * len(sizes)
    errors = []

    def caller(j):
        try:
            results[j] = queue.query(requests[j], timeout=60.0)
        except Exception as e:   # surfaced below; don't hang the join
            errors.append((j, repr(e)))

    threads = [threading.Thread(target=caller, args=(j,)) for j in range(len(sizes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for b, req, got in zip(sizes, requests, results):
        assert tuple(got.ids.shape) == (b, 2)
        _assert_same(got, queue_env["direct"](req), f"concurrent caller (size {b})")
    assert queue.dispatch_count == len(queue.tick_log)
    assert queue.depth == 0


def test_stats_summary_accounting(queue_env):
    queue = _fresh_queue(queue_env)
    for b in (3, 2, 9, 5):
        queue.submit(queue_env["make_request"](b))
    queue.drain()
    s = queue.stats_summary()
    assert s["rows_served"] == 19 and s["segments"] == 4
    assert s["dispatches"] == s["ticks"] == len(queue.tick_log)
    assert 0.0 < s["occupancy_mean"] <= 1.0
    assert 0.0 <= s["pad_waste"] < 1.0
    assert s["p99_dispatch_ms"] >= s["p50_dispatch_ms"] > 0.0
    assert "external_store" not in s


def test_failed_dispatch_fails_tickets_not_hangs(queue_env):
    """A dying dispatch resolves its tickets with the error, surfaces it to
    the caller of tick(), and the queue keeps serving."""
    queue = _fresh_queue(queue_env)
    real_fn = queue._fn
    calls = {"n": 0}

    def flaky(qs, valid):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected dispatch failure")
        return real_fn(qs, valid)

    queue._fn = flaky
    doomed = queue.submit(queue_env["make_request"](3))
    with pytest.raises(RuntimeError, match="injected"):
        queue.tick()
    assert doomed.done()
    with pytest.raises(RuntimeError, match="injected"):
        doomed.result(timeout=0)
    ok = queue.query(queue_env["make_request"](2), timeout=60.0)
    assert tuple(ok.ids.shape) == (2, 2)


def test_background_loop_survives_a_failed_dispatch(queue_env):
    """The loop fails the affected tickets and keeps ticking."""
    queue = _fresh_queue(queue_env, tick_us=100.0)
    real_fn = queue._fn
    calls = {"n": 0}

    def flaky(qs, valid):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected dispatch failure")
        return real_fn(qs, valid)

    queue._fn = flaky
    with queue:
        doomed = queue.submit(queue_env["make_request"](3))
        with pytest.raises(RuntimeError, match="failed in its serving tick"):
            doomed.result(timeout=60.0)
        req = queue_env["make_request"](4)
        _assert_same(queue.submit(req).result(timeout=60.0), queue_env["direct"](req),
                     "after a failed tick")


def test_ladder_normalization():
    assert BatchQueue.resolve_ladder((32, 8, 8, 128)) == (8, 32, 128)
    assert BatchQueue.resolve_ladder((8, 32, 128), 64) == (8, 32, 64)
    assert BatchQueue.resolve_ladder((0, -4, 8), 16) == (8, 16)
    assert BatchQueue.resolve_ladder((), 16) == (16,)
    with pytest.raises(ValueError, match="ladder"):
        BatchQueue.resolve_ladder(())
    with pytest.raises(ValueError, match="max_batch"):
        BatchQueue.resolve_ladder((8,), 0)


def test_bad_requests_rejected(queue_env):
    queue = _fresh_queue(queue_env, warmup=False)
    with pytest.raises(ValueError, match="empty request"):
        queue.submit(np.zeros((0, queue_env["d"]), np.float32))
    with pytest.raises(ValueError, match="expected"):
        queue.submit(np.zeros((3, queue_env["d"] + 1), np.float32))
    with pytest.raises(ValueError, match="ladder"):
        BatchQueue(queue_env["engine"], ladder=(), warmup=False)
    with pytest.raises(TimeoutError, match="not served yet"):
        queue.submit(np.zeros((1, queue_env["d"]), np.float32)).result(timeout=0)


def _check_random_sequence(env, sizes):
    queue = _fresh_queue(env)
    _assert_queued_matches_direct(env, queue, sizes)
    assert queue.dispatch_count == len(queue.tick_log)


if HAVE_HYPOTHESIS:
    @settings(max_examples=8, deadline=None)
    @given(sizes=st.lists(st.integers(1, MAX_BATCH + 6), min_size=1, max_size=8))
    def test_random_request_sequences_bit_exact(queue_env, sizes):
        _check_random_sequence(queue_env, sizes)
else:
    @pytest.mark.parametrize("sizes", [
        (1,), (2, 2, 2), (16, 1, 5), (22, 3), (4, 8, 16, 1, 1, 1),
    ])
    def test_random_request_sequences_bit_exact(queue_env, sizes):
        _check_random_sequence(queue_env, sizes)


@pytest.mark.parametrize("plan", ["oracle", "host"])
def test_queue_over_oracle_and_host_plans(queue_env, plan):
    """The queue is plan-agnostic: the masked seam is in the engine."""
    queue = BatchQueue(queue_env["engine"], plan=plan, k=2, ladder=(8,), max_batch=8)
    for b in (5, 1, 8):
        req = queue_env["make_request"](b)
        _assert_same(queue.query(req, timeout=60.0),
                     queue_env["engine"].query(req, plan=plan, k=2), plan)


@pytest.mark.parametrize("probe_sizes", [False, True])
def test_result_packs_into_one_transfer_bit_exact(queue_env, probe_sizes):
    """``QueryResult.cpu`` (a tick's one device-to-host transfer) packs every
    field into one int32 tensor and unpacks it with each field's dtype,
    shape and bits (inf distances and the probe trace included)."""
    res = queue_env["engine"].query(
        np.concatenate([queue_env["make_request"](5), np.full((1, queue_env["d"]), 50.0,
                                                               np.float32)]),
        k=3, collect_probe_sizes=probe_sizes)
    assert res.cpu() is res                    # already on the host
    packed = res._packed()
    assert packed.dtype == torch.int32 and packed.shape[0] == 6
    back = res._unpacked(packed)
    assert bool(torch.isinf(res.dists).any())
    for name in _EXACT_FIELDS + ("probe_sizes",):
        a, b = getattr(res, name), getattr(back, name)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


# --------------------------------------------------------------------------
# Loading a kernel library from two threads
# --------------------------------------------------------------------------

def test_kernel_library_loads_once_under_threads(monkeypatch):
    """Eight threads reach one kernel first at once: one build, one dlopen,
    and every launch counted."""
    builds, opens = [], []

    class _Symbol:
        def __init__(self):
            self.argtypes, self.restype = None, None

        def __call__(self, *args):
            return 0

    class _Lib:
        def __init__(self, path):
            time.sleep(0.05)                   # a slow dlopen widens the race
            opens.append(path)
            self.kernel_fn = _Symbol()
            self.kernel_error_string = _Symbol()

    def fake_build(names=None):
        builds.append(names)
        time.sleep(0.05)
        return 0.0

    monkeypatch.setattr(kbuild, "build_all", fake_build)
    monkeypatch.setattr(kbuild.ctypes, "CDLL", _Lib)
    kern = kbuild.CudaKernel("lsh_hash", "kernel_fn", [])
    barrier = threading.Barrier(8)
    errors = []

    def launch():
        try:
            barrier.wait(timeout=30)
            for _ in range(25):
                kern()
        except Exception as e:
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert builds == [["lsh_hash"]] and len(opens) == 1
    assert kern.launches == 8 * 25


# --------------------------------------------------------------------------
# Telemetry under the queue: the stats race and the live /metrics server
# --------------------------------------------------------------------------

@pytest.fixture
def _telemetry_clean():
    yield
    telemetry.disable()
    telemetry.get_tracer().clear()


def test_stats_summary_window_vs_reset_race(queue_env):
    """tick() commits, stats_summary(window=N) reads and reset_stats()
    clears, concurrently: every summary is a consistent cut (a dispatch is
    never visible without its tick row)."""
    q = BatchQueue(queue_env["engine"], plan="fused", ladder=(4,), max_batch=4, k=2)
    req = queue_env["make_request"](3)
    q.submit(req)
    q.tick()
    q.reset_stats()
    stop = threading.Event()
    errors: list = []

    def reader():
        try:
            while not stop.is_set():
                full = q.stats_summary()
                assert full["dispatches"] == full["ticks"], \
                    f"torn cut: {full['dispatches']} != {full['ticks']}"
                windowed = q.stats_summary(window=3)
                assert windowed["ticks"] <= 3
                assert windowed["dispatches"] >= windowed["ticks"]
        except Exception as e:
            errors.append(e)

    def resetter():
        try:
            while not stop.is_set():
                q.reset_stats()
                time.sleep(0.002)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(2)]
    threads.append(threading.Thread(target=resetter))
    for t in threads:
        t.start()
    try:
        for _ in range(60):
            q.submit(req)
            q.tick()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]


def test_live_metrics_server_under_load(queue_env, tmp_path, _telemetry_clean):
    """A queue over an external engine behind a MetricsServer on an
    ephemeral port: the scrape carries live store reads, the queue's
    ``e2lsh_serve_*`` series, the dispatch histogram and the span trace."""
    idx = queue_env["idx"]
    idx.index.spill(tmp_path / "ix.e2l")
    telemetry.reset()
    telemetry.enable(sampling=1.0)
    with rst.load_external(tmp_path / "ix.e2l", backend="mem", device="cpu") as ext:
        q = BatchQueue(SearchEngine(ext), plan="external", ladder=(4, 8), max_batch=8, k=2)
        with MetricsServer(0) as server:
            tickets = [q.submit(queue_env["make_request"](4), deadline_ms=60_000)
                       for _ in range(4)]
            while q.depth:
                q.tick()
            for t in tickets:
                assert t.result(timeout=5).ids.shape[0] == 4

            def get(path):
                with urllib.request.urlopen(server.url + path, timeout=5) as r:
                    return r.read().decode()

            metrics = {}
            for line in get("/metrics").splitlines():
                if line and not line.startswith("#"):
                    key, val = line.rsplit(" ", 1)
                    metrics[key] = float(val)

            def series(prefix):
                return {k: v for k, v in metrics.items() if k.startswith(prefix)}

            assert sum(series("e2lsh_store_reads_total").values()) > 0
            assert metrics['e2lsh_serve_dispatches_total{plan="external"}'] == q.dispatch_count
            assert sum(series("e2lsh_serve_ticks_total{").values()) >= 2
            hit = series("e2lsh_serve_deadline_hit_rate{")
            assert hit and all(v == 1.0 for v in hit.values()), hit
            assert sum(series("e2lsh_serve_dispatch_ms_count").values()) >= 2
            doc = json.loads(get("/trace?last=64"))
            names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
            assert {"serve.tick", "tick.dispatch", "tick.scatter", "plan.external"} <= names
            assert json.loads(get("/snapshot"))["e2lsh_store_reads_total"]
            assert get("/healthz").strip() == "ok"
        assert server.port is None               # stopped
    s = q.stats_summary()
    assert s["qos"]["deadline_hit_rate"] == 1.0
    assert s["external_store"]["reads"] > 0
    assert s["external_store"]["backend"] == "mem"


def test_chrome_and_jsonl_exports(queue_env, tmp_path, _telemetry_clean):
    telemetry.enable(sampling=1.0)
    q = _fresh_queue(queue_env)
    q.query(queue_env["make_request"](3), timeout=60.0)
    n = telemetry.export_chrome_trace(tmp_path / "t.json")
    doc = json.loads((tmp_path / "t.json").read_text())
    assert n > 0 and {"serve.tick", "tick.dispatch"} <= {e["name"] for e in doc["traceEvents"]}
    assert telemetry.export_jsonl(tmp_path / "t.jsonl") == n
    assert len((tmp_path / "t.jsonl").read_text().splitlines()) == n


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.fixture
def cuda_env(cuda):
    from repro_torch.data import make_dataset

    ds = make_dataset("sift", n=20_000, n_queries=64, seed=4)
    engine = SearchEngine(E2LSHoS.build(ds.db, gamma=0.8, max_L=32, device=cuda))
    return engine, ds.queries


@pytest.mark.cuda
def test_cuda_queued_matches_direct_fused(cuda_env, monkeypatch):
    """On the card, over the fused plan at ladder 8/32/128 (one tick per
    group, so every rung serves): every request, lone queries included,
    comes back bit for bit its direct dispatch at its own size; the three
    kernels launched, and no kernel library loaded after the warm-up."""
    from repro_torch.kernels import KERNELS

    engine, qs = cuda_env
    queue = BatchQueue(engine, plan="fused", k=5, ladder=(8, 32, 128))
    loads = []
    monkeypatch.setattr(kbuild.CudaKernel, "_load", lambda self: loads.append(self.name))
    _, direct = engine.make_plan_fn(plan="fused", k=5)
    groups = ((1,), (3, 2), (8,), (9, 17), (31, 1), (32,), (33, 60), (128,))
    sizes = [b for g in groups for b in g]
    stream = qs[np.arange(sum(sizes)) % qs.shape[0]]
    requests = np.split(stream, np.cumsum(sizes)[:-1])
    for kern in KERNELS:
        kern.launches = 0
    tickets, i = [], 0
    for g in groups:
        tickets += [queue.submit(requests[i + j]) for j in range(len(g))]
        i += len(g)
        queue.tick()
    launches = {kern.name: kern.launches for kern in KERNELS}
    assert all(launches[k] > 0 for k in ("lsh_hash", "bucket_probe", "l2_distance")), launches
    assert not loads, loads
    assert [t.shape for t in queue.tick_log] == [8, 8, 8, 32, 32, 32, 128, 128]
    for b, r, t in zip(sizes, requests, tickets):
        _assert_same(t.result(timeout=0), direct(r), f"size {b}")


@pytest.mark.cuda
def test_cuda_background_thread_first_launch(cuda, monkeypatch):
    """A kernel's first launch may come from the queue's loop thread: with
    the libraries built but not yet loaded in this process, the loop loads
    them, launches on its default stream, and serves the right answer."""
    from repro_torch.data import make_dataset
    from repro_torch.kernels import KERNELS

    kbuild.build_all()
    for kern in KERNELS:
        monkeypatch.setattr(kern, "_fn", None)
    ds = make_dataset("sift", n=5_000, n_queries=16, seed=5)
    engine = SearchEngine(E2LSHoS.build(ds.db, gamma=0.8, max_L=16, device=cuda))
    queue = BatchQueue(engine, plan="fused", k=3, ladder=(16,), warmup=False)
    with queue:
        got = queue.submit(ds.queries).result(timeout=120)
    _assert_same(got, engine.query(ds.queries, plan="fused", k=3), "first launch")
