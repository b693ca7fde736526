"""The port's query engine: its own plans against each other, and against the
reference on an index carried across by ``IndexArrays.from_numpy``.

* fused == oracle, bit-exact on every field, on the port (the contract the
  reference pins in tests/test_query_engine.py), under the k, s_cap and
  block_objs knobs, with masked rows inert and a lone query padded;
* the port's probe stage fed the reference's query hashes == the reference's
  fused plan: exact on every integer field, distances allclose at 2e-4;
  one radius of it, the plain fused probe and distance epilogue, == the
  reference's ``_probe_radius_fused`` under several chain depths and
  budgets, with inactive queries;
* the io_count replay of the port's probe trace == its I/O counters;
* the fused and external plans fold each radius through ``_update_state``:
  on the card one ``topk_merge`` launch a ``query.merge`` span (a rung),
  and no CUDA tensor reaches the plain fold; on the CPU no launch;
* the hash stage is one ``lsh_hash`` launch a ``query.hash`` span on the
  card (fused, external and in-process sharded plans), with no other
  launch inside the span; on the CPU its plain version is the plain hashes
  followed by ``table_lookup``, bit for bit, and launches nothing.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (E2LSHIndex, HashFamily, IndexArrays, LSHParams,
                              SearchEngine)
from repro_torch.core import query as tq
from repro_torch.core.io_count import nio_for_block_size
from repro_torch.kernels import KERNELS

_INT_FIELDS = ("ids", "found", "radii_searched", "nio_table", "nio_blocks",
               "cands_checked")


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_identical(a, b, *, probe_sizes=False):
    for name in _INT_FIELDS + ("dists",):
        np.testing.assert_array_equal(_np(getattr(a, name)), _np(getattr(b, name)),
                                      err_msg=f"field {name} diverged")
    if probe_sizes:
        np.testing.assert_array_equal(_np(a.probe_sizes), _np(b.probe_sizes))


def _carry(ref_index, device="cpu") -> E2LSHIndex:
    """The reference's index as a port index (params, family, leaves)."""
    ra, f = ref_index.arrays, ref_index.family
    arrays = IndexArrays.from_numpy(
        {n: np.asarray(getattr(ra, n)) for n in IndexArrays.array_fields()},
        block_objs=ra.block_objs, lane_pad=ra.lane_pad, device=device)
    family = HashFamily.from_numpy(np.asarray(f.a), np.asarray(f.b), np.asarray(f.rm),
                                   w=f.w, u=f.u, fp_bits=f.fp_bits, device=device)
    return E2LSHIndex(params=LSHParams(**dataclasses.asdict(ref_index.params)),
                      family=family, arrays=arrays, stats=None)


@pytest.fixture(scope="module")
def engine(built_index):
    return SearchEngine(_carry(built_index.index), device="cpu")


@pytest.mark.parametrize("k,s_cap,block_objs", [(1, None, None), (5, None, None),
                                                (1, 8, None), (3, None, 16)])
def test_fused_matches_oracle_bit_exact(engine, clustered_data, k, s_cap, block_objs):
    q = clustered_data["queries"]
    kw = dict(k=k, s_cap=s_cap, block_objs=block_objs)
    _assert_identical(engine.query(q, plan="oracle", **kw),
                      engine.query(q, plan="fused", **kw))


def test_fused_probe_sizes_match_oracle(engine, clustered_data):
    q = clustered_data["queries"][:16]
    ref = engine.query(q, plan="oracle", collect_probe_sizes=True)
    fus = engine.query(q, plan="fused", collect_probe_sizes=True)
    _assert_identical(ref, fus, probe_sizes=True)


@pytest.mark.parametrize("plan", ["fused", "oracle"])
def test_masked_rows_inert_and_lone_query(engine, clustered_data, plan):
    """Masked rows probe nothing and report found=False; the real rows, and a
    lone query (padded to a masked pair), match an unpadded dispatch."""
    q = clustered_data["queries"][:16]
    valid = np.arange(16) < 9
    full = engine.query(q[:9], plan=plan, k=2)
    out = engine.query(q, plan=plan, k=2, valid=valid)
    _assert_identical(full, out.slice_rows(0, 9))
    pad = out.slice_rows(9, 16)
    assert not pad.found.any()
    assert (pad.ids == tq.INVALID).all() and torch.isinf(pad.dists).all()
    for name in ("radii_searched", "nio_table", "nio_blocks", "cands_checked"):
        assert (getattr(pad, name) == 0).all(), name
    one = engine.query(q[3:4], plan=plan, k=2)
    _assert_identical(one, full.slice_rows(3, 4))
    stitched = tq.QueryResult.concat_rows([full.slice_rows(0, 4), full.slice_rows(4, 9)])
    _assert_identical(stitched, full)


def test_rows_agree_allows_only_tie_swaps():
    """The parity rule between plans: integers exact, dists to tol, and two
    ids may trade places only where their distances tie within tol."""
    def result(ids, dists, nio_blocks=(1, 1, 1)):
        z = torch.zeros(3, dtype=torch.int32)
        return tq.QueryResult(ids=torch.tensor(ids, dtype=torch.int32),
                              dists=torch.tensor(dists, dtype=torch.float32),
                              found=torch.ones(3, dtype=torch.bool), radii_searched=z,
                              nio_table=z, cands_checked=z,
                              nio_blocks=torch.tensor(nio_blocks, dtype=torch.int32))
    inf = float("inf")
    a = result([[1, 2], [3, 4], [5, tq.INVALID]], [[1.0, 2.0], [1.0, 1.00001], [0.5, inf]])
    b = result([[1, 2], [4, 3], [5, tq.INVALID]], [[1.0, 2.0], [1.00001, 1.0], [0.5, inf]])
    np.testing.assert_array_equal(a.rows_agree(b), [True, True, True])
    c = result([[2, 1], [4, 3], [5, tq.INVALID]], [[2.0, 1.0], [1.00001, 1.0], [0.5, inf]],
               nio_blocks=(1, 1, 2))
    np.testing.assert_array_equal(a.rows_agree(c), [False, True, False])
    np.testing.assert_array_equal(a.rows_agree(c, tol=0.0), [False, False, False])


def test_make_plan_fn_matches_query(engine, clustered_data):
    q = clustered_data["queries"][:12]
    cfg, fn = engine.make_plan_fn(plan="fused", k=3)
    _, fn_m = engine.make_plan_fn(plan="oracle", k=3, masked=True)
    assert cfg.k == 3 and engine.PLANS == ("fused", "host", "oracle")
    assert engine.plans == engine.PLANS and engine.external is None
    _assert_identical(fn(q), engine.query(q, plan="fused", k=3))
    _assert_identical(fn_m(q, np.ones(12, bool)), engine.query(q, plan="oracle", k=3))
    with pytest.raises(ValueError, match="unknown plan"):
        engine.query(q, plan="external")


@pytest.mark.parametrize("k,s_cap", [(1, None), (3, 8)])
def test_host_plan_matches_fused_bit_exact(engine, clustered_data, k, s_cap):
    """The host plan (the oracle's radius step, one host sync per radius for
    the early exit) equals fused on every field, masked rows and a lone
    query included."""
    q = clustered_data["queries"]
    kw = dict(k=k, s_cap=s_cap)
    _assert_identical(engine.query(q, plan="fused", collect_probe_sizes=True, **kw),
                      engine.query(q, plan="host", collect_probe_sizes=True, **kw),
                      probe_sizes=True)
    valid = np.arange(16) < 11
    _assert_identical(engine.query(q[:16], plan="fused", valid=valid, **kw),
                      engine.query(q[:16], plan="host", valid=valid, **kw))
    _, fn = engine.make_plan_fn(plan="host", **kw)
    _assert_identical(fn(q[5:6]), engine.query(q[5:6], plan="fused", **kw))


def test_tune_gamma_hits_target(clustered_data):
    """As the reference's (tests/test_serving.py): the first grid point that
    reaches the target overall ratio is returned, with its index."""
    from repro_torch.core import tune_gamma

    res = tune_gamma(clustered_data["db"], clustered_data["queries"],
                     clustered_data["gt_dists"][:, :1], target_ratio=1.05,
                     gammas=(0.7,), s_scales=(2.0,), max_L=24, seed=3, device="cpu")
    assert res.ratio < 1.05
    assert (res.gamma, res.s_scale) == (0.7, 2.0)
    assert res.index.index.arrays.device.type == "cpu"


@pytest.mark.parametrize("k", [1, 5])
def test_probe_stage_with_reference_hashes_matches_reference(engine, built_index,
                                                             clustered_data, k):
    """Inject the reference's query hashes into the port's probe stage: every
    integer field equals the reference's fused plan, distances agree to the
    kernel tolerance."""
    import jax.numpy as jnp
    from repro.core import SearchEngine as RefEngine
    from repro.kernels.lsh_hash.ops import lsh_hash_all_radii as ref_hash

    q = clustered_data["queries"]
    want = RefEngine(built_index.index).query(jnp.asarray(q), plan="fused", k=k)
    cfg = engine.config(k=k)
    ix = engine.arrays(cfg.block_objs)
    queries, qnorm2 = tq._prep_queries(torch.from_numpy(np.array(q)))
    ra = built_index.index.arrays
    bk, qfp = ref_hash(jnp.asarray(q), ra.a, ra.b, ra.rm, w=cfg.w, radii=cfg.radii,
                       u=cfg.u, fp_bits=cfg.fp_bits)
    cnt_all, head_all = tq.table_lookup(ix, torch.from_numpy(np.array(bk)), cfg)
    state = tq.probe_stage(ix, queries, qnorm2, cnt_all, head_all,
                           torch.from_numpy(np.array(qfp)), cfg)
    got = tq._result_from_state(state, cfg)
    for name in _INT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)),
                                      err_msg=f"field {name} diverged")
    np.testing.assert_allclose(_np(got.dists), _np(want.dists), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("max_chain,s_cap,t", [(1, None, 0), (2, 8, 1), (4, 24, 2),
                                               (2, None, 3)])
def test_probe_append_ref_matches_reference_fused_probe(engine, built_index,
                                                        clustered_data, max_chain, s_cap, t):
    """One radius of the fused probe, fed the reference's bucket sizes, chain
    heads and fingerprints: ``probe_append_ref`` == the reference's
    ``_probe_radius_fused`` on the buffer, the count and the blocks read,
    exactly; ``l2_distance_by_id_ref`` on that buffer == its distances at
    2e-4. A third of the queries are inactive; at s_cap = 8 and 24 the
    budget runs out inside a step."""
    import jax.numpy as jnp
    from repro.core import SearchEngine as RefEngine
    from repro.core import query as rq
    from repro.kernels.lsh_hash.ops import lsh_hash_all_radii as ref_hash
    from repro_torch.kernels import l2_distance_by_id_ref, probe_append_ref

    ref_engine = RefEngine(built_index.index)
    rcfg = ref_engine.config(k=1, s_cap=s_cap, max_chain=max_chain)
    rix = ref_engine.arrays(rcfg.block_objs)
    cfg = engine.config(k=1, s_cap=s_cap, max_chain=max_chain)
    ix = engine.arrays(cfg.block_objs)
    assert (cfg.S, cfg.max_chain, cfg.block_objs) == (rcfg.S, rcfg.max_chain,
                                                      rcfg.block_objs)
    q = np.asarray(clustered_data["queries"])
    active = np.arange(q.shape[0]) % 3 != 1
    rq_q, rq_n2 = rq._prep_queries(jnp.asarray(q))
    bk, qfp = ref_hash(rq_q, rix.a, rix.b, rix.rm, w=rcfg.w, radii=rcfg.radii, u=rcfg.u,
                       fp_bits=rcfg.fp_bits)
    flat = (np.arange(rcfg.L)[None, :] << rcfg.u) + np.asarray(bk[t])
    cnt = np.asarray(rix.table_cnt[t]).reshape(-1)[flat]
    head = np.asarray(rix.blocks_head[t]).reshape(-1)[flat]
    want_buf, want_d2, want_st = rq._probe_radius_fused(
        rix, rq_q, rq_n2, jnp.asarray(cnt), jnp.asarray(head), qfp[t], rcfg,
        jnp.asarray(active))
    buf, count, blocks = probe_append_ref(
        *(torch.from_numpy(np.array(x)) for x in (cnt, head, qfp[t], active)),
        ix.ids_blocks, ix.fps_blocks, block_objs=cfg.block_objs, max_chain=cfg.max_chain,
        S=cfg.S, sbuf=np.asarray(want_buf).shape[1])
    np.testing.assert_array_equal(_np(buf), np.asarray(want_buf))
    np.testing.assert_array_equal(_np(count), np.asarray(want_st["cands"]))
    np.testing.assert_array_equal(_np(blocks), np.asarray(want_st["nio_blocks"]))
    assert (_np(count)[~active] == 0).all() and _np(blocks)[active].sum() > 0
    if s_cap is not None:
        assert (_np(count) == cfg.S).any()
    queries, qnorm2 = tq._prep_queries(torch.from_numpy(q))
    d2 = l2_distance_by_id_ref(queries, buf, ix.db, ix.db_norm2, qnorm2)
    np.testing.assert_array_equal(np.isinf(_np(d2)), np.isinf(np.asarray(want_d2)))
    np.testing.assert_allclose(_np(d2), np.asarray(want_d2), rtol=2e-4, atol=2e-4)


def test_nio_replay_ties_out_with_counters(engine, built_index, clustered_data):
    res = engine.query(clustered_data["queries"], plan="fused", collect_probe_sizes=True)
    p = built_index.params
    replay = nio_for_block_size(_np(res.probe_sizes), s_cap=p.S,
                                block_bytes=p.block_bytes)
    np.testing.assert_array_equal(replay, _np(res.nio))
    assert replay.sum() > 0


@pytest.mark.cuda
def test_cuda_fused_matches_oracle_on_agreeing_rows():
    """On the card the fused plan runs the three kernels; on every row whose
    kernel hashes equal the plain hashes it matches the oracle plan exactly
    on integers, distances to 2e-4. (Port only: the card's machine has no
    JAX.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++")
    from repro_torch.core import E2LSHoS
    from repro_torch.data import make_dataset
    ds = make_dataset("sift", n=20_000, n_queries=64, seed=1)
    engine = SearchEngine(E2LSHoS.build(ds.db, gamma=0.8, max_L=32, device="cuda"))
    q = ds.queries
    for kern in KERNELS:
        kern.launches = 0
    fus = engine.query(q, plan="fused", k=3)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}
    assert all(launches[k] > 0 for k in ("lsh_hash", "bucket_probe", "l2_distance"))
    assert launches["l2_distance_dense"] == 0, launches
    ref = engine.query(q, plan="oracle", k=3)
    cfg, ix = engine.config(k=3), engine.arrays()
    qt = torch.from_numpy(np.array(q)).cuda()
    kw = dict(w=cfg.w, radii=cfg.radii, u=cfg.u, fp_bits=cfg.fp_bits)
    from repro_torch.kernels import lsh_hash_all_radii, lsh_hash_all_radii_ref
    bk, fp = lsh_hash_all_radii(qt, ix.a, ix.b, ix.rm, **kw)
    bk_p, fp_p = lsh_hash_all_radii_ref(qt, ix.a, ix.b, ix.rm, **kw)
    agree = _np(((bk == bk_p) & (fp == fp_p)).all(dim=2).all(dim=0))
    assert agree.mean() > 0.9
    # the parity rule chip_smoke.py holds: a tie within 2e-4 may swap ids
    differ = agree & ~fus.rows_agree(ref, tol=2e-4)
    assert not differ.any(), f"rows {np.flatnonzero(differ)} differ from the oracle"


_STAGES = ("query.upload", "query.hash", "query.init", "query.sync", "query.probe",
           "query.merge")


def _traced(fn, **enable):
    """fn() with tracing on at sampling 1.0: (its result, the spans recorded)."""
    from repro_torch import telemetry as tel
    tel.reset()
    tel.enable(sampling=1.0, **enable)
    try:
        return fn(), tel.get_tracer().spans()
    finally:
        tel.disable()
        tel.get_tracer().configure(record_function=False)
        tel.reset()


@pytest.mark.parametrize("k,s_cap,rows", [(1, None, "near"), (5, 8, "near"),
                                          (10, None, "near"), (1, None, "masked"),
                                          (1, None, "far")])
def test_fused_plan_spans_split_the_radius_loop(engine, clustered_data, k, s_cap, rows):
    """One fused call records one upload, hash and init span, a probe and a
    merge per radius run and a sync before each (the one that leaves early
    included; none after the last radius of the schedule), all children of
    the root ``query`` span inside its interval; results are the untraced
    call's, and tracing off records nothing."""
    from repro_torch import telemetry as tel

    q = clustered_data["queries"] + (1e6 if rows == "far" else 0.0)  # far: no bucket holds it
    valid = np.zeros(len(q), bool) if rows == "masked" else None
    kw = dict(plan="fused", k=k, s_cap=s_cap, valid=valid)
    res, spans = _traced(lambda: engine.query(q, **kw))
    (root,) = [sp for sp in spans if sp.name == "query"]
    by = {n: [sp for sp in spans if sp.name == n] for n in _STAGES}
    assert [len(by[n]) for n in ("query.upload", "query.hash", "query.init")] == [1, 1, 1]
    runs = int(res.radii_searched.max())
    r = len(engine.config().radii)
    if rows == "near":
        assert 0 < runs < r        # the batch leaves early
    else:
        assert runs == {"masked": 0, "far": r}[rows]
    assert len(by["query.probe"]) == len(by["query.merge"]) == runs
    assert len(by["query.sync"]) == runs + (0 if runs == r else 1)
    for n in ("query.sync", "query.probe", "query.merge"):
        assert [sp.attrs["t"] for sp in by[n]] == list(range(len(by[n]))), n
    for n in _STAGES:
        for sp in by[n]:
            assert sp.parent == root.sid, n
            assert root.ts_ns <= sp.ts_ns and sp.ts_ns + sp.dur_ns <= root.ts_ns + root.dur_ns
    _assert_identical(res, engine.query(q, **kw))
    assert len(tel.get_tracer()) == 0


def _merge_kernel():
    (kern,) = [k for k in KERNELS if k.name == "topk_merge"]
    return kern


def test_cpu_folds_launch_no_merge_kernel(engine, built_index, clustered_data, tmp_path):
    """On the CPU the fused and external plans fold every radius through the
    plain version: merge spans are recorded, no kernel launch is counted."""
    from repro_torch.storage import load_external

    q = clustered_data["queries"][:16]
    path = tmp_path / "ix.e2l"
    built_index.index.spill(path)
    before = _merge_kernel().launches
    _, spans = _traced(lambda: engine.query(q, plan="fused", k=3))
    with load_external(path, backend="mem", device="cpu") as ext:
        _, ext_spans = _traced(lambda: SearchEngine(ext).query(q, k=3))
    assert sum(sp.name == "query.merge" for sp in spans) > 0
    assert sum(sp.name == "external.fold_dispatch" for sp in ext_spans) > 0
    assert _merge_kernel().launches == before


@pytest.mark.cuda
def test_cuda_fused_and_external_fold_by_one_merge_launch_a_radius(tmp_path, monkeypatch):
    """On the card the fused plan launches ``topk_merge`` once a
    ``query.merge`` span (a radius folded) and the external plan once a rung,
    no CUDA tensor reaches the plain fold on either, and the oracle plan
    launches none; the fused result still matches the oracle's on every row
    whose kernel hashes equal the plain ones, and the external plan equals
    the fused one bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++")
    from repro_torch.core import E2LSHoS
    from repro_torch.data import make_dataset
    from repro_torch.kernels import lsh_hash_all_radii, lsh_hash_all_radii_ref
    from repro_torch.kernels.topk_merge import ops as merge_ops
    from repro_torch.storage import load_external

    plain = merge_ops.topk_merge_ref
    reached = []

    def watched(state, *args, **kw):
        reached.append(state[0].device.type)
        return plain(state, *args, **kw)
    monkeypatch.setattr(merge_ops, "topk_merge_ref", watched)
    ds = make_dataset("sift", n=20_000, n_queries=64, seed=1)
    idx = E2LSHoS.build(ds.db, gamma=0.8, max_L=32, device="cuda")
    engine = SearchEngine(idx)
    q = ds.queries
    kern = _merge_kernel()
    before = kern.launches
    fus, spans = _traced(lambda: engine.query(q, plan="fused", k=3))
    torch.cuda.synchronize()
    merges = sum(sp.name == "query.merge" for sp in spans)
    assert merges == int(fus.radii_searched.max()) > 0
    assert kern.launches - before == merges
    before = kern.launches
    ref = engine.query(q, plan="oracle", k=3)
    torch.cuda.synchronize()
    assert kern.launches == before
    cfg, ix = engine.config(k=3), engine.arrays()
    qt = torch.from_numpy(np.array(q)).cuda()
    kw = dict(w=cfg.w, radii=cfg.radii, u=cfg.u, fp_bits=cfg.fp_bits)
    bk, fp = lsh_hash_all_radii(qt, ix.a, ix.b, ix.rm, **kw)
    bk_p, fp_p = lsh_hash_all_radii_ref(qt, ix.a, ix.b, ix.rm, **kw)
    agree = _np(((bk == bk_p) & (fp == fp_p)).all(dim=2).all(dim=0))
    assert agree.mean() > 0.9
    differ = agree & ~fus.rows_agree(ref, tol=2e-4)
    assert not differ.any(), f"rows {np.flatnonzero(differ)} differ from the oracle"
    path = tmp_path / "ix.e2l"
    idx.index.spill(path)
    with load_external(path, backend="mem", device="cuda") as ext:
        before = kern.launches
        got = SearchEngine(ext).query(q, k=3)
        torch.cuda.synchronize()
        assert kern.launches - before == len(ext.last_plan_stats.rungs) > 0
    _assert_identical(got, fus)
    assert reached == []


def test_hash_stage_plain_is_table_lookup_over_plain_hashes(engine, clustered_data):
    """On the CPU the hash stage equals ``table_lookup`` over the plain
    hashes of the index's pack, bit for bit, in contiguous [r, Q, L]
    tensors, and launches no kernel."""
    from repro_torch.kernels.lsh_hash.ops import index_hash_pack
    from repro_torch.kernels.lsh_hash.ref import lsh_hash_packed_ref

    cfg = engine.config(k=3)
    ix = engine.arrays(cfg.block_objs)
    queries, _ = tq._prep_queries(torch.from_numpy(np.array(clustered_data["queries"])))
    before = [k.launches for k in KERNELS]
    cnt, head, qfp = tq.hash_stage(ix, queries, cfg)
    assert [k.launches for k in KERNELS] == before
    bk_p, qfp_p = lsh_hash_packed_ref(queries, index_hash_pack(ix, w=cfg.w, radii=cfg.radii),
                                      u=cfg.u, fp_bits=cfg.fp_bits)
    cnt_p, head_p = tq.table_lookup(ix, bk_p, cfg)
    shape = (len(cfg.radii), queries.shape[0], cfg.L)
    for got, want in ((cnt, cnt_p), (head, head_p), (qfp, qfp_p)):
        assert got.shape == shape and got.dtype == torch.int32 and got.is_contiguous()
        assert torch.equal(got, want)
    assert bool((head == -1).any()) and bool((head >= 0).any())


_LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")


def _hash_span_launches(prof):
    """Per ``query.hash`` range of a profile, the runtime calls inside it
    that put work on the card (kernel launches, copies, sets)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ranges = [e for e in events if e.name == "query.hash"]
    calls = [e for e in events if e.name.startswith("cu")
             and any(w in e.name for w in _LAUNCH_CALLS)]
    return [[c.name for c in calls if c.thread == r.thread
             and r.time_range.start <= c.time_range.start
             and c.time_range.end <= r.time_range.end] for r in ranges]


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["fused", "external", "sharded"])
def test_cuda_hash_stage_is_one_launch_a_span(plan, tmp_path):
    """On the card every ``query.hash`` span (the fused plan's, the external
    plan's set-up, each shard's fused body in the one-process sharded plan)
    launches ``lsh_hash`` exactly once, and ``torch.profiler`` sees no other
    launch, copy or set inside the span; the stage's outputs are the
    contiguous [r, Q, L] tensors the probe stage reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import E2LSHoS
    from repro_torch.core.distributed import build_sharded_index
    from repro_torch.data import make_dataset
    from repro_torch.storage import load_external

    ds = make_dataset("sift", n=20_000, n_queries=64, seed=1)
    (kern,) = [k for k in KERNELS if k.name == "lsh_hash"]
    ext = None
    if plan == "sharded":
        engine = SearchEngine(build_sharded_index(ds.db, 2, gamma=0.8, max_L=32, seed=3,
                                                  device="cuda"))
    else:
        idx = E2LSHoS.build(ds.db, gamma=0.8, max_L=32, device="cuda")
        engine = SearchEngine(idx)
        if plan == "external":
            idx.index.spill(tmp_path / "ix.e2l")
            ext = load_external(tmp_path / "ix.e2l", backend="mem", device="cuda")
            engine = SearchEngine(ext)
    try:
        def run():
            return engine.query(ds.queries, plan=plan, k=3)
        run()                                   # loads the kernels, builds the packs
        torch.cuda.synchronize()
        before = kern.launches

        def profiled():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            return prof
        prof, spans = _traced(profiled, record_function=True)
        hashes = sum(sp.name == "query.hash" for sp in spans)
        assert hashes == (2 if plan == "sharded" else 1)
        assert kern.launches - before == hashes
        inside = _hash_span_launches(prof)
        assert len(inside) == hashes
        assert all(len(names) == 1 and "Launch" in names[0] for names in inside), inside
    finally:
        if ext is not None:
            ext.close()
    if plan == "fused":
        cfg, ix = engine.config(k=3), engine.arrays()
        qt, _ = tq._prep_queries(torch.from_numpy(np.array(ds.queries)).cuda())
        outs = tq.hash_stage(ix, qt, cfg)
        assert all(o.shape == (len(cfg.radii), 64, cfg.L) and o.is_contiguous()
                   for o in outs)


def test_spans_open_profiler_ranges_with_record_function(engine, clustered_data):
    """``enable(record_function=True)``: each recorded span is a
    ``torch.profiler`` range, so a profile maps its operations to stages."""
    from torch.profiler import ProfilerActivity, profile

    q = clustered_data["queries"][:16]

    def run():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            engine.query(q, plan="fused", k=2)
        return {ev.name for ev in prof.events()}

    names, _ = _traced(run, record_function=True)
    assert {"query", "query.hash", "query.probe", "query.merge"} <= names
    names_off, _ = _traced(run)
    assert not {"query.hash", "query.probe", "query.merge"} & names_off


def _query_series(snap) -> dict:
    entry = snap.get("e2lsh_query_calls_total")
    if entry is None:
        return {}
    return {s["labels"]["plan"]: s["value"] for s in entry["samples"] if s["value"]}


def test_query_telemetry_matches_reference(engine, built_index, clustered_data, tmp_path):
    """After the same fused, oracle and external calls with tracing at
    sampling 1.0, the port's registry holds the reference's
    ``e2lsh_query_calls_total{plan}`` series and values, and its tracer the
    reference's span names, the root ``query`` span included, plus the six
    ``query.*`` stages of the port's host loop; every query span carries its
    plan and k."""
    import jax.numpy as jnp
    from repro import telemetry as ref_tel
    from repro.core import SearchEngine as RefEngine
    from repro.storage import load_external as ref_load
    from repro_torch import telemetry as tel
    from repro_torch.storage import load_external

    q = clustered_data["queries"][:8]
    path = tmp_path / "ix.e2l"
    built_index.index.spill(path)
    ref_engine = RefEngine(built_index.index)
    names = {}
    for side, t, make_engine, load, qs in (
            ("ref", ref_tel, lambda: ref_engine, ref_load, jnp.asarray(q)),
            ("port", tel, lambda: engine, lambda p, **kw: load_external(p, device="cpu", **kw),
             q)):
        t.reset()
        t.enable(sampling=1.0)
        try:
            e = make_engine()
            e.query(qs, plan="fused", k=2)
            e.query(qs, plan="oracle", k=2)
            e.query(qs, k=2)
            with load(path, backend="mem") as ext:
                type(e)(ext).query(qs, k=2)
            names[side] = (_query_series(t.snapshot()),
                           sorted({sp.name for sp in t.get_tracer().spans()}))
            roots = [sp for sp in t.get_tracer().spans() if sp.name == "query"]
            assert sorted(sp.attrs["plan"] for sp in roots) == [
                "external", "fused", "fused", "oracle"], side
            assert all(sp.attrs["k"] == 2 for sp in roots)
        finally:
            t.disable()
            t.reset()
    assert names["port"][0] == names["ref"][0] == {"fused": 2, "oracle": 1, "external": 1}
    # the reference's fused plan is one jitted dispatch with no host loop to split
    assert not set(names["ref"][1]) & set(_STAGES)
    assert names["port"][1] == sorted(set(names["ref"][1]) | set(_STAGES))
    assert "query" in names["port"][1]


def test_e2lshos_facade_entry_points(engine, built_index, clustered_data):
    """``query(adaptive=False)`` is the oracle plan, ``adaptive=True`` the
    fused one; ``index_arrays`` and ``query_config`` are the engine's."""
    from repro_torch.core import E2LSHoS

    idx = E2LSHoS(_carry(built_index.index))
    q = clustered_data["queries"][:12]
    _assert_identical(idx.query(q, k=3, adaptive=False), engine.query(q, plan="oracle", k=3))
    _assert_identical(idx.query(q, k=3), engine.query(q, plan="fused", k=3))
    _assert_identical(idx.query(q, k=3, adaptive=False, plan="fused"),
                      engine.query(q, plan="fused", k=3))
    assert idx.index_arrays() is idx.engine.arrays()
    narrow = idx.index_arrays(16)
    assert narrow.block_objs == 16 and idx.index_arrays(16) is narrow
    for name in IndexArrays.array_fields():
        assert torch.equal(getattr(narrow, name), getattr(engine.arrays(16), name)), name
    kw = dict(k=3, s_cap=8, max_chain=2, block_objs=16, collect_probe_sizes=True)
    assert idx.query_config(**kw) == engine.config(**kw)
    assert idx.query_config() == engine.config()
