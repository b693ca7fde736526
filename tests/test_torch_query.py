"""The port's query engine: its own plans against each other, and against the
reference on an index carried across by ``IndexArrays.from_numpy``.

* fused == oracle, bit-exact on every field, on the port (the contract the
  reference pins in tests/test_query_engine.py), under the k, s_cap and
  block_objs knobs, with masked rows inert and a lone query padded;
* the port's probe stage fed the reference's query hashes == the reference's
  fused plan: exact on every integer field, distances allclose at 2e-4;
* the io_count replay of the port's probe trace == its I/O counters.
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
