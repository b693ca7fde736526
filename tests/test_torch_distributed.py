"""The port's sharded in-memory plan (``repro_torch.core.distributed``).

* ``plan="sharded"`` (the fused body on every shard, merged) equals the
  port's per-shard ``plan="oracle"`` through the same merge, bit for bit,
  on 1, 2 and 4 uneven shards; also re-blockified per shard, and behind the
  serving queue, where every ticket equals its direct dispatch bit for bit
  for ragged request sizes.
* A reference sharded build carried across (``ShardedIndexArrays.from_numpy``)
  strips to per-shard data equal to the reference's stacked leaves; its
  ``to_global()`` equals the reference's leaf for leaf; its ``spill()``
  writes the reference's bytes, which ``plan="sharded_external"`` serves
  bit for bit with ``plan="fused"`` over ``to_global()``; fed the
  reference's query hashes, each shard's probe stage equals the reference's
  per-shard ``fused_plan_body``.
* One subprocess with two host devices runs the reference's own sharded plan
  under ``shard_map``; the port's merged result equals it on every row whose
  hashes the two packages compute alike.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import storage as st
from repro_torch.core import IndexArrays, LSHParams, SearchEngine
from repro_torch.core import query as tq
from repro_torch.core.distributed import (ShardedIndexArrays, build_sharded_index,
                                          make_sharded_query_fn, sharded_query_result)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-4
_FIELDS = ("ids", "dists", "found", "radii_searched", "nio_table", "nio_blocks",
           "cands_checked")


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_identical(a, b, fields=_FIELDS):
    for name in fields:
        np.testing.assert_array_equal(_np(getattr(a, name)), _np(getattr(b, name)),
                                      err_msg=f"field {name} diverged")


def _data(seed, n, d, n_centers=32, nq=16, spread=0.2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    db = (centers[rng.integers(0, n_centers, n)]
          + spread * rng.normal(size=(n, d))).astype(np.float32)
    q = (db[rng.choice(n, nq, replace=False)]
         + 0.05 * rng.normal(size=(nq, d))).astype(np.float32)
    return db / 2.0, q / 2.0, rng


@pytest.fixture(scope="module")
def data():
    return _data(4, 3001, 16)   # odd n: uneven shards


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sharded_matches_oracle(data, num_shards):
    db, q, _ = data
    sh = build_sharded_index(db, num_shards, gamma=0.7, s_scale=2.0, max_L=16, seed=3,
                             device="cpu")
    assert [ix.db.shape[0] for ix in sh.arrays] == list(np.diff(
        np.linspace(0, 3001, num_shards + 1).astype(int)))
    engine = SearchEngine(sh, device="cpu")
    assert engine.plans == ("sharded", "oracle") and engine.default_plan == "sharded"
    a = engine.query(q, k=2)
    b = engine.query(q, plan="oracle", k=2)
    _assert_identical(a, b)
    assert a.probe_sizes is None and float(a.found.float().mean()) > 0.5
    # the merge: the shards' counters summed and maximised, each shard's ids
    # offset by its base
    cap = max(4 * 2, -(-sh.params.S // num_shards))
    cfg = tq.QueryConfig.from_params(sh.params, k=2).replace(s_cap=cap)
    parts = [tq.fused_plan_body(ix, torch.from_numpy(q), cfg) for ix in sh.arrays]
    for name in ("nio_table", "nio_blocks", "cands_checked"):
        assert torch.equal(getattr(a, name), sum(getattr(r, name) for r in parts)), name
    assert torch.equal(a.radii_searched,
                       torch.stack([r.radii_searched for r in parts]).max(dim=0).values)
    owner = np.searchsorted(np.asarray(sh.shard_offsets), _np(a.ids), side="right") - 1
    for row, col in zip(*np.nonzero(_np(a.ids) != tq.INVALID)):
        s_ = owner[row, col]
        local = int(a.ids[row, col]) - sh.shard_offsets[s_]
        assert local in _np(parts[s_].ids[row])
    # a masked batch: padded rows are inert on every shard
    valid = np.arange(16) < 9
    out = engine.query(q, k=2, valid=valid)
    _assert_identical(out.slice_rows(0, 9), engine.query(q[:9], k=2))
    pad = out.slice_rows(9, 16)
    assert not pad.found.any() and (pad.nio_blocks == 0).all()
    assert (pad.ids == tq.INVALID).all()


def test_sharded_knobs_and_rejections(data):
    db, q, _ = data
    sh = build_sharded_index(db, 2, gamma=0.7, s_scale=2.0, max_L=8, seed=3, device="cpu")
    engine = SearchEngine(sh, device="cpu")
    # the per-shard budget: the default and an override
    cap = max(4 * 3, -(-sh.params.S // 2))
    direct = sharded_query_result(sh, q, k=3)
    _assert_identical(engine.query(q, k=3), direct)
    _assert_identical(engine.query(q, k=3, s_cap_per_shard=cap), direct)
    fn = make_sharded_query_fn(sh, k=3, s_cap_per_shard=5, local_plan="oracle")
    _assert_identical(fn(q), engine.query(q, plan="oracle", k=3, s_cap_per_shard=5))
    assert int(fn(q).cands_checked.max()) <= 2 * 5 * len(sh.params.radii)
    cfg, plan_fn = engine.make_plan_fn(plan="sharded", k=3, s_cap=40)
    assert cfg.S == 40 and cfg.k == 3
    _assert_identical(plan_fn(q), engine.query(q, k=3, s_cap=40))
    with pytest.raises(ValueError, match="collect_probe_sizes"):
        engine.query(q, collect_probe_sizes=True)
    with pytest.raises(ValueError, match="max_chain"):
        engine.make_plan_fn(plan="sharded", max_chain=7)
    with pytest.raises(ValueError, match="unknown plan"):
        engine.query(q, plan="fused")
    with pytest.raises(ValueError, match="local_plan"):
        sharded_query_result(sh, q, local_plan="host")
    glob = SearchEngine(_as_index(sh.to_global(), sh.params), device="cpu")
    with pytest.raises(ValueError, match="s_cap_per_shard only applies to sharded"):
        glob.query(q, s_cap_per_shard=4)


def _as_index(arrays, params):
    from repro_torch.core import E2LSHIndex
    return E2LSHIndex(params=params, family=None, arrays=arrays, stats=None)


def test_sharded_block_objs_reblockify(data):
    """Each shard re-blockified from its CSR view (memoized) equals a direct
    blockify; the sharded plan over it equals the sharded oracle under the
    same chunking, and the narrower blocks cost more block reads."""
    from repro_torch.kernels.bucket_probe.ops import blockify_entries

    rng = np.random.default_rng(4)
    n, d = 1501, 12
    centers = rng.normal(size=(4, d)).astype(np.float32)       # heavy buckets
    db = (centers[rng.integers(0, 4, n)] + 0.1 * rng.normal(size=(n, d))).astype(np.float32)
    q = (db[rng.choice(n, 8, replace=False)] + 0.02 * rng.normal(size=(8, d))).astype(np.float32)
    s = float(np.median(np.linalg.norm(db - db.mean(0), axis=1))) / 2
    sh = build_sharded_index(db / s, 2, gamma=0.7, s_scale=2.0, max_L=4, seed=3,
                             device="cpu")
    engine = SearchEngine(sh, device="cpu")
    narrow = engine.arrays(block_objs=33)
    assert engine.arrays(block_objs=33) is narrow                 # memoized
    assert engine.arrays()[0].block_objs == sh.params.block_objs  # native intact
    for ix, base in zip(narrow, sh.arrays):
        ids_b, fps_b, head, nb = blockify_entries(base.entries_id, base.entries_fp,
                                                  base.table_off, base.table_cnt, 33,
                                                  lane_pad=base.lane_pad)
        assert ix.block_objs == 33 and ix.a is base.a
        assert torch.equal(ix.ids_blocks, ids_b) and torch.equal(ix.blocks_head, head)
    kw = dict(k=2, block_objs=33, s_cap_per_shard=150)
    a = engine.query(q / s, plan="sharded", **kw)
    _assert_identical(a, engine.query(q / s, plan="oracle", **kw))
    nat = engine.query(q / s, plan="sharded", k=2, s_cap_per_shard=150)
    assert int(a.nio_blocks.sum()) > int(nat.nio_blocks.sum())
    cfg, _ = engine.make_plan_fn(plan="sharded", block_objs=16)
    assert cfg.block_objs == 16


def test_queue_over_sharded_plan_matches_direct(data):
    """The serving queue in front of plan="sharded": ragged requests (a lone
    row, one wider than max_batch) are bit for bit their direct sharded
    dispatch; one plan call per tick."""
    from repro_torch.serving import BatchQueue

    db, _, rng = _data(9, 3001, 16)
    sh = build_sharded_index(db, 2, gamma=0.7, s_scale=2.0, max_L=16, seed=3, device="cpu")
    engine = SearchEngine(sh, device="cpu")
    queue = BatchQueue(engine, plan="sharded", k=2, ladder=(4, 8), tick_us=50.0)
    _, direct = engine.make_plan_fn(plan="sharded", k=2)
    reqs = [(db[rng.choice(len(db), b, replace=False)]
             + 0.05 * rng.normal(size=(b, 16))).astype(np.float32) for b in (1, 4, 11, 3)]
    tickets = [queue.submit(r) for r in reqs]
    queue.drain()
    for r, t in zip(reqs, tickets):
        _assert_identical(t.result(0), direct(r))
    s = queue.stats_summary()
    assert s["dispatches"] == s["ticks"] >= 3


# --------------------------------------------------------------------------
# Against the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_sharded():
    """A reference sharded build (2 uneven shards, n = 1999, d = 16) and the
    same carried across."""
    from repro.core.distributed import build_sharded_index as ref_build

    db, _, _ = _data(5, 1999, 16)
    ref = ref_build(db, 2, gamma=0.7, s_scale=2.0, max_L=8, seed=2)
    port = _carry(ref)
    return ref, port, db


def _carry(ref) -> ShardedIndexArrays:
    ra = ref.arrays
    return ShardedIndexArrays.from_numpy(
        {name: np.asarray(getattr(ra, name)) for name in IndexArrays.array_fields()},
        shard_offsets=np.asarray(ref.shard_offsets),
        params=LSHParams(**dataclasses.asdict(ref.params)),
        block_objs=ra.block_objs, lane_pad=ra.lane_pad, device="cpu")


def test_from_numpy_strips_the_reference_stack(ref_sharded):
    ref, port, db = ref_sharded
    ra = ref.arrays
    assert port.num_shards == 2 and port.shard_offsets == (0, 999)
    for s, ix in enumerate(port.arrays):
        assert ix.a is port.arrays[0].a
        for name in IndexArrays.array_fields():
            got = ix.leaf_numpy(name)
            want = np.asarray(getattr(ra, name))
            if name not in ("a", "b", "rm"):
                want = want[s]
            np.testing.assert_array_equal(got, want[:got.shape[0]], err_msg=name)
            # what was stripped is padding
            if name == "ids_blocks":
                assert (want[got.shape[0]:] == tq.INVALID).all()
            if name == "db":
                np.testing.assert_array_equal(got, db[port.shard_offsets[s]:][:got.shape[0]])


def test_to_global_matches_reference_leaf_for_leaf(ref_sharded):
    ref, port, _ = ref_sharded
    want, got = ref.to_global(), port.to_global()
    assert (got.block_objs, got.lane_pad) == (want.block_objs, want.lane_pad)
    for name in IndexArrays.array_fields():
        np.testing.assert_array_equal(got.leaf_numpy(name), np.asarray(getattr(want, name)),
                                      err_msg=f"to_global leaf {name}")


def test_spill_matches_reference_bytes_and_serves(ref_sharded, tmp_path):
    """Both packages' sharded spill directories hold the same bytes, and
    plan="sharded_external" over the port's equals plan="fused" over
    to_global()."""
    ref, port, db = ref_sharded
    man_ref = ref.spill(tmp_path / "ref")
    man = port.spill(tmp_path / "port")
    assert man == man_ref
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 2 + 2        # two stripes, resident, manifest
    for name in names:
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    qs = db[:8] * 1.01
    fused = SearchEngine(_as_index(port.to_global(), port.params), device="cpu")
    want = fused.query(qs, plan="fused", k=2)
    with st.load_external_sharded(tmp_path / "port", backend="aio", qd=4,
                                  device="cpu") as ext:
        engine = SearchEngine(ext)
        assert ext.num_shards == 2
        _assert_identical(engine.query(qs, k=2), want)
        with pytest.raises(ValueError, match="s_cap_per_shard"):
            engine.query(qs, k=2, s_cap_per_shard=4)


def test_shard_probe_with_reference_hashes_matches_reference_body(ref_sharded):
    """Each shard of the carried index, its probe stage fed the reference's
    query hashes, equals the reference's fused_plan_body on that shard's
    (padded) view under the sharded plan's config: integer fields exact,
    distances at 2e-4."""
    import jax.numpy as jnp
    from repro.core import query as rq
    from repro.core.distributed import _local_view
    from repro.kernels.lsh_hash.ops import lsh_hash_all_radii as ref_hash

    ref, port, db = ref_sharded
    qs = db[::97][:10] * 1.02
    p = ref.params
    cap = max(4 * 2, -(-p.S // 2))
    rcfg = rq.QueryConfig.from_params(p, k=2).replace(s_cap=cap)
    cfg = tq.QueryConfig.from_params(port.params, k=2).replace(s_cap=cap)
    queries, qnorm2 = tq._prep_queries(torch.from_numpy(qs))
    for s, ix in enumerate(port.arrays):
        local = _local_view(dataclasses.replace(ref.arrays, **{
            name: getattr(ref.arrays, name)[s:s + 1] for name in IndexArrays.array_fields()
            if name not in ("a", "b", "rm")}))
        want = rq.fused_plan_body(local, jnp.asarray(qs), rcfg)
        bk, qfp = ref_hash(jnp.asarray(qs), local.a, local.b, local.rm, w=rcfg.w,
                           radii=rcfg.radii, u=rcfg.u, fp_bits=rcfg.fp_bits)
        cnt_all, head_all = tq.table_lookup(ix, torch.from_numpy(np.array(bk)), cfg)
        state = tq.probe_stage(ix, queries, qnorm2, cnt_all, head_all,
                               torch.from_numpy(np.array(qfp)), cfg)
        got = tq._result_from_state(state, cfg)
        _assert_identical(got, want, fields=[f for f in _FIELDS if f != "dists"])
        np.testing.assert_allclose(_np(got.dists), np.asarray(want.dists),
                                   rtol=TOL, atol=TOL)


_REF_SHARDED = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import IndexArrays
from repro.core.distributed import ShardedIndexArrays, sharded_query_result
from repro.core.probabilities import LSHParams

z = np.load(sys.argv[1], allow_pickle=True)
bo, lp = (int(v) for v in z["layout"])
arrays = IndexArrays(**{f: jnp.asarray(z["leaf_" + f]) for f in IndexArrays.array_fields()},
                     block_objs=bo, lane_pad=lp)
sh = ShardedIndexArrays(arrays=arrays, shard_offsets=jnp.asarray(z["offsets"]),
                        params=LSHParams(**z["params"][0]), num_shards=2)
mesh = Mesh(np.array(jax.devices()[:2]), ("shard",))
res = sharded_query_result(sh, jnp.asarray(z["q"]), mesh, k=2)
np.savez(sys.argv[2], **{f: np.asarray(getattr(res, f)) for f in
                         ("ids", "dists", "found", "radii_searched", "nio_table",
                          "nio_blocks", "cands_checked")})
"""


def test_reference_sharded_plan_agrees_two_shards(ref_sharded, tmp_path):
    """The reference's sharded plan under shard_map on two host devices (one
    subprocess, the index handed over as arrays) against the port's on the
    same index carried across: equal on every row whose query hashes the
    two packages compute alike (integer fields exact, distances at 2e-4;
    the port's merge keeps the reference's bits)."""
    from repro.kernels.lsh_hash.ops import lsh_hash_all_radii as ref_hash
    from repro_torch.kernels import lsh_hash_all_radii_ref

    ref, port, db = ref_sharded
    q = db[::131][:16] * 1.02
    ra, p = ref.arrays, ref.params
    np.savez(tmp_path / "index.npz", q=q, offsets=np.asarray(ref.shard_offsets),
             layout=np.asarray([ra.block_objs, ra.lane_pad]),
             params=np.array([dataclasses.asdict(p)], dtype=object),
             **{"leaf_" + f: np.asarray(getattr(ra, f)) for f in IndexArrays.array_fields()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_SHARDED),
                           str(tmp_path / "index.npz"), str(tmp_path / "out.npz")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    got = SearchEngine(port, device="cpu").query(q, plan="sharded", k=2)
    ix = port.arrays[0]
    kw = dict(w=p.w, radii=p.radii, u=p.u, fp_bits=p.fp_bits)
    bk, fp = lsh_hash_all_radii_ref(torch.from_numpy(q), ix.a, ix.b, ix.rm, **kw)
    rbk, rfp = ref_hash(q, ra.a, ra.b, ra.rm, **kw)
    agree = ((_np(bk) == np.asarray(rbk)) & (_np(fp) == np.asarray(rfp))).all(axis=(0, 2))
    assert agree.mean() >= 0.75, agree
    assert want["found"].mean() > 0.5
    for name in _FIELDS:
        g, w = _np(getattr(got, name))[agree], want[name][agree]
        if name == "dists":
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    print(f"reference sharded plan: rows with agreeing hashes {agree.mean():.4f}")


@pytest.mark.cuda
def test_cuda_sharded_matches_oracle_on_agreeing_rows():
    """On the card each shard runs the three query kernels; on every row
    whose kernel hashes equal the plain hashes the merged result matches the
    sharded oracle (a tie within 2e-4 may swap ids)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++")
    from repro_torch.data import make_dataset
    from repro_torch.kernels import KERNELS, lsh_hash_all_radii, lsh_hash_all_radii_ref

    ds = make_dataset("sift", n=20_000, n_queries=64, seed=1)
    sh = build_sharded_index(ds.db, 4, gamma=0.8, max_L=32, device="cuda")
    engine = SearchEngine(sh)
    for kern in KERNELS:
        kern.launches = 0
    got = engine.query(ds.queries, k=3)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}
    assert launches["lsh_hash"] == 4 and launches["bucket_probe"] >= 4, launches
    ref = engine.query(ds.queries, plan="oracle", k=3)
    qt = torch.from_numpy(ds.queries).cuda()
    ix, p = sh.arrays[0], sh.params
    kw = dict(w=p.w, radii=p.radii, u=p.u, fp_bits=p.fp_bits)
    bk, fp = lsh_hash_all_radii(qt, ix.a, ix.b, ix.rm, **kw)
    bk_p, fp_p = lsh_hash_all_radii_ref(qt, ix.a, ix.b, ix.rm, **kw)
    agree = _np(((bk == bk_p) & (fp == fp_p)).all(dim=2).all(dim=0))
    assert agree.mean() > 0.9
    assert not (agree & ~got.rows_agree(ref, tol=TOL)).any()
