"""The port's storage tier: the spill format against the reference's, and
``plan="external"`` against the port's fused plan and the reference's
external plan.

* A file spilled by either package is byte for byte the other's, loads in
  the other's ``load_arrays`` leaf for leaf and passes its ``verify_file``,
  at lane_pad 8 and 128; the port rejects damaged files as the reference
  does.
* The port's external plan equals the port's fused plan on every
  ``QueryResult`` field, bit for bit, on every block-store backend (uring
  skips with the probe's reason where io_uring is unavailable); the store's
  logical reads equal ``sum(nio_blocks)`` and the io_count replay.
* Fed the reference's query hashes, the port's external probe stage equals
  the reference's external plan on the same file: integer fields exact,
  distances at 2e-4 (the reference's kernel tolerance).
* The striped store reassembles rows in request order, and
  ``plan="sharded_external"`` equals fused.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import storage as st
from repro_torch import telemetry
from repro_torch.core import (E2LSHIndex, HashFamily, IndexArrays, IndexStats,
                              LSHParams, SearchEngine)
from repro_torch.core import query as tq
from repro_torch.core.io_count import nio_for_block_size

_FIELDS = ("ids", "dists", "found", "radii_searched", "nio_table", "nio_blocks",
           "cands_checked")
_BACKENDS = ("mem", "mmap", "aio", "uring")


def _assert_identical(a, b, *, probe_sizes=False):
    for name in _FIELDS + (("probe_sizes",) if probe_sizes else ()):
        np.testing.assert_array_equal(getattr(a, name).cpu().numpy(),
                                      getattr(b, name).cpu().numpy(),
                                      err_msg=f"field {name} diverged")


def _require_uring(path) -> None:
    caps = st.capabilities(str(path))
    if not caps["uring_store"]:
        pytest.skip(f"io_uring unavailable: {caps['io_uring_reason']}")


@pytest.fixture(scope="module")
def ref_storage():
    """A small index built by the reference, and its queries (the sizing of
    the reference's own storage tests)."""
    from repro.core import E2LSHoS

    rng = np.random.default_rng(7)
    n, d = 1500, 12
    centers = rng.normal(size=(24, d)).astype(np.float32)
    db = (centers[rng.integers(0, 24, n)] + 0.18 * rng.normal(size=(n, d))).astype(np.float32)
    qs = (db[rng.choice(n, 24, replace=False)]
          + 0.05 * rng.normal(size=(24, d))).astype(np.float32)
    s = float(np.median(np.linalg.norm(db - db.mean(0), axis=1))) / 3
    return E2LSHoS.build(db / s, gamma=0.7, s_scale=2.0, max_L=8, seed=3).index, qs / s


def _carry(ref_index, ref_arrays=None) -> E2LSHIndex:
    """The reference's index as a port index on the CPU."""
    ra = ref_index.arrays if ref_arrays is None else ref_arrays
    f = ref_index.family
    arrays = IndexArrays.from_numpy(
        {n: np.asarray(getattr(ra, n)) for n in IndexArrays.array_fields()},
        block_objs=ra.block_objs, lane_pad=ra.lane_pad, device="cpu")
    family = HashFamily.from_numpy(np.asarray(f.a), np.asarray(f.b), np.asarray(f.rm),
                                   w=f.w, u=f.u, fp_bits=f.fp_bits, device="cpu")
    return E2LSHIndex(params=LSHParams(**dataclasses.asdict(ref_index.params)),
                      family=family, arrays=arrays,
                      stats=IndexStats(**dataclasses.asdict(ref_index.stats)))


@pytest.fixture(scope="module")
def port_index(ref_storage):
    return _carry(ref_storage[0])


@pytest.fixture(scope="module")
def spilled(port_index, tmp_path_factory):
    path = tmp_path_factory.mktemp("spill") / "index.e2l"
    port_index.spill(path)
    return path


@pytest.fixture(scope="module")
def hard_queries(ref_storage):
    """Mostly easy queries plus one far outlier that walks several radii (the
    multi-rung loop, the prefetch and the early exit)."""
    q = ref_storage[1][:15]
    return np.concatenate([q, np.full((1, q.shape[1]), 40.0, np.float32)])


@pytest.fixture(scope="module")
def fused(port_index):
    return SearchEngine(port_index, device="cpu")


# --------------------------------------------------------------------------
# On-disk format
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lane_pad", [8, 128])
def test_spill_interchanges_with_reference_both_ways(ref_storage, tmp_path, lane_pad):
    from repro import storage as rst

    ref_index = ref_storage[0]
    ra = ref_index.arrays.with_block_objs(ref_index.arrays.block_objs, lane_pad=lane_pad)
    port = _carry(ref_index, ra)
    ref_path, port_path = tmp_path / "ref.e2l", tmp_path / "port.e2l"
    rst.spill_index(ref_path, ra, params=ref_index.params, stats=ref_index.stats)
    port.arrays.spill(port_path, params=port.params, stats=port.stats)
    assert ref_path.read_bytes() == port_path.read_bytes()
    # reference file -> port, leaf for leaf, crc-checked
    hdr = st.verify_file(ref_path)
    assert (hdr.lane_pad, hdr.blkp) == (lane_pad, ra.ids_blocks.shape[1])
    got = st.load_arrays(ref_path, device="cpu")
    assert (got.block_objs, got.lane_pad) == (ra.block_objs, lane_pad)
    for name in IndexArrays.array_fields():
        np.testing.assert_array_equal(got.leaf_numpy(name), np.asarray(getattr(ra, name)),
                                      err_msg=f"leaf {name} differs")
        assert got.leaf_numpy(name).dtype == np.asarray(getattr(ra, name)).dtype, name
    # port file -> reference, leaf for leaf, crc-checked
    rst.verify_file(port_path)
    back = rst.load_arrays(port_path)
    assert (back.block_objs, back.lane_pad) == (ra.block_objs, lane_pad)
    for name in IndexArrays.array_fields():
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(ra, name)))


def _damage(path, tmp_path, what):
    data = bytearray(path.read_bytes())
    if what == "magic":
        data[:8] = b"NOTANIDX"
    elif what == "version":
        data[8] = 0xFE
    elif what == "header":
        data[40] ^= 0xFF
    else:
        data[st.read_header(path).sections["db"]["offset"]] ^= 0xFF
    bad = tmp_path / f"bad_{what}.e2l"
    bad.write_bytes(bytes(data))
    return bad


@pytest.mark.parametrize("what,match", [("magic", "magic"), ("version", "version"),
                                        ("header", "corrupted header"),
                                        ("section", "crc32")])
def test_rejects_damaged_files(spilled, tmp_path, what, match):
    bad = _damage(spilled, tmp_path, what)
    with pytest.raises(st.StorageFormatError, match=match):
        st.load_arrays(bad, device="cpu")
    if what != "section":
        with pytest.raises(st.StorageFormatError, match=match):
            st.load_external(bad, backend="mem", device="cpu")


def test_spill_without_params_is_not_servable(port_index, tmp_path):
    path = tmp_path / "bare.e2l"
    port_index.arrays.spill(path)
    st.load_arrays(path, device="cpu")
    with pytest.raises(st.StorageFormatError, match="LSHParams"):
        st.load_external(path, backend="mem", device="cpu")


# --------------------------------------------------------------------------
# plan="external"
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", _BACKENDS)
def test_external_plan_matches_fused(port_index, fused, spilled, hard_queries, backend):
    """external == fused on every field, on every backend; the store's
    logical reads equal sum(nio_blocks) and the io_count replay."""
    if backend == "uring":
        _require_uring(spilled)
    want = fused.query(hard_queries, plan="fused", k=3, collect_probe_sizes=True)
    with st.load_external(spilled, backend=backend, qd=8, device="cpu") as ext:
        engine = SearchEngine(ext)
        assert engine.plans == ("external",) and engine.default_plan == "external"
        got = engine.query(hard_queries, k=3, collect_probe_sizes=True)
        _assert_identical(want, got, probe_sizes=True)
        ps = engine.external.last_plan_stats
        assert ps.backend == (st.store_backend_env() or backend)
        assert ps.measured_nio_blocks == ps.nio_blocks_counted == int(got.nio_blocks.sum())
        assert sum(r.blocks_fetched for r in ps.rungs) == ps.measured_nio_blocks
        assert len(ps.rungs) >= 2              # the outlier walks several radii
        p = port_index.params
        replay = nio_for_block_size(got.probe_sizes.numpy(), s_cap=p.S,
                                    block_bytes=p.block_bytes)
        np.testing.assert_array_equal(replay, got.nio.numpy())
        assert ext.store.stats.reads == ext.store.stats.device_reads + ext.store.stats.cache_hits


@pytest.mark.parametrize("backend", ["mem", "aio"])
def test_external_s_cap_lone_query_and_tiny_cache(fused, spilled, hard_queries, backend):
    with st.load_external(spilled, backend=backend, qd=2, cache_rows=4,
                          device="cpu") as ext:
        engine = SearchEngine(ext)
        _assert_identical(fused.query(hard_queries, k=1, s_cap=8),
                          engine.query(hard_queries, k=1, s_cap=8))
        _assert_identical(fused.query(hard_queries[:1], k=2),
                          engine.query(hard_queries[:1], k=2))


def test_external_masked_rows_inert(fused, spilled, ref_storage):
    q = ref_storage[1][:9]
    pad = np.concatenate([q, np.full((7, q.shape[1]), 1e6, np.float32)])
    with st.load_external(spilled, backend="aio", qd=4, device="cpu") as ext:
        out = SearchEngine(ext).query(pad, k=2, valid=np.arange(16) < 9)
        _assert_identical(fused.query(q, k=2), out.slice_rows(0, 9))
        tail = out.slice_rows(9, 16)
        assert (tail.ids == tq.INVALID).all() and not tail.found.any()
        assert (tail.nio == 0).all()
        assert ext.last_plan_stats.queries == 16


def test_external_with_reference_hashes_matches_reference(ref_storage, spilled,
                                                          hard_queries):
    """The port's probe stage fed the reference's query hashes, against the
    reference's external plan on the same file."""
    import jax.numpy as jnp
    from repro import storage as rst
    from repro.core import SearchEngine as RefEngine
    from repro.kernels.lsh_hash.ops import lsh_hash_all_radii as ref_hash
    from repro_torch.storage.external import external_probe_stage

    with rst.load_external(spilled, backend="mem") as rext:
        want = RefEngine(rext).query(jnp.asarray(hard_queries), k=3)
    ra = ref_storage[0].arrays
    with st.load_external(spilled, backend="mem", device="cpu") as ext:
        cfg = SearchEngine(ext).config(k=3, block_objs=ext.block_objs)
        bk, qfp = ref_hash(jnp.asarray(hard_queries), ra.a, ra.b, ra.rm, w=cfg.w,
                           radii=cfg.radii, u=cfg.u, fp_bits=cfg.fp_bits)
        cnt_all, head_all = tq.table_lookup(ext, torch.from_numpy(np.array(bk)), cfg)
        queries, qnorm2 = tq._prep_queries(torch.from_numpy(hard_queries))
        state, rungs = external_probe_stage(ext, queries, qnorm2, cnt_all.numpy(),
                                            head_all.numpy(), np.array(qfp), cfg)
        got = tq._result_from_state(state, cfg)
    for name in _FIELDS[2:] + ("ids",):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"field {name} diverged")
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=2e-4, atol=2e-4)
    assert len(rungs) == int(np.asarray(want.radii_searched).max())


def test_external_rejects_foreign_plans_and_knobs(spilled, port_index):
    with st.load_external(spilled, backend="mem", device="cpu") as ext:
        engine = SearchEngine(ext)
        q = np.zeros((2, ext.db.shape[1]), np.float32)
        with pytest.raises(ValueError, match="unknown plan"):
            engine.query(q, plan="fused")
        with pytest.raises(ValueError, match="re-spill"):
            engine.query(q, block_objs=16)
        with pytest.raises(ValueError, match="on disk"):
            engine.arrays()
    with pytest.raises(ValueError, match="unknown plan"):
        SearchEngine(port_index, device="cpu").query(q, plan="external")
    with pytest.raises(ValueError, match="unknown block-store backend"):
        st.load_external(spilled, backend="warp", device="cpu")


def test_aio_cache_hits_and_tracing_tie_out(spilled, ref_storage):
    """A repeated batch is served from the clock cache with the same logical
    N_io; with tracing on, the store.read spans sum to the ledger."""
    q = ref_storage[1][:16]
    tracer = telemetry.get_tracer()
    with st.load_external(spilled, backend="aio", qd=8, device="cpu") as ext:
        engine = SearchEngine(ext)
        first = engine.query(q, k=1)
        nio1 = ext.last_plan_stats.measured_nio_blocks
        telemetry.enable(sampling=1.0, record_function=True)
        tracer.clear()
        try:
            second = engine.query(q, k=1)
            spans = tracer.drain()
        finally:
            telemetry.disable()
            telemetry.get_tracer().configure(record_function=False)
        ps = ext.last_plan_stats
        assert ps.measured_nio_blocks == nio1 and ps.cache_hit_rate > 0.9
        _assert_identical(first, second)
        reads = [s for s in spans if s.name == "store.read"]
        assert sum(s.attrs["rows"] for s in reads) == ps.measured_nio_blocks
        assert {"plan.external", "external.setup", "external.rung"} <= {s.name for s in spans}
    snap = telemetry.snapshot()
    assert any(k.startswith("e2lsh_external_") for k in snap)


# --------------------------------------------------------------------------
# Sharded spill (block rows striped over per-shard files)
# --------------------------------------------------------------------------

def test_sharded_external_matches_fused(port_index, fused, hard_queries, tmp_path):
    path = tmp_path / "sharded"
    st.spill_index_sharded(path, port_index.arrays, 3, params=port_index.params,
                           stats=port_index.stats)
    loaded = st.load_arrays_sharded(path, device="cpu")
    for name in IndexArrays.array_fields():
        assert torch.equal(getattr(loaded, name), getattr(port_index.arrays, name)), name
    with st.load_external_sharded(path, backend="aio", qd=4, device="cpu") as ext:
        rows = np.array([7, 0, 5, 5, 3, 1, 8, 2, 6, 4])
        ids, fps = ext.store.read_rows(rows)
        np.testing.assert_array_equal(ids, port_index.arrays.ids_blocks.numpy()[rows])
        np.testing.assert_array_equal(fps, port_index.arrays.fps_blocks.numpy()[rows])
        engine = SearchEngine(ext)
        assert engine.plans == ("sharded_external",)
        got = engine.query(hard_queries, k=3, collect_probe_sizes=True)
        _assert_identical(fused.query(hard_queries, k=3, collect_probe_sizes=True), got,
                          probe_sizes=True)
        ps = ext.last_plan_stats
        assert ps.num_shards == 3
        assert sum(s.reads for s in ps.per_shard) == ps.io.reads == int(got.nio_blocks.sum())


def test_measure_harness_runs_every_discipline(tmp_path):
    """The measured sync-vs-async harness and the queue-depth sweep on a
    tiny heavy-bucket index: every timed backend reads the same logical
    blocks, and the sweep keeps N_io fixed across queue depths."""
    idx, qs = st.heavy_bucket_workload(dict(n=3000, queries=16), device="cpu")
    out = st.measure_backends(idx, qs, spill_path=tmp_path / "mb.e2l", repeats=1, qd=4)
    assert out["sync"]["measured_nio_blocks"] == out["async_"]["measured_nio_blocks"] > 0
    assert out["sync"]["backend"] == "mmap" and out["t_compute_us"] > 0
    sweep = st.qd_sweep(idx, qs, spill_path=tmp_path / "sw.e2l", qds=(1, 4), repeats=1)
    points = sweep["curves"][0]["points"]
    assert [p["qd"] for p in points] == [1, 4] and sweep["cache_mode"] == "cold"
    assert {p["measured_nio_blocks"] for p in points} == {sweep["curves"][0]["measured_nio_blocks"]}


@pytest.mark.cuda
def test_cuda_external_plan_matches_fused(tmp_path):
    """On the card: external == fused bit for bit (both hash through the
    same lsh_hash launch), the store's reads equal the io_count replay, and
    the external plan launches lsh_hash and l2_distance_gathered but never
    bucket_probe (its chain walk is on the host). Port only: the card's
    machine has no JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++")
    from repro_torch.core import E2LSHoS
    from repro_torch.data import make_dataset
    from repro_torch.kernels import KERNELS

    ds = make_dataset("sift", n=20_000, n_queries=64, seed=2)
    idx = E2LSHoS.build(ds.db, gamma=0.8, max_L=32, device="cuda")
    want = SearchEngine(idx).query(ds.queries, k=3, collect_probe_sizes=True)
    idx.index.spill(tmp_path / "ix.e2l")
    for backend in ("mem", "aio"):
        with st.load_external(tmp_path / "ix.e2l", backend=backend, qd=8) as ext:
            for kern in KERNELS:
                kern.launches = 0
            got = SearchEngine(ext).query(ds.queries, k=3, collect_probe_sizes=True)
            torch.cuda.synchronize()
            launches = {kern.name: kern.launches for kern in KERNELS}
            _assert_identical(want, got, probe_sizes=True)
            assert launches["lsh_hash"] == 1 and launches["l2_distance"] > 0, launches
            assert launches["bucket_probe"] == 0 and launches["l2_distance_dense"] == 0
            p = idx.params
            replay = nio_for_block_size(got.probe_sizes.cpu().numpy(), s_cap=p.S,
                                        block_bytes=p.block_bytes)
            np.testing.assert_array_equal(replay, got.nio.cpu().numpy())
            assert ext.last_plan_stats.measured_nio_blocks == int(got.nio_blocks.sum())
