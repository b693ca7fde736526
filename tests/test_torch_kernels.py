"""The port's kernels against the reference's Pallas kernels, and (on a card)
against their own plain versions.

CPU cases: the port's plain versions vs the reference's Pallas kernels run
in interpret mode, on the same numpy inputs. Integer outputs are exact when
both sides see the same projections; with Gaussian inputs the two fp32
projections are summed in different orders, so a compound hash must match
exactly only when every one of its m components lies more than 1e-4 of a
bucket width from a floor() boundary (float64 recomputation), and flips
among the rest are counted. Distances: allclose at rtol = atol = 2e-4, the
reference's own kernel tolerance.

The hash kernel's operands are a pack built once per index and radius
schedule (``kernels/lsh_hash/ops.py``): each hash's m columns padded to a
width that divides the kernel's block, with inert padding columns. The pack
and the plain version over it are held to the reference's Pallas kernel
too, for m in {1, 6, 13, 23} and r*L not a multiple of the hashes a block
takes.

The fused probe (``probe_append``) and the distance-by-id epilogue
(``l2_distance_by_id``) are compositions around the reference's
``bucket_probe`` and ``l2_distance_gathered``: their plain versions are held
to those kernels here, and to the reference's whole fused probe in
``tests/test_torch_query.py``.

The radius fold (``topk_merge``) replaces no Pallas kernel: its plain
version is held to a brute-force numpy merge here, and the fused plans that
fold through it to the oracle in ``tests/test_torch_query.py``.

The query plans' Step 1 (``lsh_hash_lookup``) is the hash kernel with the
table lookup in its epilogue: its plain version is held to the plain
hashes followed by the plain lookup, and bad tables are refused before any
launch on either device.

CUDA cases (marker ``cuda``): each hand-written kernel vs its plain version
on the card, by the same rules (the fold bit for bit); they skip where no
card is present.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (INVALID, KERNELS, blockify_entries, bucket_probe_ref,
                                 l2_distance, l2_distance_by_id, l2_distance_by_id_ref,
                                 l2_distance_gathered_ref, lsh_hash_all_radii,
                                 lsh_hash_all_radii_ref, lsh_hash_lookup,
                                 lsh_hash_lookup_ref, lsh_hash_ref, probe_append,
                                 probe_append_ref, topk_merge, topk_merge_ref)
from repro_torch.kernels.lsh_hash import ops as hash_ops
from repro_torch.kernels.lsh_hash.ops import hash_pack, index_hash_pack, packed_width
from repro_torch.kernels.lsh_hash.ref import floor_margin, lsh_hash_packed_ref

RNG = np.random.default_rng(11)
MARGIN = 1e-4


@pytest.fixture
def ref_kernels():
    """The reference's kernel package (JAX); the CPU parity cases need it."""
    return pytest.importorskip("repro.kernels")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU or interpret mode")
    return torch.device("cuda")


def _family(r, L, m, d, *, integer=False):
    if integer:  # small integers: every projection is exact in any order
        a = RNG.integers(-3, 4, size=(r, L, m, d)).astype(np.float32)
    else:
        a = RNG.normal(size=(r, L, m, d)).astype(np.float32)
    b = RNG.uniform(size=(r, L, m)).astype(np.float32)
    rm = ((RNG.integers(1, 2**31, size=(r, L, m)).astype(np.uint32) << 1) | 1)
    return a, b, rm.view(np.int32)


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(x)).to(device) for x in arrays]


@pytest.mark.parametrize("n,d,r,L,m,radii", [
    (1, 4, 1, 1, 1, (1.0,)),
    (70, 32, 3, 8, 6, (1.0, 2.0, 4.0)),
    (130, 100, 5, 5, 4, (1.0, 2.0, 4.0, 8.0, 16.0)),
])
def test_lsh_hash_all_radii_ref_matches_pallas_exact_projections(
        ref_kernels, n, d, r, L, m, radii):
    """Same projections on both sides (integer data): the whole epilogue —
    floor, wrapping combine, fmix32, bucket/fingerprint split — is exact."""
    import jax.numpy as jnp
    x = RNG.integers(-4, 5, size=(n, d)).astype(np.float32)
    a, b, rm = _family(r, L, m, d, integer=True)
    kw = dict(w=4.0, radii=radii, u=12, fp_bits=10)
    bk_j, fp_j = ref_kernels.lsh_hash_all_radii(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(rm),
        interpret=True, force_pallas=True, **kw)
    bk, fp = lsh_hash_all_radii(*_t(x, a, b, rm), **kw)
    assert bk.shape == (r, n, L) and bk.dtype == torch.int32
    np.testing.assert_array_equal(bk.numpy(), np.asarray(bk_j))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fp_j))


@pytest.mark.parametrize("w_r,u,fp_bits", [(0.5, 10, 16), (4.0, 14, 12), (8.0, 18, 14)])
def test_lsh_hash_ref_single_radius_matches_pallas_exact_projections(
        ref_kernels, w_r, u, fp_bits):
    """The per-radius plain hash (the oracle plan's) vs the reference's
    single-radius Pallas kernel."""
    import jax.numpy as jnp
    x = RNG.integers(-4, 5, size=(96, 64)).astype(np.float32)
    a, b, rm = (v[0] for v in _family(1, 6, 5, 64, integer=True))
    kw = dict(w_r=w_r, u=u, fp_bits=fp_bits)
    bk_j, fp_j = ref_kernels.lsh_hash(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(rm), interpret=True,
                                      force_pallas=True, **kw)
    bk, fp = lsh_hash_ref(*_t(x, a, b, rm), **kw)
    np.testing.assert_array_equal(bk.numpy(), np.asarray(bk_j))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fp_j))


def _assert_hashes_agree(bk, fp, bk_o, fp_o, margin):
    """Exact on every compound hash clear of a floor() boundary; returns the
    number of flips among the others."""
    safe = margin > MARGIN
    same = (bk == bk_o) & (fp == fp_o)
    assert bool(same[safe].all()), (
        f"{int((~same & safe).sum())} hashes clear of every boundary disagree")
    return int((~same).sum())


@pytest.mark.parametrize("n,d,r,L,m", [(64, 24, 4, 6, 13), (257, 128, 3, 8, 23)])
def test_lsh_hash_all_radii_ref_matches_pallas_boundary_rule(ref_kernels, n, d, r, L, m):
    import jax.numpy as jnp
    x = RNG.normal(size=(n, d)).astype(np.float32) * 3
    a, b, rm = _family(r, L, m, d)
    radii = tuple(2.0 ** t for t in range(r))
    kw = dict(w=4.0, radii=radii, u=14, fp_bits=14)
    bk_j, fp_j = ref_kernels.lsh_hash_all_radii(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(rm),
        interpret=True, force_pallas=True, **kw)
    xt, at, bt, rmt = _t(x, a, b, rm)
    bk, fp = lsh_hash_all_radii(xt, at, bt, rmt, **kw)
    margin = floor_margin(xt, at, bt, w=4.0, radii=radii)
    flips = _assert_hashes_agree(bk, fp, torch.from_numpy(np.array(bk_j)),
                                 torch.from_numpy(np.array(fp_j)), margin)
    assert flips <= int((margin <= MARGIN).sum())


# (r, L, m): r*L is not a multiple of the hashes a block takes (96 // mp for
# a batch, 48 // mp for a lone query) in any case.
PACK_SHAPES = [(2, 5, 1), (3, 5, 6), (2, 7, 13), (3, 3, 23)]


def test_packed_width_divides_the_block():
    """Up to the kernel's 96-column block a width divides it; past it (the
    plain version's alone) it is m rounded up to a multiple of 4."""
    assert [packed_width(m) for m in (1, 4, 5, 6, 9, 13, 17, 23, 25, 33, 96)] == \
        [4, 4, 8, 8, 12, 16, 24, 24, 32, 48, 96]
    assert [packed_width(m) for m in (97, 100, 130)] == [100, 100, 132]


def test_lsh_hash_past_the_kernel_block_on_the_cpu(ref_kernels):
    """m = 101 exceeds the kernel's block; a CPU tensor still hashes it, equal
    to the reference's kernel on integer data (exact projections)."""
    import jax.numpy as jnp
    r, L, m, n, d = 2, 3, 101, 9, 12
    rng = np.random.default_rng(101)
    x = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    a = rng.integers(-3, 4, size=(r, L, m, d)).astype(np.float32)
    b = rng.uniform(size=(r, L, m)).astype(np.float32)
    rm = ((rng.integers(1, 2**31, size=(r, L, m)).astype(np.uint32) << 1) | 1).view(np.int32)
    kw = dict(w=4.0, radii=(1.0, 2.0), u=12, fp_bits=10)
    bk_j, fp_j = ref_kernels.lsh_hash_all_radii(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(rm),
        interpret=True, force_pallas=True, **kw)
    bk, fp = lsh_hash_all_radii(*_t(x, a, b, rm), **kw)
    np.testing.assert_array_equal(bk.numpy(), np.asarray(bk_j))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fp_j))


@pytest.mark.parametrize("r,L,m", PACK_SHAPES)
def test_hash_pack_layout(r, L, m):
    """Real columns carry a, b*wR, wR, rm; padding columns a = 0, bwr = 0,
    wr = 1, rm = 0, so they add floor(0/1) * 0 = 0 to their hash."""
    d = 20
    a, b, rm = _t(*_family(r, L, m, d))
    radii = tuple(1.5 ** t for t in range(r))
    pack = hash_pack(a, b, rm, w=4.0, radii=radii)
    mp = pack.mp
    assert mp == packed_width(m) and mp % 4 == 0 and 96 % mp == 0
    assert pack.a.shape == (r * L * mp, d) and pack.rm.dtype == torch.int32
    wr = torch.tensor([4.0 * rad for rad in radii], dtype=torch.float32)[:, None, None]
    a4, bwr, w4, rm4 = (pack.a.view(r, L, mp, d), pack.bwr.view(r, L, mp),
                        pack.wr.view(r, L, mp), pack.rm.view(r, L, mp))
    assert torch.equal(a4[:, :, :m], a) and bool((a4[:, :, m:] == 0).all())
    assert torch.equal(bwr[:, :, :m], b * wr) and bool((bwr[:, :, m:] == 0).all())
    assert torch.equal(w4[:, :, :m], wr.expand(r, L, m)) and bool((w4[:, :, m:] == 1).all())
    assert torch.equal(rm4[:, :, :m], rm) and bool((rm4[:, :, m:] == 0).all())


@pytest.mark.parametrize("r,L,m", PACK_SHAPES)
def test_hash_pack_matches_pallas_exact_projections(ref_kernels, r, L, m):
    """Integer data, so both sides see the same projections: the plain
    version over the pack, and the wrapper (which runs it on a CPU tensor),
    equal the reference's kernel exactly."""
    import jax.numpy as jnp
    n, d = 37, 30
    x = RNG.integers(-4, 5, size=(n, d)).astype(np.float32)
    a, b, rm = _family(r, L, m, d, integer=True)
    radii = tuple(2.0 ** t for t in range(r))
    kw = dict(w=4.0, radii=radii, u=12, fp_bits=10)
    bk_j, fp_j = ref_kernels.lsh_hash_all_radii(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(rm),
        interpret=True, force_pallas=True, **kw)
    xt, at, bt, rmt = _t(x, a, b, rm)
    pack = hash_pack(at, bt, rmt, w=4.0, radii=radii)
    for bk, fp in (lsh_hash_packed_ref(xt, pack, u=12, fp_bits=10),
                   lsh_hash_all_radii(xt, at, bt, rmt, **kw)):
        assert bk.shape == (r, n, L) and bk.dtype == torch.int32
        np.testing.assert_array_equal(bk.numpy(), np.asarray(bk_j))
        np.testing.assert_array_equal(fp.numpy(), np.asarray(fp_j))


@pytest.mark.parametrize("r,L,m", PACK_SHAPES)
def test_hash_pack_matches_pallas_boundary_rule(ref_kernels, r, L, m):
    """Gaussian data: exact on every hash clear of a floor() boundary by
    1e-4 of a bucket width; and bit for bit the per-radius plain version
    (the oracle plan's hashing), which keeps fused == oracle on the CPU."""
    import jax.numpy as jnp
    n, d = 65, 100
    x = RNG.normal(size=(n, d)).astype(np.float32) * 3
    a, b, rm = _family(r, L, m, d)
    radii = tuple(2.0 ** t for t in range(r))
    kw = dict(w=4.0, radii=radii, u=14, fp_bits=14)
    bk_j, fp_j = ref_kernels.lsh_hash_all_radii(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(rm),
        interpret=True, force_pallas=True, **kw)
    xt, at, bt, rmt = _t(x, a, b, rm)
    bk, fp = lsh_hash_packed_ref(xt, hash_pack(at, bt, rmt, w=4.0, radii=radii),
                                 u=14, fp_bits=14)
    margin = floor_margin(xt, at, bt, w=4.0, radii=radii)
    flips = _assert_hashes_agree(bk, fp, torch.from_numpy(np.array(bk_j)),
                                 torch.from_numpy(np.array(fp_j)), margin)
    assert flips <= int((margin <= MARGIN).sum())
    bk_p, fp_p = lsh_hash_all_radii_ref(xt, at, bt, rmt, **kw)
    assert torch.equal(bk, bk_p) and torch.equal(fp, fp_p)


def test_hash_pack_built_once_per_index_and_schedule(monkeypatch):
    """Two query batches on one index reuse one pack; another schedule
    builds another; the packs go when their index is freed."""
    import gc
    from repro_torch.core import E2LSHoS, SearchEngine
    built, real = [], hash_ops.hash_pack
    monkeypatch.setattr(hash_ops, "hash_pack",
                        lambda *args, **kw: built.append(real(*args, **kw)) or built[-1])
    db = RNG.normal(size=(400, 16)).astype(np.float32)
    idx = E2LSHoS.build(db, gamma=0.7, max_L=4, device="cpu")
    engine = SearchEngine(idx, device="cpu")
    first = engine.query(db[:6], plan="fused", k=2)
    assert len(built) == 1
    second = engine.query(db[6:9], plan="fused", k=2)
    engine.query(db[:6], plan="fused", k=3)
    assert len(built) == 1
    assert first.ids.shape == (6, 2) and second.ids.shape == (3, 2)
    ix = engine.arrays()
    assert index_hash_pack(ix, w=idx.params.w, radii=idx.params.radii) is built[0]
    other = index_hash_pack(ix, w=idx.params.w, radii=idx.params.radii[:-1] + (99.0,))
    assert len(built) == 2 and other is not built[0]

    class Family:
        a, b, rm = torch.zeros((1, 2, 3, 4)), torch.zeros((1, 2, 3)), torch.zeros(
            (1, 2, 3), dtype=torch.int32)
    fam = Family()
    index_hash_pack(fam, w=4.0, radii=(1.0,))
    key = id(fam)
    assert key in hash_ops._INDEX_PACKS
    del fam
    gc.collect()
    assert key not in hash_ops._INDEX_PACKS


def _csr(n_entries=600):
    eid = RNG.integers(0, 5000, size=n_entries).astype(np.int32)
    efp = RNG.integers(0, 64, size=n_entries).astype(np.uint16)
    toff = np.array([0, 37, 200, -1, 595])
    tcnt = np.array([37, 163, 395, 0, 5])
    return eid, efp, toff, tcnt


@pytest.mark.parametrize("block_objs,lane_pad", [(8, 8), (16, 128), (99, 8), (99, 128)])
def test_blockify_and_bucket_probe_match_reference(ref_kernels, block_objs, lane_pad):
    """blockify_entries equals the reference's layout, and the plain probe
    equals the Pallas kernel (interpret mode) on it, exactly."""
    import jax.numpy as jnp
    eid, efp, toff, tcnt = _csr()
    ids_j, fps_j, head_j, nb_j = ref_kernels.blockify_entries(
        eid, efp, toff, tcnt, block_objs, lane_pad=lane_pad)
    ids_b, fps_b, head, nb = blockify_entries(
        *_t(eid, efp.astype(np.int32), toff, tcnt), block_objs, lane_pad=lane_pad)
    assert nb == nb_j
    for got, want in ((ids_b, ids_j), (fps_b, fps_j), (head, head_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    G = 19
    rows = RNG.integers(0, nb, size=G).astype(np.int32)
    qfp = RNG.integers(0, 64, size=G).astype(np.int32)
    want = ref_kernels.bucket_probe(jnp.asarray(rows), jnp.asarray(qfp), ids_j, fps_j,
                                    interpret=True, use_pallas=True)
    got = bucket_probe_ref(*_t(rows, qfp), ids_b, fps_b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q,s,d", [(1, 1, 8), (5, 17, 24), (48, 128, 100)])
def test_l2_distance_gathered_ref_matches_pallas(ref_kernels, q, s, d):
    import jax.numpy as jnp
    qs = RNG.normal(size=(q, d)).astype(np.float32)
    coords = RNG.normal(size=(q, s, d)).astype(np.float32)
    xn2 = (coords.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    qn2 = (qs.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    want = ref_kernels.l2_distance_gathered(
        jnp.asarray(qs), jnp.asarray(coords), jnp.asarray(xn2), jnp.asarray(qn2),
        interpret=True, force_pallas=True)
    got = l2_distance_gathered_ref(*_t(qs, coords, xn2, qn2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("q,s,n,d", [(1, 8, 40, 8), (5, 17, 300, 24), (7, 61, 500, 100)])
def test_l2_distance_by_id_ref_matches_pallas(ref_kernels, q, s, n, d):
    """The distance epilogue by id == the reference's gathered kernel
    (interpret mode) on the rows of the same ids, masked and clamped as the
    reference's plans do; INVALID slots (a third of them) are +inf."""
    import jax.numpy as jnp
    qs = RNG.normal(size=(q, d)).astype(np.float32)
    db = RNG.normal(size=(n, d)).astype(np.float32)
    xn2 = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    qn2 = (qs.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    ids = RNG.integers(0, n, size=(q, s)).astype(np.int32)
    ids[RNG.uniform(size=(q, s)) < 1 / 3] = INVALID
    valid = ids != INVALID
    safe = np.where(valid, ids, 0)
    d2 = ref_kernels.l2_distance_gathered(
        jnp.asarray(qs), jnp.asarray(db[safe]), jnp.asarray(xn2[safe]), jnp.asarray(qn2),
        interpret=True, force_pallas=True)
    want = np.where(valid, np.maximum(np.asarray(d2), 0.0), np.inf)
    got = l2_distance_by_id(*_t(qs, ids, db, xn2, qn2))
    assert got.dtype == torch.float32 and got.shape == (q, s)
    np.testing.assert_array_equal(np.isinf(got.numpy()), ~valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    strided = torch.from_numpy(np.concatenate([ids, ids[:, :3]], axis=1))[:, :s]
    assert torch.equal(l2_distance_by_id_ref(*_t(qs), strided, *_t(db, xn2, qn2)), got)


def _probe_inputs(Q, L, C, block_objs, *, lane_pad=8, fp_range=4, device="cpu"):
    """A blockified store of random buckets (sizes 0 .. C+1 chunks deep, so
    chains end before, at and past the walk's depth) and, per (query, table),
    one of its buckets with a query fingerprint: the probe's inputs.
    Fingerprints in [0, fp_range) make matches frequent, so the S budget
    runs out inside a step."""
    n_buckets = 64
    tcnt = RNG.integers(0, (C + 1) * block_objs + 2, size=n_buckets)
    tcnt[:8] = 0
    tcnt[8:12] = block_objs * np.arange(1, 5)  # chains ending on a chunk edge
    toff = np.where(tcnt > 0, np.cumsum(tcnt) - tcnt, -1)
    total = int(tcnt.sum())
    eid = RNG.integers(0, 5000, size=total).astype(np.int32)
    efp = RNG.integers(0, fp_range, size=total).astype(np.int32)
    ids_b, fps_b, head_row, _ = blockify_entries(
        *_t(eid, efp, toff, tcnt), block_objs, lane_pad=lane_pad)
    pick = RNG.integers(0, n_buckets, size=(Q, L))
    cnt = torch.from_numpy(tcnt[pick].astype(np.int32))
    head = head_row[torch.from_numpy(pick)]
    qfp = torch.from_numpy(RNG.integers(0, fp_range, size=(Q, L)).astype(np.int32))
    active = torch.from_numpy(RNG.uniform(size=Q) < 0.8)
    active[0] = True
    return [x.to(device) for x in (cnt, head, qfp, active, ids_b, fps_b)]


@pytest.mark.parametrize("Q,L,C,block_objs,S", [(6, 5, 1, 8, 8), (9, 12, 2, 16, 40),
                                                (4, 40, 4, 8, 100), (3, 3, 3, 150, 12)])
def test_probe_append_ref_matches_a_chain_walk(Q, L, C, block_objs, S):
    """The plain fused probe (one gather of every step, a gate scan, one
    append) == a walk that reads step by step while the count is below S,
    as the oracle plan does: same buffer, count and blocks read, with S
    reached inside a step, chains deeper and shallower than C, inactive
    queries, L past one warp's 32 rows and rows wider than 128 slots."""
    cnt, head, qfp, active, ids_b, fps_b = _probe_inputs(Q, L, C, block_objs)
    sbuf = -(-S // 8) * 8 + 5
    buf, count, blocks = probe_append(cnt, head, qfp, active, ids_b, fps_b,
                                      block_objs=block_objs, max_chain=C, S=S, sbuf=sbuf)
    want_buf = np.full((Q, sbuf), INVALID, np.int64)
    want_count, want_blocks = np.zeros(Q, np.int64), np.zeros(Q, np.int64)
    ids_n, fps_n = ids_b.numpy(), fps_b.numpy()
    for q in range(Q):
        n = 0
        for c in range(C):
            if not active[q] or n >= S:
                break
            for l in range(L):
                if cnt[q, l] <= c * block_objs:
                    continue
                want_blocks[q] += 1
                row = int(head[q, l]) + c
                for e, f in zip(ids_n[row], fps_n[row]):
                    if f == qfp[q, l] and e != INVALID:
                        if n < S:
                            want_buf[q, n] = e
                        n += 1
        want_count[q] = min(n, S)
    np.testing.assert_array_equal(buf.numpy(), want_buf)
    np.testing.assert_array_equal(count.numpy(), want_count)
    np.testing.assert_array_equal(blocks.numpy(), want_blocks)
    assert (want_count == S).any() and (want_count[~active.numpy()] == 0).all()


def test_probe_append_and_l2_distance_by_id_refuse_bad_arguments():
    cnt, head, qfp, active, ids_b, fps_b = _probe_inputs(2, 3, 2, 8)
    kw = dict(block_objs=8, max_chain=2, S=8, sbuf=8)
    with pytest.raises(ValueError, match="shapes disagree"):
        probe_append(cnt, head[:, :2], qfp, active, ids_b, fps_b, **kw)
    for bad in (dict(max_chain=0), dict(block_objs=0), dict(S=9), dict(S=0)):
        with pytest.raises(ValueError, match="need max_chain"):
            probe_append(cnt, head, qfp, active, ids_b, fps_b, **dict(kw, **bad))
    q, db = torch.zeros((2, 4)), torch.zeros((5, 4))
    with pytest.raises(ValueError, match="shapes disagree"):
        l2_distance_by_id(q, cnt, db[:, :3], torch.zeros(5), torch.zeros(2))


def _fold_inputs(Q, k, sbuf, L, *, r=4, t=1, collect=True, device="cpu"):
    """A search state and one radius' fold inputs that hit every rule of the
    merge: ids drawn from a range of about k + sbuf / 2, so an id is often
    both in the running top-k and among the candidates, and often several
    times among one radius' candidates (its L tables); distances on a grid
    of 0.25, so ties in d2 are common (broken by id); running top-ks of 0 to
    k entries, so rows hold fewer than k finite ones; a tenth of the
    repeated candidates with another distance than the id's first (the
    first occurrence wins); candidate counts from 0 to sbuf, INVALID after;
    a quarter of the rows done and, of those, half masked (an empty top-k
    and zero probe counts, as a ``valid=False`` row has). Row 0 (active, a
    full buffer) always holds an id of its top-k among its candidates, a
    repeated candidate and a tie in d2 between two ids; row 1 (active) has
    fewer than k finite entries; rows 2 and 3, where Q > 3, are done and
    masked. Returns (state, (cand_id, cand_d2, cnt, blocks_read, count),
    fold kwargs)."""
    n_ids = k + sbuf // 2 + 1
    table = RNG.integers(1, 17, size=(Q, n_ids)).astype(np.float32) * 0.25
    best_id = np.full((Q, k), INVALID, np.int32)
    best_d2 = np.full((Q, k), np.inf, np.float32)
    done = RNG.uniform(size=Q) < 0.25
    masked = done & (RNG.uniform(size=Q) < 0.5)
    done[:2] = masked[:2] = False
    if Q > 3:
        done[2:4], masked[2:4] = True, (False, True)
    for q in range(Q):
        nb = 0 if masked[q] or q == 1 else k if q == 0 else int(RNG.integers(0, k + 1))
        ids = RNG.choice(n_ids, size=nb, replace=False)
        order = np.lexsort((ids, table[q, ids]))
        best_id[q, :nb], best_d2[q, :nb] = ids[order], table[q, ids[order]]
    cand_id = RNG.integers(0, n_ids, size=(Q, sbuf)).astype(np.int32)
    cand_d2 = np.take_along_axis(table, cand_id, axis=1)
    jitter = RNG.uniform(size=(Q, sbuf)) < 0.1
    cand_d2[jitter] = RNG.integers(1, 17, size=int(jitter.sum())) * 0.25
    cand_id[0, :5] = best_id[0, 0], 3 % n_ids, 3 % n_ids, 4 % n_ids, 5 % n_ids
    cand_d2[0, :5] = best_d2[0, 0], 1.0, 1.0, 0.75, 0.75
    count = RNG.integers(0, sbuf + 1, size=Q).astype(np.int32)
    count[0], count[1], count[masked] = sbuf, min(k - 1, sbuf), 0
    past = np.arange(sbuf)[None, :] >= count[:, None]
    cand_id[past], cand_d2[past] = INVALID, np.inf
    cnt = RNG.integers(0, 3, size=(Q, L)).astype(np.int32) * RNG.integers(
        0, 200, size=(Q, L)).astype(np.int32)
    blocks = np.where(masked, 0, RNG.integers(0, 2 * L + 1, size=Q)).astype(np.int32)
    i32 = np.int32
    probe = np.full((Q, r, L), -1, i32) if collect else np.zeros((0,), i32)
    if collect:
        probe[:, :t] = RNG.integers(-1, 50, size=(Q, t, L))
    state = (best_id, best_d2, done, RNG.integers(0, t + 1, size=Q).astype(i32),
             RNG.integers(0, 9, size=Q).astype(i32), RNG.integers(0, 9, size=Q).astype(i32),
             RNG.integers(0, 99, size=Q).astype(i32), probe)
    return (tuple(_t(*state, device=device)),
            tuple(_t(cand_id, cand_d2, cnt, blocks, count, device=device)),
            dict(t=t, thresh2=float(np.float32(1.5))))


def _fold_brute(state, cand_id, cand_d2, cnt, blocks_read, count, *, t, thresh2):
    """The fold row by row in Python, from its definition: the k running
    entries, then the candidates; a valid id seen before gets +inf; the k
    least by (d2, id, position) stay; a done row keeps its top-k."""
    (best_id, best_d2, done, radii, nio_t, nio_b, cands, probe) = (
        x.numpy().copy() for x in state)
    cand_id, cand_d2, cnt = cand_id.numpy(), cand_d2.numpy(), cnt.numpy()
    k = best_id.shape[1]
    nio_b += blocks_read.numpy()
    cands += count.numpy()
    for q in range(best_id.shape[0]):
        if probe.ndim == 3:
            probe[q, t] = np.where(cnt[q] > 0, cnt[q], -1) if not done[q] else -1
        if done[q]:
            continue
        radii[q] += 1
        nio_t[q] += int((cnt[q] > 0).sum())
        seen, keyed = set(), []
        for pos, (i, d) in enumerate(zip(np.concatenate([best_id[q], cand_id[q]]).tolist(),
                                         np.concatenate([best_d2[q], cand_d2[q]]).tolist())):
            if i != INVALID and i in seen:
                d = np.inf
            seen.add(i)
            keyed.append((d, i, pos))
        top = sorted(keyed)[:k]
        best_id[q] = [INVALID if np.isinf(d) else i for d, i, _ in top]
        best_d2[q] = [d for d, _, _ in top]
        done[q] = sum(d <= thresh2 for d, _, _ in top) >= k
    return best_id, best_d2, done, radii, nio_t, nio_b, cands, probe


def _assert_states_equal(got, want):
    for name, g, w in zip(("best_id", "best_d2", "done", "radii_searched", "nio_table",
                           "nio_blocks", "cands_checked", "probe_sizes"), got, want):
        g = g.cpu().numpy() if torch.is_tensor(g) else g
        w = w.cpu().numpy() if torch.is_tensor(w) else w
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      w.view(np.int32) if w.dtype == np.float32 else w,
                                      err_msg=f"state field {name} differs")


def _packed(cands):
    """The fold inputs as column slices of one [Q, sbuf + 2 + L] int32 array
    (the external plan's upload): strided rows and elements."""
    cand_id, cand_d2, cnt, blocks, count = cands
    sb = cand_id.shape[1]
    up = torch.cat([cand_id, blocks[:, None], count[:, None], cnt], dim=1)
    return up[:, :sb], cand_d2, up[:, sb + 2:], up[:, sb], up[:, sb + 1]


@pytest.mark.parametrize("Q,k,sbuf,L,collect", [(7, 1, 8, 4, False), (9, 3, 16, 5, True),
                                                (12, 10, 64, 32, True),
                                                (6, 64, 40, 3, False)])
def test_topk_merge_ref_matches_a_brute_force_merge(Q, k, sbuf, L, collect):
    """The plain fold == the fold written out row by row, on every state
    field: ids in both the top-k and the candidates, repeated candidates,
    ties in d2 broken by id, INVALID padding, rows with fewer than k finite
    entries, done rows left as they were, masked rows inert, every counter
    and the probe trace. The wrapper runs it for CPU tensors, strided inputs
    too, and the state given is not changed."""
    state, cands, kw = _fold_inputs(Q, k, sbuf, L, collect=collect)
    before = [x.clone() for x in state]
    want = _fold_brute(state, *cands, **kw)
    got = topk_merge(state, *cands, **kw)
    _assert_states_equal(got, want)
    _assert_states_equal(state, before)
    _assert_states_equal(topk_merge_ref(state, *cands, **kw), want)
    _assert_states_equal(topk_merge(state, *_packed(cands), **kw), want)
    assert (want[0][1] == INVALID).any()    # fewer than k finite entries
    assert state[2].numpy()[2:4].all() and (state[0].numpy()[3] == INVALID).all()


def test_topk_merge_done_test_counts_the_kth_distance():
    """A row is done when its k-th merged distance lies within thresh2 (c
    R_t)^2 (equal counts), one ulp above it is not."""
    k, thresh2 = 3, float(np.float32(2.25))
    i32 = dict(dtype=torch.int32)
    state = (torch.full((2, k), INVALID, **i32), torch.full((2, k), torch.inf),
             torch.zeros(2, dtype=torch.bool), *(torch.zeros(2, **i32) for _ in range(4)),
             torch.zeros(0, **i32))
    cand_id = torch.tensor([[4, 5, 6, INVALID], [4, 5, 6, INVALID]], **i32)
    above = float(np.nextafter(np.float32(thresh2), np.float32(np.inf)))
    cand_d2 = torch.tensor([[0.5, 1.0, thresh2, np.inf], [0.5, 1.0, above, np.inf]])
    zeros = torch.zeros(2, **i32)
    got = topk_merge(state, cand_id, cand_d2, torch.zeros((2, 1), **i32), zeros, zeros,
                     t=0, thresh2=thresh2)
    assert got[2].tolist() == [True, False]
    assert got[3].tolist() == [1, 1]


def test_topk_merge_refuses_bad_arguments():
    state, cands, kw = _fold_inputs(3, 2, 8, 4)
    cand_id, cand_d2, cnt, blocks, count = cands
    with pytest.raises(ValueError, match="shapes disagree"):
        topk_merge(state, cand_id[:, :5], cand_d2, cnt, blocks, count, **kw)
    with pytest.raises(ValueError, match="shapes disagree"):
        topk_merge(state, cand_id, cand_d2, cnt, blocks[:2], count, **kw)
    with pytest.raises(ValueError, match="shapes disagree"):
        topk_merge(state, cand_id, cand_d2, cnt, blocks, count, **dict(kw, t=4))


def _tables(r, L, u, device, *, empty=0.4):
    """Random hash tables [r, L, 2^u] int32: bucket sizes and chain heads,
    a share ``empty`` of the buckets empty (size 0, head -1)."""
    gen = torch.Generator().manual_seed(r * 1000 + L * 10 + u)
    cnt = torch.randint(1, 300, (r, L, 1 << u), generator=gen, dtype=torch.int32)
    head = torch.randint(1, 2**31 - 1, (r, L, 1 << u), generator=gen, dtype=torch.int32)
    hole = torch.rand((r, L, 1 << u), generator=gen) < empty
    cnt[hole], head[hole] = 0, -1
    return cnt.to(device), head.to(device)


@pytest.mark.parametrize("r,L,m,u,fp_bits", [(2, 5, 6, 10, 8), (3, 4, 23, 18, 14),
                                             (2, 3, 27, 20, 12)])
def test_lsh_hash_lookup_plain_is_the_hash_then_the_lookup(r, L, m, u, fp_bits):
    """On the CPU the lookup entry is the plain hashes over the pack, then
    each bucket's row of the tables, empty buckets (-1) included, bit for
    bit; each output a contiguous [r, N, L] tensor."""
    n, d = 9, 24
    a, b, rm = _t(*_family(r, L, m, d))
    x = torch.from_numpy(RNG.normal(size=(n, d)).astype(np.float32) * 3)
    radii = tuple(2.0 ** t for t in range(r))
    pack = hash_pack(a, b, rm, w=4.0, radii=radii)
    tcnt, thead = _tables(r, L, u, "cpu")
    cnt, head, fp = lsh_hash_lookup(x, pack, tcnt, thead, u=u, fp_bits=fp_bits)
    bk_p, fp_p = lsh_hash_packed_ref(x, pack, u=u, fp_bits=fp_bits)
    rr, ll = torch.meshgrid(torch.arange(r), torch.arange(L), indexing="ij")
    want_cnt = tcnt[rr[:, None, :], ll[:, None, :], bk_p.long()]
    want_head = thead[rr[:, None, :], ll[:, None, :], bk_p.long()]
    for got, want in ((cnt, want_cnt), (head, want_head), (fp, fp_p)):
        assert got.shape == (r, n, L) and got.dtype == torch.int32 and got.is_contiguous()
        assert torch.equal(got, want)
    assert bool((head == -1).any()) and bool((cnt == 0).any())


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("fault", ["int64 table", "short table", "tables of another u",
                                   "strided table", "x of another D", "u + fp_bits > 32"])
def test_lsh_hash_lookup_refuses_bad_tables(device, fault):
    """Tables of the wrong dtype, shape or layout, an x of another width and
    bits past 32 raise on either device before any launch."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU or interpret mode")
    r, L, m, d, u = 2, 3, 6, 16, 10
    a, b, rm = _t(*_family(r, L, m, d), device=device)
    pack = hash_pack(a, b, rm, w=4.0, radii=(1.0, 2.0))
    tcnt, thead = _tables(r, L, u, device)
    x = torch.zeros((5, d), device=device)
    kw = dict(u=u, fp_bits=8)
    if fault == "int64 table":
        tcnt = tcnt.long()
    elif fault == "short table":
        thead = thead[:, :2].contiguous()
    elif fault == "tables of another u":
        kw["u"] = u + 1
    elif fault == "strided table":
        tcnt = tcnt.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "x of another D":
        x = torch.zeros((5, d + 4), device=device)
    else:
        kw["fp_bits"] = 32 - u + 1
    before = KERNELS[0].launches
    with pytest.raises(ValueError, match="lsh_hash"):
        lsh_hash_lookup(x, pack, tcnt, thead, **kw)
    assert KERNELS[0].launches == before


def test_cpu_tensors_never_launch_a_kernel():
    """On the CPU every wrapper runs its plain version: no launch counted."""
    before = [k.launches for k in KERNELS]
    x = torch.zeros((3, 8))
    a, b, rm = _t(*_family(2, 2, 3, 8))
    lsh_hash_all_radii(x, a, b, rm, w=4.0, radii=(1.0, 2.0), u=10, fp_bits=8)
    tables = _tables(2, 2, 10, "cpu")
    lsh_hash_lookup(x, hash_pack(a, b, rm, w=4.0, radii=(1.0, 2.0)), *tables, u=10, fp_bits=8)
    cnt, head, qfp, active, ids_b, fps_b = _probe_inputs(3, 4, 2, 8)
    buf, _, _ = probe_append(cnt, head, qfp, active, ids_b, fps_b, block_objs=8,
                             max_chain=2, S=8, sbuf=8)
    l2_distance_by_id(x, buf, torch.zeros((5000, 8)), torch.zeros(5000), torch.zeros(3))
    l2_distance(x, x)
    state, cands, kw = _fold_inputs(3, 2, 8, 4)
    topk_merge(state, *cands, **kw)
    assert len(KERNELS) == 5
    assert [k.launches for k in KERNELS] == before


# ---------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 33, 256, 300])
@pytest.mark.parametrize("r,L,m,d", [(7, 32, 23, 128), (3, 8, 13, 100)])
def test_cuda_lsh_hash_kernel_matches_plain(cuda, n, r, L, m, d):
    """The SIFT1M family (r=7, L=32, m=23, d=128) and a ragged one (m=13,
    d=100: 16-column hashes, 4-byte copies), from a lone query to a batch
    past the block rows: exact on hashes clear of a boundary, flips counted
    among the rest."""
    a, b, rm = _t(*_family(r, L, m, d), device=cuda)
    x = torch.from_numpy(RNG.normal(size=(n, d)).astype(np.float32) * 3).to(cuda)
    radii = tuple(2.0 ** t for t in range(r))
    kw = dict(w=4.0, radii=radii, u=18, fp_bits=14)
    launches = KERNELS[0].launches
    bk, fp = lsh_hash_all_radii(x, a, b, rm, **kw)
    torch.cuda.synchronize()
    assert KERNELS[0].launches == launches + 1
    assert bk.shape == (r, n, L) and bk.is_contiguous() and fp.is_contiguous()
    bk_p, fp_p = lsh_hash_all_radii_ref(x, a, b, rm, **kw)
    _assert_hashes_agree(bk, fp, bk_p, fp_p, floor_margin(x, a, b, w=4.0, radii=radii))


@pytest.mark.cuda
def test_cuda_lsh_hash_refuses_m_past_the_block(cuda):
    a, b, rm = _t(*_family(1, 2, 97, 8), device=cuda)
    with pytest.raises(ValueError, match="at most 96"):
        lsh_hash_all_radii(torch.zeros((2, 8), device=cuda), a, b, rm,
                           w=4.0, radii=(1.0,), u=10, fp_bits=8)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [2, 3, 5, 256])
@pytest.mark.parametrize("m", [6, 23, 27])
def test_cuda_lsh_hash_lookup_matches_plain(cuda, Q, m):
    """One launch writes (cnt, head, fp) [r, Q, L]: on every hash clear of a
    floor() boundary equal to ``table_lookup`` over the plain hashes, empty
    buckets (head -1) included, at u + fp_bits = 32; Q = 2 .. 5 straddles
    the lone tile (N <= 4), m = 6, 23, 27 pack 8, 24 and 32 columns (the
    last only on the batch tile). The bucket entry shares the epilogue: its
    fp equals the lookup's, and the plain lookup at its buckets gives cnt
    and head, bit for bit everywhere. A lone query's row equals the same
    row of the batch, bit for bit."""
    import types
    from repro_torch.core.query import table_lookup
    r, L, d, u, fp_bits = 3, 8, 128, 18, 14
    a, b, rm = _t(*_family(r, L, m, d), device=cuda)
    x = torch.from_numpy(RNG.normal(size=(Q, d)).astype(np.float32) * 3).to(cuda)
    radii = tuple(2.0 ** t for t in range(r))
    hkw = dict(w=4.0, radii=radii, u=u, fp_bits=fp_bits)
    pack = hash_pack(a, b, rm, w=4.0, radii=radii)
    tcnt, thead = _tables(r, L, u, cuda)
    ix = types.SimpleNamespace(table_cnt=tcnt, blocks_head=thead)
    cfg = types.SimpleNamespace(radii=radii, L=L, u=u)
    launches = KERNELS[0].launches
    cnt, head, fp = lsh_hash_lookup(x, pack, tcnt, thead, u=u, fp_bits=fp_bits)
    torch.cuda.synchronize()
    assert KERNELS[0].launches == launches + 1
    for out in (cnt, head, fp):
        assert out.shape == (r, Q, L) and out.dtype == torch.int32 and out.is_contiguous()
    bk_p, fp_p = lsh_hash_all_radii_ref(x, a, b, rm, **hkw)
    cnt_p, head_p = table_lookup(ix, bk_p, cfg)
    safe = floor_margin(x, a, b, w=4.0, radii=radii) > MARGIN
    assert bool(safe.float().mean() > 0.5)
    for got, want, name in ((cnt, cnt_p, "cnt"), (head, head_p, "head"), (fp, fp_p, "fp")):
        bad = int((safe & (got != want)).sum())
        assert bad == 0, f"{bad} {name} clear of every boundary disagree"
    assert bool((head == -1).any()) and bool((head != -1).any())
    bk, fp_b = lsh_hash_all_radii(x, a, b, rm, **hkw, pack=pack)
    assert bk.is_contiguous() and fp_b.is_contiguous()
    assert torch.equal(fp_b, fp)
    cnt_b, head_b = table_lookup(ix, bk, cfg)
    assert torch.equal(cnt_b, cnt) and torch.equal(head_b, head)
    lone = lsh_hash_lookup(x[-1:].contiguous(), pack, tcnt, thead, u=u, fp_bits=fp_bits)
    for got, want in zip(lone, (cnt, head, fp)):
        assert torch.equal(got, want[:, -1:])


@pytest.mark.cuda
@pytest.mark.parametrize("Q,L,C,block_objs,S,sbuf,fp_range", [
    (1, 32, 2, 99, 64, 64, 4),      # a lone query at the SIFT1M shape
    (256, 32, 2, 99, 64, 64, 64),   # the batch, the budget reached in step 1 or never
    (37, 7, 1, 8, 13, 21, 2),       # L < 32, sbuf not a multiple of 8
    (19, 45, 4, 16, 100, 100, 8),   # L past a 32-row chunk, four steps
    (11, 3, 3, 150, 30, 33, 2),     # rows of 152 slots: two 32-lane segments
])
def test_cuda_probe_append_kernel_matches_plain(cuda, Q, L, C, block_objs, S, sbuf,
                                                fp_range):
    """The fused probe kernel == its plain version, exactly: the buffer (S
    reached inside a step, INVALID after), the counts and the blocks read,
    inactive queries included."""
    args = _probe_inputs(Q, L, C, block_objs, fp_range=fp_range, device=cuda)
    kw = dict(block_objs=block_objs, max_chain=C, S=S, sbuf=sbuf)
    launches = KERNELS[1].launches
    got = probe_append(*args, **kw)
    torch.cuda.synchronize()
    assert KERNELS[1].launches == launches + 1
    want = probe_append_ref(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_probe_append_refuses_what_the_kernel_cannot_take(cuda):
    """L past the 4,096 tables a block stages, rows not made of 16 B vectors,
    and strided [Q, L] inputs raise before a launch."""
    cnt, head, qfp, active, ids_b, fps_b = _probe_inputs(2, 3, 2, 8, device=cuda)
    kw = dict(block_objs=8, max_chain=2, S=8, sbuf=8)
    wide = torch.zeros((2, 4097), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="L <= 4096"):
        probe_append(wide, wide, wide, active, ids_b, fps_b, **kw)
    with pytest.raises(ValueError, match="16 B vectors"):
        probe_append(cnt, head, qfp, active, ids_b[:, :6].contiguous(),
                     fps_b[:, :6].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        probe_append(cnt.t().contiguous().t(), head, qfp, active, ids_b, fps_b, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("q,s,d", [(1, 64, 128), (256, 64, 128), (7, 61, 128),
                                   (5, 17, 100), (3, 9, 30), (4, 70, 960)])
def test_cuda_l2_distance_by_id_kernel_matches_plain(cuda, q, s, d):
    """The distance-by-id kernel == its plain version at 2e-4 (D = 128 one
    float4 a lane, 100 ragged, 30 scalar, 960 GIST's eight chunks), +inf on
    exactly the INVALID slots; a strided buffer (a column slice, as the
    external plan passes) gives the same values, and each slot's value
    depends on its (query, id) only: a lone query's row and a narrower
    buffer agree bit for bit."""
    n = 3000
    qs, db = _t(RNG.normal(size=(q, d)).astype(np.float32),
                RNG.normal(size=(n, d)).astype(np.float32), device=cuda)
    ids = RNG.integers(0, n, size=(q, s + 3)).astype(np.int32)
    ids[RNG.uniform(size=ids.shape) < 0.25] = INVALID
    wide = torch.from_numpy(ids).to(cuda)
    buf = wide[:, :s]
    xn2, qn2 = (db * db).sum(-1), (qs * qs).sum(-1)
    launches = KERNELS[2].launches
    got = l2_distance_by_id(qs, buf, db, xn2, qn2)
    torch.cuda.synchronize()
    assert KERNELS[2].launches == launches + 1
    want = l2_distance_by_id_ref(qs, buf, db, xn2, qn2)
    assert torch.equal(torch.isinf(got), buf == INVALID)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert torch.equal(l2_distance_by_id(qs, buf.contiguous(), db, xn2, qn2), got)
    lone = l2_distance_by_id(qs[-1:].contiguous(), buf[-1:, : s // 2 + 1].contiguous(),
                             db, xn2, qn2[-1:].contiguous())
    assert torch.equal(lone, got[-1:, : s // 2 + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("sbuf", [64, 512])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("Q", [2, 256])
def test_cuda_topk_merge_kernel_matches_plain(cuda, Q, k, sbuf):
    """The fold kernel == its plain version on the card, bit for bit on every
    state field, in one launch: the cases of the CPU test at the main path's
    k and buffer (10, 64), k = 1 and 64, a buffer of 512 (the widest
    ``s_cap`` the plans are run at), a lone pair of rows and a batch; with
    the probe trace on and off, and with the external plan's strided
    inputs. The kernel updates the state it is given in place."""
    for collect in (True, False):
        state, cands, kw = _fold_inputs(Q, k, sbuf, 32, collect=collect, device=cuda)
        want = topk_merge_ref(state, *cands, **kw)
        mine = tuple(x.clone() for x in state)
        launches = KERNELS[4].launches
        got = topk_merge(mine, *cands, **kw)
        torch.cuda.synchronize()
        assert KERNELS[4].launches == launches + 1
        assert all(g is m for g, m in zip(got, mine))
        _assert_states_equal(got, want)
        strided = topk_merge(tuple(x.clone() for x in state), *_packed(cands), **kw)
        _assert_states_equal(strided, want)


@pytest.mark.cuda
def test_cuda_topk_merge_refuses_what_the_kernel_cannot_take(cuda):
    """k + sbuf past the 4,096 entries a block stages, a strided state and
    a candidate buffer with strided columns raise before a launch."""
    state, cands, kw = _fold_inputs(2, 10, 4087, 4, device=cuda)
    launches = KERNELS[4].launches
    with pytest.raises(ValueError, match="k \\+ sbuf <= 4096"):
        topk_merge(state, *cands, **kw)
    state, cands, kw = _fold_inputs(2, 10, 64, 4, device=cuda)
    strided = (state[0].t().contiguous().t(),) + state[1:]
    with pytest.raises(ValueError, match="contiguous"):
        topk_merge(strided, *cands, **kw)
    wide = torch.cat([cands[0], cands[0]], dim=1)[:, ::2]
    with pytest.raises(ValueError, match="unit column stride"):
        topk_merge(state, wide, *cands[1:], **kw)
    assert KERNELS[4].launches == launches
