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

CUDA cases (marker ``cuda``): each hand-written kernel vs its plain version
on the card, by the same rules; they skip where no card is present.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (INVALID, KERNELS, blockify_entries, bucket_probe,
                                 bucket_probe_ref, l2_distance, l2_distance_gathered,
                                 l2_distance_gathered_ref, lsh_hash_all_radii,
                                 lsh_hash_all_radii_ref, lsh_hash_ref)
from repro_torch.kernels.lsh_hash.ref import floor_margin

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
    got = bucket_probe(*_t(rows, qfp), ids_b, fps_b)
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
    got = l2_distance_gathered(*_t(qs, coords, xn2, qn2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_cpu_tensors_never_launch_a_kernel():
    """On the CPU every wrapper runs its plain version: no launch counted."""
    before = [k.launches for k in KERNELS]
    x = torch.zeros((3, 8))
    a, b, rm = _t(*_family(2, 2, 3, 8))
    lsh_hash_all_radii(x, a, b, rm, w=4.0, radii=(1.0, 2.0), u=10, fp_bits=8)
    ids = torch.full((2, 8), INVALID, dtype=torch.int32)
    bucket_probe(torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
                 ids, ids)
    l2_distance_gathered(x, x[:, None, :], torch.zeros(3, 1), torch.zeros(3))
    l2_distance(x, x)
    assert [k.launches for k in KERNELS] == before


# ---------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 256, 300])
def test_cuda_lsh_hash_kernel_matches_plain(cuda, n):
    """SIFT1M-shaped family (d=128, m=23): exact on hashes clear of a
    boundary, flips counted among the rest."""
    r, L, m, d = 3, 32, 23, 128
    a, b, rm = _t(*_family(r, L, m, d), device=cuda)
    x = torch.from_numpy(RNG.normal(size=(n, d)).astype(np.float32) * 3).to(cuda)
    radii = (1.0, 2.0, 4.0)
    kw = dict(w=4.0, radii=radii, u=18, fp_bits=14)
    launches = KERNELS[0].launches
    bk, fp = lsh_hash_all_radii(x, a, b, rm, **kw)
    torch.cuda.synchronize()
    assert KERNELS[0].launches == launches + 1
    bk_p, fp_p = lsh_hash_all_radii_ref(x, a, b, rm, **kw)
    _assert_hashes_agree(bk, fp, bk_p, fp_p, floor_margin(x, a, b, w=4.0, radii=radii))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 16384, 16381])
def test_cuda_bucket_probe_kernel_matches_plain(cuda, G):
    eid, efp, toff, tcnt = _csr(4000)
    toff, tcnt = np.array([0, 900, -1, 2500]), np.array([900, 1600, 0, 1500])
    ids_b, fps_b, _, nb = blockify_entries(
        *_t(eid, efp.astype(np.int32), toff, tcnt, device=cuda), 99, lane_pad=8)
    rows, qfp = _t(RNG.integers(0, nb, size=G).astype(np.int32),
                   RNG.integers(0, 64, size=G).astype(np.int32), device=cuda)
    got = bucket_probe(rows, qfp, ids_b, fps_b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, bucket_probe_ref(rows, qfp, ids_b, fps_b),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("q,s,d", [(1, 64, 128), (256, 64, 128), (7, 61, 128),
                                   (5, 17, 24), (3, 9, 30)])
def test_cuda_l2_distance_gathered_kernel_matches_plain(cuda, q, s, d):
    qs, coords = _t(RNG.normal(size=(q, d)).astype(np.float32),
                    RNG.normal(size=(q, s, d)).astype(np.float32), device=cuda)
    xn2 = (coords * coords).sum(-1)
    qn2 = (qs * qs).sum(-1)
    got = l2_distance_gathered(qs, coords, xn2, qn2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, l2_distance_gathered_ref(qs, coords, xn2, qn2),
                               rtol=2e-4, atol=2e-4)
