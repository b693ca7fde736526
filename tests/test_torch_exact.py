"""The port's dense distance and exact k-NN scan against the reference.

CPU cases: the port's plain ``l2_distance_ref`` (what ``l2_distance`` runs
on a CPU tensor) against the reference's Pallas kernel in interpret mode,
over the reference's own shape grid (D = 100 and 960, float16 inputs), at
the reference's kernel tolerance rtol = atol = 2e-4; and ``exact_knn`` on
the CPU against the reference's ``exact_knn`` and its float64 numpy oracle:
distances at 2e-4, ids equal except where two distances tie within it.

CUDA case (marker ``cuda``): the dense kernel against its plain version on
the card, and ``exact_knn`` launching it; it skips where no card is present.
"""
import numpy as np
import pytest
import torch

from repro_torch.baselines import exact_knn, exact_knn_np
from repro_torch.kernels import KERNELS, l2_distance, l2_distance_ref

TOL = 2e-4
GRID = [(1, 1, 8, np.float32), (10, 50, 32, np.float32), (130, 200, 100, np.float32),
        (64, 64, 960, np.float32), (33, 190, 128, np.float16)]


@pytest.fixture
def ref():
    """The reference's l2_distance and exact k-NN (JAX)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.baselines import exact_knn as ref_exact, exact_knn_np as ref_exact_np
    from repro.kernels.l2_distance import l2_distance as ref_l2
    return jnp, ref_l2, ref_exact, ref_exact_np


def _inputs(nq, nc, d, dtype, seed=0):
    rng = np.random.default_rng(seed + nq * 7 + nc * 3 + d)
    return (rng.normal(size=(nq, d)).astype(dtype), rng.normal(size=(nc, d)).astype(dtype))


@pytest.mark.parametrize("nq,nc,d,dtype", GRID)
def test_l2_distance_ref_matches_reference_pallas(ref, nq, nc, d, dtype):
    jnp, ref_l2, _, _ = ref
    q, x = _inputs(nq, nc, d, dtype)
    want = np.asarray(ref_l2(jnp.asarray(q), jnp.asarray(x), interpret=True,
                             force_pallas=True))
    got = l2_distance(torch.from_numpy(q), torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (nq, nc)
    assert torch.equal(got, l2_distance_ref(torch.from_numpy(q), torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert (got >= 0).all()


def _assert_knn_agree(ids, dists, want_ids, want_dists):
    """Distances allclose at TOL; ids equal except where the two distances
    at that rank tie within TOL (a tie ranked the other way)."""
    ids, dists = np.asarray(ids), np.asarray(dists)
    np.testing.assert_allclose(dists, want_dists, rtol=TOL, atol=TOL)
    differ = ids != np.asarray(want_ids)
    assert np.isclose(dists[differ], np.asarray(want_dists)[differ], rtol=TOL, atol=TOL).all()


@pytest.mark.parametrize("k,block", [(1, 16384), (10, 1024)])
def test_exact_knn_matches_reference(ref, clustered_data, k, block):
    """block=1024 leaves a ragged last block (6000 = 5 * 1024 + 880)."""
    jnp, _, ref_exact, ref_exact_np = ref
    db, q = clustered_data["db"], clustered_data["queries"]
    ids, dists = exact_knn(db, q, k=k, block=block, device="cpu")
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (q.shape[0], k)
    r_ids, r_dists = ref_exact(jnp.asarray(db), jnp.asarray(q), k=k, block=block)
    _assert_knn_agree(ids, dists, r_ids, r_dists)
    np_ids, np_dists = ref_exact_np(db, q, k=k)
    _assert_knn_agree(ids, dists, np_ids, np_dists)
    p_ids, p_dists = exact_knn_np(db, q, k=k)
    np.testing.assert_array_equal(p_ids, np_ids)
    np.testing.assert_array_equal(p_dists, np_dists)


def test_exact_knn_keeps_lower_id_on_ties_and_fills_short_results():
    """Stable merge: duplicate rows tie and rank by id; with n < k the
    missing ranks keep id -1 and distance inf, as in the reference."""
    db = np.array([[1.0, 0.0], [0.0, 0.0], [1.0, 0.0]], np.float32)
    ids, dists = exact_knn(db, np.array([[1.0, 0.0]], np.float32), k=4, block=2,
                           device="cpu")
    np.testing.assert_array_equal(ids.numpy(), [[0, 2, 1, -1]])
    np.testing.assert_array_equal(dists.numpy(), [[0.0, 0.0, 1.0, np.inf]])


def test_cpu_exact_knn_never_launches_the_kernel(clustered_data):
    before = [kern.launches for kern in KERNELS]
    exact_knn(clustered_data["db"][:300], clustered_data["queries"][:4], k=2, device="cpu")
    assert [kern.launches for kern in KERNELS] == before


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nc,d,dtype", GRID + [(256, 16384, 128, np.float32)])
def test_cuda_l2_distance_kernel_matches_plain(nq, nc, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ with no CPU or "
                    "interpret mode")
    from repro_torch.kernels.l2_distance.ops import DENSE_KERNEL
    q, x = (torch.from_numpy(a).cuda() for a in _inputs(nq, nc, d, dtype))
    n0 = DENSE_KERNEL.launches
    got = l2_distance(q, x)
    torch.cuda.synchronize()
    assert DENSE_KERNEL.launches == n0 + 1
    torch.testing.assert_close(got, l2_distance_ref(q, x), rtol=TOL, atol=TOL)
    db = torch.from_numpy(_inputs(1, 5000, 16, np.float32, seed=1)[1]).cuda()
    n0 = DENSE_KERNEL.launches
    ids, dists = exact_knn(db, db[:9] * 1.01, k=3, block=2048)
    torch.cuda.synchronize()
    assert DENSE_KERNEL.launches == n0 + 3
    want_ids, want_d = exact_knn_np(db.cpu().numpy(), db[:9].cpu().numpy() * 1.01, k=3)
    _assert_knn_agree(ids.cpu(), dists.cpu(), want_ids, want_d)
