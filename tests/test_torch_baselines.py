"""The port's small-index baselines, SRS and QALSH (the exact scan has its
own file, test_torch_exact.py).

* The reference's own checks (tests/test_baselines.py), on the port built on
  the CPU: SRS's ratio, its budget, its accuracy over T' and its tiny index,
  QALSH's ratio and its rounds under a hard and an easy collision
  threshold.
* Parity with the reference. SRS on the reference's projection
  (``SRSIndex.from_numpy``): ``checked`` equal, ids equal except where two
  candidates' distances tie within 2e-4 (the rate is reported), distances
  within 2e-4. QALSH on the reference's index (``QALSHIndex.from_numpy``):
  ids, checked and rounds equal on every query whose windows the port finds
  at the same sorted positions; a query whose fp32 projection lands on the
  other side of a window edge is shown to sit within rounding of that edge
  (the rate is reported).
"""
import numpy as np
import pytest
import torch

from repro_torch.baselines import (QALSHIndex, SRSIndex, build_qalsh, build_srs,
                                   qalsh_query, srs_query)
from repro_torch.core import overall_ratio

TOL = 2e-4


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def srs(clustered_data):
    return build_srs(clustered_data["db"], m=8, device="cpu")


def test_srs_reaches_target_ratio(srs, clustered_data):
    ids, d, checked = srs_query(srs, clustered_data["queries"], k=1, t_prime=800)
    assert ids.dtype == torch.int32 and d.dtype == torch.float32
    ratio = overall_ratio(_np(d), clustered_data["gt_dists"][:, :1])
    assert ratio < 1.05
    assert int(checked.max()) <= 800


def test_srs_accuracy_grows_with_tprime(srs, clustered_data):
    r = []
    for tp in (8, 64, 1024):
        _, d, _ = srs_query(srs, clustered_data["queries"], k=1, t_prime=tp)
        r.append(overall_ratio(_np(d), clustered_data["gt_dists"][:, :1]))
    assert r[2] <= r[0] + 1e-9


def test_srs_index_is_tiny(srs, clustered_data):
    assert srs.index_bytes == srs.proj_db.numel() * 4
    assert srs.index_bytes < clustered_data["db"].nbytes  # m << d


def test_qalsh_reaches_target_ratio(clustered_data):
    q = build_qalsh(clustered_data["db"], K=64, device="cpu")
    ids, d, checked, rounds = qalsh_query(q, clustered_data["queries"][:16], k=1)
    ratio = overall_ratio(_np(d), clustered_data["gt_dists"][:16, :1])
    assert ratio < 1.08
    assert (rounds >= 1).all()
    assert q.index_bytes == 2 * 4 * 64 * clustered_data["db"].shape[0]


def test_qalsh_collision_counting_superlinear_windows(clustered_data):
    """More rounds -> wider windows -> more checked candidates."""
    qs = clustered_data["queries"][:4]
    hard = build_qalsh(clustered_data["db"], K=48, collision_ratio=0.9, device="cpu")
    _, _, _, rounds_hard = qalsh_query(hard, qs, k=1, max_rounds=6)
    easy = build_qalsh(clustered_data["db"], K=48, collision_ratio=0.3, device="cpu")
    _, _, _, rounds_easy = qalsh_query(easy, qs, k=1, max_rounds=6)
    assert rounds_hard.float().mean() >= rounds_easy.float().mean()


@pytest.mark.parametrize("t_prime,k", [(800, 1), (8, 1), (64, 5), (1024, 10)])
def test_srs_matches_reference_on_its_projection(clustered_data, t_prime, k):
    """The reference's proj carried across: the same candidates examined,
    the same ids but for distance ties, distances at 2e-4."""
    from repro.baselines import build_srs as ref_build, srs_query as ref_query

    db, qs = clustered_data["db"], clustered_data["queries"]
    ref = ref_build(db, m=8)
    port = SRSIndex.from_numpy(proj=np.asarray(ref.proj), db=db, device="cpu")
    want = [np.asarray(x) for x in ref_query(ref, qs, k=k, t_prime=t_prime)]
    got = [_np(x) for x in srs_query(port, qs, k=k, t_prime=t_prime)]
    np.testing.assert_array_equal(got[2], want[2], err_msg="checked diverged")
    both_inf = np.isinf(got[1]) & np.isinf(want[1])
    close = both_inf | np.isclose(got[1], want[1], rtol=TOL, atol=TOL)
    assert close.all(), np.abs(got[1] - want[1])[~close]
    swaps = got[0] != want[0]
    assert not (swaps & ~close).any()
    print(f"srs t'={t_prime} k={k}: id swaps on ties {swaps.any(axis=1).mean():.4f} "
          f"of {len(qs)} queries")


def _edges(sorted_vals, qproj, w, c, rounds):
    """Every window edge's sorted position, [Q, K, 2 * rounds], in float32
    as both packages form them."""
    out = []
    for qp in qproj:
        row = []
        R = 1.0
        for _ in range(rounds):
            half = np.float32(w * R / 2.0)
            row.append([np.searchsorted(sv, v - half, side="left") for sv, v in
                        zip(sorted_vals, qp)])
            row.append([np.searchsorted(sv, v + half, side="right") for sv, v in
                        zip(sorted_vals, qp)])
            R *= c
        out.append(np.asarray(row).T)
    return np.asarray(out)


@pytest.mark.parametrize("k,ratio,K,rounds", [(1, 0.45, 64, 12), (5, 0.45, 64, 12),
                                              (1, 0.9, 48, 6)])
def test_qalsh_matches_reference_on_its_index(clustered_data, k, ratio, K, rounds):
    """The reference's index carried across: ids, checked and rounds equal
    on every query whose windows sit at the same sorted positions; the
    others' projections lie within fp32 rounding of an edge."""
    from repro.baselines import build_qalsh as ref_build, qalsh_query as ref_query

    db, qs = clustered_data["db"], clustered_data["queries"][:16]
    ref = ref_build(db, K=K, collision_ratio=ratio)
    port = QALSHIndex.from_numpy(proj=ref.proj, sorted_vals=ref.sorted_vals,
                                 sorted_ids=ref.sorted_ids, db=ref.db, w=ref.w,
                                 collision_ratio=ref.collision_ratio, device="cpu")
    want = ref_query(ref, qs, k=k, max_rounds=rounds)
    got = [_np(x) for x in qalsh_query(port, qs, k=k, max_rounds=rounds)]
    qp_ref = qs.astype(np.float32) @ ref.proj
    qp_port = _np(torch.from_numpy(qs) @ port.proj)
    same_edges = (_edges(ref.sorted_vals, qp_ref, ref.w, 2.0, rounds)
                  == _edges(ref.sorted_vals, qp_port, ref.w, 2.0, rounds)).all(axis=(1, 2))
    rows = [(got[i] == want[i]).reshape(len(qs), -1).all(axis=1) for i in (0, 2, 3)]
    agree = rows[0] & rows[1] & rows[2]
    assert agree[same_edges].all(), np.flatnonzero(same_edges & ~agree)
    # a query that moved across an edge did so by rounding alone
    assert np.abs(qp_ref - qp_port)[~same_edges].max(initial=0.0) < 1e-4
    fin = np.isfinite(want[1])
    np.testing.assert_array_equal(np.isfinite(got[1]), fin)
    np.testing.assert_allclose(got[1][fin & same_edges[:, None]],
                               want[1][fin & same_edges[:, None]], rtol=TOL, atol=TOL)
    print(f"qalsh k={k} ratio={ratio}: edge flips {(~same_edges).mean():.4f}, "
          f"differing queries {(~agree).mean():.4f} of {len(qs)}")


@pytest.mark.cuda
def test_cuda_srs_and_qalsh_match_the_cpu():
    """On the card SRS's true distances run ``l2_distance_by_id``'s kernel:
    ids equal the CPU run's but for distance ties, distances at 2e-4;
    QALSH's rounds run on the card and equal the CPU's (the windows come
    from the same host projections)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++")
    from repro_torch.data import make_dataset
    from repro_torch.kernels import KERNELS

    ds = make_dataset("sift", n=20_000, n_queries=32, seed=1)
    srs_gpu = build_srs(ds.db, m=8, device="cuda")
    srs_cpu = SRSIndex.from_numpy(proj=_np(srs_gpu.proj), db=ds.db, device="cpu")
    for kern in KERNELS:
        kern.launches = 0
    got = [_np(x) for x in srs_query(srs_gpu, ds.queries, k=10, t_prime=400)]
    assert {kern.name: kern.launches for kern in KERNELS}["l2_distance"] == 1
    want = [_np(x) for x in srs_query(srs_cpu, ds.queries, k=10, t_prime=400)]
    # the projected distances are summed in another order on the card, so a
    # candidate at the T'-th cut may differ; the answers may not
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
    assert not ((got[0] != want[0]) & ~np.isclose(got[1], want[1], rtol=TOL, atol=TOL)).any()
    q_gpu = build_qalsh(ds.db, K=64, device="cuda")
    q_cpu = QALSHIndex.from_numpy(proj=_np(q_gpu.proj), sorted_vals=_np(q_gpu.sorted_vals),
                                  sorted_ids=_np(q_gpu.sorted_ids), db=ds.db, w=q_gpu.w,
                                  collision_ratio=q_gpu.collision_ratio, device="cpu")
    got = [_np(x) for x in qalsh_query(q_gpu, ds.queries[:8], k=1)]
    want = [_np(x) for x in qalsh_query(q_cpu, ds.queries[:8], k=1)]
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
