"""The port's query-time hashing API and the index's legacy CSR view against
the reference's (``repro.core.hashing``, ``repro.core.index``), on the
conftest index's family:

* ``hash_points_radius`` and ``hash_points`` (float32 projections in the
  reference's op order): buckets and fingerprints equal wherever both
  sides' fp32 projections agree, i.e. on every compound hash farther than
  ``MARGIN`` bucket widths from a floor() boundary (``ROADMAP.md``'s
  "held against the reference"); flips below the margin are counted;
* ``fmix32`` bit for bit on uint32 values;
* ``repro_torch.core`` exports ``hash_points_radius`` as ``repro.core`` does;
* ``E2LSHIndex.table_off`` / ``table_cnt`` / ``entries_id`` / ``entries_fp``
  / ``db`` equal the reference's on the same build.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as port_core
from repro_torch.core import HashFamily, LSHParams, build_index
from repro_torch.core.hashing import fmix32, hash_points, hash_points_radius
from repro_torch.kernels.lsh_hash.ref import floor_margin

MARGIN = 1e-4


@pytest.fixture(scope="module")
def ref_index(built_index):
    return built_index.index


@pytest.fixture(scope="module")
def families(ref_index):
    f = ref_index.family
    port = HashFamily.from_numpy(np.asarray(f.a), np.asarray(f.b), np.asarray(f.rm),
                                 w=f.w, u=f.u, fp_bits=f.fp_bits, device="cpu")
    return f, port


def _points(clustered_data):
    return np.concatenate([clustered_data["queries"], clustered_data["db"][:200]])


def _safe(port_family, x, radii):
    """[r, N, L] bool: the hashes far enough from a floor() boundary that any
    fp32 summation order lands in the same bucket."""
    return floor_margin(torch.from_numpy(x), port_family.a, port_family.b,
                        w=port_family.w, radii=radii).numpy() > MARGIN


def test_hash_points_radius_matches_the_reference(families, ref_index, clustered_data):
    from repro.core.hashing import hash_points_radius as ref_hash
    ref_family, port_family = families
    x = _points(clustered_data)
    radii = list(ref_index.params.radii)
    safe = _safe(port_family, x, radii)
    flips = 0
    for t, radius in enumerate(radii):
        rb, rf = (np.asarray(v).astype(np.int64) for v in ref_hash(ref_family, x, t, radius))
        pb, pf = hash_points_radius(port_family, torch.from_numpy(x), t, radius)
        assert pb.dtype == pf.dtype == torch.int32 and pb.shape == rb.shape
        ok = safe[t]
        np.testing.assert_array_equal(pb.numpy()[ok], rb[ok])
        np.testing.assert_array_equal(pf.numpy()[ok], rf[ok])
        flips += int(((pb.numpy() != rb) | (pf.numpy() != rf)).sum())
    assert safe.mean() > 0.99
    print(f"hash_points_radius: {flips} flips below the margin of "
          f"{safe.size} hashes ({int((~safe).sum())} within {MARGIN})")


def test_hash_points_stacks_every_radius(families, ref_index, clustered_data):
    from repro.core.hashing import hash_points as ref_hash_points
    ref_family, port_family = families
    x = _points(clustered_data)
    radii = list(ref_index.params.radii)
    rb, rf = (np.asarray(v).astype(np.int64) for v in ref_hash_points(ref_family, x, radii))
    pb, pf = hash_points(port_family, torch.from_numpy(x), radii)
    assert tuple(pb.shape) == rb.shape == (len(radii), x.shape[0], ref_index.params.L)
    safe = _safe(port_family, x, radii)
    np.testing.assert_array_equal(pb.numpy()[safe], rb[safe])
    np.testing.assert_array_equal(pf.numpy()[safe], rf[safe])
    for t, radius in enumerate(radii):       # each plane is the one-radius call
        b, f = hash_points_radius(port_family, torch.from_numpy(x), t, radius)
        assert torch.equal(pb[t], b) and torch.equal(pf[t], f)


def test_fmix32_matches_the_reference():
    import jax.numpy as jnp
    from repro.core.hashing import fmix32 as ref_fmix32
    h = np.random.default_rng(2).integers(0, 2**32, size=4096, dtype=np.uint64)
    h[:4] = (0, 1, 2**31, 2**32 - 1)
    want = np.asarray(ref_fmix32(jnp.asarray(h.astype(np.uint32)))).astype(np.int64)
    np.testing.assert_array_equal(fmix32(torch.from_numpy(h.astype(np.int64))).numpy(), want)
    assert port_core.hashing.fmix32 is fmix32


def test_core_exports_hash_points_radius():
    import repro.core as ref_core
    assert "hash_points_radius" in ref_core.__all__
    assert "hash_points_radius" in port_core.__all__
    assert port_core.hash_points_radius is hash_points_radius


@pytest.fixture(scope="module")
def port_index(families, ref_index, clustered_data):
    """The port's build of the conftest index under the reference's family."""
    params = LSHParams(**dataclasses.asdict(ref_index.params))
    return build_index(clustered_data["db"], params, family=families[1], device="cpu")


@pytest.mark.parametrize("name", ["table_off", "table_cnt", "entries_id", "entries_fp", "db"])
def test_legacy_csr_properties_match_the_reference(port_index, ref_index, name):
    port = port_index
    got = getattr(port, name)
    assert got is getattr(port.arrays, name)
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref_index, name)))
