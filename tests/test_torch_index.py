"""The port's index build against the reference's, leaf for leaf.

Given the reference's hash family and the same ``lane_pad``, the port's
device build (float64 projections, one stable sort per radius, one
blockifying scatter) must reproduce every ``IndexArrays`` leaf of the
reference's host build exactly, and its build statistics.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import HashFamily, IndexArrays, LSHParams, build_index
from repro_torch.core.hashing import make_hash_family
from repro_torch.kernels import blockify_entries


def _leaves(ref_arrays) -> dict:
    return {name: np.asarray(getattr(ref_arrays, name))
            for name in IndexArrays.array_fields()}


def _family(ref_index) -> HashFamily:
    f = ref_index.family
    return HashFamily.from_numpy(np.asarray(f.a), np.asarray(f.b), np.asarray(f.rm),
                                 w=f.w, u=f.u, fp_bits=f.fp_bits, device="cpu")


def _assert_leaves_equal(port: IndexArrays, ref_leaves: dict):
    got = port.to_numpy()
    for name in IndexArrays.array_fields():
        np.testing.assert_array_equal(got[name], ref_leaves[name],
                                      err_msg=f"leaf {name} differs")
        assert got[name].dtype == ref_leaves[name].dtype, name


@pytest.fixture(scope="module")
def ref_index(built_index):
    return built_index.index


@pytest.fixture(scope="module")
def port_params(ref_index):
    return LSHParams(**dataclasses.asdict(ref_index.params))


@pytest.mark.parametrize("lane_pad", [8, 128])
def test_device_build_equals_reference_leaf_for_leaf(ref_index, clustered_data,
                                                     port_params, lane_pad):
    ref_arrays = ref_index.arrays.with_block_objs(ref_index.arrays.block_objs,
                                                  lane_pad=lane_pad)
    port = build_index(clustered_data["db"], port_params, family=_family(ref_index),
                       device="cpu", lane_pad=lane_pad)
    assert (port.arrays.block_objs, port.arrays.lane_pad) == (
        ref_arrays.block_objs, ref_arrays.lane_pad)
    _assert_leaves_equal(port.arrays, _leaves(ref_arrays))
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref_index.stats)


def test_blockify_entries_equals_reference_on_built_index(ref_index):
    """The port's blockify of the reference's CSR view at another block size
    equals the reference's re-blockify (the block_objs timing knob)."""
    ref16 = ref_index.arrays.with_block_objs(16)
    leaves = _leaves(ref_index.arrays)
    ids_b, fps_b, head, nb = blockify_entries(
        *(torch.from_numpy(np.array(leaves[k]).astype(np.int32))
          for k in ("entries_id", "entries_fp", "table_off", "table_cnt")),
        16, lane_pad=ref16.lane_pad)
    assert nb == ref16.ids_blocks.shape[0]
    np.testing.assert_array_equal(ids_b.numpy(), np.asarray(ref16.ids_blocks))
    np.testing.assert_array_equal(fps_b.numpy(), np.asarray(ref16.fps_blocks))
    np.testing.assert_array_equal(head.numpy(), np.asarray(ref16.blocks_head))
    port16 = IndexArrays.from_numpy(leaves, block_objs=ref_index.arrays.block_objs,
                                    lane_pad=ref_index.arrays.lane_pad,
                                    device="cpu").with_block_objs(16)
    _assert_leaves_equal(port16, _leaves(ref16))


def test_from_numpy_round_trips_reference_leaves(ref_index):
    leaves = _leaves(ref_index.arrays)
    ix = IndexArrays.from_numpy(leaves, block_objs=ref_index.arrays.block_objs,
                                lane_pad=ref_index.arrays.lane_pad, device="cpu")
    assert ix.rm.dtype == torch.int32 and ix.entries_fp.dtype == torch.int32
    _assert_leaves_equal(ix, leaves)
    with pytest.raises(ValueError, match="missing index leaves"):
        IndexArrays.from_numpy({k: v for k, v in leaves.items() if k != "db"},
                               block_objs=99, lane_pad=8, device="cpu")


def test_facade_accounting_matches_reference(built_index, ref_index, clustered_data,
                                             port_params):
    """Table-6 footprint and the Eq. 6/7 modeled time come out as the
    reference's for the same build; measured_query runs the fused plan."""
    from repro_torch.core import E2LSHoS, measured_query, storage

    port = build_index(clustered_data["db"], port_params, family=_family(ref_index),
                       device="cpu")
    cfg = storage.TABLE5_CONFIGS[0]
    for tier in ("storage", "memory"):
        ours, ref = E2LSHoS(port, tier=tier), type(built_index)(ref_index, tier=tier)
        assert dataclasses.asdict(ours.footprint()) == dataclasses.asdict(ref.footprint())
        for async_io in (True, False):
            assert ours.modeled_time(1e-4, 40.0, cfg, async_io=async_io) == \
                ref.modeled_time(1e-4, 40.0, cfg, async_io=async_io)
    mq = measured_query(E2LSHoS(port), clustered_data["queries"][:8], k=2, repeats=1)
    assert mq.result.ids.shape == (8, 2)
    assert mq.t_compute_per_query > 0 and mq.nio_mean > 0 and mq.radii_mean >= 1


def test_make_hash_family_is_seeded_and_odd():
    kw = dict(r=2, L=3, m=4, d=5, w=4.0, u=10, fp_bits=8, device="cpu")
    f1 = make_hash_family(generator=torch.Generator().manual_seed(5), **kw)
    f2 = make_hash_family(generator=torch.Generator().manual_seed(5), **kw)
    for name in ("a", "b", "rm"):
        assert torch.equal(getattr(f1, name), getattr(f2, name))
    rm = f1.rm.numpy().view(np.uint32)
    assert (rm & 1).all() and rm.dtype == np.uint32
    assert ((f1.b >= 0) & (f1.b < 1)).all()
    assert (f1.r, f1.L, f1.m, f1.d) == (2, 3, 4, 5)


def test_npz_checkpoint_loads_both_ways(ref_index, port_params, tmp_path):
    """A reference ``.npz`` checkpoint loads in the port (re-blockified at its
    saved layout, leaf for leaf), and a port checkpoint in the reference."""
    from repro.core.index import E2LSHIndex as RefIndex
    from repro_torch.core import E2LSHIndex, IndexStats

    ref_leaves = _leaves(ref_index.arrays)
    ref_index.save(tmp_path / "ref.npz")
    port = E2LSHIndex.load(tmp_path / "ref.npz", device="cpu")
    assert port.params == port_params
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref_index.stats)
    assert (port.arrays.block_objs, port.arrays.lane_pad) == (
        ref_index.arrays.block_objs, ref_index.arrays.lane_pad)
    _assert_leaves_equal(port.arrays, ref_leaves)
    assert torch.equal(port.family.rm, port.arrays.rm)

    port.save(tmp_path / "port.npz")
    back = RefIndex.load(tmp_path / "port.npz")
    assert back.params == ref_index.params
    for name in IndexArrays.array_fields():
        np.testing.assert_array_equal(np.asarray(getattr(back.arrays, name)),
                                      ref_leaves[name], err_msg=name)
    again = E2LSHIndex.load(tmp_path / "port.npz", device="cpu")
    _assert_leaves_equal(again.arrays, ref_leaves)
    assert isinstance(again.stats, IndexStats)

    z = dict(np.load(tmp_path / "port.npz", allow_pickle=True))
    del z["layout_meta"]
    np.savez(tmp_path / "bare.npz", **z)
    with pytest.raises(ValueError, match="layout_meta"):
        E2LSHIndex.load(tmp_path / "bare.npz", device="cpu")
