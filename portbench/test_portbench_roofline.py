"""The frozen roofline arithmetic against counts worked out by hand."""
import numpy as np
import pytest

from portbench import roofline


def test_hash_bound_counts_operations_and_bytes():
    # 4 rows, d 8, 1 radius, L 2, m 3: 2*4*8*6 = 384 flops; bytes: x 128,
    # a 6*8*4 = 192, b/wR/rm 3*6*4 = 72, bucket and fp 2*4*2*4 = 64
    ms, by = roofline.hash_bound_ms(4, 8, 1, 2, 3)
    assert by == "bytes"
    assert ms == pytest.approx((128 + 192 + 72 + 64) / 3.35e12 * 1e3)
    ms, by = roofline.hash_bound_ms(4096, 128, 1, 32, 23)
    assert by == "operations"
    assert ms == pytest.approx(2 * 4096 * 128 * 32 * 23 / 67e12 * 1e3)


def test_probe_and_distance_bounds_by_hand():
    # 10 chain rows of 99 ids and fingerprints; 2 queries, L 4, S 8
    nbytes = 10 * 2 * 99 * 4 + 3 * 2 * 4 * 4 + 2 + 2 * 8 * 4 + 2 * 2 * 4
    assert roofline.probe_bound_ms(10, 2, 4, 99, 8)[0] == pytest.approx(nbytes / 3.35e12 * 1e3)
    # 5 valid candidates of d 16; 2 queries, S 8
    nbytes = 5 * 17 * 4 + 2 * 2 * 8 * 4 + 2 * 17 * 4
    assert roofline.by_id_bound_ms(5, 2, 16, 8)[0] == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_a_batch_counts_only_the_rows_searching_at_each_radius():
    active = np.array([[1, 1, 0], [1, 0, 0]], bool)
    blocks = np.array([[3, 2, 0], [4, 0, 0]])
    cands = np.array([[8, 5, 0], [6, 0, 0]])
    kw = dict(d=16, L=4, m=3, block_objs=99, S=8)
    want = (roofline.hash_bound_ms(2, 16, 1, 4, 3)[0] + roofline.probe_bound_ms(7, 2, 4, 99, 8)[0]
            + roofline.by_id_bound_ms(14, 2, 16, 8)[0]
            + roofline.hash_bound_ms(1, 16, 1, 4, 3)[0] + roofline.probe_bound_ms(2, 1, 4, 99, 8)[0]
            + roofline.by_id_bound_ms(5, 1, 16, 8)[0]) * 1e-3
    assert roofline.batch_least_s(active, blocks, cands, **kw) == pytest.approx(want)
    assert roofline.batch_least_s(active[:, 2:], blocks[:, 2:], cands[:, 2:], **kw) == 0.0
