"""The roofline counts against hand-worked numbers."""

import numpy as np
import pytest

from portbench import roofline


def test_one_k1_tile():
    n_bytes, ops = roofline.k1_need(4096 * 4096, 2 * 4096, 8192)
    assert ops == 2 * 4096 * 4096 * 8192 == pytest.approx(2.75e11, 1e-3)
    assert n_bytes == 2 * 4096 * 1024 + 4096 * 4096 / 8
    t = roofline.least_time(n_bytes, ops, roofline.B1_OPS)
    assert t == pytest.approx(0.0176e-3, rel=2e-3)  # set by operations
    assert n_bytes / roofline.HBM_BPS < ops / roofline.B1_OPS


def test_k1_sweep_counts_each_pair_once():
    n = 262144
    pairs = n * (n - 1) / 2
    n_bytes, ops = roofline.k1_need(pairs, n)
    assert ops == 2 * pairs * 8192
    assert n_bytes == n * 1024 + pairs / 8
    # 2,080 tiles of 4096^2 hold the pairs twice over on the diagonal
    assert ops == pytest.approx(2080 * 2.75e11 * pairs / (2080 * 4096 ** 2),
                                rel=1e-3)
    assert roofline.least_time(n_bytes, ops, roofline.B1_OPS) == \
        pytest.approx(0.03598, rel=1e-3)


def test_int32_rate_and_k4_counts():
    assert roofline.INT32_OPS == pytest.approx(16.727e12, rel=1e-4)
    flat = np.array([1, 2, 3, 1, 2, 1, 9], dtype=np.uint32)
    # hash 1 in 3 genomes: 3 pairs; hash 2 in 2: 1 pair
    assert roofline.shared_hash_matches(flat) == 4
    n_bytes, ops = roofline.k4_mask(3, 7, 4)
    assert (n_bytes, ops) == (28 + 3 / 8, 4.0)
