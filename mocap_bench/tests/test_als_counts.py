"""The ALS's operation and byte counts, by hand at a small size and against
the kernel table's bound for B3 at C 4, N 336, 4 x 100 iterations."""
import pytest

import bench_support  # noqa: F401  (the checkout's root on the path)
from mocap_bench import roofline


def test_iteration_ops_by_hand_at_n4_rank2():
    n, r = 4, 2
    x_step, proj = 4 * n * n, 15 * n * n                 # 64, 240
    gram, rhs, spd = r * (r + 1) * n, 2 * r * n * n, r ** 3 / 3 + 2 * r * r * n
    assert (gram, rhs, spd) == (24, 64, 8 / 3 + 32)
    product = 2 * n * n * r                              # 64
    assert roofline.als_iteration_ops(n, r) == x_step + 2 * (gram + rhs + spd) + product + proj
    assert roofline.als_ops(n, r, 3) == 3 * roofline.als_iteration_ops(n, r) + 4 * n * n


def test_bytes_by_hand():
    # two problems at n 3, rank 2: each W (36 B), x_bin (9 B), count (4 B);
    # the mask (9 B) and the factor (24 B) once
    assert roofline.als_bytes(3, 2, 2) == 2 * (36 + 9 + 4) + 9 + 24


def test_b3_bound_matches_the_kernel_table():
    """PERF.md's kernel table: B3 at C 4, N 336, rank 32, 4 x 100
    iterations, bound 0.155 ms by ops."""
    ops = 4 * roofline.als_ops(336, 32, 100)
    n_bytes = roofline.als_bytes(336, 32, 4)
    assert ops / roofline.PEAK_F32_FLOPS > n_bytes / roofline.PEAK_HBM_BYTES_S
    assert roofline.least_seconds(ops, n_bytes) * 1e3 == pytest.approx(0.155, abs=5e-4)


def test_roofline_share_of_one_launch():
    """A launch of 4 problems at 400 iterations in all, taking 10 ms, has
    0.155 / 10 of its roofline."""
    pct = roofline.als_roofline_pct(400, 1, 0.010, 336, 32, 4)
    assert pct == pytest.approx(100 * 0.155 / 10, rel=3e-3)
