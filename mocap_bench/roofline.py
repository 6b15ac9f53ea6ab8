"""Peaks of one NVIDIA H100 and the ALS solve's operations and bytes.

The least time of a kernel is max(bytes / peak bandwidth, f32 operations /
peak f32 rate); its roofline share is that over its device time.  The ALS
counts are those of `chip_smoke.py`'s kernel table (`als_ops`): the least
work of the function the kernel computes, not of its algorithm.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores
PEAK_HBM_BYTES_S = 3.35e12


def spd_solve_ops(d: int, m: int) -> float:
    """An SPD system of side d with m right-hand sides: a Cholesky factor
    (d^3 / 3) and two triangular solves per right-hand side (2 d^2 m)."""
    return d ** 3 / 3 + 2 * d * d * m


def als_iteration_ops(n: int, r: int) -> float:
    """One ALS iteration at side n and rank r: the X step (4 an entry), two
    ridge solves (the symmetric r x r Gram matrix, the r x n right-hand
    side, the SPD solve with n right-hand sides), the A B^T product, and
    the projection and residual pass (15 an entry)."""
    ridge = r * (r + 1) * n + 2 * r * n * n + spd_solve_ops(r, n)
    return 4 * n * n + 2 * ridge + 2 * n * n * r + 15 * n * n


def als_ops(n: int, r: int, iters: int) -> float:
    """A problem's operations over `iters` iterations, with the closing
    symmetrisation and binarisation (4 an entry)."""
    return float(iters * als_iteration_ops(n, r) + 4 * n * n)


def als_bytes(n: int, r: int, problems: int) -> float:
    """Each problem's W (f32) read and x_bin written once, its iteration
    count written, the shared same-group mask and initial factor read once."""
    return float(problems * (n * n * 4 + n * n + 4) + n * n + n * r * 4)


def least_seconds(ops: float, n_bytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, n_bytes / PEAK_HBM_BYTES_S)


def als_roofline_pct(iters: float, launches: int, device_s: float, n: int, r: int,
                     problems: int) -> float:
    """The ALS launches' share of their roofline, %: `launches` launches of
    `problems` problems each at (n, r), `iters` iterations in all over the
    problems, `device_s` device seconds in all."""
    ops = iters * als_iteration_ops(n, r) + launches * problems * 4 * n * n
    return 100.0 * least_seconds(ops, launches * als_bytes(n, r, problems)) / device_s
