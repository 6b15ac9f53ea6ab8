"""The port's batched Gauss-Jordan solve (plain version of the CUDA kernel)
against the JAX package's `batched_spd_solve` Pallas kernel in interpret
mode, on damped SPD systems shaped like the LM normal equations."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.ops import cuda_lib
from multiview_motion_capture_torch.ops import solve_kernel
from multiview_motion_capture_tpu.ops import solve_pallas
from tests.torch_study_scene import one_thread

# both sides run the same no-pivot elimination in f32, in other orders of
# rounding; systems with a condition number ~1e3 keep the relative error of
# x near cond * D * eps32 ~ 1e-2 at worst, and it is ~1e-5 in practice
REL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _lm_systems(seed, T=8, R=96, D=68):
    """(J^T J + (lam + ridge) I, J^T r) with a few frozen, all-zero columns,
    as ik._lm_solve_batched builds them."""
    rng = np.random.RandomState(seed)
    J = rng.randn(T, R, D).astype(np.float32)
    J[:, :, -5:] = 0.0                       # leaf joints: zero jacobian columns
    r = rng.randn(T, R).astype(np.float32)
    JtJ = np.einsum("trd,tre->tde", J, J)
    ridge = 1e-6 * np.trace(JtJ, axis1=1, axis2=2) / D + 1e-6
    lam = rng.uniform(1e-3, 1.0, size=T).astype(np.float32)
    A = JtJ + (lam + ridge)[:, None, None] * np.eye(D, dtype=np.float32)
    g = np.einsum("trd,tr->td", J, r)
    return A.astype(np.float32), g.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_gauss_jordan_matches_pallas(seed):
    A, g = _lm_systems(seed)
    x_jax = np.asarray(solve_pallas.batched_spd_solve(jnp.asarray(A), jnp.asarray(g),
                                                      interpret=True))
    x = solve_kernel.batched_spd_solve(torch.as_tensor(A), torch.as_tensor(g)).numpy()
    assert x.shape == (8, 68)
    rel = np.abs(x - x_jax).max() / np.abs(x_jax).max()
    assert rel < REL_TOL, rel
    # and it solves the system
    res = np.einsum("tde,te->td", A.astype(np.float64), x) - g
    assert np.abs(res).max() / np.abs(g).max() < REL_TOL


def test_one_program_flag_gives_the_same_result():
    A, g = _lm_systems(2, T=3)
    a = solve_kernel.batched_spd_solve(torch.as_tensor(A), torch.as_tensor(g), one_program=True)
    b = solve_kernel.batched_spd_solve(torch.as_tensor(A), torch.as_tensor(g), one_program=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    j = np.asarray(solve_pallas.batched_spd_solve(jnp.asarray(A), jnp.asarray(g),
                                                  interpret=True, one_program=False))
    assert np.abs(a.numpy() - j).max() / np.abs(j).max() < REL_TOL


def test_wrapper_takes_plain_version_for_cpu_tensors():
    A, g = _lm_systems(3, T=2)
    before = cuda_lib.GJ_SOLVE.launches
    x = solve_kernel.batched_spd_solve(torch.as_tensor(A), torch.as_tensor(g))
    assert cuda_lib.GJ_SOLVE.launches == before
    np.testing.assert_array_equal(
        x.numpy(), solve_kernel.gauss_jordan_plain(torch.as_tensor(A), torch.as_tensor(g)).numpy())


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        solve_kernel.batched_spd_solve(torch.zeros((2, 3, 3), device="meta"),
                                       torch.zeros((2, 3), device="meta"))


def _quotient_pairs(case, rng, n=1 << 20):
    """float32 pairs (a, b) of one kind, as numpy arrays."""
    f32 = np.float32
    if case == "random_bits":                  # every float, subnormals and specials included
        bits = rng.integers(0, 1 << 32, (2, n), dtype=np.uint64).astype(np.uint32)
        return bits[0].view(f32), bits[1].view(f32)
    if case == "lm_magnitudes":                # the LM's entries: 1e-6 .. 1e6 either sign
        a, b = (rng.standard_normal((2, n)) * 10.0 ** rng.integers(-6, 6, (2, n))).astype(f32)
        return a, b
    if case == "subnormal_quotients":          # quotients from 2^-160 to 2^-110
        a = np.ldexp(rng.uniform(1, 2, n), rng.integers(-149, -100, n)).astype(f32)
        b = np.ldexp(rng.uniform(1, 2, n), rng.integers(-10, 40, n)).astype(f32)
        return a * rng.choice([f32(-1), f32(1)], n), b
    if case == "overflowing_quotients":        # quotients from 2^100 to 2^160, around FLT_MAX
        a = np.ldexp(rng.uniform(1, 2, n), rng.integers(90, 128, n)).astype(f32)
        b = np.ldexp(rng.uniform(1, 2, n), rng.integers(-32, 10, n)).astype(f32)
        return a, b * rng.choice([f32(-1), f32(1)], n)
    if case == "near_midpoints":               # a = RN(m b), m halfway between two floats
        q = rng.uniform(1, 2, n).astype(f32)
        m = q.astype(np.float64) + np.ldexp(1.0, -24)            # 25 significant bits
        b = np.ldexp(rng.uniform(1, 2, n), rng.integers(-60, 60, n)).astype(f32)
        return (m * b.astype(np.float64)).astype(f32), b
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -3.0, 1e-45, -1e-45,
                         1.1754944e-38, 3.4028235e38, -3.4028235e38, 0.1, 7.0], f32)
    return np.repeat(specials, len(specials)), np.tile(specials, len(specials))


@pytest.mark.parametrize("case", ["random_bits", "lm_magnitudes", "subnormal_quotients",
                                  "overflowing_quotients", "near_midpoints", "specials"])
def test_reciprocal_product_quotient_is_the_float_division(case):
    """csrc/gj_elim.cuh forms each quotient a / b of the elimination as
    a * RN64(1 / b) in double, rounded once to float (`gj::quotient`), and
    rests its bit-equality with the plain version's float division on that
    being the correctly rounded a / b for every pair of floats.  Here numpy's
    IEEE double and float operations stand for the card's __drcp_rn,
    __dmul_rn, __double2float_rn and __fdiv_rn."""
    a, b = _quotient_pairs(case, np.random.default_rng(7))
    with np.errstate(all="ignore"):
        q = a / b
        via_rcp = (a.astype(np.float64) * (1.0 / b.astype(np.float64))).astype(np.float32)
    same = (q.view(np.uint32) == via_rcp.view(np.uint32)) | (np.isnan(q) & np.isnan(via_rcp))
    bad = np.nonzero(~same)[0][:3]
    assert same.all(), [(a[i], b[i], q[i], via_rcp[i]) for i in bad]
    if case == "subnormal_quotients":
        assert ((np.abs(q) < np.finfo(np.float32).tiny) & (q != 0)).mean() > 0.3
    if case == "overflowing_quotients":
        assert np.isinf(q).mean() > 0.3 and np.isfinite(q).mean() > 0.3
