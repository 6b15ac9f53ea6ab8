"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: they need an NVIDIA GPU with nvcc and skip elsewhere.  On a
machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(`--noconftest`: the suite's conftest configures JAX, which that machine
need not have.)

Every kernel runs the same f32 operations in the same order as its plain
version, so the results must be equal, bit for bit.
"""
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.ops import als_kernel, association, cuda_lib, solve_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU interpreter)")
    cuda_lib.build_all()
    return torch.device("cuda")


@pytest.mark.parametrize("sizes,rank", [((8, 6, 6, 6, 6, 6), 16), ((16,) + (10,) * 32, 32)])
def test_als_kernel_equals_plain(cuda, sizes, rank):
    rng = np.random.RandomState(0)
    n = sum(sizes)
    W = rng.rand(n, n).astype(np.float32) * 0.2
    W = torch.as_tensor(0.5 * (W + W.T), device=cuda)
    mask = torch.as_tensor(association.block_diag_mask(sizes), device=cuda)
    init = torch.as_tensor(association.default_init_factor(n, rank), device=cuda)
    before = (cuda_lib.ALS.launches, cuda_lib.ALS_BATCHED.launches)
    k = als_kernel.match_als(W, mask, init, max_iter=60, stable_iters=10)
    p = association.match_als(W, mask, init, max_iter=60, stable_iters=10)
    assert (cuda_lib.ALS.launches, cuda_lib.ALS_BATCHED.launches) == (before[0] + 1, before[1])
    assert torch.equal(k.x_bin, p.x_bin)
    assert int(k.n_iters) == int(p.n_iters)


@pytest.mark.parametrize("T", [8, 16, 64])
def test_gj_kernel_equals_plain(cuda, T):
    g = torch.Generator().manual_seed(T)
    M = torch.randn(T, 68, 136, generator=g)
    A = (M @ M.transpose(1, 2) / 136 + 1e-3 * torch.eye(68)).to(cuda).contiguous()
    b = torch.randn(T, 68, generator=g).to(cuda)
    before = (cuda_lib.GJ_SOLVE.launches, cuda_lib.GJ_SOLVE_GRID.launches)
    x = solve_kernel.batched_spd_solve(A, b)
    assert (cuda_lib.GJ_SOLVE.launches, cuda_lib.GJ_SOLVE_GRID.launches) == \
           (before[0] + 1, before[1])
    assert torch.equal(x, solve_kernel.gauss_jordan_plain(A, b))


@pytest.mark.parametrize("sizes,rank,max_iter", [((8, 6, 6, 6, 6, 6), 16, 60),
                                                ((16,) + (10,) * 32, 32, 20)])
def test_als_batched_kernel_equals_plain_and_solo(cuda, sizes, rank, max_iter):
    rng = np.random.RandomState(1)
    n, C = sum(sizes), 3
    W = rng.rand(C, n, n).astype(np.float32) * 0.2
    W = torch.as_tensor(0.5 * (W + W.transpose(0, 2, 1)), device=cuda).contiguous()
    mask = torch.as_tensor(association.block_diag_mask(sizes), device=cuda)
    init = torch.as_tensor(association.default_init_factor(n, rank), device=cuda)
    kw = dict(max_iter=max_iter, stable_iters=10)
    before = (cuda_lib.ALS.launches, cuda_lib.ALS_BATCHED.launches)
    k = als_kernel.match_als_batched(W, mask, init, **kw)
    assert (cuda_lib.ALS.launches, cuda_lib.ALS_BATCHED.launches) == (before[0], before[1] + 1)
    for c in range(C):
        p = association.match_als(W[c], mask, init, **kw)
        solo = als_kernel.match_als(W[c], mask, init, **kw)
        assert torch.equal(k.x_bin[c], p.x_bin) and torch.equal(k.x_bin[c], solo.x_bin)
        assert int(k.n_iters[c]) == int(p.n_iters) == int(solo.n_iters)


def test_fused_normal_kernel_equals_plain(cuda):
    rng = np.random.RandomState(2)
    T, R, D = 16, 512, 68
    free = torch.as_tensor((rng.rand(D) > 0.2).astype(np.float32), device=cuda)
    J = torch.as_tensor(rng.randn(T, R, D).astype(np.float32), device=cuda) * free
    r = torch.as_tensor(rng.randn(T, R).astype(np.float32), device=cuda)
    Jaug = torch.cat([J, r[:, :, None]], dim=2).contiguous()
    lam = torch.as_tensor(rng.uniform(1e-3, 1.0, T).astype(np.float32), device=cuda)
    frozen = (1.0 - free).contiguous()
    before = cuda_lib.FUSED_NORMAL_GJ.launches
    x = solve_kernel.fused_normal_solve(Jaug, lam, frozen)
    assert cuda_lib.FUSED_NORMAL_GJ.launches == before + 1
    assert torch.equal(x, solve_kernel.fused_normal_plain(Jaug, lam, frozen))


def test_gj_one_program_false_launch_equals_plain(cuda):
    g = torch.Generator().manual_seed(16)
    M = torch.randn(16, 68, 136, generator=g)
    A = (M @ M.transpose(1, 2) / 136 + 1e-3 * torch.eye(68)).to(cuda).contiguous()
    b = torch.randn(16, 68, generator=g).to(cuda)
    before = (cuda_lib.GJ_SOLVE.launches, cuda_lib.GJ_SOLVE_GRID.launches)
    x = solve_kernel.batched_spd_solve(A, b, one_program=False)
    assert (cuda_lib.GJ_SOLVE.launches, cuda_lib.GJ_SOLVE_GRID.launches) == \
           (before[0], before[1] + 1)
    assert torch.equal(x, solve_kernel.gauss_jordan_plain(A, b))


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        solve_kernel.batched_spd_solve(torch.zeros(2, 4, 4, device=cuda, dtype=torch.float64),
                                       torch.zeros(2, 4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        als_kernel.match_als(torch.zeros(400, 400, device=cuda),
                             torch.zeros(400, 400, dtype=torch.bool, device=cuda),
                             torch.zeros(400, 8, device=cuda))
    with pytest.raises(ValueError):
        als_kernel.match_als_batched(torch.zeros(2, 400, 400, device=cuda),
                                     torch.zeros(400, 400, dtype=torch.bool, device=cuda),
                                     torch.zeros(400, 8, device=cuda))
    with pytest.raises(ValueError):
        solve_kernel.fused_normal_solve(torch.zeros(2, 8, 100, device=cuda),
                                        torch.zeros(2, device=cuda), torch.zeros(99, device=cuda))
