"""Batched solves of the LM normal equations: CUDA kernel wrappers and
their plain versions.

Port of `multiview_motion_capture_tpu/ops/solve_pallas.py` (TPU kernels
`_gj_kernel_3d`, `_gj_kernel` and `_fused_normal_gj_kernel`):

- `batched_spd_solve(A, g)` solves A[t] x[t] = g[t] for T SPD systems.  A
  CUDA tensor launches `csrc/gj_solve.cu` (one block of 256 threads per
  system, the augmented block in registers, one barrier per pivot); a CPU
  tensor takes `gauss_jordan_plain`, the same no-pivot Gauss-Jordan in
  torch ops, step for step as the TPU kernel.  `one_program` selects
  between the TPU kernel's two launch shapes; on Hopper both are the same
  launch (one block per system), counted apart:
  `cuda_lib.GJ_SOLVE.launches` for `one_program=True`,
  `cuda_lib.GJ_SOLVE_GRID.launches` for False.
- `fused_normal_solve(Jaug, lam, frozen_diag)` forms each slot's damped
  normal equations from [J | r] and solves them.  A CUDA tensor launches
  `csrc/fused_normal_gj.cu` (one cluster of 4 blocks per slot: the
  symmetric J^T [J | r] in register tiles, gathered in the leader block's
  shared memory, then gj_solve.cu's elimination), counted in
  `cuda_lib.FUSED_NORMAL_GJ.launches`; a CPU tensor takes
  `fused_normal_plain`.

Every wrapper raises on anything its kernel does not take; there is no
fallback from a CUDA tensor to a plain version.  `gj_launch_shape` and
`fused_launch_shape` say how a side D launches on a card.  Each launch runs
under `torch.cuda.device(tensor.device)`: the C side's attributes and
queries act on the current device.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from multiview_motion_capture_torch.ops.cuda_lib import (
    FUSED_NORMAL_GJ,
    GJ_SOLVE,
    GJ_SOLVE_GRID,
)

# the augmented block lives in the registers of one 256-thread block: a
# thread holds a 12 x 12 tile at most (`gj_max_d` in the source)
MAX_D = 191
# the fused kernel: its Gram tiles fill at most 256 threads of each of the
# cluster's 4 blocks (`fused_normal_max_d` in the source)
FUSED_MAX_D = 90


class GjLaunchShape(NamedTuple):
    threads: int              # threads per block
    blocks_per_system: int
    smem_bytes: int           # shared memory per block
    registers: int            # per thread, as ptxas assigned them
    local_bytes: int          # per thread: spills (0 when none)


class FusedLaunchShape(NamedTuple):
    cluster: int              # thread blocks per slot
    threads: int              # threads per block
    smem_bytes: int           # dynamic shared memory per block
    registers: int            # per thread, as ptxas assigned them
    local_bytes: int          # per thread: spills (0 when none)
    max_active_clusters: int  # clusters of this shape the card holds at once


def gj_launch_shape(D: int, device=None) -> GjLaunchShape:
    """How `csrc/gj_solve.cu` launches side D on `device` (the current card
    by default)."""
    return _gj_launch_shape(D, torch.cuda._utils._get_device_index(device, optional=True))


@lru_cache(maxsize=None)
def _gj_launch_shape(D: int, index: int) -> GjLaunchShape:
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(index):
        err = GJ_SOLVE.lib().gj_launch_shape(D, out)
    if err != 0:
        raise RuntimeError(f"gj_launch_shape(D={D}) failed: cudaError {err}")
    return GjLaunchShape(*out)


def fused_launch_shape(D: int, device=None) -> FusedLaunchShape:
    """How `csrc/fused_normal_gj.cu` launches side D on `device` (the
    current card by default).  Raises if the card cannot hold even one such
    cluster."""
    return _fused_launch_shape(D, torch.cuda._utils._get_device_index(device, optional=True))


@lru_cache(maxsize=None)
def _fused_launch_shape(D: int, index: int) -> FusedLaunchShape:
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(index):
        err = FUSED_NORMAL_GJ.lib().fused_launch_shape(D, out)
    if err != 0:
        raise RuntimeError(f"fused_launch_shape(D={D}) failed: cudaError {err}")
    shape = FusedLaunchShape(*out)
    if shape.max_active_clusters < 1:
        raise RuntimeError(f"the card holds no cluster of {shape.cluster} blocks of the "
                           f"fused kernel at D={D}")
    return shape


def gauss_jordan_plain(A: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """No-pivot Gauss-Jordan on [A | g] in torch ops: (T, D, D), (T, D) ->
    (T, D).  Rounds as the kernel does (a product, then a difference)."""
    T, D = g.shape
    aug = torch.cat([A, g[:, :, None]], dim=2)               # (T, D, D+1)
    row_ids = torch.arange(D, device=A.device)[None, :, None]
    for k in range(D):
        pivot_row = aug[:, k, :] / aug[:, k, k:k + 1]        # (T, D+1)
        col = aug[:, :, k:k + 1]                             # (T, D, 1)
        elim = aug - col * pivot_row[:, None, :]
        aug = torch.where(row_ids == k, pivot_row[:, None, :], elim)
    return aug[:, :, D]


def fused_normal_plain(Jaug: torch.Tensor, lam: torch.Tensor,
                       frozen_diag: torch.Tensor) -> torch.Tensor:
    """The fused kernel's function in torch ops: (T, R, D+1), (T,), (D,) ->
    (T, D).  G = Jaug^T Jaug (first D rows) summed over the R rows in index
    order, one rounding per product and per sum; tr summed over the diagonal
    in index order; then + (lam + ridge) I + diag(frozen_diag) and
    `gauss_jordan_plain`: the kernel's operations in the kernel's order."""
    T, R, D1 = Jaug.shape
    D = D1 - 1
    Jd = Jaug[:, :, :D]
    G = Jd[:, 0, :, None] * Jaug[:, 0, None, :]               # (T, D, D+1)
    for r in range(1, R):
        G = G + Jd[:, r, :, None] * Jaug[:, r, None, :]
    diag = torch.diagonal(G[:, :, :D], dim1=1, dim2=2)      # (T, D)
    tr = diag[:, 0]
    for i in range(1, D):
        tr = tr + diag[:, i]
    # a 0-dim tensor on the device, not a Python number: PyTorch's CUDA
    # division by a host scalar multiplies by its reciprocal, the kernel divides
    d_t = torch.full((), float(D), dtype=Jaug.dtype, device=Jaug.device)
    ridge = 1e-6 * (tr / d_t) + 1e-6
    idx = torch.arange(D, device=Jaug.device)
    A = G[:, :, :D].clone()
    A[:, idx, idx] = (A[:, idx, idx] + (lam + ridge)[:, None]) + frozen_diag[None]
    return gauss_jordan_plain(A, G[:, :, D])


def fused_normal_solve(Jaug: torch.Tensor, lam: torch.Tensor,
                       frozen_diag: torch.Tensor) -> torch.Tensor:
    """Solve (J^T J + (lam + ridge) I + diag(frozen_diag)) x = J^T r for every
    slot, with ridge = 1e-6 * trace(J^T J) / D + 1e-6, reading Jaug = [J | r]
    (T, R, D+1) once.  lam: (T,); frozen_diag: (D,), 1.0 on frozen
    parameters.  Returns x (T, D); the caller applies dx = -x * free_mask."""
    if Jaug.device.type == "cpu":
        return fused_normal_plain(Jaug, lam, frozen_diag)
    if Jaug.device.type != "cuda":
        raise ValueError(f"fused_normal_solve: unsupported device {Jaug.device}")
    if Jaug.dim() != 3:
        raise ValueError(f"Jaug must be (T, R, D+1), got {tuple(Jaug.shape)}")
    T, R, D1 = Jaug.shape
    D = D1 - 1
    if not 0 < D <= FUSED_MAX_D or R < 1:
        raise ValueError(f"Jaug {tuple(Jaug.shape)}: need R >= 1 and 1 <= D <= {FUSED_MAX_D}")
    if lam.shape != (T,) or frozen_diag.shape != (D,):
        raise ValueError(f"lam must be ({T},) and frozen_diag ({D},), got "
                         f"{tuple(lam.shape)} and {tuple(frozen_diag.shape)}")
    for name, t in (("Jaug", Jaug), ("lam", lam), ("frozen_diag", frozen_diag)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != Jaug.device:
            raise ValueError(f"{name} is on {t.device}, Jaug on {Jaug.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    x = torch.empty((T, D), dtype=torch.float32, device=Jaug.device)
    if T == 0:
        return x
    lib = FUSED_NORMAL_GJ.lib()
    # the C side sets the kernel's shared-memory size on the current device
    with torch.cuda.device(Jaug.device):
        stream = torch.cuda.current_stream(Jaug.device).cuda_stream
        err = lib.fused_normal_gj_f32(Jaug.data_ptr(), lam.data_ptr(),
                                      frozen_diag.data_ptr(), x.data_ptr(), T, R, D, stream)
    if err != 0:
        raise RuntimeError(f"fused_normal_gj_f32 launch failed: cudaError {err}")
    FUSED_NORMAL_GJ.count_launch()
    return x


def batched_spd_solve(A: torch.Tensor, g: torch.Tensor,
                      one_program: bool = True) -> torch.Tensor:
    """Solve A[t] x[t] = g[t] for SPD A: (T, D, D), (T, D) -> (T, D)."""
    if A.device.type == "cpu":
        return gauss_jordan_plain(A, g)
    if A.device.type != "cuda":
        raise ValueError(f"batched_spd_solve: unsupported device {A.device}")
    if A.dim() != 3 or g.dim() != 2:
        raise ValueError("A must be (T, D, D) and g (T, D)")
    T, D = g.shape
    if A.shape != (T, D, D):
        raise ValueError(f"A {tuple(A.shape)} does not match g {tuple(g.shape)}")
    if not 0 < D <= MAX_D:
        raise ValueError(f"D={D}: the kernel takes 1 <= D <= MAX_D={MAX_D}")
    for name, t in (("A", A), ("g", g)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    x = torch.empty((T, D), dtype=torch.float32, device=A.device)
    if T == 0:
        return x
    kernel = GJ_SOLVE if one_program else GJ_SOLVE_GRID
    lib = kernel.lib()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.gj_solve_f32(A.data_ptr(), g.data_ptr(), x.data_ptr(), T, D, stream)
    if err != 0:
        raise RuntimeError(f"gj_solve_f32 launch failed: cudaError {err}")
    kernel.count_launch()
    return x
