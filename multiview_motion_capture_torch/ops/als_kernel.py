"""The ALS association solves: CUDA kernel wrappers and their plain versions.

Port of `multiview_motion_capture_tpu/ops/als_pallas.py:match_als_pallas`
and `match_als_pallas_batched` (the fused TPU kernels `_als_kernel` and
`_als_kernel_batched`).  Both take unpadded matrices and the same-group
mask:

- `match_als(W (N, N), ...)`: a CUDA tensor launches `csrc/als.cu` with
  one problem (one thread-block cluster runs the whole ADMM loop and its
  stop test on the device), counted in `cuda_lib.ALS.launches`;
- `match_als_batched(W (C, N, N), ...)`: C problems of one layout (the
  camera clusters of a wide rig); a CUDA tensor launches `csrc/als.cu` once
  for all C (one thread-block cluster per problem, each stopping at its own
  test), counted in `cuda_lib.ALS_BATCHED.launches`;
- a CPU tensor takes the plain torch version, `association.match_als`
  (once per problem for the batch).

With `return_x=True` the kernel also writes the symmetrized continuous X
(the TPU kernels' `x_out`), as the plain version always returns it; by
default it writes none (the tracker's launches pass a null X pointer).

The launch shape depends on (N, rank) alone (`launch_shape`): one block
per problem while its state fits one SM's shared memory, else a cluster of
16 blocks.  Each wrapper raises on anything its kernel does not take,
rank above `MAX_RANK` included; there is no fallback between kernel and
plain version, and none between launch shapes.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from multiview_motion_capture_torch.ops import association
from multiview_motion_capture_torch.ops.association import AlsResult
from multiview_motion_capture_torch.ops.cuda_lib import ALS, ALS_BATCHED, CudaKernel

# Largest matrix side the kernel takes: the JAX context's fused-kernel
# ceiling (als_pallas.MAX_PAD), which covers a 32-cam x 10-people rig at
# N = 336.
MAX_N = 384
# Largest rank: the ridge solves give each lane of a warp one column of the
# rank x rank block.  Every preset stays within it (2 x 16 track slots).
MAX_RANK = 32


class LaunchShape(NamedTuple):
    cluster: int              # thread blocks per problem (1 or 16)
    threads: int              # threads per block
    smem_bytes: int           # dynamic shared memory per block
    max_active_clusters: int  # clusters of this shape the card holds at once


def launch_shape(n: int, rank: int, device=None) -> LaunchShape:
    """How `csrc/als.cu` launches one (n, rank) problem on `device` (the
    current card by default).  Raises if the card cannot hold even one such
    cluster."""
    return _launch_shape(n, rank, torch.cuda._utils._get_device_index(device, optional=True))


@lru_cache(maxsize=None)
def _launch_shape(n: int, rank: int, index: int) -> LaunchShape:
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        err = ALS.lib().als_launch_shape(n, rank, out)
    if err != 0:
        raise RuntimeError(f"als_launch_shape(n={n}, rank={rank}) failed: cudaError {err}")
    shape = LaunchShape(*out)
    if shape.max_active_clusters < 1:
        raise RuntimeError(f"the card holds no cluster of {shape.cluster} blocks with "
                           f"{shape.smem_bytes} B of shared memory each (n={n}, rank={rank})")
    return shape


def match_als(W: torch.Tensor, diag_mask: torch.Tensor, init_A: torch.Tensor,
              alpha: float = 50.0, beta: float = 0.1, mu0: float = 64.0,
              tol: float = 1e-4, max_iter: int = 1000,
              stable_iters: int = 0, return_x: bool = False) -> AlsResult:
    """ALS multi-way matching (same arguments and result as
    `association.match_als`).  The kernel writes `x`, the symmetrized
    continuous X, only with `return_x=True`; else `x` is None."""
    if W.device.type == "cpu":
        res = association.match_als(W, diag_mask, init_A, alpha=alpha, beta=beta,
                                    mu0=mu0, tol=tol, max_iter=max_iter,
                                    stable_iters=stable_iters)
        return res if return_x else res._replace(x=None)
    if W.device.type != "cuda":
        raise ValueError(f"match_als: unsupported device {W.device}")
    n = W.shape[0]
    if W.shape != (n, n) or W.dtype != torch.float32:
        raise ValueError(f"W must be (N, N) float32, got {tuple(W.shape)} {W.dtype}")
    rank = _check_inputs(W, n, diag_mask, init_A)
    x_bin, iters, x = _launch(ALS, W, diag_mask, init_A, rank, alpha, beta, mu0, tol,
                              max_iter, stable_iters, return_x)
    return AlsResult(x_bin=x_bin[0], n_iters=iters[0], x=None if x is None else x[0])


class AlsBatchResult(NamedTuple):
    x_bin: torch.Tensor    # (C, N, N) bool, each problem's binarized match matrix
    n_iters: torch.Tensor  # (C,) int32, each problem's iteration count
    x: Optional[torch.Tensor] = None  # (C, N, N) f32 symmetrized X (return_x only)


def match_als_batched(W: torch.Tensor, diag_mask: torch.Tensor, init_A: torch.Tensor,
                      alpha: float = 50.0, beta: float = 0.1, mu0: float = 64.0,
                      tol: float = 1e-4, max_iter: int = 1000,
                      stable_iters: int = 0, return_x: bool = False) -> AlsBatchResult:
    """C independent ALS matchings of one layout: W (C, N, N) similarities,
    one (N, N) same-group mask and one (N, rank) initial factor for all.
    Each problem stops at its own test, so problem c's result equals
    `match_als(W[c], ...)`, bit for bit, on either device."""
    if W.dim() != 3 or W.shape[1] != W.shape[2]:
        raise ValueError(f"W must be (C, N, N), got {tuple(W.shape)}")
    kw = dict(alpha=alpha, beta=beta, mu0=mu0, tol=tol, max_iter=max_iter,
              stable_iters=stable_iters)
    if W.device.type == "cpu":
        solos = [association.match_als(W[c], diag_mask, init_A, **kw)
                 for c in range(W.shape[0])]
        return AlsBatchResult(x_bin=torch.stack([s.x_bin for s in solos]),
                              n_iters=torch.stack([s.n_iters for s in solos]),
                              x=torch.stack([s.x for s in solos]) if return_x else None)
    if W.device.type != "cuda":
        raise ValueError(f"match_als_batched: unsupported device {W.device}")
    C, n = W.shape[0], W.shape[1]
    if W.dtype != torch.float32:
        raise ValueError(f"W must be float32, got {W.dtype}")
    if C < 1:
        raise ValueError("match_als_batched needs at least one problem")
    rank = _check_inputs(W, n, diag_mask, init_A)
    x_bin, iters, x = _launch(ALS_BATCHED, W, diag_mask, init_A, rank, alpha, beta, mu0,
                              tol, max_iter, stable_iters, return_x)
    return AlsBatchResult(x_bin=x_bin, n_iters=iters, x=x)


def _launch(kernel: CudaKernel, W: torch.Tensor, diag_mask: torch.Tensor,
            init_A: torch.Tensor, rank: int, alpha: float, beta: float, mu0: float,
            tol: float, max_iter: int, stable_iters: int, return_x: bool):
    """One launch of `csrc/als.cu` for the problems of W ((N, N) is one
    problem, (C, N, N) C of them), counted in `kernel.launches`.  Returns
    x_bin (C, N, N), iters (C,) and, with `return_x`, X (C, N, N) f32
    (else None: the kernel gets a null pointer and writes no X)."""
    n = W.shape[-1]
    C = W.shape[0] if W.dim() == 3 else 1
    launch_shape(n, rank, W.device)   # raises where the card holds no such cluster
    x_bin = torch.empty((C, n, n), dtype=torch.bool, device=W.device)
    iters = torch.empty((C,), dtype=torch.int32, device=W.device)
    x = torch.empty((C, n, n), dtype=torch.float32, device=W.device) if return_x else None
    lib = kernel.lib()
    # the C side sets the kernel's shared-memory and cluster attributes on
    # the current device: make it W's
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.als_solve_f32(
            W.data_ptr(), diag_mask.data_ptr(), init_A.data_ptr(), C, n, rank,
            float(alpha), float(beta), float(mu0), float(tol), int(max_iter),
            int(stable_iters), x_bin.data_ptr(), None if x is None else x.data_ptr(),
            iters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"als_solve_f32 launch failed: cudaError {err}")
    kernel.count_launch()
    return x_bin, iters, x


def _check_inputs(W: torch.Tensor, n: int, diag_mask: torch.Tensor,
                  init_A: torch.Tensor) -> int:
    """Raise on what the ALS kernels do not take; returns the rank."""
    if n > MAX_N:
        raise ValueError(f"association matrix n={n} exceeds the kernel's MAX_N={MAX_N}")
    if diag_mask.shape != (n, n) or diag_mask.dtype != torch.bool:
        raise ValueError("diag_mask must be (N, N) bool")
    if init_A.dim() != 2 or init_A.shape[0] != n or init_A.dtype != torch.float32:
        raise ValueError("init_A must be (N, rank) float32")
    rank = init_A.shape[1]
    if not 0 < rank <= n:
        raise ValueError(f"rank={rank} must be in [1, N={n}]")
    if rank > MAX_RANK:
        raise ValueError(f"rank={rank} exceeds the kernel's MAX_RANK={MAX_RANK} (its ridge "
                         f"solves hold one column of the rank x rank block per warp lane)")
    for name, t in (("W", W), ("diag_mask", diag_mask), ("init_A", init_A)):
        if t.device != W.device:
            raise ValueError(f"{name} is on {t.device}, W on {W.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return rank
