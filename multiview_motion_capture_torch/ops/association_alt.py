"""Alternate multi-way matching solvers (the reference's commented-out
options at ref:src/motion_capture.py:757-760): SVT, spectral and binary-LP.

Port of `multiview_motion_capture_tpu/ops/association_alt.py`.
`association.match_als` (the ALS kernel, `als_kernel.match_als`) is the
tracker's solver; these serve the same interface for experiments:

- `match_svt`: singular-value-thresholding ADMM with the doubly-stochastic
  projection (ref:src/mv_association.py:321-411 + `myproj2dpam` :15-61),
  tensor code on the device of its input (the JAX package's is XLA code,
  no Pallas kernel).  Its SVD is `torch.linalg.svd` (cuSOLVER on the card,
  LAPACK on the CPU, each rounding its own way) and its loop a host loop
  of at most `max_iter` iterations that reads the stop test each
  iteration.
- `match_eig_np`: spectral rounding (ref:src/mv_association.py:187-219),
  numpy with the port's Hungarian (`utils.hungarian`).
- `match_bip`: the reference's binary-LP matcher
  (ref:src/mv_association.py:124-176), whose transitivity constraints are
  commented out (:156-157), so its exact optimum is x_ij = [c_ij > 0.5]:
  closed form.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multiview_motion_capture_torch.utils.hungarian import hungarian
from multiview_motion_capture_torch.utils.precision import high_precision

Tensor = torch.Tensor


def _project_rows_to_pav(X: Tensor) -> Tensor:
    """Row-wise projection of the doubly-stochastic step
    (ref:src/mv_association.py:49-61): negatives clipped; rows with mass
    >= 1 projected onto the probability simplex."""
    y = X.clamp(min=0.0)
    n = y.shape[-1]
    u = torch.sort(y, dim=-1, descending=True).values
    sv = torch.cumsum(u, dim=-1)
    k = torch.arange(1, n + 1, dtype=X.dtype, device=X.device)
    cond = u > (sv - 1.0) / k
    rho = cond.sum(dim=-1) - 1                     # last index where cond holds
    sv_rho = torch.gather(sv, -1, rho.clamp(min=0)[..., None])[..., 0]
    theta = ((sv_rho - 1.0) / (rho + 1.0).to(X.dtype)).clamp(min=0.0)
    proj = (y - theta[..., None]).clamp(min=0.0)
    needs = y.sum(dim=-1, keepdim=True) >= 1.0
    return torch.where(needs, proj, y)


def doubly_stochastic_projection(X: Tensor, n_iters: int = 10) -> Tensor:
    """Alternating row/column simplex projections with Dykstra-style
    increments (ref:src/mv_association.py:15-61), a fixed iteration count."""
    I2 = torch.zeros_like(X)
    for _ in range(n_iters):
        X1 = _project_rows_to_pav(X + I2)
        I1 = X1 - (X + I2)
        X2 = _project_rows_to_pav((X + I1).T).T
        I2 = X2 - (X + I1)
        X = X2
    return X


def match_svt(S: Tensor, diag_mask: Tensor, group_sizes: Tuple[int, ...] = (),
              alpha: float = 0.1, lam: float = 50.0, mu0: float = 64.0,
              tol: float = 5e-4, max_iter: int = 20,
              dual_stochastic: bool = True) -> Tuple[Tensor, Tensor]:
    """Singular-value-thresholding ADMM multi-way matcher
    (ref:src/mv_association.py:321-411) on the device of `S`.  Returns
    (x_bin (N, N) bool, n_iters () int32).

    The doubly-stochastic projection is applied per camera-pair block (a
    person may appear once per view, so whole-matrix row sums legitimately
    exceed 1; ref:mv_association.py:372-380); `group_sizes` gives the
    blocks."""
    high_precision()
    n = S.shape[0]
    dev, dt = S.device, S.dtype
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    offs = np.cumsum((0,) + tuple(group_sizes)).tolist()
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    def project_blocks(X: Tensor) -> Tensor:
        X = X.clone()
        for i in range(len(group_sizes)):
            for j in range(len(group_sizes)):
                if offs[i + 1] > offs[i] and offs[j + 1] > offs[j]:
                    si, sj = slice(offs[i], offs[i + 1]), slice(offs[j], offs[j + 1])
                    X[si, sj] = doubly_stochastic_projection(X[si, sj])
        return X

    S = torch.where(eye, zero, S)
    S = 0.5 * (S + S.T)
    W = alpha - S
    X, Y = S, torch.zeros_like(S)
    mu = torch.full((), mu0, dtype=dt, device=dev)
    it = 0
    while it < max_iter:
        X0 = X
        U, s, Vt = torch.linalg.svd(Y / mu + X, full_matrices=False)
        s = (s - lam / mu).clamp(min=0.0)
        Q = (U * s[None, :]) @ Vt
        X = Q - (W + Y) / mu
        X = torch.where(diag_mask, zero, X)
        X = torch.where(eye, one, X)
        X = X.clamp(0.0, 1.0)
        if dual_stochastic and group_sizes:
            X = project_blocks(X)
        X = 0.5 * (X + X.T)
        Y = Y + mu * (X - Q)
        p_res = torch.linalg.norm(X - Q) / n
        d_res = mu * torch.linalg.norm(X - X0) / n
        done = bool((p_res < tol) & (d_res < tol))
        mu = torch.where(p_res > 10 * d_res, 2 * mu,
                         torch.where(d_res > 10 * p_res, mu / 2, mu))
        it += 1
        if done:
            break
    X = 0.5 * (X + X.T)
    return X > 0.5, torch.tensor(it, dtype=torch.int32, device=dev)


def match_eig_np(S: np.ndarray, group_sizes) -> np.ndarray:
    """Spectral multi-way matching (ref:src/mv_association.py:187-219):
    per-block Hungarian binarization, top-d eigen-embedding, per-block
    Hungarian rounding.  Host numpy (tiny matrices; the eigenvectors of a
    non-symmetric matrix)."""
    offs = np.cumsum([0] + list(group_sizes))
    n_groups = len(group_sizes)
    d = max(group_sizes)

    def biparti(block):
        rows, cols = hungarian(-block)
        P = np.zeros_like(block)
        P[rows, cols] = 1
        return P

    Z = np.zeros_like(S)
    for i in range(n_groups):
        for j in range(n_groups):
            bi, bj = slice(offs[i], offs[i + 1]), slice(offs[j], offs[j + 1])
            if offs[i + 1] > offs[i] and offs[j + 1] > offs[j]:
                Z[bi, bj] = biparti(S[bi, bj])

    vals, vecs = np.linalg.eig(Z)
    order = np.argsort(-vals.real)
    vals, vecs = vals[order[:d]], vecs[:, order[:d]]
    U = (vecs * np.sqrt(np.maximum(vals.real, 0.0))).real

    out = np.zeros_like(S)
    for i in range(n_groups):
        for j in range(n_groups):
            if i == j:
                continue
            bi, bj = slice(offs[i], offs[i + 1]), slice(offs[j], offs[j + 1])
            if offs[i + 1] > offs[i] and offs[j + 1] > offs[j]:
                blk = U[bi] @ U[bj].T
                blk[blk < 0] = 0
                out[bi, bj] = biparti(blk)
    return out > 0.5


def match_bip(cor_mat: np.ndarray, min_cor: float = 0.2) -> np.ndarray:
    """The reference's LP maximizes sum_ij 2 (c_ij - 0.5) x_ij over binary x
    with no active constraint (ref:src/mv_association.py:156-157), so the
    exact optimum is x_ij = [c_ij > 0.5] on the candidate edges c_ij >
    min_cor."""
    c = np.asarray(cor_mat, dtype=np.float64).copy()
    np.fill_diagonal(c, 0.0)
    x = c > max(min_cor, 0.5)
    return np.triu(x, 1) | np.triu(x, 1).T
