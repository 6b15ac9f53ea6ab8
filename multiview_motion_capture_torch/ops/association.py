"""Multi-way matching on tensors: the plain ALS solve, transitive closure
and group extraction.

Port of `multiview_motion_capture_tpu/ops/association.py`:

- `match_als` (ref:src/mv_association.py:222-318) is the plain torch
  version of the ALS kernel (`ops/als_kernel.py`, `csrc/als.cu`): the
  ADMM/ALS loop with Gauss-Jordan ridge solves and the stable-binarization
  early exit, step for step as the JAX `match_als`, in the kernel's order of
  f32 operations.  It serves CPU tensors and is what the kernel is held
  against on the card.
- `transitive_closure` squares the boolean relation log2(N) times.
- `extract_groups`: each element's group representative is the lowest-index
  member of its equivalence class; an element participates only when its
  group has >= 2 members.
- `associate_frame`: one frame's cross-view association on its own
  (spatial affinity -> ALS -> groups), on the card unless asked otherwise.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def block_diag_mask(group_sizes: Tuple[int, ...]) -> np.ndarray:
    """(N, N) bool mask which is True inside each group's diagonal block
    (one group per camera, plus one for tracklets in the spatial-time
    matrix; ref:src/mv_association.py:284-286)."""
    n = int(sum(group_sizes))
    mask = np.zeros((n, n), dtype=bool)
    off = 0
    for g in group_sizes:
        mask[off:off + g, off:off + g] = True
        off += g
    return mask


def default_init_factor(n: int, rank: int) -> np.ndarray:
    """Seeded uniform init: numpy RandomState(0).rand, the reference's own
    init (ref:src/mv_association.py:271).  A torch generator would give other
    numbers and other groupings."""
    return np.random.RandomState(0).rand(n, rank).astype(np.float32)


class AlsResult(NamedTuple):
    x_bin: Tensor             # (N, N) bool, symmetric binarized match matrix
    n_iters: Tensor           # () int32, iterations until convergence (or max)
    x: Optional[Tensor] = None  # symmetrized continuous X (plain version only)


def _ordered_matmul(L: Tensor, R: Tensor) -> Tensor:
    """L (m, k) @ R (k, p), summed over k in index order with one rounding
    per product and one per sum (no fused multiply-add): the ALS kernel's
    order of operations, so both give the same f32 result bit for bit."""
    prods = L.T[:, :, None] * R[:, None, :]           # (k, m, p), each rounded
    s = prods[0]
    for k in range(1, prods.shape[0]):
        s = s + prods[k]
    return s


def _ridge_gauss_jordan(aug: Tensor, lam: float) -> Tensor:
    """Solve (G + lam I) S = R for the (r, r + m) block aug = [G | R] by
    no-pivot Gauss-Jordan (G + lam I is SPD), as the kernel does.  Returns S
    (r, m)."""
    r = aug.shape[0]
    idx = torch.arange(r, device=aug.device)
    aug = aug.clone()
    aug[idx, idx] = aug[idx, idx] + lam
    for k in range(r):
        prow = aug[k] / aug[k, k]
        aug = aug - aug[:, k:k + 1] * prow[None, :]
        aug[k] = prow
    return aug[:, r:]


def match_als(W: Tensor, diag_mask: Tensor, init_A: Tensor,
              alpha: float = 50.0, beta: float = 0.1, mu0: float = 64.0,
              tol: float = 1e-4, max_iter: int = 1000,
              stable_iters: int = 0) -> AlsResult:
    """ALS low-rank multi-way matching, the plain version.

    W: (N, N) similarity (symmetrized here), float32 (float64 runs the same
    steps in f64, for studies); diag_mask: (N, N) bool, True inside
    same-group blocks; init_A: (N, rank) initial factor.
    `stable_iters` > 0 also stops once `X > 0.5` has been unchanged for that
    many consecutive iterations (0 = the reference's residual-only test).

    The iteration need not converge within `max_iter` (the reference's
    schedule often cycles), and where it does not, its result depends on
    every rounding.  So this version fixes the order of every f32 operation
    to the kernel's (`_ordered_matmul`, `_ridge_gauss_jordan`, the residual
    sums in f64), and the kernel and this version return the same x_bin and
    iteration count on the same inputs, on the CPU and on the card.  The
    ridge solves are the TPU kernel's Gauss-Jordan where the JAX `match_als`
    uses Cholesky: the same function.  The loop reads its residuals on the
    host once per iteration.
    """
    n = W.shape[0]
    dt, dev = (torch.float64 if W.dtype == torch.float64 else torch.float32), W.device
    f = np.float64 if dt == torch.float64 else np.float32   # scalars, rounded as dt
    eye_n = torch.eye(n, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    beta_r, tol_r = float(f(beta)), float(f(tol))

    W = W.to(dt)
    W = 0.5 * (W + W.T)
    X, Z, Y = W, W, torch.zeros_like(W)
    At = init_A.to(dt).T.contiguous()                 # A^T (rank, N)
    mu = float(f(mu0))
    stable = 0
    it = 0
    while it < max_iter:
        X0 = X
        # a 0-dim device tensor, not a Python float: PyTorch's CUDA division
        # by a host scalar multiplies by its reciprocal, the kernel divides
        mu_t = torch.full((), mu, dtype=dt, device=dev)
        lam = float(f(alpha) / f(mu))
        Xs = Z - (Y - W + beta_r) / mu_t
        Bt = _ridge_gauss_jordan(_ordered_matmul(At, torch.cat([At.T, Xs], 1)), lam)
        At = _ridge_gauss_jordan(_ordered_matmul(Bt, torch.cat([Bt.T, Xs.T], 1)), lam)
        X = _ordered_matmul(At.T, Bt)
        Zc = X + Y / mu_t
        Zc = torch.where(diag_mask, zero, Zc)     # no self-group matches
        Zc = torch.where(eye_n, one, Zc)          # pSelect == 1: diagonal on
        Z = Zc.clamp(0.0, 1.0)
        dz = X - Z
        Y = Y + mu * dz
        dx = X - X0
        sums = torch.stack([(dz * dz).double().sum(), (dx * dx).double().sum(),
                            ((X > 0.5) != (X0 > 0.5)).sum().double()])
        p_sq, d_sq, flips = sums.tolist()
        p_res = math.sqrt(p_sq) / n
        d_res = mu * math.sqrt(d_sq) / n
        done = p_res < tol_r and d_res < tol_r
        stable = stable + 1 if flips == 0 else 0
        if stable_iters > 0 and stable >= stable_iters:
            done = True
        mu = 2 * mu if p_res > 10 * d_res else (mu / 2 if d_res > 10 * p_res else mu)
        it += 1
        if done:
            break

    X = 0.5 * (X + X.T)
    return AlsResult(x_bin=X > 0.5,
                     n_iters=torch.tensor(it, dtype=torch.int32, device=dev), x=X)


def transitive_closure(x_bin: Tensor) -> Tensor:
    """Reflexive-transitive closure of a boolean relation by repeated boolean
    matrix squaring (exact in f32: entries are small integer counts)."""
    n = x_bin.shape[0]
    reach = x_bin | torch.eye(n, dtype=torch.bool, device=x_bin.device)
    n_steps = max(1, int(math.ceil(math.log2(max(n, 2)))))
    for _ in range(n_steps):
        f = reach.to(torch.float32)
        reach = (f @ f) > 0.5
    return reach


class MatchGroups(NamedTuple):
    rep: Tensor          # (N,) int32 — lowest-index member of each element's group
    group_size: Tensor   # (N,) int32 — size of the group containing each element
    member: Tensor       # (N,) bool  — element belongs to a group of size >= 2


def extract_groups(x_bin: Tensor, elem_valid: Tensor) -> MatchGroups:
    """Equivalence classes of a binarized match matrix (semantics of
    ref:src/mv_association.py:112-121 + ref:src/motion_capture.py:417-425).
    `elem_valid` masks padded slots: their rows/columns are ignored and they
    are never members."""
    valid2 = elem_valid[:, None] & elem_valid[None, :]
    closure = transitive_closure(x_bin & valid2) & valid2
    n = x_bin.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=x_bin.device)
    big = torch.full((), n, dtype=torch.int32, device=x_bin.device)
    cand = torch.where(closure, idx[:, None], big)
    rep = cand.min(dim=0).values
    rep = torch.where(elem_valid, rep, big)
    group_size = closure.sum(dim=0).to(torch.int32)
    member = elem_valid & (group_size >= 2)
    return MatchGroups(rep=rep, group_size=group_size, member=member)


def associate_frame(kps, valid, cams, cfg=None, device="cuda"):
    """Standalone single-frame cross-view association (the reference's
    `match_multiview_poses`, ref:src/mv_association.py:414-457): spatial
    epipolar affinity -> ALS (`als_kernel.match_als`: the ALS kernel on the
    card, its plain version for `device="cpu"`) -> groups of (view,
    detection) pairs.

    kps: (V, P, K, 3) numpy or tensor; valid: (V, P) bool; cams: a
    `cameras.CameraBank`.  The similarity is formed in `WORK_DTYPE` and
    rounded once to f32, as the tracker's.  Returns List[List[(view, det)]]
    for the groups with >= 2 members, ordered by their leader."""
    from multiview_motion_capture_torch.cameras import pairwise_fundamental_np
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.ops import als_kernel
    from multiview_motion_capture_torch.ops.geometry import projected_distance_all_pairs
    from multiview_motion_capture_torch.utils.precision import (
        WORK_DTYPE,
        high_precision,
        resolve_device,
    )

    dev = resolve_device(device)
    high_precision()
    V, P = kps.shape[0], kps.shape[1]
    cfg = cfg or PipelineConfig(n_views=V, max_people=P)
    F = pairwise_fundamental_np(np.asarray(cams.K.cpu(), dtype=np.float64),
                                np.asarray(cams.Rt.cpu(), dtype=np.float64))
    # F reaches the distances as the f32 constant the JAX package uses
    F = torch.as_tensor(F.astype(np.float32), device=dev).to(WORK_DTYPE)
    kps_w = torch.as_tensor(kps, dtype=torch.float32, device=dev).to(WORK_DTYPE)
    d = projected_distance_all_pairs(kps_w, F)                   # (V, P, V, P)
    same_view = torch.eye(V, dtype=torch.bool, device=dev)[:, None, :, None]
    d = torch.where(same_view, torch.full_like(d, cfg.spatial_fill_distance), d)
    dst = d.reshape(V * P, V * P)
    eye = torch.eye(V * P, dtype=torch.bool, device=dev)
    zero = torch.zeros_like(dst)
    dst = torch.where(eye, zero, dst)
    dv = torch.as_tensor(valid, dtype=torch.bool, device=dev).reshape(-1)
    both = dv[:, None] & dv[None, :]
    cnt = both.sum().clamp(min=1)
    mean = torch.where(both, dst, zero).sum() / cnt
    var = torch.where(both, (dst - mean) ** 2, zero).sum() / cnt
    sim = torch.where(both, torch.sigmoid(-cfg.affinity_sigmoid_scale * (dst - mean)
                                          / torch.sqrt(var).clamp(min=1e-6)), zero)
    sizes = (P,) * V
    res = als_kernel.match_als(
        sim.to(torch.float32).contiguous(),
        torch.as_tensor(block_diag_mask(sizes), device=dev),
        torch.as_tensor(default_init_factor(V * P, cfg.als_max_rank), device=dev),
        alpha=cfg.als_alpha, beta=cfg.als_beta, mu0=cfg.als_mu, tol=cfg.als_tol,
        max_iter=cfg.als_max_iter, stable_iters=cfg.als_stable_iters)
    g = extract_groups(res.x_bin, dv)
    rep, member = g.rep.cpu().numpy(), g.member.cpu().numpy()
    groups = {}
    for e in range(V * P):
        if member[e]:
            groups.setdefault(int(rep[e]), []).append((e // P, e % P))
    return [v for _, v in sorted(groups.items()) if len(v) >= 2]
