"""Batched masked DLT triangulation + Gauss-Newton reprojection polish.

Port of `multiview_motion_capture_tpu/ops/triangulate.py`
(ref:src/mv_math_util.py:152-240): a weighted 4x4 DLT normal-equation
eigensolve per keypoint in intrinsics-normalized coordinates (f32
conditioning), then a fixed number of Gauss-Newton steps on the
score-weighted pixel reprojection residual with adjugate 3x3 solves.
Batched over any leading dims (the tracker passes one problem per slot),
with the cameras shared or given per problem (a track's top-k views).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _dlt_normal_equations(P_norm: Tensor, xy_norm: Tensor, w: Tensor) -> Tensor:
    """Weighted DLT for every point at once.

    P_norm: (..., V, 3, 4); xy_norm: (..., K, V, 2); w: (..., K, V).
    Returns (..., K, 3)."""
    Pn = P_norm[..., None, :, :, :]                              # (...,1,V,3,4)
    rows = torch.stack(
        [xy_norm[..., 0:1] * Pn[..., 2, :] - Pn[..., 0, :],
         xy_norm[..., 1:2] * Pn[..., 2, :] - Pn[..., 1, :]],
        dim=-2,
    )                                                            # (...,K,V,2,4)
    wr = rows * w[..., None, None]
    A = rows.flatten(-3, -2)                                     # (...,K,2V,4)
    WA = wr.flatten(-3, -2)
    AtA = A.transpose(-1, -2) @ WA                               # (...,K,4,4)
    _, vecs = torch.linalg.eigh(AtA)
    h = vecs[..., :, 0]                      # eigenvector of the smallest eigenvalue
    denom = torch.where(h[..., 3].abs() < 1e-12,
                        torch.full_like(h[..., 3], 1e-12), h[..., 3])
    return h[..., :3] / denom[..., None]


def triangulate_points(P: Tensor, K_inv: Tensor, kps: Tensor, view_mask: Tensor,
                       min_score: float, refine_iters: int = 2,
                       eps: float = 1e-6) -> Tensor:
    """Triangulate keypoints observed by masked views
    (ref:src/mv_math_util.py:152-212): per keypoint, views with score >=
    min_score are used; with fewer than 2 such views, all masked views are.
    The output score is the mean score over the used views.

    P: (V, 3, 4) shared, or (T, V, 3, 4) per problem with kps (T, V, K, 3);
    K_inv: (V, 3, 3) or (T, V, 3, 3) alike; kps: (..., V, K, 3); view_mask:
    (..., V) bool.  Returns (..., K, 4) = (x, y, z, score)."""
    per_slot = P.dim() == 4
    vm = view_mask.to(P.dtype)
    scores = kps[..., 2] * vm[..., None]                         # (..., V, K)
    good = (kps[..., 2] >= min_score) & view_mask[..., None]
    n_good = good.sum(dim=-2)                                    # (..., K)
    use_fallback = n_good < 2
    w = torch.where(use_fallback[..., None, :], vm[..., None].expand_as(scores),
                    good.to(P.dtype))                            # (..., V, K)
    out_score = (scores * w).sum(dim=-2) / w.sum(dim=-2).clamp(min=1.0)

    P_norm = torch.einsum("...vab,...vbc->...vac" if per_slot else "vab,vbc->vac", K_inv, P)
    homo = torch.cat([kps[..., :2], torch.ones_like(kps[..., :1])], dim=-1)
    xyn = torch.einsum("tvab,tvkb->tvka" if per_slot else "vab,...vkb->...vka", K_inv, homo)
    xy_norm = xyn[..., :2] / (xyn[..., 2:3] + 1e-12)            # (..., V, K, 2)

    pts = _dlt_normal_equations(P_norm, xy_norm.transpose(-3, -2),
                                w.transpose(-1, -2))             # (..., K, 3)

    obs_xy = kps[..., :2].transpose(-3, -2)                      # (..., K, V, 2)
    obs_s = (kps[..., 2] * vm[..., None]).transpose(-1, -2)      # (..., K, V)
    Pk = P[:, None] if per_slot else P                           # ([T, 1,] V, 3, 4)
    P2 = Pk[..., :2, :3]                                         # ([T, 1,] V, 2, 3)
    P3 = Pk[..., 2, :3]                                          # ([T, 1,] V, 3)
    eye3 = 1e-8 * torch.eye(3, dtype=P.dtype, device=P.device)

    for _ in range(refine_iters):
        homo_p = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        proj = torch.einsum("tvab,tkb->tkva" if per_slot else "vab,...kb->...kva",
                            P, homo_p)                           # (..., K, V, 3)
        wq = proj[..., 2:3] + eps
        uv = proj[..., :2] / wq
        r = (uv - obs_xy) * obs_s[..., None]                     # (..., K, V, 2)
        J = ((P2 - uv[..., None] * P3[..., None, :]) / wq[..., None]) \
            * obs_s[..., None, None]                             # (..., K, V, 2, 3)
        Jf = J.flatten(-3, -2)                                   # (..., K, 2V, 3)
        rf = r.flatten(-2, -1)                                   # (..., K, 2V)
        A = torch.einsum("...rx,...ry->...xy", Jf, Jf) + eye3
        g = torch.einsum("...rx,...r->...x", Jf, rf)
        a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
        d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
        co00 = d * f - e * e
        co01 = c * e - b * f
        co02 = b * e - c * d
        co11 = a * f - c * c
        co12 = b * c - a * e
        co22 = a * d - b * b
        det = a * co00 + b * co01 + c * co02
        inv_det = 1.0 / det
        dx = torch.stack(
            [co00 * g[..., 0] + co01 * g[..., 1] + co02 * g[..., 2],
             co01 * g[..., 0] + co11 * g[..., 1] + co12 * g[..., 2],
             co02 * g[..., 0] + co12 * g[..., 1] + co22 * g[..., 2]],
            dim=-1,
        ) * inv_det[..., None]
        pts = pts - dx

    return torch.cat([pts, out_score[..., None]], dim=-1)
