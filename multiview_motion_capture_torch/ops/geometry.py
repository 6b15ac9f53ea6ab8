"""Batched epipolar / projective geometry on tensors.

Port of `multiview_motion_capture_tpu/ops/geometry.py`: the fundamental
matrices, epipolar distances, projection and reprojection error, and
pixel-to-ray unprojection.  Conventions: points are pixel
coordinates, homogeneous via an appended 1; epipolar lines are normalized so
a^2 + b^2 = 1 (cv2.computeCorrespondEpilines semantics), making |l . x| the
point-line distance in pixels.  Callers pin full f32 (no TF32) through
`utils.precision.high_precision`.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _homo(xy: Tensor) -> Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def fundamental_from_projections(P1: Tensor, P2: Tensor) -> Tensor:
    """F from two 3x4 projection matrices by the minor/determinant
    construction (ref:src/mv_math_util.py:57-77; Hartley & Zisserman
    9.2.2): F[i, j] = det([P1 without row j; P2 without row i]), rows kept
    in cyclic order.  Batched over the leading dims of P1/P2."""
    idx = torch.tensor([[1, 2], [2, 0], [0, 1]], device=P1.device)
    x = P1[..., idx, :]                                   # (..., 3, 2, 4)
    y = P2[..., idx, :]
    lead = x.shape[:-3]
    stacked = torch.cat([x[..., None, :, :, :].expand(*lead, 3, 3, 2, 4),
                         y[..., :, None, :, :].expand(*lead, 3, 3, 2, 4)], dim=-2)
    return torch.linalg.det(stacked)                      # (..., 3, 3)


def _skew(v: Tensor) -> Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def pairwise_fundamental_mats(K: Tensor, Rt: Tensor) -> Tensor:
    """All-pairs fundamental tensor (V, V, 3, 3) in one batch, the closed
    form of ref:src/mv_math_util.py:267-285:
      F_ij = K_i^-T (R_i R_j^T) K_j^T [K_j R_j R_i^T (t_i - R_i R_j^T t_j)]_x
    with 1e-12 added to the self pairs (exactly zero) to keep them finite.
    The tracker's own F comes from `cameras.pairwise_fundamental_np` (f64 on
    the host, normalized)."""
    R, t = Rt[..., :3], Rt[..., 3]
    K_inv_T = torch.linalg.inv(K).transpose(1, 2)
    Rij = torch.einsum("iab,jcb->ijac", R, R)                        # R_i R_j^T
    rel_t = t[:, None, :] - torch.einsum("ijab,jb->ija", Rij, t)     # t_i - R_i R_j^T t_j
    e = torch.einsum("jab,ijcb->ijac", K, Rij.transpose(2, 3))       # K_j R_j R_i^T
    e = torch.einsum("ijab,ijb->ija", e, rel_t)
    F = torch.einsum("iab,ijbc,jdc,ijde->ijae", K_inv_T, Rij, K, _skew(e))
    eye = torch.eye(F.shape[0], dtype=torch.bool, device=F.device)[:, :, None, None]
    return torch.where(eye, F + 1e-12, F)


def _normalize_lines(lines: Tensor) -> Tensor:
    n = torch.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    return lines / (n[..., None] + 1e-12)


def epilines(F: Tensor, pts: Tensor, which: int) -> Tensor:
    """Epipolar lines for `pts`: which=1 gives l = F x (points of image 1 ->
    lines in image 2), which=2 gives l = F^T x.  pts: (..., K, 2); F:
    (..., 3, 3) broadcastable against pts' leading dims.  Returns (..., K, 3)
    unit-normal lines."""
    homo = _homo(pts)
    mat = F if which == 1 else F.transpose(-1, -2)
    # (..., 3, 3) x (..., K, 3) -> (..., K, 3) as a broadcast multiply-sum
    lines = (mat[..., None, :, :] * homo[..., None, :]).sum(-1)
    return _normalize_lines(lines)


def projected_distance_all_pairs(kps: Tensor, F: Tensor) -> Tensor:
    """Spatial-association distances for every view pair at once
    (ref:src/mv_math_util.py:288-351):

      dist[a, i, b, j] = 0.5 * ( mean_k |l(F_ab^T x_aik) . x_bjk|
                               + mean_k |l(F_ba^T x_bjk) . x_aik| )

    kps: (V, P, K, >=2) pixel keypoints (scores ignored); F: (V, V, 3, 3).
    Returns (V, P, V, P)."""
    homo = _homo(kps[..., :2])                                   # (V,P,K,3)
    lines = torch.einsum("abyx,apky->abpkx", F, homo)
    lines = _normalize_lines(lines)
    d = torch.einsum("abpkx,bqkx->abpqk", lines, homo).abs().mean(dim=-1)
    sym = 0.5 * (d + d.permute(1, 0, 3, 2))
    return sym.permute(0, 2, 1, 3)


def masked_symmetric_epipolar_error(kps_a: Tensor, kps_b: Tensor, F_ab: Tensor,
                                    min_pair_score: float) -> Tensor:
    """Score-gated symmetric epipolar error (ref:src/mv_math_util.py:80-115).

    kps_a, kps_b: (..., K, 3) with scores; F_ab maps image-a points to lines
    in image b via l = F x.  Returns (...) the mean error over keypoints with
    score_a*score_b > min_pair_score, or NaN when none qualifies."""
    l_in_b = epilines(F_ab, kps_a[..., :2], which=1)
    l_in_a = epilines(F_ab, kps_b[..., :2], which=2)
    homo_a = _homo(kps_a[..., :2])
    homo_b = _homo(kps_b[..., :2])
    d_ab = (l_in_b * homo_b).sum(-1).abs()
    d_ba = (l_in_a * homo_a).sum(-1).abs()
    per_kp = 0.5 * (d_ab + d_ba)
    valid = (kps_a[..., 2] * kps_b[..., 2]) > min_pair_score
    cnt = valid.sum(-1)
    total = torch.where(valid, per_kp, torch.zeros_like(per_kp)).sum(-1)
    return torch.where(cnt > 0, total / cnt.clamp(min=1),
                       torch.full_like(total, float("nan")))


def project_points(P: Tensor, pts_3d: Tensor, eps: float = 0.0) -> Tensor:
    """(..., 3, 4) x (..., N, 3) -> (..., N, 2) pinhole projection."""
    homo = _homo(pts_3d)
    uvw = (P[..., None, :, :] * homo[..., None, :]).sum(-1)     # (..., N, 3)
    return uvw[..., :2] / (uvw[..., 2:3] + eps)


def masked_reprojection_error(pts_3d: Tensor, scores_3d: Tensor, kps_2d: Tensor,
                              P: Tensor, min_pair_score: float,
                              eps: float = 1e-5) -> Tensor:
    """Mean pixel reprojection error over score-valid keypoints
    (ref:src/motion_capture.py:403-414); NaN where no keypoint has
    score_3d*score_2d > min_pair_score.

    pts_3d: (..., K, 3), scores_3d: (..., K), kps_2d: (..., K, 3),
    P: (..., 3, 4), all broadcastable."""
    reproj = project_points(P, pts_3d, eps=eps)
    d = torch.linalg.vector_norm(reproj - kps_2d[..., :2], dim=-1)
    valid = (scores_3d * kps_2d[..., 2]) > min_pair_score
    cnt = valid.sum(-1)
    total = torch.where(valid, d, torch.zeros_like(d)).sum(-1)
    return torch.where(cnt > 0, total / cnt.clamp(min=1),
                       torch.full_like(total, float("nan")))


def unproject_to_rays(kps_2d: Tensor, Kr_inv: Tensor) -> Tensor:
    """Pixel -> unit world-space ray directions (ref:src/mv_math_util.py:
    11-21).  kps_2d: (..., 2); Kr_inv: (..., 3, 3)."""
    rays = torch.einsum("...ab,...b->...a", Kr_inv, _homo(kps_2d))
    return rays / (torch.linalg.vector_norm(rays, dim=-1, keepdim=True) + 1e-12)


def point_to_ray_distance(points: Tensor, origins: Tensor, rays: Tensor) -> Tensor:
    """Distance of 3D `points` to rays (origin, unit direction)
    (ref:src/mv_math_util.py:24-32)."""
    diff = points - origins
    diff, rays = torch.broadcast_tensors(diff, rays)
    return torch.linalg.vector_norm(torch.linalg.cross(diff, rays, dim=-1), dim=-1)
