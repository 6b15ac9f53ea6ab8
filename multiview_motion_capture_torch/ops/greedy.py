"""Greedy cross-view association (the reference's legacy matcher and the
approach its README describes; ref:src/motion_capture.py:44-241).

Port of `multiview_motion_capture_tpu/ops/greedy.py`, numpy on the host as
there.  A host-side alternative associator: seed the view with the most
detections, then for every other view solve a Hungarian assignment between
the current hypotheses and that view's detections using mean epipolar
distance to the hypothesis' members; assignments worse than the threshold
spawn new hypotheses.  Uses `utils.hungarian`, the numpy copy of the C++
solver the JAX package calls, so ties break alike.

Also provides the ray-distance tracklet->detection matcher of
ref:src/motion_capture.py:845-871 (unused on the reference's main path but
part of its API surface).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from multiview_motion_capture_torch.utils.hungarian import hungarian

Array = np.ndarray


@dataclasses.dataclass
class GreedyGroup:
    """One cross-view person hypothesis: (view, detection) members."""

    views: List[int]
    dets: List[int]


def _epipolar_distance_np(kps_a, kps_b, F_ab, min_pair_score=0.05):
    """Symmetric score-gated epipolar distance (numpy mirror of
    ops.geometry.masked_symmetric_epipolar_error)."""
    homo_a = np.concatenate([kps_a[:, :2], np.ones((len(kps_a), 1))], axis=1)
    homo_b = np.concatenate([kps_b[:, :2], np.ones((len(kps_b), 1))], axis=1)

    def norm_lines(L):
        return L / (np.linalg.norm(L[:, :2], axis=1, keepdims=True) + 1e-12)

    l_in_b = norm_lines(homo_a @ F_ab.T)
    l_in_a = norm_lines(homo_b @ F_ab)
    d = 0.5 * (np.abs(np.sum(l_in_b * homo_b, axis=1)) +
               np.abs(np.sum(l_in_a * homo_a, axis=1)))
    valid = (kps_a[:, 2] * kps_b[:, 2]) > min_pair_score
    if not valid.any():
        return np.nan
    return float(d[valid].mean())


def match_greedy(
    kps: Array,            # (V, P, K, 3)
    valid: Array,          # (V, P) bool
    F_det: Array,          # (V, V, 3, 3) minor-formula F tensor
    match_threshold: float = 200.0,
) -> List[GreedyGroup]:
    """Greedy seeded association (semantics of
    ref:src/motion_capture.py:166-241 `match_objects_across_views`)."""
    V = kps.shape[0]
    counts = valid.sum(axis=1)
    if counts.max() == 0:
        return []
    seed = int(np.argmax(counts))
    groups = [GreedyGroup([seed], [int(p)]) for p in np.nonzero(valid[seed])[0]]

    order = [v for v in range(V) if v != seed]
    for v in order:
        dets = np.nonzero(valid[v])[0]
        if len(dets) == 0:
            continue
        if not groups:
            groups = [GreedyGroup([v], [int(p)]) for p in dets]
            continue
        cost = np.zeros((len(groups), len(dets)))
        for gi, g in enumerate(groups):
            for di, p in enumerate(dets):
                ds = []
                for mv, mp in zip(g.views, g.dets):
                    d = _epipolar_distance_np(kps[mv, mp], kps[v, p], F_det[mv, v])
                    if np.isfinite(d):
                        ds.append(d)
                cost[gi, di] = np.mean(ds) if ds else match_threshold * 10
        rows, cols = hungarian(cost)
        assigned = set()
        for gi, di in zip(rows, cols):
            if cost[gi, di] < match_threshold:
                groups[gi].views.append(v)
                groups[gi].dets.append(int(dets[di]))
                assigned.add(di)
        for di, p in enumerate(dets):
            if di not in assigned:
                groups.append(GreedyGroup([v], [int(p)]))
    return groups


def tracklet_ray_association(
    track_pts3d: Array,     # (T, K3, 3) last 3D poses (common-kps rows)
    track_scores: Array,    # (T, K3)
    det_kps: Array,         # (P, K3, 3) one view's detections (common rows)
    Kr_inv: Array,          # (3, 3)
    cam_loc: Array,         # (3,)
    max_dst: float = 0.1,
) -> List[Tuple[int, int]]:
    """Single-view tracklet->detection matching by mean 3D point-to-ray
    distance + Hungarian (ref:src/motion_capture.py:845-871)."""
    T, P = len(track_pts3d), len(det_kps)
    if T == 0 or P == 0:
        return []
    homo = np.concatenate([det_kps[..., :2],
                           np.ones(det_kps.shape[:2] + (1,))], axis=-1)
    rays = homo @ Kr_inv.T
    rays = rays / (np.linalg.norm(rays, axis=-1, keepdims=True) + 1e-12)
    # dist[t, p, k] = || (X_tk - cam) x ray_pk ||
    diff = track_pts3d[:, None, :, :] - cam_loc[None, None, None, :]  # (T,1,K,3)
    cross = np.cross(diff, rays[None, :, :, :])                        # (T,P,K,3)
    cost = np.linalg.norm(cross, axis=-1).mean(axis=-1)  # (T, P)
    rows, cols = hungarian(cost)
    return [(int(t), int(p)) for t, p in zip(rows, cols) if cost[t, p] <= max_dst]
