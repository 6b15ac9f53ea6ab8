"""Reprojection quality of tracking runs (port of `reprojection_metrics`
from `multiview_motion_capture_tpu/eval.py`): reproject each tracked pose
into the views it was matched in and measure the pixel distance to the
matched detection's keypoints.  `decision_digests` fingerprints each
frame's tracking decisions, so two runs can be compared frame by frame
without carrying their outputs."""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List

import numpy as np

from multiview_motion_capture_torch.cameras import CameraBank
from multiview_motion_capture_torch.data.ingest import FrameBatch
from multiview_motion_capture_torch.tracker import (
    B18_COCO_OBS_IDX,
    B18_COCO_SKEL_IDX,
    Tracklet,
)


@dataclasses.dataclass
class RunMetrics:
    n_tracklets: int
    lengths: List[int]
    frames_covered: int
    mean_reproj_px: float
    median_reproj_px: float
    per_tracklet_reproj_px: List[float]
    # (tracklet, frame) entries whose pose was non-finite: counted, not hidden
    n_degenerate_poses: int = 0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _project(P: np.ndarray, X: np.ndarray) -> np.ndarray:
    homo = np.concatenate([X, np.ones((len(X), 1))], axis=1)
    uvw = homo @ P.T
    return uvw[:, :2] / uvw[:, 2:3]


def reprojection_metrics(tracklets: List[Tracklet], batch: FrameBatch,
                         cams: CameraBank, min_score: float = 0.3,
                         frame_offset: int = 0) -> RunMetrics:
    P = cams.P.cpu().numpy().astype(np.float64)
    skel_idx = np.asarray(B18_COCO_SKEL_IDX)
    obs_idx = np.asarray(B18_COCO_OBS_IDX)
    all_errs: List[float] = []
    per_tlet: List[float] = []
    frames = set()
    n_degenerate = 0
    for t in tracklets:
        errs = []
        for i, f in enumerate(t.frame_idxs):
            frames.add(f)
            fi = f - frame_offset
            if fi < 0 or fi >= batch.n_frames:
                continue
            X = t.poses_3d[i]
            if X.shape[0] == 18:
                X_sel, o_idx = X[skel_idx], obs_idx
            else:
                X_sel, o_idx = X[:17], np.arange(17)
            if not np.isfinite(X_sel).all():
                n_degenerate += 1
                continue
            for v in range(cams.n_views):
                p_idx = int(t.matched_pose[i, v])
                if p_idx < 0:
                    continue
                det = batch.kps[fi, v, p_idx]
                uv = _project(P[v], X_sel)
                m = (det[o_idx, 2] > min_score) & np.isfinite(uv).all(axis=-1)
                if m.sum():
                    errs.append(float(np.linalg.norm(uv[m] - det[o_idx][m, :2],
                                                     axis=-1).mean()))
        if errs:
            per_tlet.append(float(np.mean(errs)))
            all_errs.extend(errs)
    return RunMetrics(
        n_tracklets=len(tracklets),
        lengths=sorted((len(t) for t in tracklets), reverse=True),
        frames_covered=len(frames),
        mean_reproj_px=float(np.mean(all_errs)) if all_errs else float("nan"),
        median_reproj_px=float(np.median(all_errs)) if all_errs else float("nan"),
        per_tracklet_reproj_px=per_tlet,
        n_degenerate_poses=n_degenerate,
    )


DECISION_FIELDS = ("track_id", "active", "updated", "spawned", "died_track_id",
                   "matched_pose")


def decision_digests(out) -> List[str]:
    """One short hash per frame of a run's decisions: `out` holds the
    per-frame outputs (F, ...) of `DECISION_FIELDS` as numpy arrays (the
    port's `FrameOutput` or the JAX package's, moved to the host).  Equal
    digests mean equal track ids, lifecycle states, updated/spawned flags,
    deaths and matched detections on that frame."""
    fields = [np.asarray(getattr(out, f)).astype(np.int32) for f in DECISION_FIELDS]
    digests = []
    for frame in range(fields[0].shape[0]):
        h = hashlib.sha1()
        for a in fields:
            h.update(np.ascontiguousarray(a[frame]).tobytes())
        digests.append(h.hexdigest()[:10])
    return digests
