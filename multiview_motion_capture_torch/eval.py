"""Evaluation metrics for tracking runs (port of
`multiview_motion_capture_tpu/eval.py`):

- `reprojection_metrics`: reproject each tracked pose into the views it was
  matched in and measure the pixel distance to the matched detection's
  keypoints;
- `identity_metrics`: IDF1 / ID switches / fragmentation against synthetic
  ground truth (`SyntheticSequence.gt_slot_person`), on the port's
  Hungarian (`utils/hungarian`, the C++ solver's assignments);
- `mpjpe_vs_ground_truth` and `run_consistency_mpjpe`: joint errors against
  ground truth or between two runs.

`decision_digests` fingerprints each frame's tracking decisions, so two runs
can be compared frame by frame without carrying their outputs."""
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
from multiview_motion_capture_torch.utils.hungarian import hungarian


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


def mpjpe_vs_ground_truth(tracklets: List[Tracklet], gt_3d: np.ndarray,
                          joint_map=None) -> float:
    """MPJPE against synthetic ground truth (F, N_people, K, 3): each
    tracklet is matched to the nearest GT person per frame."""
    errs = []
    for t in tracklets:
        for i, f in enumerate(t.frame_idxs):
            X = t.poses_3d[i]
            if joint_map is not None:
                skel_sel, gt_sel = joint_map
                X = X[skel_sel]
                G = gt_3d[f][:, gt_sel]
            else:
                k = min(X.shape[0], gt_3d.shape[2])
                X = X[:k]
                G = gt_3d[f][:, :k]
            d = np.linalg.norm(G - X[None], axis=-1).mean(axis=-1)
            errs.append(d.min())
    return float(np.mean(errs)) if errs else float("nan")


@dataclasses.dataclass
class IdentityMetrics:
    """MOT-style identity scores against synthetic ground truth
    (detection-slot -> person-id labels, so the scores are exact)."""

    idf1: float                 # 2*IDTP / (total predicted + total GT frames)
    idtp: int
    idfp: int
    idfn: int
    n_gt_identities: int        # GT people that were ever trackable
    n_pred_tracks: int
    id_switches: int            # per-identity track-label changes over time
    fragments_per_identity: List[int]  # distinct tracks covering each GT id
    gt_frames: int              # (frame, person) pairs trackable (>= min_views)
    covered_frames: int         # of those, covered by some track

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _tracklet_gt_ids(t: Tracklet, gt_slot_person: np.ndarray) -> np.ndarray:
    """Per-frame GT person id of a tracklet (majority vote over the detection
    slots it was matched to, the lowest id on a tie), -1 where no vote
    exists."""
    F = gt_slot_person.shape[0]
    ids = np.full(len(t.frame_idxs), -1, dtype=np.int64)
    for i, f in enumerate(t.frame_idxs):
        if f < 0 or f >= F:
            continue
        votes = []
        for v in range(t.matched_pose.shape[1]):
            p = int(t.matched_pose[i, v])
            if p >= 0:
                pid = int(gt_slot_person[f, v, p])
                if pid >= 0:
                    votes.append(pid)
        if votes:
            vals, counts = np.unique(votes, return_counts=True)
            ids[i] = int(vals[np.argmax(counts)])
    return ids


def identity_metrics(tracklets: List[Tracklet], gt_slot_person: np.ndarray,
                     min_views: int = 2) -> IdentityMetrics:
    """IDF1 / ID switches / fragmentation against synthetic ground truth.

    gt_slot_person: (F, V, P) int, the person id of each detection slot or
    -1.  A GT person is trackable in a frame where it appears in at least
    `min_views` views (the tracker's spawn/update rule).  IDF1 follows
    Ristani et al. 2016: a one-to-one track <-> identity assignment that
    maximises the overlap (exact Hungarian), IDTP = matched (frame, person)
    pairs, IDF1 = 2 * IDTP / (pred + gt).  ID switches count, per identity,
    changes of the covering track (the lowest track index covering a
    frame) between consecutive covered frames.
    """
    F, V, P = gt_slot_person.shape
    n_people = int(gt_slot_person.max()) + 1 if gt_slot_person.size else 0
    present = np.zeros((F, n_people), dtype=bool)
    for p in range(n_people):
        present[:, p] = (gt_slot_person == p).reshape(F, -1).sum(axis=1) >= min_views
    gt_frames = int(present.sum())
    n_gt = int((present.any(axis=0)).sum())

    n_tr = len(tracklets)
    overlap = np.zeros((n_tr, n_people), dtype=np.int64)
    pred_total = 0
    cover = np.full((F, n_people), -1, dtype=np.int64)
    for ti, t in enumerate(tracklets):
        pred_total += len(t.frame_idxs)
        ids = _tracklet_gt_ids(t, gt_slot_person)
        for i, f in enumerate(t.frame_idxs):
            pid = ids[i]
            if pid >= 0 and 0 <= f < F and present[f, pid]:
                overlap[ti, pid] += 1
                if cover[f, pid] < 0:  # deterministic: lowest track index
                    cover[f, pid] = ti

    # one-to-one assignment maximising overlap (padded to square)
    idtp = 0
    if n_tr and n_people:
        n = max(n_tr, n_people)
        cost = np.zeros((n, n), dtype=np.float64)
        cost[:n_tr, :n_people] = -overlap
        rows, cols = hungarian(cost)
        for r, c in zip(rows, cols):
            if r < n_tr and c < n_people:
                idtp += int(overlap[r, c])
    idfp = pred_total - idtp
    idfn = gt_frames - idtp
    idf1 = 2.0 * idtp / max(pred_total + gt_frames, 1)

    id_switches = 0
    fragments = []
    for p in range(n_people):
        if not present[:, p].any():
            continue
        seq = cover[present[:, p], p]
        covered = seq[seq >= 0]
        fragments.append(int(len(np.unique(covered))) if len(covered) else 0)
        if len(covered) > 1:
            id_switches += int((covered[1:] != covered[:-1]).sum())

    return IdentityMetrics(
        idf1=float(idf1), idtp=idtp, idfp=idfp, idfn=idfn, n_gt_identities=n_gt,
        n_pred_tracks=n_tr, id_switches=id_switches, fragments_per_identity=fragments,
        gt_frames=gt_frames, covered_frames=int((cover >= 0).sum()),
    )


def run_consistency_mpjpe(a: List[Tracklet], b: List[Tracklet]) -> float:
    """Mean joint distance between two runs over matched (by overlap)
    tracklet pairs: for each tracklet of `a`, the closest tracklet of `b`
    among those sharing at least two frames."""
    errs = []
    for ta in a:
        fa = {f: i for i, f in enumerate(ta.frame_idxs)}
        best = None
        for tb in b:
            common = [(fa[f], j) for j, f in enumerate(tb.frame_idxs) if f in fa]
            if len(common) < 2:
                continue
            ia, ib = zip(*common)
            d = float(np.linalg.norm(ta.poses_3d[list(ia)] - tb.poses_3d[list(ib)],
                                     axis=-1).mean())
            if best is None or d < best:
                best = d
        if best is not None:
            errs.append(best)
    return float(np.mean(errs)) if errs else float("nan")


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
