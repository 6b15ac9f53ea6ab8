"""Rendered evaluation sequences and detection quality (numpy only).

The inference-side part of `multiview_motion_capture_tpu/data/
detect_train.py`: `render_sequence` renders a synthetic sequence's views
into camera frames for the detection path, and `evaluate_detections`
scores a detector's output against the rendered ground truth.  The
training harness of that module (sample generation, the train step) is
not ported yet.
"""
from __future__ import annotations

import numpy as np

from multiview_motion_capture_torch.data.render import RenderConfig, render_scene


def _cam_locations(cams) -> np.ndarray:
    Rt = np.asarray(cams.Rt, dtype=np.float64)  # (V, 3, 4)
    R, t = Rt[:, :, :3], Rt[:, :, 3]
    return -np.einsum("vji,vj->vi", R, t)


def render_sequence(seq, render_cfg: RenderConfig,
                    world_scale: float = 0.25, seed: int = 0,
                    person_tints: np.ndarray = None) -> np.ndarray:
    """Render a SyntheticSequence's views consistently (no per-sample zoom):
    (F, V, H, W, 3) f32 frames in [0, 1] whose detections match
    `seq.batch.kps * world_scale` (pair with cameras scaled by the same
    factor).  `person_tints` (N_people, 3) gives each person a stable
    clothing colour."""
    rng = np.random.RandomState(seed)
    cam_loc = _cam_locations(seq.cameras)
    F, V = seq.batch.kps.shape[:2]
    kseq = seq.batch.kps[..., :2] * world_scale
    out = np.zeros((F, V) + render_cfg.hw + (3,), dtype=np.float32)
    for f in range(F):
        for v in range(V):
            pres = seq.batch.valid[f, v]
            slot_p = seq.gt_slot_person[f, v]
            depth = np.array([
                np.linalg.norm(seq.gt_3d[f, slot_p[s], 11] - cam_loc[v])
                if slot_p[s] >= 0 else 1e9
                for s in range(len(pres))
            ])
            tints = (person_tints[np.clip(slot_p, 0, None)]
                     if person_tints is not None else None)
            out[f, v] = render_scene(kseq[f, v], pres, depth, rng, render_cfg,
                                     person_tints=tints)
    return out


def evaluate_detections(
    det_kps: np.ndarray,    # (N, Pd, K, 3) detector output, frame px
    det_valid: np.ndarray,  # (N, Pd)
    gt_kps: np.ndarray,     # (N, P, K, 2)
    gt_present: np.ndarray,  # (N, P)
    match_px: float = 12.0,
):
    """Greedy nearest-person matching: recall@match_px, matched mean error,
    and precision (detections that matched some person)."""
    n_gt = 0
    n_hit = 0
    n_det = 0
    n_det_matched = 0
    errs = []
    for i in range(det_kps.shape[0]):
        gts = [gt_kps[i, p] for p in range(gt_kps.shape[1])
               if gt_present[i, p]]
        n_gt += len(gts)
        hit_gt = [False] * len(gts)
        for s in range(det_kps.shape[1]):
            if not det_valid[i, s]:
                continue
            n_det += 1
            if not gts:
                continue
            d = [np.nanmean(np.linalg.norm(det_kps[i, s, :, :2] - g, axis=-1))
                 for g in gts]
            j = int(np.argmin(d))
            if d[j] < match_px:
                n_det_matched += 1
                if not hit_gt[j]:
                    hit_gt[j] = True
                    n_hit += 1
                    errs.append(d[j])
    recall = n_hit / max(n_gt, 1)
    precision = n_det_matched / max(n_det, 1)
    err = float(np.mean(errs)) if errs else float("inf")
    return {"recall": recall, "precision": precision, "mean_err_px": err,
            "n_gt": n_gt, "n_det": n_det}
