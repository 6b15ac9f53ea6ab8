"""Ingest: OpenPose BODY_25 JSON -> fixed-capacity packed frame arrays.

Port of `multiview_motion_capture_tpu/data/ingest.py` (numpy only; the
optional C++ scanner of the JAX package is not ported, the `json` parser
gives the same arrays), with its per-camera .npy reader and the packed npz
writer and reader.  The whole sequence is packed into dense padded
arrays

    kps:   (F, V, P_max, K, 3) float32   (x, y, score), zero-padded
    valid: (F, V, P_max)       bool      detection slot occupied

so the run is a single host->device transfer.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from multiview_motion_capture_torch.config import PipelineConfig
from multiview_motion_capture_torch.pose_def import OPENPOSE25_TO_COCO


@dataclasses.dataclass
class FrameBatch:
    """A packed multi-view keypoint sequence."""

    kps: np.ndarray     # (F, V, P, K, 3)
    valid: np.ndarray   # (F, V, P) bool

    @property
    def n_frames(self) -> int:
        return self.kps.shape[0]

    @property
    def n_views(self) -> int:
        return self.kps.shape[1]

    @property
    def max_people(self) -> int:
        return self.kps.shape[2]

    def __getitem__(self, idx) -> "FrameBatch":
        return FrameBatch(kps=self.kps[idx], valid=self.valid[idx])


def _parse_openpose_json(path: Path) -> np.ndarray:
    """One OpenPose frame -> (n_people, 25, 3) float32."""
    with open(path, "rt") as f:
        data = json.load(f)
    people = data.get("people", [])
    if not people:
        return np.zeros((0, 25, 3), dtype=np.float32)
    return np.stack(
        [np.asarray(p["pose_keypoints_2d"], dtype=np.float32).reshape(-1, 3)
         for p in people]
    )


def load_openpose_dir(kps_root: Path, cfg: PipelineConfig,
                      max_frames: Optional[int] = None) -> FrameBatch:
    """Load `kps_root/<cam>/*.json` (one sub-dir per camera, sorted by name;
    frame order by the numeric field of the filename) into a packed COCO-17
    FrameBatch."""
    kps_root = Path(kps_root)
    cam_dirs = sorted([d for d in kps_root.iterdir() if d.is_dir()],
                      key=lambda p: p.stem)
    if not cam_dirs:
        raise FileNotFoundError(f"no camera sub-directories in {kps_root}")

    def frame_key(p: Path) -> int:
        # filenames look like '0_000000000012_keypoints.json'
        parts = p.stem.split("_")
        return int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else int(parts[0])

    cam_files: List[List[Path]] = [
        sorted(d.glob("*.json"), key=frame_key) for d in cam_dirs
    ]
    n_frames = min(len(files) for files in cam_files)
    if max_frames is not None:
        n_frames = min(n_frames, max_frames)

    V, P, K = len(cam_dirs), cfg.max_people, cfg.n_kps
    kps = np.zeros((n_frames, V, P, K, 3), dtype=np.float32)
    valid = np.zeros((n_frames, V, P), dtype=bool)
    for v, files in enumerate(cam_files):
        for f in range(n_frames):
            body25 = _parse_openpose_json(files[f])
            coco = body25[:, OPENPOSE25_TO_COCO, :]
            n = min(len(coco), P)
            kps[f, v, :n] = coco[:n]
            valid[f, v, :n] = True
    return FrameBatch(kps=kps, valid=valid)


def filter_bad_poses(batch: FrameBatch, cfg: PipelineConfig) -> FrameBatch:
    """Vectorized bad-pose filter (ref:src/motion_capture.py:1023-1043):
    a detection is dropped if it has fewer than `filter_min_valid_kps`
    keypoints scoring above `filter_min_kps_score`, or if the bbox over its
    valid keypoints is thinner than `filter_min_bbox_px` on any side."""
    scores = batch.kps[..., 2]                     # (F, V, P, K)
    kp_ok = scores > cfg.filter_min_kps_score
    n_ok = kp_ok.sum(axis=-1)                      # (F, V, P)
    enough_kps = n_ok >= cfg.filter_min_valid_kps

    xy = batch.kps[..., :2]
    big = np.float32(1e30)
    mins = np.min(np.where(kp_ok[..., None], xy, big), axis=-2)    # (F, V, P, 2)
    maxs = np.max(np.where(kp_ok[..., None], xy, -big), axis=-2)
    bbox_ok = np.all((maxs - mins) >= cfg.filter_min_bbox_px, axis=-1)

    new_valid = batch.valid & enough_kps & bbox_ok
    return FrameBatch(kps=batch.kps, valid=new_valid)


def load_npy_keypoints(npy_paths, cfg: PipelineConfig,
                       max_frames: Optional[int] = None) -> FrameBatch:
    """Alternative ingest: one .npy per camera with (F, P_i, K, 3) keypoints
    (the reference's `kpts_to_frames.py` input contract,
    ref:src/kpts_to_frames.py:26-45).  A slot is valid where any of its
    keypoints scores above 0."""
    arrays = [np.load(p) for p in npy_paths]
    n_frames = min(a.shape[0] for a in arrays)
    if max_frames is not None:
        n_frames = min(n_frames, max_frames)
    V, P, K = len(arrays), cfg.max_people, cfg.n_kps
    kps = np.zeros((n_frames, V, P, K, 3), dtype=np.float32)
    valid = np.zeros((n_frames, V, P), dtype=bool)
    for v, a in enumerate(arrays):
        n = min(a.shape[1], P)
        kps[:, v, :n] = a[:n_frames, :n, :K, :3]
        valid[:, v, :n] = a[:n_frames, :n, :, 2].max(axis=-1) > 0
    return FrameBatch(kps=kps, valid=valid)


def save_frame_batch(path: Path, batch: FrameBatch) -> None:
    """Write a packed batch as npz (`kps`, `valid`)."""
    np.savez_compressed(path, kps=batch.kps, valid=batch.valid)


def load_frame_batch(path: Path) -> FrameBatch:
    """Read a batch written by `save_frame_batch` (of either package)."""
    with np.load(path) as z:
        return FrameBatch(kps=z["kps"], valid=z["valid"])
