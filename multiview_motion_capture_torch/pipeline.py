"""End-to-end run: filter detections, track the whole sequence, emit
tracklets.

Port of `multiview_motion_capture_tpu/pipeline.py:run` (IK or
triangulation mode, appearance embeddings; not yet its checkpointing, re-ID,
crossing repair or device mesh), plus `filter_ghost_tracklets` and the tracklet pickle writer/reader with the
same schema of plain dicts, so files load in either package (or with
neither installed).
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle
import time
import warnings
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from multiview_motion_capture_torch.cameras import CameraBank
from multiview_motion_capture_torch.config import PipelineConfig
from multiview_motion_capture_torch.data.ingest import FrameBatch, filter_bad_poses
from multiview_motion_capture_torch.tracker import (
    Tracklet,
    TrackerContext,
    assemble_tracklets,
    outputs_to_numpy,
    run_offline,
)
from multiview_motion_capture_torch.utils.precision import resolve_device


@dataclasses.dataclass
class RunResult:
    tracklets: List[Tracklet]
    n_frames: int
    wall_time_s: float
    track_time_s: float     # steady-state (second) pass, device synchronized
    timings: dict
    # mean concurrent CONFIRMED tracks over the run (density diagnostic)
    mean_concurrent_tracks: float = 0.0

    @property
    def fps(self) -> float:
        return self.n_frames / max(self.track_time_s, 1e-9)


class _StageTimer:
    def __init__(self, device: torch.device):
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0


def _density_guard(cfg: PipelineConfig, active: np.ndarray) -> float:
    """Mean concurrent CONFIRMED tracks; warns when track rescue is on in a
    scene that dense (rescue is a measured identity hazard in crowds, the
    JAX package's `pipeline._density_guard`)."""
    if active.size == 0:
        return 0.0
    mean_conc = float((active == 2).sum(axis=1).mean())
    if (cfg.track_rescue_px > 0 and cfg.density_warn_tracks > 0
            and cfg.appearance_dim == 0 and mean_conc >= cfg.density_warn_tracks):
        warnings.warn(
            f"Dense scene: {mean_conc:.1f} concurrent confirmed tracks on "
            f"average (threshold {cfg.density_warn_tracks:g}) with track "
            f"rescue ACTIVE (track_rescue_px={cfg.track_rescue_px:g}); in "
            "crowds rescue adoption swaps identities mid-fragment.  Use "
            "PipelineConfig.crowded() for dense scenes, or set "
            "density_warn_tracks=0 to silence this.",
            stacklevel=3,
        )
    return mean_conc


def run(batch: FrameBatch, cams: CameraBank, cfg: Optional[PipelineConfig] = None,
        use_ik: bool = True, skip_first_frame: bool = False, app=None,
        device="cuda") -> RunResult:
    """Filter detections, then track and solve the whole sequence on
    `device` ("cuda" unless the caller asks for "cpu").  The sequence is
    tracked twice, as the JAX package does: the first pass pays the one-off
    costs (the kernels' build and load at first use, CUDA warm-up), the
    second is the steady-state `track_time_s`.

    `use_ik=False` tracks in triangulation mode.  `app` (F, V, P, D):
    per-detection appearance embeddings, needed when
    `cfg.appearance_dim > 0`.  `skip_first_frame` replicates the
    reference's off-by-one (frm_idx starts at 1,
    ref:src/motion_capture.py:1058-1063)."""
    dev = resolve_device(device)
    cfg = cfg or PipelineConfig(n_views=batch.n_views)
    timer = _StageTimer(dev)

    with timer.stage("filter"):
        batch = filter_bad_poses(batch, cfg)

    start = 1 if skip_first_frame else 0
    end = batch.n_frames
    if cfg.max_frames is not None:
        end = min(batch.n_frames, start + cfg.max_frames)
    frame_idxs = np.arange(batch.n_frames)[start:end]
    if cfg.appearance_dim > 0:
        if app is None:
            raise ValueError("cfg.appearance_dim > 0: run() needs "
                             "app=(F, V, P, D) detection embeddings")
        app = np.asarray(app)[start:end]
    else:
        app = None

    t0 = time.perf_counter()
    with timer.stage("build_context"):
        ctx = TrackerContext.build(cams, cfg, use_ik=use_ik, device=dev)
        kps = torch.as_tensor(batch.kps[start:end], device=dev)
        valid = torch.as_tensor(batch.valid[start:end], device=dev)
        if app is not None:
            app = torch.as_tensor(app, dtype=torch.float32, device=dev)
    with timer.stage("warmup+track"):
        run_offline(ctx, kps, valid, app=app)
    with timer.stage("track"):
        t1 = time.perf_counter()
        _, outputs = run_offline(ctx, kps, valid, app=app)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        track_time = time.perf_counter() - t1
    with timer.stage("assemble"):
        host_out = outputs_to_numpy(outputs)
        tracklets = filter_ghost_tracklets(
            assemble_tracklets(host_out, list(frame_idxs)), cfg.min_track_length)

    return RunResult(
        tracklets=tracklets,
        n_frames=int(end - start),
        wall_time_s=time.perf_counter() - t0,
        track_time_s=track_time,
        timings=dict(timer.totals),
        mean_concurrent_tracks=_density_guard(cfg, host_out.active),
    )


def filter_ghost_tracklets(tracklets: List[Tracklet],
                           min_length: int = 1) -> List[Tracklet]:
    """With `min_length > 1`, drop tracklets shorter than `min_length`
    frames and tracklets with no finite pose at all; `min_length <= 1` keeps
    everything (the reference's raw fragment output)."""
    if min_length <= 1:
        return tracklets
    return [t for t in tracklets
            if len(t) >= min_length and np.isfinite(np.asarray(t.poses_3d)).any()]


def save_tracklets(path: Path, tracklets: List[Tracklet]) -> None:
    """Write the reference's output contract: a pickle of {"tracklets":
    [...]} sorted by descending length (ref:src/motion_capture.py:
    1127-1129), each tracklet a plain dict."""
    payload = {
        "tracklets": [
            {
                "track_id": t.track_id,
                "frame_idxs": list(t.frame_idxs),
                "roots": t.roots,
                "euler_angles": t.eulers,
                "side_bone_lens": t.side_lens,
                "poses_3d": t.poses_3d,
                "poses_score": t.poses_score,
                "matched_pose": t.matched_pose,
                "app": t.app,
                "kps_format": "BASIC_18",
            }
            for t in tracklets
        ]
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_tracklets(path: Path) -> List[Tracklet]:
    """Read a tracklet pickle written by `save_tracklets` (of either
    package).  Unpickling runs code: load only files this program wrote."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return [
        Tracklet(
            track_id=d["track_id"], frame_idxs=d["frame_idxs"], roots=d["roots"],
            eulers=d["euler_angles"], side_lens=d["side_bone_lens"],
            poses_3d=d["poses_3d"], poses_score=d["poses_score"],
            matched_pose=d["matched_pose"], app=d.get("app"),
        )
        for d in payload["tracklets"]
    ]
