"""End-to-end entry points: prepare / run / evaluate.

Port of `multiview_motion_capture_tpu/pipeline.py`:

- `prepare`: OpenPose JSON -> packed npz (`data.ingest`);
- `run`: filter detections, track the whole sequence on the card (IK or
  triangulation mode, appearance embeddings), optionally in checkpointed
  chunks that a restarted run resumes, then the host post-passes (crossing
  repair, the re-ID merge, the ghost filter) on the tracklets; with
  `mesh_spec` the tracker's stages are sharded over several devices
  (`parallel.mesh.MeshSpec`);
- `filter_ghost_tracklets`, `mpjpe_between`, and the tracklet pickle
  writer/reader with the same schema of plain dicts, so files load in
  either package (or with neither installed).
"""
from __future__ import annotations

import dataclasses
import pickle
import time
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from multiview_motion_capture_torch.cameras import CameraBank
from multiview_motion_capture_torch.config import PipelineConfig
from multiview_motion_capture_torch.crossings import resolve_crossings
from multiview_motion_capture_torch.data.ingest import (
    FrameBatch,
    filter_bad_poses,
    load_openpose_dir,
    save_frame_batch,
)
from multiview_motion_capture_torch.reid import merge_tracklets
from multiview_motion_capture_torch.tracker import (
    Tracklet,
    TrackerContext,
    assemble_tracklets,
    outputs_to_numpy,
    run_offline,
)
from multiview_motion_capture_torch.utils import checkpoint as ckpt
from multiview_motion_capture_torch.utils.precision import resolve_device
from multiview_motion_capture_torch.utils.profiling import StageTimer


@dataclasses.dataclass
class RunResult:
    tracklets: List[Tracklet]
    n_frames: int
    wall_time_s: float
    track_time_s: float     # steady-state (second) pass, device synchronized;
                            # with checkpoints, the one chunked pass
    timings: dict
    # mean concurrent CONFIRMED tracks over the run (density diagnostic)
    mean_concurrent_tracks: float = 0.0

    @property
    def fps(self) -> float:
        return self.n_frames / max(self.track_time_s, 1e-9)


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


def prepare(kps_dir: Path, out_path: Path, cfg: Optional[PipelineConfig] = None,
            max_frames: Optional[int] = None) -> FrameBatch:
    """Parse OpenPose JSON into the packed npz (ref:src/motion_capture.py:
    987-1005); `data.ingest.load_frame_batch` reads it back."""
    cfg = cfg or PipelineConfig()
    batch = load_openpose_dir(Path(kps_dir), cfg, max_frames=max_frames)
    save_frame_batch(Path(out_path), batch)
    return batch


def run(batch: FrameBatch, cams: CameraBank, cfg: Optional[PipelineConfig] = None,
        use_ik: bool = True, skip_first_frame: bool = False, app=None,
        checkpoint_dir: Optional[Path] = None, checkpoint_every: int = 100,
        reid: bool = False, reid_cfg=None, crossings: bool = False, crossings_cfg=None,
        mesh_spec=None, device="cuda") -> RunResult:
    """Filter detections, then track and solve the whole sequence on
    `device` ("cuda" unless the caller asks for "cpu").  The sequence is
    tracked twice, as the JAX package does: the first pass pays the one-off
    costs (the kernels' build and load at first use, CUDA warm-up), the
    second is the steady-state `track_time_s`.

    `use_ik=False` tracks in triangulation mode.  `app` (F, V, P, D):
    per-detection appearance embeddings, needed when
    `cfg.appearance_dim > 0`.  `skip_first_frame` replicates the
    reference's off-by-one (frm_idx starts at 1,
    ref:src/motion_capture.py:1058-1063).

    With `checkpoint_dir`, the sequence is tracked once, in chunks of
    `checkpoint_every` frames; after each chunk the tracker state and the
    chunk's outputs are written there (`utils.checkpoint`), and a run
    started on a directory that holds checkpoints resumes after the last
    completed chunk, its state loaded onto `device`.  `track_time_s` is
    then that one pass, first-use costs and the writes included.

    The tracklets then pass, on the host, through `crossings.resolve_crossings`
    (`crossings=True`, with `crossings_cfg`), `reid.merge_tracklets`
    (`reid=True`, or implied by `crossings`: the crossing repair's cuts are
    meant to be reassembled by the merge, with `reid_cfg`), and
    `filter_ghost_tracklets(cfg.min_track_length)`, in the JAX package's
    order.

    `mesh_spec` (a `parallel.mesh.MeshSpec` or its string form, e.g.
    ``"cameras=4,clusters=8,tracks=8"``) shards the tracker's stages over
    several devices: camera-sharded similarity, cluster-sharded ALS (B3 on
    each device), track-sharded LM, composable in one context.  On a CUDA
    `device` its meshes take the first n visible cards and it raises when
    fewer are visible; on the CPU they repeat the CPU n times."""
    dev = resolve_device(device)
    cfg = cfg or PipelineConfig(n_views=batch.n_views)
    timer = StageTimer(dev)

    def post(tracklets: List[Tracklet]) -> List[Tracklet]:
        if crossings:
            tracklets = resolve_crossings(tracklets, crossings_cfg)
        if reid or crossings:
            tracklets = merge_tracklets(tracklets, reid_cfg)
        return filter_ghost_tracklets(tracklets, cfg.min_track_length)

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

    mesh_kwargs = {}
    if mesh_spec is not None:
        from multiview_motion_capture_torch.parallel.mesh import MeshSpec

        if isinstance(mesh_spec, str):
            mesh_spec = MeshSpec.parse(mesh_spec)
        mesh_kwargs = mesh_spec.context_kwargs(dev)

    t0 = time.perf_counter()
    with timer.stage("build_context"):
        ctx = TrackerContext.build(cams, cfg, use_ik=use_ik, device=dev, **mesh_kwargs)
        kps = torch.as_tensor(batch.kps[start:end], device=dev)
        valid = torch.as_tensor(batch.valid[start:end], device=dev)
        if app is not None:
            app = torch.as_tensor(app, dtype=torch.float32, device=dev)

    if checkpoint_dir is not None:
        n = int(end - start)
        n_chunks = (n + checkpoint_every - 1) // checkpoint_every
        info = ckpt.resume_info(checkpoint_dir)
        first_chunk, state = 0, None
        if info is not None:
            first_chunk = info["last_chunk"] + 1
            state = ckpt.load_state(checkpoint_dir, info["last_chunk"], device=dev)
        with timer.stage("warmup+track"):
            t1 = time.perf_counter()
            for c in range(first_chunk, n_chunks):
                s, e = c * checkpoint_every, min(n, (c + 1) * checkpoint_every)
                state, outs = run_offline(ctx, kps[s:e], valid[s:e], state=state,
                                          app=None if app is None else app[s:e])
                ckpt.save_chunk(checkpoint_dir, c, e, state, outputs_to_numpy(outs))
            track_time = time.perf_counter() - t1
        with timer.stage("assemble"):
            host_out = ckpt.concat_outputs(ckpt.load_outputs(checkpoint_dir, n_chunks - 1))
            tracklets = post(assemble_tracklets(host_out, list(frame_idxs)))
    else:
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
            tracklets = post(assemble_tracklets(host_out, list(frame_idxs)))

    return RunResult(
        tracklets=tracklets,
        n_frames=int(end - start),
        wall_time_s=time.perf_counter() - t0,
        track_time_s=track_time,
        timings=timer.summary(),
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


def mpjpe_between(t_a: Tracklet, t_b: Tracklet, joint_idx=None) -> float:
    """Mean per-joint position error over the overlapping frames of two
    tracklets (the parity metric of BASELINE.md)."""
    frames_a = {f: i for i, f in enumerate(t_a.frame_idxs)}
    pairs = [(frames_a[f], j) for j, f in enumerate(t_b.frame_idxs) if f in frames_a]
    if not pairs:
        return float("nan")
    ia, ib = zip(*pairs)
    pa = t_a.poses_3d[list(ia)]
    pb = t_b.poses_3d[list(ib)]
    if joint_idx is not None:
        pa, pb = pa[:, joint_idx], pb[:, joint_idx]
    return float(np.linalg.norm(pa - pb, axis=-1).mean())
