"""CLI: prepare | run | detect | viz | bench, the JAX package's command line
(`multiview_motion_capture_tpu/__main__.py`, the reference's argparse
surface, ref:src/motion_capture.py:1221-1256) over the port.

`run`, `detect` and `bench` run on the card unless `--cpu` is given (then
every device step takes the plain PyTorch versions of the kernels on the
CPU); without a GPU and without `--cpu` they raise.  `run --mesh SPEC`
shards the tracker's stages over the visible cards (over the CPU,
repeated, with `--cpu`).  `bench` is the package's `bench.main`: Shelf
end to end, one JSON line (`--data_dir`: the Shelf directory, with
`kps_opn/` and `calibs/`).

Examples:
  python -m multiview_motion_capture_torch prepare \
      --kps_dir data/shelf/kps_opn --out data/shelf/frames.npz
  python -m multiview_motion_capture_torch run \
      --kps_dir data/shelf/kps_opn --calib_dir data/shelf/calibs \
      --out_dir out/ --bvh --max_frames 300
  python -m multiview_motion_capture_torch viz \
      --tracklets out/tracklets.pkl --calib_dir data/shelf/calibs \
      --out out/result.mp4
  python -m multiview_motion_capture_torch bench --data_dir data/shelf
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# the shipped detector weights, read as data files from the JAX package's
# directory (they are neither imported nor copied)
CHECKPOINTS = (Path(__file__).resolve().parents[1] / "multiview_motion_capture_tpu"
               / "models" / "checkpoints")


class UsageError(ValueError):
    """A flag combination the CLI cannot run; `main` reports it as argparse
    does."""


def _add_common(p):
    p.add_argument("--max_frames", type=int, default=300,
                   help="frame cap (reference n_test=300)")
    p.add_argument("--max_people", type=int, default=10)
    p.add_argument("--max_tracks", type=int, default=16)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain PyTorch versions); "
                        "without it the run needs an NVIDIA GPU")
    p.add_argument("--min_track_len", type=int, default=1,
                   help="drop output tracklets shorter than this (and "
                        "never-finite degenerate ghosts); 1 = keep all "
                        "(reference-parity fragments)")
    p.add_argument("--preset", default="default",
                   choices=("default", "parity", "fast", "crowded", "wide"),
                   help="config preset: default (recommended: includes the "
                        "documented track-rescue deviation, docs/PARITY.md), "
                        "parity (STRICT reference lifecycle — rescue off, "
                        "the config the oracle parity study pins), "
                        "fast (ALS early-exit throughput), crowded "
                        "(identity-first, rescue off), wide (16+-camera "
                        "rigs: merged cold IK, warm budget 3, 16-view cap)")


def _config(args, n_views):
    from multiview_motion_capture_torch.config import PipelineConfig

    common = dict(
        max_frames=args.max_frames,
        max_people=args.max_people,
        max_tracks=args.max_tracks,
        min_track_length=getattr(args, "min_track_len", 1),
    )
    preset = getattr(args, "preset", "default")
    if preset == "parity":
        return PipelineConfig.parity(n_views=n_views, **common)
    if preset == "fast":
        return PipelineConfig.fast(n_views=n_views, **common)
    if preset == "crowded":
        return PipelineConfig.crowded(n_views=n_views, **common)
    if preset == "wide":
        return PipelineConfig.wide(n_views, **common)
    return PipelineConfig(n_views=n_views, **common)


def _crossings_cfg(args):
    """CrossingConfig override from CLI flags (None = library defaults)."""
    gate = getattr(args, "cut_gate", None)
    if gate is None:
        return None
    from multiview_motion_capture_torch.crossings import CrossingConfig

    return CrossingConfig(cut_gate=gate)


def read_image_dir(image_dir: Path, n_views: int, max_frames=None):
    """`image_dir/<cam>/*.jpg|*.png` (one sub-directory per camera, sorted)
    -> (F, V, H, W, 3) f32 RGB in [0, 1].  Needs `cv2`."""
    import cv2
    import numpy as np

    root = Path(image_dir)
    cam_dirs = sorted(d for d in root.iterdir() if d.is_dir())
    if len(cam_dirs) != n_views:
        raise UsageError(f"{len(cam_dirs)} image dirs vs {n_views} calibs")
    per_cam = [sorted(list(d.glob("*.jpg")) + list(d.glob("*.png"))) for d in cam_dirs]
    n = min(len(x) for x in per_cam)
    if max_frames:
        n = min(n, max_frames)
    return np.stack([
        np.stack([cv2.imread(str(per_cam[v][f]))[..., ::-1].astype(np.float32) / 255.0
                  for v in range(n_views)])
        for f in range(n)
    ])


def detect_frames(images, cams, cfg, out_dir: Path, params=None, smoke: bool = False,
                  crop_hw=(512, 384), use_ik: bool = True, appearance: bool = False,
                  crossings: bool = False, crossings_cfg=None, appearance_head="auto",
                  device="cuda") -> dict:
    """`detect` after the images are read: camera frames (F, V, H, W, 3)
    (f32 in [0, 1] or uint8) -> keypoints (and appearance embeddings) by the
    detector CNN -> `pipeline.run` -> `out_dir/tracklets.pkl`.  Returns the
    JSON line the CLI prints.

    `params`: a PoseNet checkpoint (default: the shipped
    `posenet_synth.npz`); `smoke=True` with no checkpoint found runs a
    random-init PoseNet from a seeded generator (noise; plumbing only).
    `appearance_head`: a head checkpoint, "auto" (the shipped
    `appearance_head.npz` when present) or "none" (the raw descriptor)."""
    import dataclasses

    import torch

    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.data.detect import (
        frames_to_frame_batch,
        make_bottom_up_detector,
        make_multi_person_detector,
    )
    from multiview_motion_capture_torch.models.checkpoint import (
        load_appearance_head,
        load_posenet,
    )
    from multiview_motion_capture_torch.models.pose_net import PoseNetConfig, init_posenet
    from multiview_motion_capture_torch.utils.precision import resolve_device

    dev = resolve_device(device)
    if params is None and (CHECKPOINTS / "posenet_synth.npz").exists():
        params = CHECKPOINTS / "posenet_synth.npz"
    if params:
        mcfg, net = load_posenet(Path(params), device=dev)
    elif smoke:
        mcfg = PoseNetConfig(predict_center=True)
        net = init_posenet(mcfg, torch.Generator().manual_seed(0)).to(dev).eval()
    else:
        raise UsageError("no trained weights: pass --params <checkpoint>, or --smoke "
                         "to run with random-init weights (the output would be noise)")

    if appearance and not mcfg.predict_offsets:
        raise UsageError("--appearance needs the bottom-up checkpoint "
                         "(predict_offsets=True)")
    head = None
    if appearance and appearance_head != "none":
        hp = appearance_head
        if hp == "auto":
            shipped = CHECKPOINTS / "appearance_head.npz"
            hp = shipped if shipped.exists() else None
        if hp:
            _, head = load_appearance_head(Path(hp), device=dev)
    if mcfg.predict_offsets:
        # single-pass bottom-up (the shipped checkpoint's architecture)
        detect = make_bottom_up_detector(mcfg, max_people=cfg.max_people,
                                         center_nms_window=cfg.detect_nms_window,
                                         return_appearance=appearance,
                                         appearance_head=head)
    else:
        detect = make_multi_person_detector(mcfg, max_people=cfg.max_people,
                                            crop_hw=tuple(crop_hw))
    n = len(images)
    t0 = time.perf_counter()
    app = None
    if appearance:
        batch, app = frames_to_frame_batch(detect, net, images, cfg, collect_appearance=True)
        # gain 60 for both extractors (the JAX CLI's choice, measured on
        # its packed-crowd detector study)
        cfg = dataclasses.replace(cfg, appearance_dim=app.shape[-1], appearance_gain_px=60.0)
    else:
        batch = frames_to_frame_batch(detect, net, images, cfg)
    detect_s = time.perf_counter() - t0
    res = pipeline.run(batch, cams, cfg, use_ik=use_ik, app=app, crossings=crossings,
                       crossings_cfg=crossings_cfg, device=dev)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pipeline.save_tracklets(out_dir / "tracklets.pkl", res.tracklets)
    total_s = detect_s + res.track_time_s
    return {
        "n_frames": n,
        "detect_fps": round(n / max(detect_s, 1e-9), 2),
        "track_fps": round(res.fps, 2),
        "e2e_fps": round(n / max(total_s, 1e-9), 2),
        "n_tracklets": len(res.tracklets),
        "out": str(out_dir / "tracklets.pkl"),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="multiview_motion_capture_torch",
        description="Multi-view motion capture on an NVIDIA GPU (PyTorch/CUDA); "
                    "--cpu runs on the CPU.")
    sub = parser.add_subparsers(dest="mode", required=True)

    p_prep = sub.add_parser("prepare", help="OpenPose JSON -> packed npz")
    p_prep.add_argument("--kps_dir", required=True)
    p_prep.add_argument("--out", required=True)
    _add_common(p_prep)

    p_run = sub.add_parser("run", help="track + IK a sequence")
    p_run.add_argument("--kps_dir", help="OpenPose JSON root (one dir per cam)")
    p_run.add_argument("--frames_npz", help="packed npz from prepare")
    p_run.add_argument("--calib_dir", required=True)
    p_run.add_argument("--out_dir", required=True)
    p_run.add_argument("--no_ik", action="store_true",
                       help="triangulation pass-through instead of IK")
    p_run.add_argument("--bvh", action="store_true", help="export BVH per track")
    p_run.add_argument("--reid", action="store_true",
                       help="offline re-identification merge of tracklet "
                            "fragments (bone-length + trajectory evidence)")
    p_run.add_argument("--crossings", action="store_true",
                       help="hindsight crossing repair: cut every track at "
                            "its appearance identity change-points (2-means "
                            "label transitions) and reassemble the pure "
                            "pieces with the re-ID merge (implied); crossing "
                            "events without appearance are adjudicated by "
                            "bone/velocity tail swaps")
    p_run.add_argument("--cut_gate", type=float, default=None,
                       help="crossing identity-cut separation gate "
                            "(default 0.03; flat optimum 0.03-0.05 across "
                            "extractors, docs/PERF.md r5); needs "
                            "--crossings")
    p_run.add_argument("--mesh", default=None, metavar="SPEC",
                       help="multi-device sharding of the tracker stages, "
                            "e.g. cameras=4,clusters=8,tracks=8 (any "
                            "subset); shards the similarity assembly / "
                            "per-cluster ALS solves / per-slot IK solves "
                            "over the visible devices")
    p_run.add_argument("--debug_dump", default=None, metavar="DIR",
                       help="per-frame association diagnostics: similarity "
                            "matrix csv/npz, ALS X + |X-0.5| margins, group "
                            "parse, track->detection distances (the "
                            "reference's xlsx/crop debug surface)")
    p_run.add_argument("--debug_frames", default=None,
                       help="comma-separated frame indices for --debug_dump "
                            "(default: every frame where a track dies, "
                            "capped at 20)")
    _add_common(p_run)

    p_det = sub.add_parser(
        "detect",
        help="camera frames -> tracklets, no OpenPose: the keypoint CNN on "
             "the device, then association/tracking/IK",
    )
    p_det.add_argument("--image_dir", required=True,
                       help="root with one subdir of frame images per camera")
    p_det.add_argument("--calib_dir", required=True)
    p_det.add_argument("--out_dir", required=True)
    p_det.add_argument("--params", default=None,
                       help="CNN parameter checkpoint (models.checkpoint); "
                            "defaults to the shipped checkpoint "
                            "(posenet_synth.npz) if present")
    p_det.add_argument("--smoke", action="store_true",
                       help="allow running with RANDOM-INIT weights (output "
                            "is noise; pipeline smoke-testing only)")
    p_det.add_argument("--crop_h", type=int, default=512)
    p_det.add_argument("--crop_w", type=int, default=384)
    p_det.add_argument("--no_ik", action="store_true")
    p_det.add_argument("--appearance", action="store_true",
                       help="appearance-evidence association: the detector "
                            "also emits keypoint-color-layout embeddings "
                            "and the tracker uses them to disambiguate "
                            "crossings (bottom-up checkpoint only)")
    p_det.add_argument("--crossings", action="store_true",
                       help="hindsight crossing resolution post-pass "
                            "(see run --crossings); most effective with "
                            "--appearance")
    p_det.add_argument("--cut_gate", type=float, default=None,
                       help="crossing identity-cut separation gate "
                            "(see run --cut_gate)")
    p_det.add_argument("--appearance_head", default="auto",
                       metavar="PATH|auto|none",
                       help="metric-learned embedding head refining the "
                            "color-layout descriptor. 'auto' (the default) "
                            "uses the shipped checkpoint when present; "
                            "'none' keeps the raw descriptor")
    _add_common(p_det)

    p_viz = sub.add_parser("viz", help="render tracklets to video")
    p_viz.add_argument("--tracklets", required=True)
    p_viz.add_argument("--calib_dir", required=True)
    p_viz.add_argument("--out", required=True)
    p_viz.add_argument("--image_dir", default=None,
                       help="optional dir with per-cam frame images")
    p_viz.add_argument("--animate_3d", default=None, metavar="PATH",
                       help="also export an animated 3D skeleton playback "
                            "(mp4; falls back to gif without ffmpeg) — the "
                            "reference's FuncAnimation window, exported")
    _add_common(p_viz)

    from multiview_motion_capture_torch import bench

    p_bench = sub.add_parser("bench", help="the Shelf end-to-end benchmark: bench.py's "
                                               "JSON line")
    p_bench.add_argument("--data_dir", default=str(bench.SHELF_DIR),
                         help="the Shelf sequence: kps_opn/ (OpenPose JSON) and "
                              "calibs/ (default: %(default)s)")
    p_bench.add_argument("--cpu", action="store_true",
                         help="run on the CPU (the kernels' plain PyTorch versions); "
                              "without it the run needs an NVIDIA GPU")

    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.mode == "prepare":
        from multiview_motion_capture_torch import pipeline

        cfg = _config(args, n_views=0)
        batch = pipeline.prepare(Path(args.kps_dir), Path(args.out), cfg,
                                 max_frames=args.max_frames)
        print(f"packed {batch.n_frames} frames x {batch.n_views} views -> {args.out}")
        return 0

    if args.mode == "run":
        from multiview_motion_capture_torch import pipeline
        from multiview_motion_capture_torch.cameras import CameraBank
        from multiview_motion_capture_torch.data.ingest import (
            load_frame_batch,
            load_openpose_dir,
        )
        from multiview_motion_capture_torch.utils.precision import resolve_device

        resolve_device(device)
        cams = CameraBank.from_json_dir(Path(args.calib_dir))
        cfg = _config(args, n_views=cams.n_views)
        if args.frames_npz:
            batch = load_frame_batch(Path(args.frames_npz))
        elif args.kps_dir:
            batch = load_openpose_dir(Path(args.kps_dir), cfg, max_frames=args.max_frames)
        else:
            parser.error("run needs --kps_dir or --frames_npz")
        res = pipeline.run(batch, cams, cfg, use_ik=not args.no_ik,
                           reid=args.reid, crossings=args.crossings,
                           crossings_cfg=_crossings_cfg(args), mesh_spec=args.mesh,
                           device=device)
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        pipeline.save_tracklets(out_dir / "tracklets.pkl", res.tracklets)
        if args.debug_dump:
            from multiview_motion_capture_torch import debug as dbg
            from multiview_motion_capture_torch.data.ingest import filter_bad_poses
            from multiview_motion_capture_torch.tracker import TrackerContext

            fb = filter_bad_poses(batch, cfg)
            nmax = min(fb.n_frames, cfg.max_frames) if cfg.max_frames else fb.n_frames
            dbg_frames = ([int(x) for x in args.debug_frames.split(",")]
                          if args.debug_frames else None)
            ctx = TrackerContext.build(cams, cfg, use_ik=not args.no_ik, device=device)
            paths = dbg.dump_association_debug(
                ctx, fb.kps[:nmax], fb.valid[:nmax], Path(args.debug_dump),
                frames=dbg_frames,
            )
            print(f"debug dump: {len(paths)} frames -> {args.debug_dump}")
        if args.bvh and not args.no_ik:
            from multiview_motion_capture_torch.utils.bvh import export_tracklet_bvh

            for t in res.tracklets:
                export_tracklet_bvh(out_dir / f"track_{t.track_id:03d}.bvh", t)
        print(json.dumps({
            "n_frames": res.n_frames,
            "fps": round(res.fps, 2),
            "n_tracklets": len(res.tracklets),
            "top_lengths": sorted((len(t) for t in res.tracklets), reverse=True)[:5],
            "out": str(out_dir / "tracklets.pkl"),
        }))
        return 0

    if args.mode == "detect":
        from multiview_motion_capture_torch.cameras import CameraBank
        from multiview_motion_capture_torch.utils.precision import resolve_device

        resolve_device(device)
        cams = CameraBank.from_json_dir(Path(args.calib_dir))
        cfg = _config(args, n_views=cams.n_views)
        try:
            images = read_image_dir(Path(args.image_dir), cams.n_views, args.max_frames)
            line = detect_frames(images, cams, cfg, Path(args.out_dir), params=args.params,
                                 smoke=args.smoke, crop_hw=(args.crop_h, args.crop_w),
                                 use_ik=not args.no_ik, appearance=args.appearance,
                                 crossings=args.crossings,
                                 crossings_cfg=_crossings_cfg(args),
                                 appearance_head=args.appearance_head, device=device)
        except UsageError as e:
            parser.error(str(e))
        print(json.dumps(line))
        return 0

    if args.mode == "viz":
        from multiview_motion_capture_torch import pipeline
        from multiview_motion_capture_torch.cameras import CameraBank
        from multiview_motion_capture_torch.utils.viz import render_tracklets_video

        cams = CameraBank.from_json_dir(Path(args.calib_dir))
        tlets = pipeline.load_tracklets(Path(args.tracklets))
        frame_images = None
        if args.image_dir:
            import cv2

            frame_images = {}
            root = Path(args.image_dir)
            cam_dirs = sorted([d for d in root.iterdir() if d.is_dir()])
            per_cam = [sorted(d.glob("*.jpg")) for d in cam_dirs]
            n = min(len(x) for x in per_cam) if per_cam else 0
            for f in range(n):
                frame_images[f] = [cv2.imread(str(per_cam[v][f]))
                                   for v in range(len(cam_dirs))]
        out = render_tracklets_video(tlets, cams, Path(args.out),
                                     frame_images=frame_images)
        print(f"wrote {out}")
        if args.animate_3d:
            from multiview_motion_capture_torch.utils.viz import animate_tracklets_3d

            out3d = animate_tracklets_3d(tlets, Path(args.animate_3d))
            print(f"wrote {out3d}")
        return 0

    if args.mode == "bench":
        bench.main(Path(args.data_dir), device=device)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
