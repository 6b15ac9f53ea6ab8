"""Detect+track benchmark of the PyTorch/CUDA port (BASELINE config 5): raw
camera frames -> tracklets, in frames/s.

The counterpart of `scripts/bench_detect.py`: the same frames, detectors,
five detection timings, tracking stage and JSON line
(`detect_track_e2e_fps`), on the port's package:

- full-frame person proposal (center channel, multi-peak NMS) -> crops on
  the device -> top-down keypoint CNN (`make_multi_person_detector`, the
  cascade, random weights from `torch.Generator` seed 0: the CNN's work is
  the same whether the weights are trained or random);
- the single-pass bottom-up detector (`make_bottom_up_detector`) with the
  shipped PoseNet checkpoint's weights (read as data from the JAX
  package's directory, as the CLI reads it; random weights of its
  architecture when the file is absent);
- `pipeline.run(use_ik=True)` on the ground-truth detections at the same
  scale (ALS kernel B1 `csrc/als.cu`, LM solve kernel B2
  `csrc/gj_solve.cu`).

The frames are synthetic blob renders at half Shelf resolution (516 x 388,
5 cameras), fed as uint8: the CNN's work is resolution-realistic, only the
pixels are fake.

Host reads in the timed loops: none inside the detectors (no `.cpu()`,
`.item()` or host-to-device copy of a constant).  Each loop synchronises
the device once, at its end, as the JAX program blocks once.  The
"with upload" loops copy each frame from pageable host memory, which
waits for the stream's earlier work (the JAX loop's per-frame
`jnp.asarray` upload); the staged loops read frames already on the card;
the overlapped loop copies frame f+1 from pinned memory on a side stream
before frame f's forward (`data.detect.FrameUploader`, the pattern of
`frames_to_frame_batch`).

    python scripts/torch_bench_detect.py [--frames 100] [--cpu]

Runs on the card unless `--cpu` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SCALE = 0.5
FRAME_HW = (388, 516)
CROP_HW = (256, 192)


def make_frames(n_frames: int, n_people: int, n_views: int):
    """The scene, its calibration at the frames' scale and its renders:
    (cfg, seq, cams_small, kps_px (F, V, P, 17, 2), images (F, V, H, W, 3)
    f32 in [0, 1])."""
    from examples.torch_e2e_fullframe import render_frame, scaled_cameras
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    cfg = PipelineConfig(n_views=n_views, max_people=6, max_tracks=8,
                         max_frames=None, als_max_iter=100,
                         ik_warm_stages=1, ik_solver="gj")
    seq = synthetic_sequence(n_frames=n_frames, n_people=n_people,
                             n_views=n_views, cfg=cfg, noise_px=0.0,
                             drop_prob=0.0, seed=0)
    cams_small = scaled_cameras(seq.cameras, SCALE)
    rng = np.random.RandomState(0)
    joint_colors = rng.uniform(0.3, 1.0, size=(17, 3))
    kps_px = seq.batch.kps[..., :2] * SCALE

    print("rendering frames...", file=sys.stderr)
    images = np.stack([
        np.stack([
            render_frame(kps_px[f, v], seq.batch.valid[f, v], joint_colors,
                         hw=FRAME_HW, sigma=3.0)
            for v in range(n_views)
        ]) for f in range(n_frames)
    ]).astype(np.float32)
    return cfg, seq, cams_small, kps_px, images


def detectors(cfg, dev: torch.device) -> dict:
    """The cascade (random init) and the bottom-up detector (the shipped
    checkpoint's weights when present) on `dev`."""
    from multiview_motion_capture_torch.__main__ import CHECKPOINTS
    from multiview_motion_capture_torch.data.detect import (
        make_bottom_up_detector,
        make_multi_person_detector,
    )
    from multiview_motion_capture_torch.models.checkpoint import load_posenet
    from multiview_motion_capture_torch.models.pose_net import PoseNetConfig, init_posenet

    mcfg = PoseNetConfig(img_hw=CROP_HW, predict_center=True)
    net = init_posenet(mcfg, torch.Generator().manual_seed(0)).to(dev).eval()
    detect = make_multi_person_detector(mcfg, max_people=cfg.max_people, crop_hw=CROP_HW)

    # SINGLE-PASS bottom-up path: the shipped checkpoint's architecture
    # (weights from the checkpoint when present; throughput is identical
    # with random weights)
    shipped = CHECKPOINTS / "posenet_synth.npz"
    if shipped.exists():
        bu_cfg, bu_net = load_posenet(shipped, device=dev)
    else:
        bu_cfg = PoseNetConfig(img_hw=(192, 256), stage_features=(64, 128, 256),
                               blocks_per_stage=2, head_features=128,
                               predict_center=True, predict_offsets=True)
        bu_net = init_posenet(bu_cfg, torch.Generator().manual_seed(0)).to(dev).eval()
    detect_bu = make_bottom_up_detector(bu_cfg, max_people=cfg.max_people)
    return {"mcfg": mcfg, "net": net, "detect": detect, "bu_cfg": bu_cfg,
            "bu_net": bu_net, "detect_bu": detect_bu, "shipped": shipped.exists()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_with_upload(detect, net, frames_u8: np.ndarray, dev: torch.device) -> float:
    """Seconds for one detector call a frame, each frame copied from
    pageable host memory inside the loop; one synchronisation at the end."""
    t0 = time.perf_counter()
    for f in range(frames_u8.shape[0]):
        detect(net, torch.as_tensor(frames_u8[f], device=dev))
    _sync(dev)
    return time.perf_counter() - t0


def time_staged(detect, net, staged: torch.Tensor) -> float:
    """Seconds for one detector call a frame on frames already on the
    device (the host-to-device link left out); one synchronisation."""
    t0 = time.perf_counter()
    for f in range(staged.shape[0]):
        detect(net, staged[f])
    _sync(staged.device)
    return time.perf_counter() - t0


def time_overlapped(detect, net, frames_u8: np.ndarray, dev: torch.device) -> float:
    """Seconds for one detector call a frame, frame f+1's copy issued from
    pinned memory on a side stream before frame f's forward; one
    synchronisation at the end."""
    from multiview_motion_capture_torch.data.detect import FrameUploader

    up = FrameUploader(dev)
    n = frames_u8.shape[0]
    nxt = up.start(frames_u8[0])
    t0 = time.perf_counter()
    for f in range(n):
        cur = up.take(nxt)
        if f + 1 < n:
            nxt = up.start(frames_u8[f + 1])
        detect(net, cur)
    _sync(dev)
    return time.perf_counter() - t0


def tracking_batch(seq, kps_px):
    """The ground-truth detections at the frames' scale, as a FrameBatch."""
    from multiview_motion_capture_torch.data.ingest import FrameBatch

    return FrameBatch(
        kps=np.concatenate([kps_px, seq.batch.kps[..., 2:]], axis=-1).astype(np.float32),
        valid=seq.batch.valid,
    )


def main(n_frames=100, n_people=3, n_views=5, steps=0, device="cuda"):
    """Print the benchmark's JSON line for `n_frames` frames on `device`
    ("cuda" unless the caller asks for "cpu") and return it."""
    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.ops import cuda_lib
    from multiview_motion_capture_torch.utils.precision import resolve_device

    dev = resolve_device(device)
    cfg, seq, cams_small, kps_px, images = make_frames(n_frames, n_people, n_views)
    d = detectors(cfg, dev)
    detect, net, detect_bu, bu_net = d["detect"], d["net"], d["detect_bu"], d["bu_net"]

    # uint8 on the wire: 1 byte/px host->device (f32 quadruples the transfer)
    images_u8 = (images * 255).astype(np.uint8)

    # warm up: first use of each convolution and decoder
    detect(net, torch.as_tensor(images_u8[0], device=dev))
    detect_bu(bu_net, torch.as_tensor(images_u8[0], device=dev))
    _sync(dev)

    # timed: per-frame detection over the sequence, including host->device
    # frame upload (the CNN work is identical whether the weights are
    # trained or random, so random weights give the true throughput; the
    # tracking stage below uses ground-truth detections)
    detect_s = time_with_upload(detect, net, images_u8, dev)
    # device-compute-bound variant: frames staged on the device up front,
    # so the number excludes the host->device link
    staged = torch.as_tensor(images_u8, device=dev)
    _sync(dev)
    detect_staged_s = time_staged(detect, net, staged)
    # bottom-up timings (same protocol)
    bu_s = time_with_upload(detect_bu, bu_net, images_u8, dev)
    bu_staged_s = time_staged(detect_bu, bu_net, staged)
    # overlapped upload: frame f+1's copy before frame f's forward
    bu_overlap_s = time_overlapped(detect_bu, bu_net, images_u8, dev)

    # tracking stage at the same scale (real detections)
    before = {k.name: k.launches for k in cuda_lib.ALL_KERNELS}
    res = pipeline.run(tracking_batch(seq, kps_px), cams_small, cfg, use_ik=True, device=dev)
    launches = {k.name: k.launches - before[k.name] for k in cuda_lib.ALL_KERNELS}

    # headline: the single-pass bottom-up path (the shipped architecture)
    e2e_fps = n_frames / (bu_staged_s + res.track_time_s)
    line = {
        "metric": "detect_track_e2e_fps",
        "value": round(e2e_fps, 2),
        "unit": "frames/s",
        "extra": {
            "bottom_up_fps_staged": round(n_frames / bu_staged_s, 2),
            "bottom_up_fps_incl_upload": round(n_frames / bu_s, 2),
            "bottom_up_fps_upload_overlap": round(n_frames / bu_overlap_s, 2),
            "cascade_fps_staged": round(n_frames / detect_staged_s, 2),
            "cascade_fps_incl_upload": round(n_frames / detect_s, 2),
            "cascade_e2e_fps": round(
                n_frames / (detect_staged_s + res.track_time_s), 2),
            "track_fps": round(res.fps, 2),
            "n_frames": n_frames,
            "n_views": n_views,
            "frame_hw": FRAME_HW,
            "crop_hw": CROP_HW,
            "cascade_model_input": d["mcfg"].img_hw,
            "bottom_up_model_input": tuple(d["bu_cfg"].img_hw),
            "bottom_up_ckpt": d["shipped"],
            "backend": dev.type,
            "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
            # both pipeline.run passes (warm and timed)
            "kernel_launches": launches,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    main(n_frames=args.frames, device="cpu" if args.cpu else "cuda")
