"""End-to-end appearance study with the real extractor, on the PyTorch/CUDA
port: the counterpart of `scripts/appearance_e2e_study.py`.

Renders a multi-person crowd with stable per-person clothing tints, runs
the shipped bottom-up detector with `return_appearance=True`
(keypoint-color-layout embeddings from the same forward; `--head` adds
the shipped metric-learned head), labels each detection with its nearest
ground-truth person, and tracks in triangulation mode (B1) with the
appearance term off and on (static gains, the auto gain, the crossing
repair): raw and re-ID-merged IDF1 and ID switches per row.

    python scripts/torch_appearance_e2e_study.py [--people 4] [--frames 60]
        [--dist 1.2] [--nms 5] [--scale 1.0] [--head] [--gate_sweep] [--cpu]

`--scale F` renders and detects at F x (192, 256) and rescales the
detected keypoints and centres back into the unchanged quarter-scale
camera space, so every pixel-calibrated tracker constant holds and only
detection and embedding quality move.  The shipped weights are read from
the JAX package's checkpoint directory as data (`__main__.CHECKPOINTS`).
Runs on the card unless `--cpu` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples.torch_e2e_fullframe import scaled_cameras  # noqa: E402
from multiview_motion_capture_torch import pipeline  # noqa: E402
from multiview_motion_capture_torch.__main__ import CHECKPOINTS  # noqa: E402
from multiview_motion_capture_torch.config import PipelineConfig  # noqa: E402
from multiview_motion_capture_torch.crossings import CrossingConfig  # noqa: E402
from multiview_motion_capture_torch.data.detect import (  # noqa: E402
    frames_to_frame_batch,
    make_bottom_up_detector,
)
from multiview_motion_capture_torch.data.detect_train import render_sequence  # noqa: E402
from multiview_motion_capture_torch.data.render import RenderConfig  # noqa: E402
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence  # noqa: E402
from multiview_motion_capture_torch.eval import identity_metrics  # noqa: E402
from multiview_motion_capture_torch.models.checkpoint import (  # noqa: E402
    load_appearance_head,
    load_posenet,
)
from multiview_motion_capture_torch.reid import merge_tracklets  # noqa: E402
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402

CKPT = CHECKPOINTS / "posenet_synth.npz"
HEAD = CHECKPOINTS / "appearance_head.npz"
# 4 well-separated people (the shipped checkpoint trains on 1-4 a view);
# the flags set the crowd, the centre NMS window and the render scale
N_PEOPLE = 4
N_VIEWS = 5
N_FRAMES = 60
MIN_DIST = 1.2
NMS = 5
SCALE = 1.0
GATES = (0.015, 0.02, 0.05, 0.08)


def hue_tints(n_people: int) -> np.ndarray:
    """Distinct stable "clothing": hue-spread tints (n_people, 3)."""
    hues = np.linspace(0, 1, n_people, endpoint=False)
    return np.stack([
        1.0 + 0.5 * np.stack([np.cos(2 * np.pi * h),
                              np.cos(2 * np.pi * (h + 1 / 3)),
                              np.cos(2 * np.pi * (h + 2 / 3))])
        for h in hues
    ]).astype(np.float32)


def rescaled(detect, scale: float):
    """`detect` with its keypoints and centres mapped back by 1 / scale."""
    def wrapped(net, images):
        kps, centers, valid, emb = detect(net, images)
        inv = torch.tensor([1.0 / scale, 1.0 / scale, 1.0], dtype=kps.dtype,
                           device=kps.device)
        centers = torch.cat([centers[..., :2] * (1.0 / scale), centers[..., 2:]], dim=-1)
        return kps * inv, centers, valid, emb
    return wrapped


def _label_detections(seq, batch, app):
    """Detector slots are not the generator's slots: each valid detection
    gets the person of its nearest projected ground truth (within 40 px),
    (F, V, P) labels, and the embeddings' mean cosine within and across
    people."""
    ws = 0.25
    F, V, P = batch.valid.shape
    det_slot_person = np.full((F, V, P), -1, dtype=np.int32)
    embs, labels = [], []
    for f in range(F):
        for v in range(V):
            gt = seq.batch.kps[f, v][..., :2] * ws
            slotp = seq.gt_slot_person[f, v]
            for d in range(P):
                if not batch.valid[f, v, d]:
                    continue
                errs = [np.nanmean(np.linalg.norm(
                    batch.kps[f, v, d, :, :2] - gt[s], axis=-1))
                    if slotp[s] >= 0 else 1e9 for s in range(gt.shape[0])]
                s_best = int(np.argmin(errs))
                if errs[s_best] < 40:
                    det_slot_person[f, v, d] = int(slotp[s_best])
                    embs.append(app[f, v, d])
                    labels.append(int(slotp[s_best]))
    embs = np.stack(embs)
    labels = np.asarray(labels)
    cos = embs @ embs.T
    same = float(cos[labels[:, None] == labels[None, :]].mean())
    diff = float(cos[labels[:, None] != labels[None, :]].mean())
    return det_slot_person, (same, diff)


def detect_scene(args, dev):
    """The rendered scene detected: (cfg, seq, batch, app, scaled cameras,
    extractor name)."""
    mcfg, net = load_posenet(CKPT, device=dev)
    cfg = PipelineConfig(n_views=N_VIEWS, max_people=max(8, args.people + 2),
                         max_tracks=max(12, 2 * args.people),
                         max_frames=None, als_max_iter=100, ik_warm_stages=1,
                         ik_solver="gj", track_rescue_px=0.0)
    seq = synthetic_sequence(n_frames=args.frames, n_people=args.people,
                             n_views=N_VIEWS, cfg=cfg, seed=1, noise_px=0.0,
                             drop_prob=0.0, min_person_distance=args.dist)
    s = args.scale
    hw = (int(round(192 * s)), int(round(256 * s)))
    images = render_sequence(
        seq, RenderConfig(hw=hw, limb_sigma=1.6 * s, joint_sigma=2.0 * s),
        world_scale=0.25 * s, seed=2, person_tints=hue_tints(args.people))
    cams_small = scaled_cameras(seq.cameras, 0.25)
    head = load_appearance_head(HEAD, device=dev)[1] if args.head else None
    detect = make_bottom_up_detector(mcfg, max_people=cfg.max_people, full_hw=hw,
                                     center_min_score=0.2, center_nms_window=args.nms,
                                     return_appearance=True, appearance_head=head)
    if s != 1.0:
        detect = rescaled(detect, s)
    batch, app = frames_to_frame_batch(detect, net, images, cfg, collect_appearance=True)
    return cfg, seq, batch, app, cams_small, "color_layout+head" if head else "color_layout"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--people", type=int, default=N_PEOPLE)
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--dist", type=float, default=MIN_DIST)
    ap.add_argument("--nms", type=int, default=NMS)
    ap.add_argument("--scale", type=float, default=SCALE)
    ap.add_argument("--head", action="store_true")
    ap.add_argument("--gate_sweep", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg, seq, batch, app, cams_small, extractor = detect_scene(args, dev)
    det_slot_person, (same, diff) = _label_detections(seq, batch, app)

    def score(appearance, crossings=False, crossings_cfg=None, **over):
        c = (dataclasses.replace(cfg, appearance_dim=app.shape[-1], **over)
             if appearance else cfg)
        res = pipeline.run(batch, cams_small, c, use_ik=False,
                           app=app if appearance else None,
                           crossings=crossings, crossings_cfg=crossings_cfg, device=dev)
        m_raw = identity_metrics(res.tracklets, det_slot_person)
        m_reid = identity_metrics(merge_tracklets(res.tracklets), det_slot_person)
        return {
            "raw_tracks": m_raw.n_pred_tracks,
            "raw_idf1": round(m_raw.idf1, 3),
            "raw_idsw": m_raw.id_switches,
            "reid_idf1": round(m_reid.idf1, 3),
            "reid_idsw": m_reid.id_switches,
        }

    out = {
        "extractor": extractor,
        "extractor_cos_same": round(same, 3),
        "extractor_cos_diff": round(diff, 3),
        "geometry_only": score(False),
        "appearance_gain60": score(True, appearance_gain_px=60.0),
        # the oracle-tuned default gain, too weak for this extractor's gap
        "appearance_gain20_default": score(True),
        # online auto-calibration: the static gain left at the default,
        # target 8 px per true-vs-false swap
        "appearance_auto_target8": score(True, appearance_auto_target_px=8.0),
        # hindsight crossing repair (cuts and the implied merge inside
        # pipeline.run: this row's raw_* fields are already post-merge)
        "appearance_crossings": score(True, crossings=True),
        # packed scenes push the best static gain up: the crossing pass over
        # gain and the auto rule
        "appearance_gain40": score(True, appearance_gain_px=40.0),
        "appearance_crossings_gain40": score(True, crossings=True, appearance_gain_px=40.0),
        "appearance_crossings_gain60": score(True, crossings=True, appearance_gain_px=60.0),
        "appearance_crossings_auto20": score(True, crossings=True,
                                             appearance_auto_target_px=20.0),
    }
    if args.gate_sweep:
        # the crossing cut gate on this scene's extractor at its best
        # static gain
        for g in GATES:
            out[f"crossings_gain60_gate{g}"] = score(
                True, crossings=True, crossings_cfg=CrossingConfig(cut_gate=g),
                appearance_gain_px=60.0)
    line = {"metric": "appearance_e2e_study", "extra": out}
    print(json.dumps(line, indent=1), flush=True)
    return line


if __name__ == "__main__":
    main()
