"""Detector robustness to held-out render styles, on the PyTorch/CUDA port:
the counterpart of `scripts/detector_style_holdout.py`.

The shipped checkpoint trains and evaluates on one renderer with one style
distribution; held-out seeds do not test a shift.  This evaluates it on
six styles outside the training distribution (training used
RenderConfig's defaults: brightness 0.7-1.15, noise 0.02, 4 background
blobs, 3 distractors, appearance jitter 0.3) on held-out seeds 3000-3002,
then calibrates the centre-score threshold on the union of three shifted
styles (the threshold with the best F1).

    python scripts/torch_detector_style_holdout.py [--seeds 3000 3001 3002] [--cpu]

A style's samples are the same at every threshold, so they are rendered
once per style.  No TPU kernel lies on this path (the forward is cuDNN's
convolutions).  Runs on the card unless `--cpu` is given; without a GPU
it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from multiview_motion_capture_torch.__main__ import CHECKPOINTS  # noqa: E402
from multiview_motion_capture_torch.data.detect import make_bottom_up_detector  # noqa: E402
from multiview_motion_capture_torch.data.detect_train import (  # noqa: E402
    evaluate_detections,
    generate_samples,
)
from multiview_motion_capture_torch.data.render import RenderConfig  # noqa: E402
from multiview_motion_capture_torch.models.checkpoint import load_posenet  # noqa: E402
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402

CKPT = CHECKPOINTS / "posenet_synth.npz"
SEEDS = [3000, 3001, 3002]
THRESHOLDS = (0.05, 0.1, 0.15, 0.2, 0.3, 0.4)
CALIBRATION_STYLES = ("dark_noisy", "bright", "cluttered")

# held-out styles: each differs from the training RenderConfig in the
# named directions; seeds 3000+ were never trained on
STYLES = {
    "in_distribution": RenderConfig(hw=(192, 256)),
    "dark_noisy": RenderConfig(hw=(192, 256), brightness_range=(0.45, 0.65),
                               noise_std=0.06),
    "bright": RenderConfig(hw=(192, 256), brightness_range=(1.2, 1.45)),
    "cluttered": RenderConfig(hw=(192, 256), bg_blobs=12,
                              distractor_segments=10),
    "clean_flat": RenderConfig(hw=(192, 256), bg_gradient=False, bg_blobs=0,
                               distractor_segments=0, noise_std=0.0),
    "heavy_palette_jitter": RenderConfig(hw=(192, 256),
                                         appearance_jitter=0.7),
}


def style_samples(render_cfg, seeds, device):
    """The (frame, view) samples of one style: 4 frames x 4 views a seed,
    2-4 people."""
    return generate_samples(seeds, render_cfg, n_frames=4, n_views=4,
                            n_people_range=(2, 4), device=device)


def eval_style(mcfg, net, render_cfg, seeds, center_min_score, samples=None):
    """Recall, precision and matched error at 12 px of the bottom-up
    detector on one style's samples (rendered here unless given)."""
    dev = next(net.parameters()).device
    ss = samples if samples is not None else style_samples(render_cfg, seeds, dev)
    detect = make_bottom_up_detector(mcfg, max_people=6, center_min_score=center_min_score)
    kps_all, val_all = [], []
    for s in range(0, ss.images.shape[0], 16):
        kps, _, valid = detect(net, ss.images[s:s + 16])
        kps_all.append(kps.cpu().numpy())
        val_all.append(valid.cpu().numpy())
    return evaluate_detections(
        np.concatenate(kps_all), np.concatenate(val_all),
        np.nan_to_num(ss.kps_px[..., :2]), ss.present, match_px=12.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=SEEDS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    mcfg, net = load_posenet(CKPT, device=dev)
    samples = {name: style_samples(rcfg, args.seeds, dev) for name, rcfg in STYLES.items()}
    out = {"styles": {}, "calibration": {}}
    for name, rcfg in STYLES.items():
        q = eval_style(mcfg, net, rcfg, args.seeds, 0.2, samples[name])
        out["styles"][name] = {k: round(float(v), 4) for k, v in q.items()}
        print(name, out["styles"][name], file=sys.stderr)

    # threshold calibration on the union of shifted styles (the
    # in-distribution control excluded): the score that maximizes F1
    for thr in THRESHOLDS:
        rs, ps = [], []
        for name in CALIBRATION_STYLES:
            q = eval_style(mcfg, net, STYLES[name], args.seeds, thr, samples[name])
            rs.append(q["recall"])
            ps.append(q["precision"])
        r, p = float(np.mean(rs)), float(np.mean(ps))
        f1 = 2 * r * p / max(r + p, 1e-9)
        out["calibration"][str(thr)] = {
            "recall": round(r, 4), "precision": round(p, 4), "f1": round(f1, 4)}
        print("thr", thr, out["calibration"][str(thr)], file=sys.stderr)

    best = max(out["calibration"].items(), key=lambda kv: kv[1]["f1"])
    out["best_threshold"] = float(best[0])
    line = {"metric": "detector_style_holdout", "extra": out}
    print(json.dumps(line, indent=1), flush=True)
    return line


if __name__ == "__main__":
    main()
