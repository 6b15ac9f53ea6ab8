"""Dense-crowd detection diagnosis on the PyTorch/CUDA port: the
counterpart of `scripts/crowd_detect_study.py`.  On the shipped
bottom-up checkpoint, against crowd density (4, 6, 8, 10 people at
shrinking distances), in stages:

  A. detection recall and precision (and recall over the people a
     detector could see: at least 5 joints left visible by occlusion),
  B. centre recall alone (does the centre channel fire per person?),
  C. oracle-centre decode (ground-truth centres injected, the network's
     offsets and the keypoint snap): grouping and offset quality apart
     from centre detection,
  D. centre collisions (how close ground-truth centres come in heatmap
     pixels against the NMS window).

    python scripts/torch_crowd_detect_study.py [--people 10] [--frames 8]
        [--ckpt PATH] [--nms 5] [--cpu]

No TPU kernel lies on this path (the forward is cuDNN's convolutions).
Runs on the card unless `--cpu` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from multiview_motion_capture_torch.__main__ import CHECKPOINTS  # noqa: E402
from multiview_motion_capture_torch.config import PipelineConfig  # noqa: E402
from multiview_motion_capture_torch.data.detect import make_bottom_up_detector  # noqa: E402
from multiview_motion_capture_torch.data.detect_train import (  # noqa: E402
    _cam_locations,
    evaluate_detections,
    render_sequence,
)
from multiview_motion_capture_torch.data.render import RenderConfig, render_scene  # noqa: E402
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence  # noqa: E402
from multiview_motion_capture_torch.models.checkpoint import load_posenet  # noqa: E402
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402

CKPT = CHECKPOINTS / "posenet_synth.npz"
WS = 0.25  # world px -> render px
# (people, minimum distance m), scripts/crowd_detect_study.py:173
DENSITIES = [(4, 1.2), (6, 0.8), (8, 0.5), (10, 0.3)]
N_VIEWS = 5


def gt_arrays(seq, n_frames, n_views):
    """(N, P, K, 2) gt kps in render px + (N, P) presence, flattened over
    (frame, view) samples."""
    kps, pres = [], []
    for f in range(n_frames):
        for v in range(n_views):
            kps.append(seq.batch.kps[f, v][..., :2] * WS)
            pres.append(seq.batch.valid[f, v])
    return np.stack(kps), np.stack(pres)


def visibility_arrays(seq, n_frames, n_views, render_cfg, seed):
    """Re-render with the owner map to get per-joint visibility ground truth
    (the rng draws of render_sequence, so the images match bit for bit)."""
    rng = np.random.RandomState(seed)
    cam_loc = _cam_locations(seq.cameras)
    vis = []
    for f in range(n_frames):
        for v in range(n_views):
            kv = seq.batch.kps[f, v][..., :2] * WS
            pres = seq.batch.valid[f, v]
            slot_p = seq.gt_slot_person[f, v]
            depth = np.array([
                np.linalg.norm(seq.gt_3d[f, slot_p[s], 11] - cam_loc[v])
                if slot_p[s] >= 0 else 1e9 for s in range(len(pres))
            ])
            _, vv = render_scene(kv, pres, depth, rng, render_cfg, return_visibility=True)
            vis.append(vv)
    return np.stack(vis)


def center_stats(gt_kps, gt_pres):
    """Min pairwise GT-center distance per sample, in heatmap px."""
    dists = []
    for i in range(gt_kps.shape[0]):
        c = gt_kps[i][gt_pres[i]].mean(axis=1) / 4.0  # heatmap px
        if len(c) < 2:
            continue
        d = np.linalg.norm(c[:, None] - c[None], axis=-1)
        d[np.arange(len(c)), np.arange(len(c))] = np.inf
        dists.append(d.min(axis=1))
    d = np.concatenate(dists)
    return {
        "min_center_dist_hm_px_p10": round(float(np.percentile(d, 10)), 2),
        "median": round(float(np.median(d)), 2),
        "frac_under_3px": round(float((d < 3).mean()), 3),
        "frac_under_5px": round(float((d < 5).mean()), 3),
    }


def center_recall(centers, valid, gt_kps, gt_pres, match_px=10.0):
    """Fraction of GT people with a detected center within match_px
    (frame px)."""
    n_gt, n_hit = 0, 0
    for i in range(centers.shape[0]):
        gt_c = gt_kps[i][gt_pres[i]].mean(axis=1)
        n_gt += len(gt_c)
        det_c = centers[i][valid[i]][:, :2]
        used = np.zeros(len(det_c), bool)
        for g in gt_c:
            if len(det_c) == 0:
                continue
            d = np.linalg.norm(det_c - g, axis=-1)
            d[used] = np.inf
            j = int(np.argmin(d))
            if d[j] < match_px:
                used[j] = True
                n_hit += 1
    return n_hit / max(n_gt, 1)


def oracle_center_decode(mcfg, net, images_flat, gt_kps, gt_pres):
    """Run the net, but group with GT centers: isolates offset/snap quality
    from center detection.  `net` maps (B, H, W, 3) images on its device
    to the heat (B, H/4, W/4, C)."""
    K = mcfg.n_kps
    P = gt_kps.shape[1]
    N = images_flat.shape[0]
    det = np.zeros((N, P, K, 3), np.float32)
    val = np.zeros((N, P), bool)
    dev = next(net.parameters()).device if isinstance(net, torch.nn.Module) else None
    for s in range(0, N, 16):
        e = min(N, s + 16)
        with torch.no_grad():
            heat = net(torch.as_tensor(images_flat[s:e], device=dev)).float().cpu().numpy()
        H, W = heat.shape[1:3]
        for i in range(e - s):
            gi = s + i
            gt_c = gt_kps[gi].mean(axis=1) / 4.0  # heatmap px
            for p in range(P):
                if not gt_pres[gi, p]:
                    continue
                cx = int(np.clip(round(gt_c[p, 0]), 0, W - 1))
                cy = int(np.clip(round(gt_c[p, 1]), 0, H - 1))
                offs = heat[i, cy, cx, K + 1:].reshape(K, 2)
                reg = gt_c[p] + offs
                # snap: local max in a 7x7 window of each kp channel
                for k in range(K):
                    rx = int(np.clip(round(reg[k, 0]), 0, W - 1))
                    ry = int(np.clip(round(reg[k, 1]), 0, H - 1))
                    y0, x0 = max(0, ry - 3), max(0, rx - 3)
                    win = heat[i, y0:y0 + 7, x0:x0 + 7, k]
                    pk = float(win.max()) if win.size else 0.0
                    if pk > 0.15:
                        yy, xx = np.unravel_index(int(win.argmax()), win.shape)
                        det[gi, p, k] = [(x0 + xx) * 4, (y0 + yy) * 4, pk]
                    else:
                        det[gi, p, k] = [reg[k, 0] * 4, reg[k, 1] * 4, 0.1]
                val[gi, p] = True
    return det, val


def density_row(mcfg, net, npp: int, dist: float, n_frames: int, nms: int) -> dict:
    """One density's four stages."""
    cfg = PipelineConfig(n_views=N_VIEWS, max_people=npp + 4)
    seq = synthetic_sequence(n_frames=n_frames, n_people=npp, n_views=N_VIEWS, cfg=cfg,
                             seed=1, noise_px=0.0, drop_prob=0.0, min_person_distance=dist)
    images = render_sequence(seq, RenderConfig(hw=(192, 256)), world_scale=WS, seed=2)
    gt_kps, gt_pres = gt_arrays(seq, n_frames, N_VIEWS)
    flat = images.reshape(-1, 192, 256, 3)

    detect = make_bottom_up_detector(mcfg, max_people=cfg.max_people,
                                     center_min_score=0.2, center_nms_window=nms)
    kps_l, ctr_l, val_l = [], [], []
    for f in range(n_frames):
        k, c, v = detect(net, images[f])
        kps_l.append(k.cpu().numpy())
        ctr_l.append(c.cpu().numpy())
        val_l.append(v.cpu().numpy())
    det_kps = np.concatenate(kps_l)
    centers = np.concatenate(ctr_l)
    det_val = np.concatenate(val_l)

    # physical limit: people with < 5 visible joints after occlusion
    # cannot be detected from this view by any detector
    vis = visibility_arrays(seq, n_frames, N_VIEWS, RenderConfig(hw=(192, 256)), seed=2)
    detectable = gt_pres & (vis.sum(axis=-1) >= 5)

    ev = evaluate_detections(det_kps, det_val, gt_kps, gt_pres)
    ev_d = evaluate_detections(det_kps, det_val, gt_kps, detectable)
    c_rec = center_recall(centers, det_val, gt_kps, gt_pres)
    o_kps, o_val = oracle_center_decode(mcfg, net, flat, gt_kps, gt_pres)
    ev_o = evaluate_detections(o_kps, o_val, gt_kps, gt_pres)
    return {
        "recall": round(ev["recall"], 3),
        "recall_detectable": round(ev_d["recall"], 3),
        "frac_detectable": round(float(detectable.sum()) / max(int(gt_pres.sum()), 1), 3),
        "precision": round(ev["precision"], 3),
        "err_px": round(ev["mean_err_px"], 2),
        "center_recall": round(c_rec, 3),
        "oracle_center_recall": round(ev_o["recall"], 3),
        "oracle_center_err_px": round(ev_o["mean_err_px"], 2),
        "centers": center_stats(gt_kps, gt_pres),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--people", type=int, default=10)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--nms", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    mcfg, net = load_posenet(Path(args.ckpt), device=dev)
    out = {}
    for npp, dist in DENSITIES:
        if npp > max(args.people, 4):
            continue
        out[f"p{npp}_d{dist}"] = density_row(mcfg, net, npp, dist, args.frames, args.nms)
        print(npp, dist, json.dumps(out[f"p{npp}_d{dist}"]), file=sys.stderr, flush=True)
    line = {"metric": "crowd_detect_study", "extra": out}
    print(json.dumps(line, indent=1), flush=True)
    return line


if __name__ == "__main__":
    main()
