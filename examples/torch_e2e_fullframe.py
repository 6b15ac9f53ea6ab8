"""FULL-FRAME end-to-end demo of the PyTorch/CUDA port without OpenPose
(BASELINE.md config 5), on the card:

  synthetic multi-person camera frames (whole images, nobody pre-cropped)
  -> person-center proposal channel (multi-peak NMS decode)
  -> fixed-window crops around each proposal, on the device
  -> top-down keypoint CNN on the crops
  -> cross-view association + tracking -> 3D tracklets vs ground truth.

The counterpart of `examples/e2e_fullframe.py`: the same scene, renders,
training set, two-size peak-weighted training, cascade detector and
tracker, on the port's package.  The "camera images" are blob renders, so
a small network trains in seconds; everything downstream of the pixels is
the port's production path (`data.detect` cascade -> FrameBatch ->
`pipeline.run`, whose association runs the ALS kernel B1,
`csrc/als.cu`).

The training draws its batches from a `torch.Generator`, not from JAX's
PRNG, so its weights are not the JAX example's; `detect_and_track` is the
inference half on any given weights.

Run: python examples/torch_e2e_fullframe.py [--steps 400] [--cpu]
(on the card unless `--cpu` is given; without a GPU it raises).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME_HW = (192, 256)   # quarter-ish Shelf scale
CROP_HW = (128, 96)     # proposal window in frame pixels
MODEL_HW = CROP_HW      # CNN input for person crops: native crop resolution
                        # (every heatmap pixel = 4 frame px; a downscaled
                        # crop would quarter the localization precision)
FULL_HW = (96, 128)     # CNN input for the full-frame proposal pass
                        # (landscape, aspect-preserving: net is fully conv)
SCALE = 0.25            # frame px = SCALE * full Shelf-scale px
BATCH = 8               # full frames and crops a training step, each
LR = 2e-3
MATCH_PX = 12.0         # a detection within this mean distance is a hit


def render_frame(kps_xy, present, joint_colors, hw=FRAME_HW, sigma=2.0):
    """(P, 17, 2) frame-pixel keypoints (+ presence mask) -> (H, W, 3)."""
    H, W = hw
    ys = np.arange(H)[:, None, None]
    xs = np.arange(W)[None, :, None]
    img = np.zeros((H, W, 3), dtype=np.float32)
    for p in range(kps_xy.shape[0]):
        if not present[p]:
            continue
        cy = kps_xy[p, None, None, :, 1]
        cx = kps_xy[p, None, None, :, 0]
        blobs = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma ** 2))
        img = np.maximum(img, np.einsum("hwk,kc->hwc", blobs, joint_colors))
    return np.clip(img, 0, 1)


def scaled_cameras(cams, scale):
    """Quarter-resolution calibration: K' = diag(s, s, 1) K."""
    from multiview_motion_capture_torch.cameras import CameraBank

    K = np.asarray(cams.K, dtype=np.float64).copy()
    K[:, :2, :] *= scale
    wh = np.asarray(cams.img_wh, dtype=np.float64) * scale
    return CameraBank.from_k_rt(K, np.asarray(cams.Rt, dtype=np.float64), wh)


def model_config(compute_dtype=torch.bfloat16):
    """The example's PoseNet: fully convolutional, run on crops at MODEL_HW
    and on full frames at FULL_HW, with the person-center channel."""
    from multiview_motion_capture_torch.models.pose_net import PoseNetConfig

    return PoseNetConfig(img_hw=MODEL_HW, stage_features=(64, 128, 256),
                         blocks_per_stage=1, head_features=128, predict_center=True,
                         compute_dtype=compute_dtype)


@dataclasses.dataclass
class Scene:
    cfg: object            # PipelineConfig
    seq: object            # SyntheticSequence
    rng: np.random.RandomState
    kps_px: np.ndarray     # (F, V, P, 17, 2) quarter-scale frame pixels
    present: np.ndarray    # (F, V, P)
    cams_small: object     # CameraBank of the quarter-scale frames
    images: np.ndarray     # (F, V, H, W, 3) f32 in [0, 1]


def make_scene(n_frames=8, n_people=2, n_views=4, seed=0) -> Scene:
    """The scene, its ground truth and its rendered frames; `rng` has drawn
    the joint colours and draws the crops' jitter next, in the JAX
    example's order."""
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    cfg = PipelineConfig(n_views=n_views, max_people=4, max_tracks=6, max_frames=None)
    # people must be separable in image space: two subjects standing in the
    # same spot merge into one center peak (and occlude each other) in EVERY
    # ring view, not a meaningful detection demo
    seq = synthetic_sequence(n_frames=n_frames, n_people=n_people, n_views=n_views,
                             cfg=cfg, noise_px=0.0, drop_prob=0.0, seed=seed,
                             min_person_distance=1.8)
    rng = np.random.RandomState(seed)
    joint_colors = rng.uniform(0.3, 1.0, size=(17, 3))
    F, V = seq.batch.kps.shape[:2]
    kps_px = seq.batch.kps[..., :2] * SCALE
    present = seq.batch.valid
    images = np.stack([
        np.stack([render_frame(kps_px[f, v], present[f, v], joint_colors)
                  for v in range(V)])
        for f in range(F)
    ])
    return Scene(cfg, seq, rng, kps_px, present, scaled_cameras(seq.cameras, SCALE), images)


def make_sample(window_img, window_kps, window_present, win_hw, net_hw, device):
    """A window and its keypoints in window pixels -> (image resized to
    `net_hw` (h, w, 3), heatmap targets (h/4, w/4, 18): the 17 keypoint
    gaussians of every present person combined by max, then the tight
    person-center channel), f32 tensors on `device`."""
    from multiview_motion_capture_torch.data.detect import resize
    from multiview_motion_capture_torch.models.pose_net import (
        center_targets,
        gaussian_heatmaps,
    )

    hh, hw_ = net_hw[0] // 4, net_hw[1] // 4
    wh_, ww_ = win_hw
    sx, sy = hw_ / ww_, hh / wh_
    kp_hm = window_kps * np.asarray([sx, sy])
    P = window_kps.shape[0]
    pres = torch.as_tensor(window_present, dtype=torch.float32, device=device)
    g = gaussian_heatmaps(torch.as_tensor(kp_hm.reshape(-1, 2), dtype=torch.float32,
                                          device=device)[None], (hh, hw_))[0]  # (hh, hw, P*17)
    g = g.permute(2, 0, 1).reshape(P, 17, hh, hw_)
    kt = (g * pres[:, None, None, None]).amax(dim=0)                    # (17, hh, hw)
    # tight center gaussians: nearby people must stay separate peaks on the
    # coarse proposal heatmap
    centers = torch.as_tensor(kp_hm.mean(axis=1), dtype=torch.float32, device=device)
    ct = center_targets(centers[None], pres[None], (hh, hw_), sigma=1.5)[0]
    tgt = torch.cat([kt.permute(1, 2, 0), ct[..., None]], dim=-1)
    im = resize(torch.as_tensor(window_img, dtype=torch.float32, device=device)[None],
                tuple(net_hw))[0]
    return im, tgt


def training_set(scene: Scene, device) -> dict:
    """Resized full frames and person-centred crops, every sample supervised
    with ALL people visible in its window: {"full_imgs", "full_tgts",
    "crop_imgs", "crop_tgts"}, stacked on `device`."""
    H, W = FRAME_HW
    ch, cw = CROP_HW
    kps_px, present, images, rng = scene.kps_px, scene.present, scene.images, scene.rng
    F, V, P = present.shape
    full, crops = [], []
    for f in range(F):
        for v in range(V):
            # full frame sample at the landscape proposal-pass size
            full.append(make_sample(images[f, v], kps_px[f, v], present[f, v],
                                    FRAME_HW, FULL_HW, device))
            # one crop per present person (jittered center), portrait size
            for p in range(P):
                if not present[f, v, p]:
                    continue
                c = kps_px[f, v, p].mean(axis=0) + rng.uniform(-8, 8, 2)
                x0 = int(np.clip(round(c[0] - cw / 2), 0, W - cw))
                y0 = int(np.clip(round(c[1] - ch / 2), 0, H - ch))
                win = images[f, v][y0:y0 + ch, x0:x0 + cw]
                wk = kps_px[f, v] - np.asarray([x0, y0])
                inside = present[f, v] & (
                    (kps_px[f, v, :, 0] >= x0) & (kps_px[f, v, :, 0] < x0 + cw)
                    & (kps_px[f, v, :, 1] >= y0) & (kps_px[f, v, :, 1] < y0 + ch)
                ).any(axis=-1)
                crops.append(make_sample(win, wk, inside, CROP_HW, MODEL_HW, device))
    return {"full_imgs": torch.stack([s[0] for s in full]),
            "full_tgts": torch.stack([s[1] for s in full]),
            "crop_imgs": torch.stack([s[0] for s in crops]),
            "crop_tgts": torch.stack([s[1] for s in crops])}


def wmse(h, t):
    # peak-weighted MSE: plain MSE dilutes the gaussian peaks' gradient over
    # the (mostly-background) map and converges slowly
    return torch.mean((h - t) ** 2 * (1.0 + 20.0 * t))


def train_step(net, optimizer, sets: dict, idx_f, idx_c):
    """One Adam step on the full frames `idx_f` and the crops `idx_c`
    through the same (fully convolutional) net; returns the loss before the
    update."""
    optimizer.zero_grad(set_to_none=True)
    loss = (wmse(net(sets["full_imgs"][idx_f]), sets["full_tgts"][idx_f])
            + wmse(net(sets["crop_imgs"][idx_c]), sets["crop_tgts"][idx_c]))
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_optimizer(net):
    """optax.adam(2e-3): b1 0.9, b2 0.999, eps 1e-8 added after the
    bias-corrected square root, no weight decay."""
    return torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)


def train(net, sets: dict, steps: int, generator: torch.Generator, batch: int = BATCH):
    """`steps` Adam steps of `batch` full frames and `batch` crops, the
    indices drawn from `generator` (all up front, one copy to the device);
    prints the loss every 50 steps."""
    dev = sets["full_imgs"].device
    n_f, n_c = sets["full_imgs"].shape[0], sets["crop_imgs"].shape[0]
    idx_f = torch.randint(0, n_f, (steps, batch), generator=generator).to(dev)
    idx_c = torch.randint(0, n_c, (steps, batch), generator=generator).to(dev)
    optimizer = make_optimizer(net)
    net.train()
    for s in range(steps):
        loss = train_step(net, optimizer, sets, idx_f[s], idx_c[s])
        if s % 50 == 0 or s == steps - 1:
            print(f"train step {s}: loss {float(loss):.5f}")
    return net.eval()


def detect_and_track(net, mcfg, scene: Scene) -> dict:
    """The inference half on the weights of `net` (on its device): the
    cascade detector over every frame, the detections against the ground
    truth (nearest-person assignment), then `pipeline.run` in triangulation
    mode.  Returns {"recall", "det_err", "n_long", "mpjpe", "det_batch",
    "result"}."""
    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.data.detect import (
        frames_to_frame_batch,
        make_multi_person_detector,
    )
    from multiview_motion_capture_torch.eval import mpjpe_vs_ground_truth

    cfg, kps_px, present = scene.cfg, scene.kps_px, scene.present
    F, V, P = present.shape
    detect = make_multi_person_detector(
        mcfg, max_people=cfg.max_people, crop_hw=CROP_HW,
        full_hw=FULL_HW, center_min_score=0.2, center_nms_window=5,
    )
    det_batch = frames_to_frame_batch(detect, net, scene.images, cfg)
    n_det = int(det_batch.valid.sum())
    n_pres = int(present.sum())
    print(f"proposals: {n_det} valid detections for {n_pres} person-views "
          f"({n_det / max(n_pres, 1):.2f}x)")

    # detection quality vs ground truth (nearest-person assignment)
    errs, n_hit, n_gt = [], 0, 0
    for f in range(F):
        for v in range(V):
            gt = [kps_px[f, v, p] for p in range(P) if present[f, v, p]]
            n_gt += len(gt)
            for s_ in range(cfg.max_people):
                if not det_batch.valid[f, v, s_]:
                    continue
                d = [np.linalg.norm(det_batch.kps[f, v, s_, :, :2] - g,
                                    axis=-1).mean() for g in gt]
                if d and min(d) < MATCH_PX:
                    n_hit += 1
                    errs.append(min(d))
    det_err = float(np.mean(errs)) if errs else float("inf")
    recall = n_hit / max(n_gt, 1)
    print(f"multi-person detection: recall {recall:.2f}, "
          f"matched err {det_err:.2f} px (quarter-scale frame pixels)")

    res = pipeline.run(det_batch, scene.cams_small, cfg, use_ik=False,
                       device=next(net.parameters()).device)
    n_frames = F
    long = [t for t in res.tracklets if len(t) >= n_frames // 2]
    mpjpe = mpjpe_vs_ground_truth(long, scene.seq.gt_3d)
    print(f"tracking from full-frame detections: {len(res.tracklets)} "
          f"tracklets ({len(long)} long), 3D MPJPE vs GT: {mpjpe * 100:.2f} cm")
    return {"recall": recall, "det_err": det_err, "n_long": len(long), "mpjpe": mpjpe,
            "det_batch": det_batch, "result": res}


def main(steps=400, n_frames=8, n_people=2, n_views=4, seed=0,
         dump_params=None, cache=False, device="cuda"):
    """Render, train, detect and track on `device` ("cuda" unless the
    caller asks for "cpu").  Returns (recall, det_err, n_long, mpjpe)."""
    from multiview_motion_capture_torch.models import pose_net as pose_net_mod
    from multiview_motion_capture_torch.models.checkpoint import (
        load_posenet,
        save_posenet,
    )
    from multiview_motion_capture_torch.models.pose_net import init_posenet
    from multiview_motion_capture_torch.utils import testcache
    from multiview_motion_capture_torch.utils.precision import high_precision, resolve_device

    dev = resolve_device(device)
    high_precision()
    scene = make_scene(n_frames, n_people, n_views, seed)

    # ---- training set: resized full frames + person-centered crops ----
    sets = training_set(scene, dev)
    print(f"training set: {sets['full_imgs'].shape[0]} full frames + "
          f"{sets['crop_imgs'].shape[0]} crops")

    # ---- train: both input sizes through the same (fully-conv) net ----
    mcfg = model_config()
    ckpt = None
    if cache:
        # train-once disk cache (utils/testcache): keyed by the sources
        # that shape the training + the hyper-params
        fp = testcache.source_fingerprint(
            [pose_net_mod.__file__, __file__],
            f"fullframe-{steps}-{n_frames}-{n_people}-{n_views}-{seed}")
        ckpt = testcache.checkpoint_path("torch_e2e_fullframe", fp)
    if ckpt is not None and ckpt.exists():
        print(f"loading cached training: {ckpt}")
        _, net = load_posenet(ckpt, device=dev)
    else:
        net = init_posenet(mcfg, torch.Generator().manual_seed(0)).to(dev)
        train(net, sets, steps, torch.Generator().manual_seed(1))
        if ckpt is not None:
            save_posenet(ckpt, mcfg, net)

    if dump_params:
        from multiview_motion_capture_torch.models.checkpoint import save_params

        save_params(Path(dump_params), net)
        print(f"params -> {dump_params}")

    # ---- full multi-person detection + tracking ----
    out = detect_and_track(net, mcfg, scene)
    return out["recall"], out["det_err"], out["n_long"], out["mpjpe"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    main(steps=args.steps, device="cpu" if args.cpu else "cuda")
