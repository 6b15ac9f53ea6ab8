"""End-to-end demo of the PyTorch/CUDA port without OpenPose (BASELINE.md
config 5), on the card:

  synthetic multi-view scene -> person crops rendered on the host
  -> keypoint CNN trained on the renders -> soft-argmax detection
  -> cross-view association + tracking -> 3D tracklets vs ground truth.

The counterpart of `examples/e2e_synthetic.py`: the same scene, crops,
training and tracker, on the port's package.  Each person crop shows
colored gaussian blobs at the projected keypoints, so a small network
learns localization quickly; everything else is the port's production
path (`data.detect.make_detector` + `crops_to_frame_batch` -> FrameBatch
-> `pipeline.run`, whose association runs the ALS kernel B1,
`csrc/als.cu`).  The training draws its batches from a `torch.Generator`,
not from JAX's PRNG, so its weights are not the JAX example's.

Run: python examples/torch_e2e_synthetic.py [--steps 300] [--cpu]
(on the card unless `--cpu` is given; without a GPU it raises).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CROP_HW = (64, 48)
BATCH = 32
LR = 2e-3


def render_crops(kps_xy, boxes, rng_colors):
    """Blob renderer: (N, K, 2) frame-pixel keypoints + (N, 4) boxes ->
    (N, H, W, 3) crop images with per-joint colored gaussians."""
    N, K, _ = kps_xy.shape
    H, W = CROP_HW
    scale = np.stack([(boxes[:, 2] - boxes[:, 0]) / W,
                      (boxes[:, 3] - boxes[:, 1]) / H], axis=-1)  # (N, 2)
    local = (kps_xy - boxes[:, None, :2]) / scale[:, None, :]     # crop pixels
    ys = np.arange(H)[None, :, None, None]
    xs = np.arange(W)[None, None, :, None]
    cy = local[:, None, None, :, 1]
    cx = local[:, None, None, :, 0]
    blobs = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * 2.0 ** 2))  # (N,H,W,K)
    img = np.einsum("nhwk,kc->nhwc", blobs, rng_colors)
    return np.clip(img, 0, 1).astype(np.float32), local


def model_config():
    """The example's top-down PoseNet on CROP_HW crops."""
    from multiview_motion_capture_torch.models.pose_net import PoseNetConfig

    return PoseNetConfig(img_hw=CROP_HW, stage_features=(64, 128, 256),
                         blocks_per_stage=1, head_features=128)


def train(net, crops, local, steps: int, generator: torch.Generator):
    """`steps` Adam(2e-3) steps (optax.adam's update) of the masked heatmap
    MSE on batches of BATCH crops, the indices drawn from `generator` (all
    up front, one copy to the device); prints the loss every 50 steps."""
    from multiview_motion_capture_torch.models.pose_net import (
        gaussian_heatmaps,
        heatmap_loss,
    )

    dev = next(net.parameters()).device
    target = gaussian_heatmaps(torch.as_tensor(local / 4.0, dtype=torch.float32, device=dev),
                               net.cfg.heatmap_hw)
    imgs = torch.as_tensor(crops, device=dev)
    mask = torch.ones((len(crops), 17), device=dev)
    idx = torch.randint(0, len(crops), (steps, BATCH), generator=generator).to(dev)
    optimizer = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    net.train()
    for s in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss = heatmap_loss(net(imgs[idx[s]]), target[idx[s]], mask[idx[s]])
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        if s % 50 == 0 or s == steps - 1:
            print(f"train step {s}: loss {float(loss):.5f}")
    return net.eval()


def main(steps=300, n_frames=20, n_people=2, n_views=4, seed=0, cache=False,
         device="cuda"):
    """Render, train, detect and track on `device` ("cuda" unless the
    caller asks for "cpu").  Returns (det_err, n_long, mpjpe)."""
    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.detect import (
        crops_to_frame_batch,
        make_detector,
    )
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
    from multiview_motion_capture_torch.eval import mpjpe_vs_ground_truth
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
    cfg = PipelineConfig(n_views=n_views, max_people=4, max_tracks=6, max_frames=None)
    seq = synthetic_sequence(n_frames=n_frames, n_people=n_people, n_views=n_views,
                             cfg=cfg, noise_px=0.0, drop_prob=0.0, seed=seed)
    rng = np.random.RandomState(seed)
    joint_colors = rng.uniform(0.3, 1.0, size=(17, 3))

    # ---- build crop dataset from ground-truth detections ----
    F, V, P = seq.batch.kps.shape[:3]
    kps = seq.batch.kps
    valid = seq.batch.valid
    flat_idx = [(f, v, p) for f in range(F) for v in range(V) for p in range(P)
                if valid[f, v, p]]
    xy = np.stack([kps[f, v, p, :, :2] for f, v, p in flat_idx])
    mins = xy.min(axis=1) - 10
    maxs = xy.max(axis=1) + 10
    boxes = np.concatenate([mins, maxs], axis=1)
    crops, local = render_crops(xy, boxes, joint_colors)

    # ---- train the keypoint CNN on the renders ----
    mcfg = model_config()
    ckpt = None
    if cache:
        # train-once disk cache (utils/testcache): keyed by the sources that
        # shape the training + the hyper-params, so any change to the model
        # or this example retrains instead of silently reusing
        fp = testcache.source_fingerprint(
            [pose_net_mod.__file__, __file__],
            f"synthetic-{steps}-{n_frames}-{n_people}-{n_views}-{seed}")
        ckpt = testcache.checkpoint_path("torch_e2e_synthetic", fp)
    if ckpt is not None and ckpt.exists():
        print(f"loading cached training: {ckpt}")
        _, net = load_posenet(ckpt, device=dev)
    else:
        net = init_posenet(mcfg, torch.Generator().manual_seed(0)).to(dev)
        train(net, crops, local, steps, torch.Generator().manual_seed(1))
        if ckpt is not None:
            save_posenet(ckpt, mcfg, net)

    # ---- detect on every crop and run the full pipeline ----
    detect, _ = make_detector(mcfg, net=net)
    crop_t = np.zeros((F, V, P) + CROP_HW + (3,), dtype=np.float32)
    box_t = np.zeros((F, V, P, 4), dtype=np.float32)
    for n, (f, v, p) in enumerate(flat_idx):
        crop_t[f, v, p] = crops[n]
        box_t[f, v, p] = boxes[n]
    det_batch = crops_to_frame_batch(detect, net, crop_t, box_t, valid, cfg)

    det_err = []
    for n, (f, v, p) in enumerate(flat_idx):
        det_err.append(np.linalg.norm(det_batch.kps[f, v, p, :, :2] - xy[n], axis=-1).mean())
    print(f"2D detection error: {np.mean(det_err):.2f} px (frame pixels)")

    res = pipeline.run(det_batch, seq.cameras, cfg, use_ik=False, device=dev)
    long = [t for t in res.tracklets if len(t) >= n_frames // 2]
    mpjpe = mpjpe_vs_ground_truth(long, seq.gt_3d)
    print(f"tracking from CNN detections: {len(res.tracklets)} tracklets "
          f"({len(long)} long), 3D MPJPE vs GT: {mpjpe * 100:.2f} cm")
    return np.mean(det_err), len(long), mpjpe


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    main(steps=args.steps, device="cpu" if args.cpu else "cuda")
