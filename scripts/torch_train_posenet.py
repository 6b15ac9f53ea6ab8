#!/usr/bin/env python3
"""Train the bottom-up keypoint CNN with the PyTorch port, on the card.

The port's counterpart of `scripts/train_posenet.py`, with the same flags,
data, schedule, held-out evaluation and final JSON line
("posenet_heldout_recall"):

    python scripts/torch_train_posenet.py --steps 6000

Quality gates (held-out synthetic, quarter-Shelf scale): recall >= 0.9 @
12 px, matched mean error <= 3 px ("gates_met" in the JSON line).

What differs from the JAX script:
- the samples are generated in this process (`generate_samples`: host
  rendering, the targets on the card) and cached as npz under
  `build/posenet_synth_data/`, one file a data set, named and laid out as
  the JAX script's cache (`SampleSet`'s fields), so its files load too;
- the initial weights come from `init_posenet` with a `torch.Generator`
  seeded 0, and the batch indices and the photometric augmentation from a
  `torch.Generator` on the card seeded 1: JAX's PRNG streams cannot be
  reproduced, so neither the batches nor the trained weights are the JAX
  script's;
- the checkpoint goes to `build/torch_posenet_synth.npz` unless `--out`
  says otherwise (the shipped checkpoint is never written);
- the JSON line also holds the shipped checkpoint's numbers on the same
  held-out set through the port's detector ("shipped_heldout"), the wall
  seconds of data generation and of training, and steps/s.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME_HW = (192, 256)
TRAIN_SEEDS = list(range(100))
EVAL_SEEDS = list(range(1000, 1010))
# dense-crowd curriculum: 5-10 people with tight packing; disjoint from the
# base train and eval seed ranges
CROWD_TRAIN_SEEDS = list(range(2000, 2080))
CROWD_EVAL_SEEDS = list(range(3000, 3010))
CACHE = REPO / "build" / "posenet_synth_data"
DEFAULT_OUT = REPO / "build" / "torch_posenet_synth.npz"
SHIPPED = REPO / "multiview_motion_capture_tpu" / "models" / "checkpoints" / "posenet_synth.npz"
GATE_RECALL, GATE_ERR_PX = 0.9, 3.0


def build_model_cfg():
    from multiview_motion_capture_torch.models.pose_net import PoseNetConfig

    return PoseNetConfig(img_hw=FRAME_HW, stage_features=(64, 128, 256), blocks_per_stage=2,
                         head_features=128, predict_center=True, predict_offsets=True)


def load_or_generate(tag, seeds, device, n_frames=6, n_views=4, n_people_range=(1, 5),
                     min_person_distance=0.9, max_people=6, visibility_aware=False):
    """The cached SampleSet of `seeds`, generated on a miss."""
    from multiview_motion_capture_torch.data.detect_train import SampleSet, generate_samples
    from multiview_motion_capture_torch.data.render import RenderConfig

    CACHE.mkdir(parents=True, exist_ok=True)
    va = "_va" if visibility_aware else ""
    f = (CACHE / f"{tag}_{len(seeds)}_{n_frames}x{n_views}"
                 f"_p{n_people_range[0]}-{n_people_range[1]}"
                 f"_d{min_person_distance}{va}.npz")
    if not f.exists():
        t0 = time.time()
        ss = generate_samples(list(seeds), RenderConfig(hw=FRAME_HW), n_frames=n_frames,
                              n_views=n_views, n_people_range=tuple(n_people_range),
                              min_person_distance=min_person_distance, max_people=max_people,
                              visibility_aware=visibility_aware, device=device)
        np.savez(f, **ss.__dict__)
        print(f"{tag}: generated in {time.time() - t0:.0f}s", file=sys.stderr)
    with np.load(f) as z:
        return SampleSet(**{k: z[k] for k in z.files})


def _pad_people(ss, P):
    """Pad a SampleSet's per-person arrays to P slots (for mixing sets
    generated at different max_people)."""
    from multiview_motion_capture_torch.data.detect_train import SampleSet

    n, p0 = ss.present.shape
    if p0 >= P:
        return ss
    kps = np.full((n, P, 17, 2), np.nan, np.float32)
    kps[:, :p0] = ss.kps_px
    pres = np.zeros((n, P), bool)
    pres[:, :p0] = ss.present
    vis = np.zeros((n, P, 17), bool)
    if ss.vis is not None and getattr(ss.vis, "ndim", 0) == 3:
        vis[:, :p0] = ss.vis
    return SampleSet(images=ss.images, kps_px=kps, present=pres, heat_tgt=ss.heat_tgt,
                     off_tgt=ss.off_tgt, off_mask=ss.off_mask, vis=vis)


def evaluate(mcfg, net, ss, max_people=6, center_nms=5):
    """Held-out detection quality of `net` through the bottom-up detector,
    16 images a call."""
    from multiview_motion_capture_torch.data.detect import make_bottom_up_detector
    from multiview_motion_capture_torch.data.detect_train import evaluate_detections

    detect = make_bottom_up_detector(mcfg, max_people=max_people, center_min_score=0.2,
                                     center_nms_window=center_nms)
    kps_all, val_all = [], []
    for s in range(0, ss.images.shape[0], 16):
        kps, _, valid = detect(net, ss.images[s:s + 16])
        kps_all.append(kps.cpu().numpy())
        val_all.append(valid.cpu().numpy())
    return evaluate_detections(np.concatenate(kps_all), np.concatenate(val_all),
                               np.nan_to_num(ss.kps_px[..., :2]), ss.present, match_px=12.0)


def make_augment(noise_aug: float, gen: torch.Generator):
    """Photometric augmentation: a per-sample brightness scale in [0.5,
    1.15] and additive gaussian noise of a per-sample sigma up to
    `noise_aug`, clipped to [0, 1]; the targets are unchanged."""
    def augment(images):
        n = images.shape[0]
        shape = (n, 1, 1, 1)
        scale = 0.5 + 0.65 * torch.rand(shape, generator=gen, device=images.device)
        sigma = noise_aug * torch.rand(shape, generator=gen, device=images.device)
        noise = torch.randn(images.shape, generator=gen, device=images.device)
        return torch.clamp(images * scale + sigma * noise, 0.0, 1.0)

    return augment


def main(steps=6000, batch=16, lr=1e-3, out=None, resume=None, crowd=False, noise_aug=0.0,
         device="cuda"):
    from multiview_motion_capture_torch.data.detect_train import SampleSet, make_train_step
    from multiview_motion_capture_torch.models.checkpoint import load_posenet, save_posenet
    from multiview_motion_capture_torch.models.optim import AdamW, warmup_cosine_decay_schedule
    from multiview_motion_capture_torch.models.pose_net import init_posenet
    from multiview_motion_capture_torch.utils.precision import high_precision, resolve_device

    dev = resolve_device(device)
    high_precision()
    t_data = time.time()
    crowd_heldout = None
    if crowd:
        # visibility-aware supervision of the base distribution plus tightly
        # packed 5-10-person scenes
        base = load_or_generate("train", TRAIN_SEEDS, dev, visibility_aware=True)
        dense = load_or_generate("crowd_train", CROWD_TRAIN_SEEDS, dev, n_people_range=(5, 10),
                                 min_person_distance=0.35, max_people=12, visibility_aware=True)
        b = _pad_people(base, dense.present.shape[1])
        train = SampleSet(**{k: np.concatenate([getattr(b, k), getattr(dense, k)])
                             for k in SampleSet.__dataclass_fields__})
        crowd_heldout = load_or_generate("crowd_eval", CROWD_EVAL_SEEDS, dev,
                                         n_people_range=(8, 10), min_person_distance=0.35,
                                         max_people=12, visibility_aware=True)
    else:
        train = load_or_generate("train", TRAIN_SEEDS, dev)
    heldout = load_or_generate("eval", EVAL_SEEDS, dev)
    data_s = time.time() - t_data

    if resume:
        mcfg, net = load_posenet(Path(resume), device=dev)
        print(f"resumed from {resume}", file=sys.stderr)
    else:
        mcfg = build_model_cfg()
        net = init_posenet(mcfg, torch.Generator().manual_seed(0)).to(dev)
    net.train()
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup_steps=min(300, steps // 10),
                                         decay_steps=steps, end_value=lr * 0.02)
    step_fn = make_train_step(mcfg, net, AdamW(net.parameters(), sched))

    imgs = torch.as_tensor(train.images, device=dev)
    heat_t = torch.as_tensor(train.heat_tgt, device=dev)
    off_t = torch.as_tensor(train.off_tgt, device=dev)
    off_m = torch.as_tensor(train.off_mask, device=dev)
    N = imgs.shape[0]
    print(f"training on {N} samples, {steps} steps, batch {batch}", file=sys.stderr)
    gen = torch.Generator(device=dev).manual_seed(1)
    augment = make_augment(noise_aug, gen) if noise_aug > 0 else None

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    first_loss = last_loss = None
    for s in range(steps):
        idx = torch.randint(0, N, (batch,), generator=gen, device=dev)
        x = imgs[idx] if augment is None else augment(imgs[idx])
        loss = step_fn(x, heat_t[idx], off_t[idx], off_m[idx])
        if s % 500 == 0 or s == steps - 1:
            last_loss = float(loss)
            first_loss = last_loss if first_loss is None else first_loss
            print(f"step {s}: loss {last_loss:.5f} ({time.time() - t0:.0f}s)", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.time() - t0
    del imgs, heat_t, off_t, off_m

    net.eval()
    q_train = evaluate(mcfg, net, train, max_people=train.present.shape[1])
    q_eval = evaluate(mcfg, net, heldout)
    shipped_cfg, shipped = load_posenet(SHIPPED, device=dev)
    extra = {"train": q_train, "heldout": q_eval, "steps": steps,
             "gates_met": bool(q_eval["recall"] >= GATE_RECALL
                               and q_eval["mean_err_px"] <= GATE_ERR_PX),
             "shipped_heldout": evaluate(shipped_cfg, shipped, heldout),
             "first_loss": first_loss, "last_loss": last_loss,
             "data_s": data_s, "train_s": train_s, "steps_per_s": steps / train_s,
             "images_per_s": steps * batch / train_s,
             "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")}
    if crowd_heldout is not None:
        # crowd gate: recall against the detectable people, both NMS windows
        extra["crowd_heldout_nms5"] = evaluate(mcfg, net, crowd_heldout, max_people=14)
        extra["crowd_heldout_nms3"] = evaluate(mcfg, net, crowd_heldout, max_people=14,
                                               center_nms=3)
    out = Path(out) if out else DEFAULT_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    save_posenet(out, mcfg, net, dtype=np.float16)
    extra["checkpoint"] = str(out)
    extra["ckpt_mb"] = round(out.stat().st_size / 1e6, 1)
    print(json.dumps({"metric": "posenet_heldout_recall", "value": round(q_eval["recall"], 3),
                      "extra": extra}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--crowd", action="store_true",
                    help="dense-crowd curriculum: visibility-aware supervision + "
                         "5-10-person packed scenes mixed in, crowd held-out gates reported")
    ap.add_argument("--noise_aug", type=float, default=0.0,
                    help="photometric augmentation: brightness scale [0.5, 1.15] + additive "
                         "gaussian noise with per-sample sigma up to this value (0 disables)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args()
    main(steps=args.steps, batch=args.batch, lr=args.lr, out=args.out, resume=args.resume,
         crowd=args.crowd, noise_aug=args.noise_aug, device="cpu" if args.cpu else "cuda")
