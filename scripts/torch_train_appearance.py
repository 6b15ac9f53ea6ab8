#!/usr/bin/env python3
"""Train the appearance embedding head with the PyTorch port, on the card.

The port's counterpart of `scripts/train_appearance.py`, with the same
flags, data, held-out selection and final JSON line
("appearance_head_val_cos_gap"): the head is metric-learned (SupCon) on
identity-labelled keypoint-color-layout descriptors of tinted synthetic
renders (`data.appearance_train`, descriptors computed on the card), and
the checkpoint with the widest held-out same-vs-different cosine gap
(fresh scenes, tints and render seeds at `--seed + 100_003`) is saved.

    python scripts/torch_train_appearance.py
    python scripts/torch_train_appearance.py --scenes 24 --iters 400

What differs from the JAX script: the head's initial weights come from
`init_head` with a `torch.Generator` seeded `--seed` (JAX's PRNG streams
cannot be reproduced, so the trained weights are not the JAX script's; the
descriptors and labels are its own); the checkpoint goes to
`build/torch_appearance_head.npz` unless `--out` says otherwise (the
shipped head is never written); the JSON line also holds the wall seconds
of data generation and of training.
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

DEFAULT_OUT = REPO / "build" / "torch_appearance_head.npz"
VAL_SEED_OFFSET = 100_003


def train_head(embs, labels, val_embs, val_labels, iters, lr, weight_decay, tau, seed, dev,
               log=print):
    """SupCon training with the held-out gap read every 25 iterations ->
    (best head (a copy), best gap, its iteration, the last loss)."""
    import copy

    from multiview_motion_capture_torch.models.appearance_net import (
        AppearanceHeadConfig,
        apply_head,
        cosine_gap,
        init_head,
        make_train_step,
    )
    from multiview_motion_capture_torch.models.optim import AdamW

    cfg = AppearanceHeadConfig(in_dim=embs.shape[-1])
    head = init_head(torch.Generator().manual_seed(seed), cfg, device=dev)
    step = make_train_step(head, AdamW(head.parameters(), lr, weight_decay=weight_decay),
                           tau=tau)
    e, lab = torch.as_tensor(embs, device=dev), torch.as_tensor(labels, device=dev)
    ve, vl = torch.as_tensor(val_embs, device=dev), torch.as_tensor(val_labels, device=dev)
    best_gap, best, best_it, loss = -1.0, copy.deepcopy(head), 0, None
    for i in range(iters):
        loss = step(e, lab)
        if (i + 1) % 25 == 0:
            with torch.no_grad():
                s, d = cosine_gap(apply_head(head, ve), vl)
            gap = float(s - d)
            log(f"it {i + 1}: loss={float(loss):.4f} val gap={gap:.3f}")
            if gap > best_gap:
                best_gap, best, best_it = gap, copy.deepcopy(head), i + 1
    return best, best_gap, best_it, float(loss)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--tau", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args()

    from multiview_motion_capture_torch.data.appearance_train import descriptor_batch
    from multiview_motion_capture_torch.models.appearance_net import apply_head, cosine_gap
    from multiview_motion_capture_torch.models.checkpoint import save_appearance_head
    from multiview_motion_capture_torch.utils.precision import high_precision, resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    high_precision()
    t0 = time.time()
    embs, labels = descriptor_batch(seed=args.seed, n_scenes=args.scenes, n_frames=args.frames,
                                    device=dev)
    # held-out: fresh scenes, tints and styles, never trained on
    ve, vl = descriptor_batch(seed=args.seed + VAL_SEED_OFFSET, n_scenes=4,
                              n_frames=args.frames, device=dev)
    data_s = time.time() - t0
    raw_s, raw_d = (float(x) for x in cosine_gap(torch.as_tensor(ve), torch.as_tensor(vl)))
    print(f"train {embs.shape} ids={np.unique(labels).size} | "
          f"val {ve.shape} raw gap={raw_s - raw_d:.3f}", file=sys.stderr)

    t0 = time.time()
    head, best_gap, best_it, _ = train_head(
        embs, labels, ve, vl, args.iters, args.lr, args.weight_decay, args.tau, args.seed, dev,
        log=lambda m: print(m, file=sys.stderr))
    train_s = time.time() - t0
    save_appearance_head(Path(args.out), head.cfg, head)
    with torch.no_grad():
        s, d = (float(x) for x in cosine_gap(apply_head(head, torch.as_tensor(ve, device=dev)),
                                             torch.as_tensor(vl, device=dev)))
    print(json.dumps({
        "metric": "appearance_head_val_cos_gap",
        "value": round(best_gap, 3),
        "unit": "cosine",
        "extra": {
            "raw_gap": round(raw_s - raw_d, 3),
            "val_same": round(s, 3),
            "val_diff": round(d, 3),
            "best_iter": best_it,
            "n_train": int(embs.shape[0]),
            "out": str(args.out),
            "data_s": data_s,
            "train_s": train_s,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        },
    }))


if __name__ == "__main__":
    main()
