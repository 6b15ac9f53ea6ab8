"""Identity-labelled descriptor batches for the appearance head.

Port of `multiview_motion_capture_tpu/data/appearance_train.py`: render
multi-person scenes with stable per-person clothing tints under the
renderer's full style randomization, run the keypoint-color-layout
descriptor (`data.detect.appearance_from_keypoints`, on `device`) at
detector-noise-corrupted keypoints (~2 px jitter, random keypoint
dropout), and return (descriptor, identity-label) pairs.  Labels are
`scene * 64 + person`, so cross-scene pairs are always negatives.

One numpy `RandomState` drives every draw in the JAX package's order, so
the labels are the JAX package's and the descriptors match to rounding.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multiview_motion_capture_torch.config import PipelineConfig
from multiview_motion_capture_torch.data.detect import appearance_from_keypoints
from multiview_motion_capture_torch.data.detect_train import render_sequence
from multiview_motion_capture_torch.data.render import RenderConfig
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
from multiview_motion_capture_torch.utils.precision import resolve_device


def random_person_tints(rng: np.random.RandomState, n_people: int,
                        lo: float = 0.3, hi: float = 1.7) -> np.ndarray:
    """(P, 3) stable clothing-colour multipliers, uniform per channel (some
    pairs land close together: the hard negatives)."""
    return rng.uniform(lo, hi, size=(n_people, 3)).astype(np.float32)


def descriptor_batch(
    seed: int,
    n_scenes: int = 4,
    n_frames: int = 6,
    n_views: int = 5,
    n_people: Tuple[int, int] = (3, 5),
    hw: Tuple[int, int] = (192, 256),
    world_scale: float = 0.25,
    kp_jitter_px: float = 2.0,
    kp_drop: float = 0.15,
    render_cfg=None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (embs (N, K*3) unit f32, labels (N,) int32), N = all valid
    detections across scenes x frames x views with a descriptor left after
    the dropout.

    Each scene: fresh people, walks, camera ring, tints and render style
    (seeded off `seed`).  The descriptors are computed on `device`
    (default "cuda"; without a GPU that raises)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    rcfg = render_cfg or RenderConfig(hw=hw)
    embs, labels = [], []
    for s in range(n_scenes):
        P = int(rng.randint(n_people[0], n_people[1] + 1))
        cfg = PipelineConfig(n_views=n_views, max_people=max(8, P + 2),
                             max_tracks=12, max_frames=None)
        seq = synthetic_sequence(
            n_frames=n_frames, n_people=P, n_views=n_views, cfg=cfg,
            seed=int(rng.randint(1 << 30)), noise_px=0.0, drop_prob=0.0,
            min_person_distance=1.0,
        )
        tints = random_person_tints(rng, P)
        images = render_sequence(seq, rcfg, world_scale=world_scale,
                                 seed=int(rng.randint(1 << 30)),
                                 person_tints=tints)
        F, V, Pmax, K = seq.batch.kps.shape[:4]
        for f in range(F):
            kps = seq.batch.kps[f].astype(np.float32).copy()  # (V, P, K, 3)
            kps[..., :2] = (kps[..., :2] * world_scale
                            + rng.normal(0, kp_jitter_px, size=kps[..., :2].shape))
            score = (rng.uniform(size=kps[..., 2].shape) >= kp_drop)
            kps[..., 2] = score.astype(np.float32)
            with torch.no_grad():
                emb = appearance_from_keypoints(
                    torch.as_tensor(images[f], device=dev), torch.as_tensor(kps, device=dev),
                    torch.as_tensor(seq.batch.valid[f], device=dev)).cpu().numpy()
            for v in range(V):
                for p in range(Pmax):
                    person = seq.gt_slot_person[f, v, p]
                    if not seq.batch.valid[f, v, p] or person < 0:
                        continue
                    row = emb[v, p]
                    if np.linalg.norm(row) < 1e-6:
                        continue      # fully dropped-out detection
                    embs.append(row)
                    labels.append(s * 64 + int(person))
    return (np.stack(embs).astype(np.float32),
            np.asarray(labels, dtype=np.int32))
