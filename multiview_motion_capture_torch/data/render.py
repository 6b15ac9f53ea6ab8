"""Domain-randomized synthetic person rendering (numpy only).

The PyTorch port's own copy of `multiview_motion_capture_tpu/data/render.py`,
on the port's `pose_def`: the same seed renders the same pixels.  It makes
the camera frames that the detection path (`data.detect`) is tested and
measured on.

The renderer draws articulated stick figures (limb segments + joint blobs)
with painter's-algorithm occlusion and randomizes everything that should
NOT carry signal:

- appearance: one shared "human" palette for ALL people with per-person
  jitter (identity is deliberately not color-separable),
- lighting: global brightness/contrast, additive noise,
- clutter: background gradients, blob noise, and limb-like distractor
  segments that are NOT people,
- scale: people size varies naturally with camera distance (projection).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from multiview_motion_capture_torch.pose_def import (
    COCO_BONES,
    KpsFormat,
    KpsType,
    kps_index,
)

_CIDX = kps_index(KpsFormat.COCO)
_CIDX_LS = _CIDX[KpsType.L_Shoulder]
_CIDX_LH = _CIDX[KpsType.L_Hip]
COCO_BONE_IDX: Tuple[Tuple[int, int], ...] = tuple(
    (_CIDX[a], _CIDX[b]) for a, b in COCO_BONES
)

# one shared palette: head/torso/arms/legs tones every "person" wears
_BONE_BASE_RGB = np.array(
    [
        [0.85, 0.70, 0.55],  # nose-eye
        [0.85, 0.70, 0.55],  # eye-ear
        [0.85, 0.70, 0.55],
        [0.85, 0.70, 0.55],
        [0.30, 0.45, 0.80],  # shoulder bar
        [0.30, 0.45, 0.80],  # upper arms
        [0.75, 0.70, 0.60],  # forearms
        [0.30, 0.45, 0.80],
        [0.75, 0.70, 0.60],
        [0.35, 0.40, 0.55],  # torso sides
        [0.25, 0.30, 0.45],  # thighs
        [0.45, 0.40, 0.35],  # shins
        [0.35, 0.40, 0.55],
        [0.25, 0.30, 0.45],
        [0.45, 0.40, 0.35],
    ],
    dtype=np.float32,
)
_JOINT_RGB = np.full((17, 3), 0.8, dtype=np.float32)
_JOINT_RGB[:5] = [0.9, 0.75, 0.6]  # face keypoints skin-toned


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    hw: Tuple[int, int] = (192, 256)
    limb_sigma: float = 1.6       # gaussian half-width of limb strokes (px)
    joint_sigma: float = 2.0
    bg_gradient: bool = True
    bg_blobs: int = 4             # random background blobs
    distractor_segments: int = 3  # limb-like clutter that is NOT a person
    appearance_jitter: float = 0.3
    brightness_range: Tuple[float, float] = (0.7, 1.15)
    noise_std: float = 0.02


def _stamp_segment(alpha, rgb, a, b, sigma, col):
    """Paint gaussian-falloff segment a->b into (alpha, rgb) in place.

    Work is restricted to the segment's padded bounding box (a full-frame
    distance field per stroke made dataset generation ~20x slower)."""
    H, W = alpha.shape
    pad = 4.0 * sigma
    x0 = int(max(0, np.floor(min(a[0], b[0]) - pad)))
    x1 = int(min(W, np.ceil(max(a[0], b[0]) + pad) + 1))
    y0 = int(max(0, np.floor(min(a[1], b[1]) - pad)))
    y1 = int(min(H, np.ceil(max(a[1], b[1]) + pad) + 1))
    if x0 >= x1 or y0 >= y1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    p = np.stack([xs, ys], axis=-1).astype(np.float32)
    ab = (b - a).astype(np.float32)
    denom = max(float(ab @ ab), 1e-6)
    t = np.clip(((p - a) @ ab) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    d2 = ((p - proj) ** 2).sum(-1)
    seg = np.exp(-d2 / (2.0 * sigma**2)).astype(np.float32)
    sub_a = alpha[y0:y1, x0:x1]
    m = seg > sub_a
    rgb[y0:y1, x0:x1][m] = col
    np.maximum(sub_a, seg, out=sub_a)


def _segment_alpha(H, W, a, b, sigma):
    """Gaussian-falloff intensity of segment a->b over the pixel grid
    (full-frame variant, used for background distractors)."""
    ys, xs = np.mgrid[0:H, 0:W]
    p = np.stack([xs, ys], axis=-1).astype(np.float32)  # (H, W, 2)
    ab = b - a
    denom = max(float(ab @ ab), 1e-6)
    t = np.clip(((p - a) @ ab) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    d2 = ((p - proj) ** 2).sum(-1)
    return np.exp(-d2 / (2.0 * sigma**2)).astype(np.float32)


def render_person(kps_xy: np.ndarray, hw, rng: np.random.RandomState,
                  cfg: RenderConfig, scale: float = 1.0,
                  tint: np.ndarray = None):
    """One person -> (alpha (H, W), rgb (H, W, 3)).  `scale` widens strokes
    for near/large people (pass bone-length-proportional values).

    `tint` (3,) overrides the per-call random appearance jitter with a
    STABLE per-person color multiplier — the appearance-consistent mode the
    tracker's appearance-evidence studies need (training data keeps the
    default: identity deliberately NOT color-separable)."""
    H, W = hw
    alpha = np.zeros((H, W), dtype=np.float32)
    rgb = np.zeros((H, W, 3), dtype=np.float32)
    jit = (np.asarray(tint, dtype=np.float32) if tint is not None
           else 1.0 + cfg.appearance_jitter * rng.uniform(-1, 1, size=(3,)))
    ls = cfg.limb_sigma * max(scale, 0.5)
    js = cfg.joint_sigma * max(scale, 0.5)
    for bi, (i, j) in enumerate(COCO_BONE_IDX):
        col = np.clip(_BONE_BASE_RGB[bi] * jit, 0, 1).astype(np.float32)
        _stamp_segment(alpha, rgb, kps_xy[i], kps_xy[j], ls, col)
    for k in range(kps_xy.shape[0]):
        col = np.clip(_JOINT_RGB[k] * jit, 0, 1).astype(np.float32)
        _stamp_segment(alpha, rgb, kps_xy[k], kps_xy[k], js, col)
    return alpha, rgb


def render_scene(
    kps_xy: np.ndarray,          # (P, 17, 2) frame px
    present: np.ndarray,         # (P,) bool
    depth: Optional[np.ndarray],  # (P,) camera distance (occlusion order)
    rng: np.random.RandomState,
    cfg: RenderConfig,
    person_tints: Optional[np.ndarray] = None,   # (P, 3) stable per-person
                                                 # color multipliers
    return_visibility: bool = False,
) -> np.ndarray:
    """Full randomized frame: background + distractors + depth-ordered
    people (nearer occludes farther).  Returns (H, W, 3) f32 in [0, 1].

    `return_visibility=True` additionally returns a (P, 17) bool array:
    joint k of person p is VISIBLE iff, after the full depth-ordered paint,
    person p still owns a solid pixel in the 3x3 neighborhood of that
    joint.  This is the occlusion ground truth dense-crowd training needs
    (supervising heatmaps/offsets at painted-over joints teaches the net to
    hallucinate, and fully occluded people are a PHYSICAL detection limit
    that recall metrics must account for — VERDICT r4 next #1)."""
    H, W = cfg.hw
    img = np.zeros((H, W, 3), dtype=np.float32)
    if cfg.bg_gradient:
        ys, xs = np.mgrid[0:H, 0:W]
        g = (
            rng.uniform(0.0, 0.25)
            + rng.uniform(-0.15, 0.15) * xs / W
            + rng.uniform(-0.15, 0.15) * ys / H
        )
        img += np.clip(g, 0, 1)[..., None] * rng.uniform(0.5, 1.0, size=3)
    for _ in range(cfg.bg_blobs):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        s = rng.uniform(5, 40)
        ys, xs = np.mgrid[0:H, 0:W]
        blob = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s**2))
        img += blob[..., None] * rng.uniform(0, 0.25, size=3)
    for _ in range(cfg.distractor_segments):
        a = np.array([rng.uniform(0, W), rng.uniform(0, H)], np.float32)
        b = a + rng.uniform(-60, 60, size=2).astype(np.float32)
        seg = _segment_alpha(H, W, a, b, cfg.limb_sigma * rng.uniform(0.8, 2))
        col = _BONE_BASE_RGB[rng.randint(len(_BONE_BASE_RGB))]
        col = np.clip(col * (1 + rng.uniform(-0.3, 0.3, 3)), 0, 1)
        img = img * (1 - seg[..., None]) + col * seg[..., None]

    order = np.argsort(-(depth if depth is not None else np.zeros(len(kps_xy))))
    owner = np.full((H, W), -1, dtype=np.int16) if return_visibility else None
    for p in order:  # far -> near: nearer painted later occludes
        if not present[p]:
            continue
        # stroke width follows apparent size (shoulder-to-hip px distance)
        ref = np.linalg.norm(kps_xy[p, _CIDX_LS] - kps_xy[p, _CIDX_LH])
        scale = float(np.clip(ref / 45.0, 0.5, 3.0))
        tint = person_tints[p] if person_tints is not None else None
        alpha, rgb = render_person(kps_xy[p], cfg.hw, rng, cfg, scale=scale,
                                   tint=tint)
        img = img * (1 - alpha[..., None]) + rgb * alpha[..., None]
        if owner is not None:
            owner[alpha > 0.5] = p  # later (nearer) paint overwrites

    img *= rng.uniform(*cfg.brightness_range)
    if cfg.noise_std > 0:
        img += rng.normal(0, cfg.noise_std, size=img.shape)
    img = np.clip(img, 0.0, 1.0).astype(np.float32)
    if not return_visibility:
        return img
    P, K = kps_xy.shape[:2]
    vis = np.zeros((P, K), dtype=bool)
    for p in range(P):
        if not present[p]:
            continue
        for k in range(K):
            x, y = kps_xy[p, k]
            if not (np.isfinite(x) and np.isfinite(y)):
                continue
            xi, yi = int(round(x)), int(round(y))
            y0, y1 = max(0, yi - 1), min(H, yi + 2)
            x0, x1 = max(0, xi - 1), min(W, xi + 2)
            if y0 < y1 and x0 < x1:
                vis[p, k] = bool((owner[y0:y1, x0:x1] == p).any())
    return img, vis
