"""The benchmark's inputs: a camera ring and one long take of people walking
through it, made from the seed.

A vectorised copy of the synthetic scene that `scripts/bench_scaled.py`
runs (the canonical COCO-17 skeleton, limb sway, bounded walks reflected at
+-2.2 m, pixel noise, dropped detections, shuffled detection slots), drawn
with a `torch.Generator` on the device in a few large calls.  The numbers
are not the script's (it draws from numpy's RandomState frame by frame);
the distributions are.  It imports nothing of the program: the harness
hands the same arrays to the tracker and to the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# canonical standing COCO-17 skeleton (x right, y forward, z up; meters)
CANONICAL_COCO = np.array([
    [0.00, 0.00, 1.70], [0.03, -0.03, 1.73], [-0.03, -0.03, 1.73],
    [0.07, -0.06, 1.70], [-0.07, -0.06, 1.70], [0.18, 0.00, 1.45],
    [-0.18, 0.00, 1.45], [0.25, 0.02, 1.20], [-0.25, 0.02, 1.20],
    [0.27, 0.05, 0.95], [-0.27, 0.05, 0.95], [0.10, 0.00, 0.95],
    [-0.10, 0.00, 0.95], [0.12, 0.03, 0.50], [-0.12, 0.03, 0.50],
    [0.13, 0.00, 0.05], [-0.13, 0.00, 0.05],
], dtype=np.float64)
N_KPS = 17
FRAME_BLOCK = 256   # frames drawn per block, to bound the generator's memory


class Calibration(NamedTuple):
    """The rig as a calibration file holds it (float64)."""

    K: np.ndarray    # (V, 3, 3)
    Rt: np.ndarray   # (V, 3, 4)
    wh: np.ndarray   # (V, 2)


class Take(NamedTuple):
    kps: torch.Tensor    # (F, V, P, 17, 3) float32 pixels and scores
    valid: torch.Tensor  # (F, V, P) bool


def _look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ eye


def camera_ring(rig: dict) -> Calibration:
    """`rig["views"]` cameras evenly on a circle of `radius` m at `height` m,
    all looking at `center`, with one pinhole intrinsic (`focal`, `image_wh`)."""
    V = int(rig["views"])
    w, h = rig["image_wh"]
    f = float(rig["focal"])
    center = np.asarray(rig["center"], dtype=np.float64)
    Ks, Rts = [], []
    for v in range(V):
        ang = 2.0 * np.pi * v / V
        eye = np.array([rig["radius"] * np.cos(ang), rig["radius"] * np.sin(ang), rig["height"]])
        R, t = _look_at(eye, center)
        Ks.append(np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]]))
        Rts.append(np.concatenate([R, t[:, None]], axis=1))
    return Calibration(K=np.stack(Ks), Rt=np.stack(Rts),
                       wh=np.tile(np.array([w, h], dtype=np.float64), (V, 1)))


def projections(cal: Calibration) -> np.ndarray:
    """(V, 3, 4) float64 P = K [R | t]."""
    return np.einsum("vij,vjk->vik", cal.K, cal.Rt)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_take(cal: Calibration, scene: dict, slots: int, n_frames: int, seed: int,
              device) -> Take:
    """`n_frames` frames of `scene["people"]` people walking through the ring,
    detected in every view with `scene["noise_px"]` px of noise, each
    detection dropped with probability `scene["drop_prob"]`, the kept ones
    packed into `slots` detection slots a view in a random order.  The walks
    are `scene["walk_seed"]`'s, turned by the run's seed.  The same seed on
    the same kind of device gives the same take."""
    dev = torch.device(device)
    g = generator(seed, dev)
    f64 = torch.float64
    n = int(scene["people"])
    V = cal.K.shape[0]
    bound = float(scene["walk_bound_m"])

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev, dtype=f64)

    # one fixed set of walks (`walk_seed`) that every seed turns about the
    # ring's axis by a whole number of camera steps (an equivalent rig), so
    # that every seed asks for the same work and only the detections' noise,
    # drops, scores and order differ
    gw = generator(scene["walk_seed"], dev)
    start_lo, start_hi = scene["start_m"]
    starts = start_lo + (start_hi - start_lo) * torch.rand((n, 2), generator=gw, device=dev,
                                                           dtype=f64)
    vels = scene["speed_m"] * (2 * torch.rand((n, 2), generator=gw, device=dev, dtype=f64) - 1)
    phases = 2 * math.pi * torch.rand((n,), generator=gw, device=dev, dtype=f64)
    turn = 2 * math.pi * int(torch.randint(V, (1,), generator=g, device=dev)) / V
    lo_s, hi_s = scene["score_range"]
    P = torch.as_tensor(projections(cal), dtype=f64, device=dev)         # (V, 3, 4)
    base = torch.as_tensor(CANONICAL_COCO, dtype=f64, device=dev)        # (17, 3)

    kps = torch.zeros((n_frames, V, slots, N_KPS, 3), dtype=torch.float32, device=dev)
    valid = torch.zeros((n_frames, V, slots), dtype=torch.bool, device=dev)
    for f0 in range(0, n_frames, FRAME_BLOCK):
        F = min(FRAME_BLOCK, n_frames - f0)
        fr = torch.arange(f0, f0 + F, dtype=f64, device=dev)[:, None]  # (F, 1)
        pts = base.expand(F, n, N_KPS, 3).clone()                       # (F, n, 17, 3)
        sway = 0.05 * torch.sin(0.3 * fr + phases)                      # (F, n)
        step = 0.08 * torch.sin(0.5 * fr + phases)
        pts[:, :, [7, 9], 1] += sway[..., None]
        pts[:, :, [8, 10], 1] -= sway[..., None]
        pts[:, :, [13, 15], 1] += step[..., None]
        pts[:, :, [14, 16], 1] -= step[..., None]
        ang = 0.2 * fr * vels[:, 0]                                     # (F, n)
        c, s = torch.cos(ang), torch.sin(ang)
        x = pts[..., 0] * c[..., None] - pts[..., 1] * s[..., None]
        y = pts[..., 0] * s[..., None] + pts[..., 1] * c[..., None]
        # bounded walk: a triangle wave keeps everyone inside the ring
        raw = starts + fr[..., None] * vels                             # (F, n, 2)
        pos = bound - torch.abs(torch.remainder(raw + bound, 4 * bound) - 2 * bound)
        wx, wy = x + pos[..., 0:1], y + pos[..., 1:2]
        ct, st = math.cos(turn), math.sin(turn)
        world = torch.stack([ct * wx - st * wy, st * wx + ct * wy, pts[..., 2]], dim=-1)
        homo = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
        uvw = torch.einsum("vab,fnkb->fvnka", P, homo)                  # (F, V, n, 17, 3)
        uv = uvw[..., :2] / uvw[..., 2:3]
        uv = uv + float(scene["noise_px"]) * torch.randn(uv.shape, generator=g, device=dev,
                                                         dtype=f64)
        score = uniform(lo_s, hi_s, F, V, n, N_KPS)
        kept = uniform(0.0, 1.0, F, V, n) >= float(scene["drop_prob"])
        # the kept detections fill the slots in a random order of the people
        order = torch.argsort(uniform(0.0, 1.0, F, V, n), dim=-1)      # (F, V, n)
        kept_o = torch.gather(kept, 2, order)
        slot = torch.cumsum(kept_o.to(torch.int64), dim=-1) - 1
        ok = kept_o & (slot < slots)
        fi, vi, ji = torch.nonzero(ok, as_tuple=True)
        person = order[fi, vi, ji]
        si = slot[fi, vi, ji]
        det = torch.cat([uv[fi, vi, person], score[fi, vi, person][..., None]], dim=-1)
        kps[f0 + fi, vi, si] = det.to(torch.float32)
        valid[f0 + fi, vi, si] = True
    return Take(kps=kps, valid=valid)
