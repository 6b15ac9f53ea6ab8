"""Training harness for the bottom-up keypoint CNN, rendered evaluation
sequences and detection quality.

Port of `multiview_motion_capture_tpu/data/detect_train.py`:
`generate_samples` renders domain-randomized (frame, view) samples from
3D-consistent synthetic scenes (host numpy through `data.render`, drawn
from one numpy `RandomState` a scene in the JAX package's order, so the
images are the JAX package's bit for bit) and computes their supervision
with `models.pose_net`'s torch targets on `device`; `make_train_step` is
the peak-weighted heatmap + offset step; `render_sequence` renders a
synthetic sequence's views for the detection path; `evaluate_detections`
scores a detector against the rendered ground truth.  `SampleSet` keeps
the JAX package's field names, so its npz caches load here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from multiview_motion_capture_torch.data.render import RenderConfig, render_scene
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
from multiview_motion_capture_torch.models.pose_net import (
    PoseNet,
    PoseNetConfig,
    center_targets,
    gaussian_heatmaps,
    offset_loss,
    offset_targets,
)
from multiview_motion_capture_torch.utils.precision import high_precision, resolve_device

TARGET_CHUNK = 64   # samples whose targets are computed at once


@dataclasses.dataclass
class SampleSet:
    images: np.ndarray    # (N, H, W, 3) f32
    kps_px: np.ndarray    # (N, P, 17, 2) frame px (NaN for absent)
    present: np.ndarray   # (N, P) bool supervision presence (with
                          # visibility_aware: detectable people only)
    heat_tgt: np.ndarray  # (N, hh, hw, K+1) keypoint + center targets
    off_tgt: np.ndarray   # (N, hh, hw, 2K)
    off_mask: np.ndarray  # (N, hh, hw, K)
    vis: np.ndarray = None  # (N, P, 17) bool per-joint visibility from the
                            # renderer's owner map


def _cam_locations(cams) -> np.ndarray:
    Rt = np.asarray(cams.Rt, dtype=np.float64)  # (V, 3, 4)
    R, t = Rt[:, :, :3], Rt[:, :, 3]
    return -np.einsum("vji,vj->vi", R, t)


def generate_samples(
    seeds: List[int],
    render_cfg: RenderConfig,
    n_frames: int = 6,
    n_people_range: Tuple[int, int] = (1, 4),
    n_views: int = 4,
    max_people: int = 6,
    zoom_range: Tuple[float, float] = (0.75, 1.3),
    heat_sigma: float = 2.0,
    center_sigma: float = 1.5,
    world_scale: float = 0.25,
    min_person_distance: float = 0.9,
    visibility_aware: bool = False,
    min_visible_joints: int = 5,
    device="cuda",
) -> SampleSet:
    """Render (frame, view) samples from 3D-consistent synthetic scenes.

    Every sample is one camera view of a multi-person scene: people occlude
    each other as their 3D positions dictate (painter's algorithm by
    camera distance), a per-sample zoom varies the apparent scale, and all
    randomization comes from the scene seed (held-out seeds give a clean
    evaluation set).

    `visibility_aware=True` (the dense-crowd curriculum): painted-over
    joints get no heatmap or offset target, and a person with fewer than
    `min_visible_joints` visible joints is not supervised at all (center
    target 0): `present` then means "detectable".  The default reproduces
    the plain supervision; `vis` is returned either way (the renderer's
    draws are the same).

    The targets are computed on `device` (default "cuda"; without a GPU
    that raises) in chunks of TARGET_CHUNK samples and returned as numpy.
    """
    dev = resolve_device(device)
    H, W = render_cfg.hw
    hh, hw = H // 4, W // 4
    imgs, all_kps, all_pres, all_vis = [], [], [], []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        n_people = int(rng.randint(n_people_range[0], n_people_range[1] + 1))
        seq = synthetic_sequence(
            n_frames=n_frames, n_people=n_people, n_views=n_views,
            noise_px=0.0, drop_prob=0.0, seed=seed,
            min_person_distance=min_person_distance,
        )
        cam_loc = _cam_locations(seq.cameras)
        kseq = seq.batch.kps[..., :2] * world_scale  # full-res px -> render px
        for f in range(n_frames):
            for v in range(n_views):
                zoom = rng.uniform(*zoom_range)
                kv = kseq[f, v].copy()
                pres = seq.batch.valid[f, v].copy()
                ctr = np.array([W / 2, H / 2])
                kv[..., :2] = (kv[..., :2] - ctr) * zoom + ctr
                # a person counts when most joints are inside the frame
                inside = (
                    (kv[..., 0] >= -5) & (kv[..., 0] < W + 5)
                    & (kv[..., 1] >= -5) & (kv[..., 1] < H + 5)
                ).mean(axis=-1) > 0.6
                pres = pres & inside
                # camera distance orders occlusion
                slot_p = seq.gt_slot_person[f, v]
                depth = np.array([
                    np.linalg.norm(seq.gt_3d[f, slot_p[s], 11] - cam_loc[v])
                    if slot_p[s] >= 0 else 1e9
                    for s in range(len(pres))
                ])
                img, vis = render_scene(kv, pres, depth, rng, render_cfg,
                                        return_visibility=True)
                kp_pad = np.full((max_people, 17, 2), np.nan, np.float32)
                pr_pad = np.zeros(max_people, bool)
                vis_pad = np.zeros((max_people, 17), bool)
                n = min(max_people, len(pres))
                kp_pad[:n] = kv[:n]
                pr_pad[:n] = pres[:n]
                vis_pad[:n] = vis[:n]
                imgs.append(img)
                all_kps.append(kp_pad)
                all_pres.append(pr_pad)
                all_vis.append(vis_pad)

    images = np.stack(imgs)
    kps_px = np.stack(all_kps)
    present = np.stack(all_pres)
    vis_arr = np.stack(all_vis)
    if visibility_aware:
        present = present & (vis_arr.sum(axis=-1) >= min_visible_joints)

    # supervision at heatmap resolution; f32 inputs as the JAX package
    # hands them to its target functions
    khm = np.nan_to_num(kps_px) / 4.0
    N, P = present.shape
    if visibility_aware:
        # a painted-over joint contributes no heatmap gaussian and no offset
        joint_w = (vis_arr & present[..., None]).astype(np.float32)
    else:
        joint_w = np.broadcast_to(present[:, :, None], (N, P, 17)).astype(np.float32)
    heat_out = np.zeros((N, hh, hw, 18), dtype=np.float32)
    off_out = np.zeros((N, hh, hw, 34), dtype=np.float32)
    om_out = np.zeros((N, hh, hw, 17), dtype=np.float32)

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    with torch.no_grad():
        for s in range(0, N, TARGET_CHUNK):
            e = min(N, s + TARGET_CHUNK)
            kc = on_dev(khm[s:e].astype(np.float32))                    # (n, P, 17, 2)
            jw = on_dev(joint_w[s:e])
            g = gaussian_heatmaps(kc.reshape(e - s, P * 17, 2), (hh, hw), sigma=heat_sigma)
            kt = (g.reshape(e - s, hh, hw, P, 17) * jw[:, None, None]).amax(dim=3)
            centers = on_dev(khm[s:e].mean(axis=2).astype(np.float32))
            pres_c = on_dev(present[s:e])
            ct = center_targets(centers, pres_c.float(), (hh, hw), sigma=center_sigma)
            ot, om = offset_targets(centers, kc, pres_c, jw, (hh, hw), radius=2.0)
            heat_out[s:e] = torch.cat([kt, ct[..., None]], dim=-1).cpu().numpy()
            off_out[s:e] = ot.cpu().numpy()
            om_out[s:e] = om.cpu().numpy()
    return SampleSet(images=images, kps_px=kps_px, present=present, heat_tgt=heat_out,
                     off_tgt=off_out, off_mask=om_out, vis=vis_arr)


def render_sequence(seq, render_cfg: RenderConfig,
                    world_scale: float = 0.25, seed: int = 0,
                    person_tints: np.ndarray = None) -> np.ndarray:
    """Render a SyntheticSequence's views consistently (no per-sample zoom):
    (F, V, H, W, 3) f32 frames in [0, 1] whose detections match
    `seq.batch.kps * world_scale` (pair with cameras scaled by the same
    factor).  `person_tints` (N_people, 3) gives each person a stable
    clothing colour."""
    rng = np.random.RandomState(seed)
    cam_loc = _cam_locations(seq.cameras)
    F, V = seq.batch.kps.shape[:2]
    kseq = seq.batch.kps[..., :2] * world_scale
    out = np.zeros((F, V) + render_cfg.hw + (3,), dtype=np.float32)
    for f in range(F):
        for v in range(V):
            pres = seq.batch.valid[f, v]
            slot_p = seq.gt_slot_person[f, v]
            depth = np.array([
                np.linalg.norm(seq.gt_3d[f, slot_p[s], 11] - cam_loc[v])
                if slot_p[s] >= 0 else 1e9
                for s in range(len(pres))
            ])
            tints = (person_tints[np.clip(slot_p, 0, None)]
                     if person_tints is not None else None)
            out[f, v] = render_scene(kseq[f, v], pres, depth, rng, render_cfg,
                                     person_tints=tints)
    return out


def detect_loss(net: PoseNet, images: torch.Tensor, heat_tgt: torch.Tensor,
                off_tgt: torch.Tensor, off_mask: torch.Tensor, heat_weight: float = 1.0,
                peak_weight: float = 20.0, off_weight: float = 0.1) -> torch.Tensor:
    """The bottom-up PoseNet's training loss: a peak-weighted MSE over the
    K keypoint and the center channels (plain MSE dilutes the gaussian
    peaks over the mostly-background map) plus `off_weight` x the masked
    smooth-L1 of the offsets."""
    K = net.cfg.n_kps
    out = net(images)
    heat = out[..., :K + 1]
    l_heat = torch.mean((heat - heat_tgt) ** 2 * (1.0 + peak_weight * heat_tgt))
    l_off = offset_loss(out[..., K + 1:], off_tgt, off_mask)
    return heat_weight * l_heat + off_weight * l_off


def make_train_step(model_cfg: PoseNetConfig, net: PoseNet, optimizer: torch.optim.Optimizer,
                    heat_weight: float = 1.0, peak_weight: float = 20.0,
                    off_weight: float = 0.1):
    """step(images, heat_tgt, off_tgt, off_mask) -> the loss (a 0-d tensor,
    before the update): `detect_loss`, its gradients and the optimizer's
    update, applied to `net` and `optimizer` in place.  The tensors lie on
    `net`'s device; nothing reads the loss back to the host.  Pins full-f32
    convolutions (no TF32), as the detectors do."""
    if net.cfg != model_cfg:
        raise ValueError("net was built for another PoseNetConfig")
    high_precision()

    def step(images, heat_tgt, off_tgt, off_mask):
        optimizer.zero_grad(set_to_none=True)
        loss = detect_loss(net, images, heat_tgt, off_tgt, off_mask, heat_weight,
                           peak_weight, off_weight)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def evaluate_detections(
    det_kps: np.ndarray,    # (N, Pd, K, 3) detector output, frame px
    det_valid: np.ndarray,  # (N, Pd)
    gt_kps: np.ndarray,     # (N, P, K, 2)
    gt_present: np.ndarray,  # (N, P)
    match_px: float = 12.0,
):
    """Greedy nearest-person matching: recall@match_px, matched mean error,
    and precision (detections that matched some person)."""
    n_gt = 0
    n_hit = 0
    n_det = 0
    n_det_matched = 0
    errs = []
    for i in range(det_kps.shape[0]):
        gts = [gt_kps[i, p] for p in range(gt_kps.shape[1])
               if gt_present[i, p]]
        n_gt += len(gts)
        hit_gt = [False] * len(gts)
        for s in range(det_kps.shape[1]):
            if not det_valid[i, s]:
                continue
            n_det += 1
            if not gts:
                continue
            d = [np.nanmean(np.linalg.norm(det_kps[i, s, :, :2] - g, axis=-1))
                 for g in gts]
            j = int(np.argmin(d))
            if d[j] < match_px:
                n_det_matched += 1
                if not hit_gt[j]:
                    hit_gt[j] = True
                    n_hit += 1
                    errs.append(d[j])
    recall = n_hit / max(n_gt, 1)
    precision = n_det_matched / max(n_det, 1)
    err = float(np.mean(errs)) if errs else float("inf")
    return {"recall": recall, "precision": precision, "mean_err_px": err,
            "n_gt": n_gt, "n_det": n_det}
