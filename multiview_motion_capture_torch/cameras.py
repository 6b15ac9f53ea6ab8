"""Stacked multi-camera calibration as a dataclass of tensors.

Port of `multiview_motion_capture_tpu/cameras.py`: all V cameras live in
stacked tensors so pairwise geometry is one batched op.  The fundamental
matrices are built on the host in float64 and cast to f32 once per
sequence, exactly as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CameraBank:
    """Calibration of V pinhole cameras (no distortion).

    K:      (V, 3, 3) intrinsics
    Rt:     (V, 3, 4) world->camera extrinsics [R|t]
    P:      (V, 3, 4) projection K @ [R|t]
    Kr_inv: (V, 3, 3) R^T K^-1 (uv+1 -> world ray)
    cam_loc:(V, 3)    camera center in world coordinates (-R^T t)
    img_wh: (V, 2)    image width/height in pixels
    """

    K: torch.Tensor
    Rt: torch.Tensor
    P: torch.Tensor
    Kr_inv: torch.Tensor
    cam_loc: torch.Tensor
    img_wh: torch.Tensor

    @property
    def n_views(self) -> int:
        return self.K.shape[0]

    def to(self, device) -> "CameraBank":
        return CameraBank(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    @classmethod
    def from_k_rt(cls, Ks: np.ndarray, Rts: np.ndarray, img_whs: np.ndarray,
                  dtype=torch.float32, device="cpu") -> "CameraBank":
        Ks = np.asarray(Ks, dtype=np.float64)
        Rts = np.asarray(Rts, dtype=np.float64)
        Ps = np.einsum("vij,vjk->vik", Ks, Rts)
        R = Rts[:, :, :3]
        t = Rts[:, :, 3]
        Kr_inv = np.einsum("vji,vjk->vik", R, np.linalg.inv(Ks))  # R^T K^-1
        cam_loc = -np.einsum("vji,vj->vi", R, t)                   # -R^T t

        def tt(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(K=tt(Ks), Rt=tt(Rts), P=tt(Ps), Kr_inv=tt(Kr_inv),
                   cam_loc=tt(cam_loc), img_wh=tt(img_whs))

    @classmethod
    def from_json_dir(cls, calib_dir: Path, names: Sequence[str] = None,
                      dtype=torch.float32, device="cpu") -> "CameraBank":
        """Load the reference's calib JSON format:
        {"K": [9], "RT": [12], "imgSize": [w, h]} per camera."""
        calib_dir = Path(calib_dir)
        if names is None:
            paths = sorted(calib_dir.glob("*.json"), key=lambda p: p.stem)
        else:
            paths = [calib_dir / f"{n}.json" for n in names]
        Ks, Rts, whs = [], [], []
        for p in paths:
            with open(p, "r") as f:
                d = json.load(f)
            Ks.append(np.asarray(d["K"], dtype=np.float64).reshape(3, 3))
            Rts.append(np.asarray(d["RT"], dtype=np.float64).reshape(3, 4))
            whs.append(np.asarray(d["imgSize"], dtype=np.float64))
        return cls.from_k_rt(np.stack(Ks), np.stack(Rts), np.stack(whs),
                             dtype=dtype, device=device)


def pairwise_fundamental_np(K: np.ndarray, Rt: np.ndarray) -> np.ndarray:
    """All-pairs fundamental tensor (V, V, 3, 3) in float64 on the host
    (formula of ref:src/mv_math_util.py:267-285).  Calibration is static per
    sequence, so F is computed once at full precision and shipped to the
    device as an f32 constant; computing it in f32 loses ~1 px of epipolar
    distance at 1k-pixel image scale."""
    K = np.asarray(K, dtype=np.float64)
    Rt = np.asarray(Rt, dtype=np.float64)
    R, t = Rt[..., :3], Rt[..., 3]

    def skew(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

    V = len(K)
    F = np.zeros((V, V, 3, 3))
    for i in range(V):
        for j in range(V):
            Rrel = R[i] @ R[j].T
            e = K[j] @ R[j] @ R[i].T @ (t[i] - Rrel @ t[j])
            F[i, j] = np.linalg.inv(K[i]).T @ Rrel @ K[j].T @ skew(e)
            if F[i, j].sum() == 0:
                F[i, j] += 1e-12
            # normalize for stable f32 storage (lines are re-normalized anyway)
            n = np.linalg.norm(F[i, j])
            if n > 1e-30:
                F[i, j] /= n
    return F


def pairwise_fundamental_det_np(P: np.ndarray) -> np.ndarray:
    """All-pairs F via the projection-minor construction (float64, host;
    ref:src/mv_math_util.py:57-77, Hartley & Zisserman 9.2.2): F_ij maps
    image-i points to image-j lines via l = F x."""
    P = np.asarray(P, dtype=np.float64)
    V = len(P)
    cyc = [(1, 2), (2, 0), (0, 1)]
    F = np.zeros((V, V, 3, 3))
    for a in range(V):
        for b in range(V):
            for i in range(3):
                for j in range(3):
                    rows = np.vstack([P[a][list(cyc[j])], P[b][list(cyc[i])]])
                    F[a, b, i, j] = np.linalg.det(rows)
            # normalize for stable f32 storage (F is scale-invariant)
            n = np.linalg.norm(F[a, b])
            if n > 0:
                F[a, b] /= n
    return F


def look_at_camera(eye: np.ndarray, target: np.ndarray,
                   up=(0, 0, 1.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Build [R|t] for a camera at `eye` looking at `target` (synthetic rigs)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ eye
    return R, t


def camera_ring_k_rt(n_views: int, radius: float = 4.0, height: float = 1.6,
                     img_wh=(1032, 776), focal: float = 1100.0,
                     center=(0.0, 0.0, 1.0)) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The float64 K (V, 3, 3), [R | t] (V, 3, 4) and image sizes (V, 2) of
    `synthetic_camera_ring`'s cameras.  The bank keeps K and [R | t] in
    float32 but forms P from these values, so calibration files written from
    them load back into the same bank, bit for bit."""
    Ks, Rts, whs = [], [], []
    w, h = img_wh
    center = np.asarray(center, dtype=np.float64)
    for v in range(n_views):
        ang = 2.0 * np.pi * v / n_views
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        R, t = look_at_camera(eye, center)
        K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1.0]])
        Ks.append(K)
        Rts.append(np.concatenate([R, t[:, None]], axis=1))
        whs.append(np.array([w, h], dtype=np.float64))
    return np.stack(Ks), np.stack(Rts), np.stack(whs)


def synthetic_camera_ring(n_views: int, radius: float = 4.0, height: float = 1.6,
                          img_wh=(1032, 776), focal: float = 1100.0,
                          center=(0.0, 0.0, 1.0)) -> CameraBank:
    """A ring of cameras around the capture volume, for synthetic/scaled
    configs (on the CPU; `CameraBank.to` moves it)."""
    return CameraBank.from_k_rt(*camera_ring_k_rt(n_views, radius, height, img_wh, focal,
                                                  center))
