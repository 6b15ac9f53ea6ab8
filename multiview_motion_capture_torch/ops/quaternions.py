"""Quaternion algebra on (..., 4) tensors in wxyz layout.

Port of `multiview_motion_capture_tpu/ops/quaternions.py`, with the same
conventions: `qmul(a, b)` is the reference's `a * b`
(ref:src/Quaternions.py:96-115), `to_euler` its xyz extraction
(ref:src/Quaternions.py:268-272), `average` its eigen-average
(ref:src/Quaternions.py:310-322).  The IK's geometric cold-start init uses
`from_matrix`, `qrot`, `between` and `to_euler`; the rest serves motion
tooling.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

_EPS = 1e-10


def normalize(q: Tensor) -> Tensor:
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)


def conjugate(q: Tensor) -> Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qmul(a: Tensor, b: Tensor) -> Tensor:
    q0, q1, q2, q3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    r0, r1, r2, r3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [r0 * q0 - r1 * q1 - r2 * q2 - r3 * q3,
         r0 * q1 + r1 * q0 - r2 * q3 + r3 * q2,
         r0 * q2 + r1 * q3 + r2 * q0 - r3 * q1,
         r0 * q3 - r1 * q2 + r2 * q1 + r3 * q0],
        dim=-1,
    )


def qrot(q: Tensor, v: Tensor) -> Tensor:
    """Rotate 3-vectors by quaternions (the reference's `q * v`)."""
    vq = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return qmul(q, qmul(vq, conjugate(q)))[..., 1:]


def to_matrix(q: Tensor) -> Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrices (ref:src/Quaternions.py:335-366)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = qx + qx, qy + qy, qz + qz
    xx, yy, zz = qx * x2, qy * y2, qz * z2
    wx, wy, wz = qw * x2, qw * y2, qw * z2
    xy, yz, xz = qx * y2, qy * z2, qx * z2
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def from_matrix(m: Tensor) -> Tensor:
    """(..., 3, 3) -> (..., 4): the reference's branch-free Shepperd variant
    (ref:src/Quaternions.py:465-506) with its sign fixups as selects."""
    d0, d1, d2 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    q0 = torch.sqrt(((d0 + d1 + d2 + 1.0) / 4.0).clamp(min=0.0))
    q1 = torch.sqrt(((d0 - d1 - d2 + 1.0) / 4.0).clamp(min=0.0))
    q2 = torch.sqrt(((-d0 + d1 - d2 + 1.0) / 4.0).clamp(min=0.0))
    q3 = torch.sqrt(((-d0 - d1 + d2 + 1.0) / 4.0).clamp(min=0.0))

    c0 = (q0 >= q1) & (q0 >= q2) & (q0 >= q3)
    c1 = (q1 >= q0) & (q1 >= q2) & (q1 >= q3) & ~c0
    c2 = (q2 >= q0) & (q2 >= q1) & (q2 >= q3) & ~c0 & ~c1

    s = torch.sign
    m21_12 = s(m[..., 2, 1] - m[..., 1, 2])
    m02_20 = s(m[..., 0, 2] - m[..., 2, 0])
    m10_01 = s(m[..., 1, 0] - m[..., 0, 1])
    p10_01 = s(m[..., 1, 0] + m[..., 0, 1])
    p02_20 = s(m[..., 0, 2] + m[..., 2, 0])
    p21_12 = s(m[..., 2, 1] + m[..., 1, 2])

    w = torch.where(c0, q0, torch.where(c1, q0 * m21_12,
                                        torch.where(c2, q0 * m02_20, q0 * m10_01)))
    x = torch.where(c0, q1 * m21_12, torch.where(c1, q1,
                                                 torch.where(c2, q1 * p10_01, q1 * p02_20)))
    y = torch.where(c0, q2 * m02_20, torch.where(c1, q2 * p10_01,
                                                 torch.where(c2, q2, q2 * p21_12)))
    z = torch.where(c0, q3 * m10_01, torch.where(c1, q3 * p02_20,
                                                 torch.where(c2, q3 * p21_12, q3)))
    return torch.stack([w, x, y, z], dim=-1)


def from_angle_axis(angle: Tensor, axis: Tensor) -> Tensor:
    """(...,), (..., 3) -> (..., 4) (ref:src/Quaternions.py:444-448)."""
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + _EPS)
    half = angle[..., None] / 2.0
    axis, half = torch.broadcast_tensors(axis, half)
    return torch.cat([torch.cos(half[..., :1]), axis * torch.sin(half)], dim=-1)


def to_angle_axis(q: Tensor) -> Tuple[Tensor, Tensor]:
    """(..., 4) -> (angles (...,), axes (..., 3)) (ref:src/Quaternions.py:324-333)."""
    q = normalize(q)
    s = torch.sqrt((1.0 - q[..., 0] ** 2).clamp(min=0.0))
    s = torch.where(s == 0, torch.full_like(s, 0.001), s)
    return 2.0 * torch.acos(q[..., 0].clamp(-1.0, 1.0)), q[..., 1:] / s[..., None]


_AXES = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0), "z": (0.0, 0.0, 1.0)}


def from_euler(es: Tensor, order: str = "xyz", world: bool = False) -> Tensor:
    """(..., 3) euler angles -> (..., 4) (ref:src/Quaternions.py:450-462)."""
    qs = [from_angle_axis(es[..., i], torch.tensor(_AXES[order[i]], dtype=es.dtype,
                                                   device=es.device))
          for i in range(3)]
    if world:
        return qmul(qs[2], qmul(qs[1], qs[0]))
    return qmul(qs[0], qmul(qs[1], qs[2]))


def to_euler(q: Tensor) -> Tensor:
    """(..., 4) -> (..., 3) xyz euler extraction."""
    q = normalize(q)
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ez = torch.atan2(2 * (q0 * q3 - q1 * q2), q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3)
    ey = torch.asin((2 * (q1 * q3 + q0 * q2)).clamp(-1.0, 1.0))
    ex = torch.atan2(2 * (q0 * q1 - q2 * q3), q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3)
    return torch.stack([ex, ey, ez], dim=-1)


def between(v0: Tensor, v1: Tensor) -> Tensor:
    """Quaternion rotating v0 onto v1 (ref:src/Quaternions.py:437-440)."""
    a = torch.linalg.cross(v0, v1)
    w = torch.sqrt((v0 ** 2).sum(-1) * (v1 ** 2).sum(-1)) + (v0 * v1).sum(-1)
    return normalize(torch.cat([w[..., None], a], dim=-1))


def exp(w: Tensor) -> Tensor:
    """Exponential map: rotation vectors (..., 3) -> quaternions
    (ref:src/Quaternions.py:393-405)."""
    t = torch.linalg.vector_norm(w, dim=-1)
    t_safe = torch.where(t == 0, torch.full_like(t, 0.001), t)
    scale = torch.sin(t_safe) / t_safe
    return normalize(torch.cat([torch.cos(t_safe)[..., None], w * scale[..., None]], dim=-1))


def log(q: Tensor) -> Tensor:
    """Log map: quaternions -> rotation vectors (..., 3)
    (ref:src/Quaternions.py:196-201)."""
    q = normalize(q)
    w = q[..., :1]
    q = q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))  # abs() hemisphere
    imgs = q[..., 1:]
    lens = torch.linalg.vector_norm(imgs, dim=-1)
    scale = torch.atan2(lens, q[..., 0]) / (lens + _EPS)
    return imgs * scale[..., None]


def slerp(q0: Tensor, q1: Tensor, a) -> Tensor:
    """Spherical interpolation (ref:src/Quaternions.py:408-434); `a` in
    [0, 1] broadcasts over the batch."""
    a = torch.as_tensor(a, dtype=q0.dtype, device=q0.device)
    d = (q0 * q1).sum(-1)
    q1 = torch.where(d[..., None] < 0, -q1, q1)
    d = d.abs()
    linear = (1.0 - d) < 0.01
    omega = torch.acos(torch.where(linear, torch.zeros_like(d), d).clamp(-1.0, 1.0))
    sinom = torch.where(linear, torch.ones_like(omega), torch.sin(omega))
    w0 = torch.where(linear, 1.0 - a, torch.sin((1.0 - a) * omega) / sinom)
    w1 = torch.where(linear, a, torch.sin(a * omega) / sinom)
    return w0[..., None] * q0 + w1[..., None] * q1


def average(qs: Tensor) -> Tensor:
    """Eigen-average of an (N, 4) quaternion set (ref:src/Quaternions.py:
    310-322): the eigenvector of sum_i q_i q_i^T best aligned with the
    inputs."""
    system = torch.einsum("ni,nj->ij", qs, qs)
    _, v = torch.linalg.eigh(system)           # columns ascending by eigenvalue
    align = (1.0 - torch.einsum("ni,ij->nj", qs, v) ** 2).sum(0)
    return v[:, torch.argmin(align)]
