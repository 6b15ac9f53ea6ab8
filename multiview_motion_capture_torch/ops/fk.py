"""Forward kinematics of the BASIC_18 skeleton on tensors.

Port of `multiview_motion_capture_tpu/ops/fk.py` (ref:src/
inverse_kinematics.py:120-199): local rotations R = Rx @ Ry @ Rz in closed
form, the parent chain composed one tree level at a time (depth 6), and the
11 mirror-shared bone lengths expanded to 18 bones.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from multiview_motion_capture_torch.ops.consts import on_device
from multiview_motion_capture_torch.pose_def import (
    BASIC_18_PARENTS,
    basic18_side_bone_maps,
)

Tensor = torch.Tensor

N_JOINTS = 18
SIDE_JOINT_IDX, SIDE_TO_FULL = basic18_side_bone_maps()
N_SIDE_BONES = len(SIDE_JOINT_IDX)  # 11

# Reference rest-pose offsets of the 18 joints (ref:src/inverse_kinematics.py:120-140).
REF_OFFSETS = np.array(
    [
        [0, 0, 0],
        [0.15, 0, 0], [0, 0, -0.5], [0, 0, -0.5],
        [-0.15, 0, 0], [0, 0, -0.5], [0, 0, -0.5],
        [0, 0, 0.3], [0, 0, 0.3],
        [0.2, 0, 0], [0.3, 0, 0], [0.3, 0, 0],
        [-0.2, 0, 0], [-0.3, 0, 0], [-0.3, 0, 0],
        [0, -0.02, 0.15], [0.07, 0.02, 0.1], [-0.07, 0.02, 0.1],
    ],
    dtype=np.float64,
)


def _offsets_to_dirs_lens(offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lens = np.linalg.norm(offsets, axis=-1)
    dirs = offsets.copy()
    dirs[1:] = dirs[1:] / lens[1:, None]
    return dirs, lens


REF_BONE_DIRS, REF_BONE_LENS = _offsets_to_dirs_lens(REF_OFFSETS)
REF_SIDE_BONE_LENS = REF_BONE_LENS[SIDE_JOINT_IDX]  # (11,)


def _tree_levels(parents: np.ndarray) -> List[np.ndarray]:
    depth = np.zeros(len(parents), dtype=np.int64)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    return [np.nonzero(depth == d)[0] for d in range(1, depth.max() + 1)]


_LEVELS = _tree_levels(BASIC_18_PARENTS)
_PARENTS = np.asarray(BASIC_18_PARENTS, dtype=np.int64)


def _ancestor_masks(parents: np.ndarray):
    """(ANC, ANC_SELF): ANC[j, k] = j is a proper ancestor of k;
    ANC_SELF includes j == k."""
    J = len(parents)
    anc = np.zeros((J, J), dtype=np.float32)
    for k in range(1, J):
        j = parents[k]
        while True:
            anc[j, k] = 1.0
            if j == 0:
                break
            j = parents[j]
    anc_self = anc + np.eye(J, dtype=np.float32)
    return anc, anc_self


ANC_MASK, ANC_SELF_MASK = _ancestor_masks(np.asarray(BASIC_18_PARENTS))
# one-hot (18, 11): bone j draws its length from side entry SIDE_TO_FULL[j]
SIDE_ONE_HOT = np.zeros((N_JOINTS, N_SIDE_BONES), dtype=np.float32)
for _j in range(1, N_JOINTS):
    SIDE_ONE_HOT[_j, SIDE_TO_FULL[_j]] = 1.0


class Skeleton(NamedTuple):
    """Static skeleton definition (tensors on the run's device)."""

    bone_dirs: Tensor        # (18, 3) unit rest directions (root row zero)
    side_bone_lens: Tensor   # (11,) reference side lengths
    parents: Tensor          # (18,) int64

    @classmethod
    def default(cls, dtype=torch.float32, device="cpu") -> "Skeleton":
        return cls(
            bone_dirs=torch.as_tensor(REF_BONE_DIRS, dtype=dtype, device=device),
            side_bone_lens=torch.as_tensor(REF_SIDE_BONE_LENS, dtype=dtype,
                                           device=device),
            parents=torch.as_tensor(_PARENTS, device=device),
        )

    def to(self, dtype) -> "Skeleton":
        """The same skeleton with its float fields in `dtype`."""
        return self._replace(bone_dirs=self.bone_dirs.to(dtype),
                             side_bone_lens=self.side_bone_lens.to(dtype))


def euler_to_matrix(euler: Tensor) -> Tensor:
    """(..., 3) euler angles -> (..., 3, 3) rotation R = Rx @ Ry @ Rz."""
    cx, cy, cz = torch.cos(euler[..., 0]), torch.cos(euler[..., 1]), torch.cos(euler[..., 2])
    sx, sy, sz = torch.sin(euler[..., 0]), torch.sin(euler[..., 1]), torch.sin(euler[..., 2])
    r00 = cy * cz
    r01 = -cy * sz
    r02 = sy
    r10 = cx * sz + cz * sx * sy
    r11 = cx * cz - sx * sy * sz
    r12 = -cy * sx
    r20 = sx * sz - cx * cz * sy
    r21 = cz * sx + cx * sy * sz
    r22 = cx * cy
    return torch.stack(
        [torch.stack([r00, r01, r02], dim=-1),
         torch.stack([r10, r11, r12], dim=-1),
         torch.stack([r20, r21, r22], dim=-1)],
        dim=-2,
    )


def side_to_full_bone_lens(side_lens: Tensor) -> Tensor:
    """(..., 11) shared lengths -> (..., 18) per-joint lengths."""
    return side_lens[..., on_device(SIDE_TO_FULL, side_lens.device)]


def mm3(a: Tensor, b: Tensor) -> Tensor:
    """Batched 3x3 @ 3x3 as a broadcast multiply-sum (the JAX package's
    summation, kept so both round alike)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def mv3(a: Tensor, v: Tensor) -> Tensor:
    """Batched 3x3 @ 3-vector as a broadcast multiply-sum."""
    return (a * v[..., None, :]).sum(dim=-1)


def euler_axis_matrices(euler: Tensor):
    """Per-axis rotation matrices and their angle derivatives (Rx, Ry, Rz,
    dRx, dRy, dRz), each (..., 3, 3): R = Rx @ Ry @ Rz and dR/d(angle_i)
    substitutes the i-th derivative matrix (the analytic IK jacobian)."""
    c = torch.cos(euler)
    s = torch.sin(euler)
    z = torch.zeros_like(euler[..., 0])
    o = torch.ones_like(z)

    def m(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    Rx = m([[o, z, z], [z, cx, -sx], [z, sx, cx]])
    Ry = m([[cy, z, sy], [z, o, z], [-sy, z, cy]])
    Rz = m([[cz, -sz, z], [sz, cz, z], [z, z, o]])
    dRx = m([[z, z, z], [z, -sx, -cx], [z, cx, -sx]])
    dRy = m([[-sy, z, cy], [z, z, z], [-cy, z, -sy]])
    dRz = m([[-sz, -cz, z], [cz, -sz, z], [z, z, z]])
    return Rx, Ry, Rz, dRx, dRy, dRz


def _compose(skel: Skeleton, root: Tensor, R_local: Tensor, side_lens: Tensor):
    offsets = skel.bone_dirs * side_to_full_bone_lens(side_lens)[..., None]
    g_R = [R_local[..., 0, :, :]] + [None] * (N_JOINTS - 1)
    g_t = [root] + [None] * (N_JOINTS - 1)
    for level in _LEVELS:
        par = _PARENTS[level]
        lvl = on_device(level, root.device)
        pR = torch.stack([g_R[p] for p in par], dim=-3)
        pt = torch.stack([g_t[p] for p in par], dim=-2)
        new_R = mm3(pR, R_local[..., lvl, :, :])
        new_t = mv3(pR, offsets[..., lvl, :]) + pt
        for i, j in enumerate(level):
            g_R[j] = new_R[..., i, :, :]
            g_t[j] = new_t[..., i, :]
    return torch.stack(g_t, dim=-2), torch.stack(g_R, dim=-3), offsets


def forward_kinematics_full(skel: Skeleton, root: Tensor, euler: Tensor,
                            side_lens: Tensor):
    """FK that also returns what the analytic jacobian needs:
    (joints (..., 18, 3), g_R (..., 18, 3, 3), (Rx, Ry, Rz), offsets)."""
    Rx, Ry, Rz, _, _, _ = euler_axis_matrices(euler)
    R_local = mm3(mm3(Rx, Ry), Rz)
    joints, g_R, offsets = _compose(skel, root, R_local, side_lens)
    return joints, g_R, (Rx, Ry, Rz), offsets


def forward_kinematics(skel: Skeleton, root: Tensor, euler: Tensor,
                       side_lens: Tensor) -> Tensor:
    """Joint positions (..., 18, 3) from root (..., 3), euler (..., 18, 3)
    and side_lens (..., 11)."""
    joints, _, _ = _compose(skel, root, euler_to_matrix(euler), side_lens)
    return joints
