"""Forward kinematics over arbitrary skeletons (CMU rigs, BVH imports).

Port of `multiview_motion_capture_tpu/ops/fk_generic.py`: the reference's
minimal CMU FK (ref:src/kinematics.py:11-31 + skeleton_CMU.yml) and the
replay of skeletons parsed from BVH files (`utils.bvh.read_bvh`): any
topology given as a parent array.  As `ops/fk.py`, the parent chain is
composed one tree level at a time, every joint of a level in one batched
product; f32 on the skeleton's device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from multiview_motion_capture_torch.ops.fk import euler_to_matrix
from multiview_motion_capture_torch.utils.precision import high_precision, resolve_device

Tensor = torch.Tensor


class GenericSkeleton(NamedTuple):
    parents: np.ndarray        # (J,) int, parent[0] == -1 or 0 (root)
    offsets: Tensor            # (J, 3) rest offsets from the parent
    levels: tuple              # per-depth joint index tuples

    @classmethod
    def build(cls, parents: Sequence[int], offsets: np.ndarray,
              device="cuda") -> "GenericSkeleton":
        """A skeleton on `device` ("cuda" unless the caller asks for
        "cpu"); `parents` must be topologically ordered (parent < child)."""
        dev = resolve_device(device)
        parents = np.asarray(parents, dtype=np.int64)
        parents = np.where(parents < 0, 0, parents)
        J = len(parents)
        depth = np.zeros(J, dtype=np.int64)
        for j in range(1, J):
            if parents[j] >= j:
                raise ValueError("parents must be topologically ordered (parent < child)")
            depth[j] = depth[parents[j]] + 1
        levels = tuple(
            tuple(np.nonzero(depth == d)[0].tolist())
            for d in range(1, int(depth.max()) + 1)
        ) if J > 1 else ()
        return cls(parents=parents,
                   offsets=torch.as_tensor(np.asarray(offsets), dtype=torch.float32,
                                           device=dev),
                   levels=levels)

    @property
    def n_joints(self) -> int:
        return len(self.parents)


def forward_kinematics_generic(skel: GenericSkeleton, root: Tensor, euler: Tensor,
                               offsets: Optional[Tensor] = None) -> Tensor:
    """Global joint positions (..., J, 3) from root (..., 3) and local euler
    angles (..., J, 3) in radians, R = Rx @ Ry @ Rz; `offsets` (..., J, 3)
    overrides the rest offsets."""
    high_precision()
    off = skel.offsets if offsets is None else offsets
    R_local = euler_to_matrix(euler)
    dev = R_local.device
    g_R = torch.eye(3, dtype=R_local.dtype, device=dev).expand(R_local.shape).clone()
    g_R[..., 0, :, :] = R_local[..., 0, :, :]
    g_t = torch.zeros(euler.shape[:-1] + (3,), dtype=R_local.dtype, device=dev)
    g_t[..., 0, :] = root
    for level in skel.levels:
        lv = torch.as_tensor(level, device=dev)
        par = torch.as_tensor(skel.parents[list(level)], device=dev)
        pR = g_R[..., par, :, :]
        pt = g_t[..., par, :]
        g_R[..., lv, :, :] = torch.einsum("...ab,...bc->...ac", pR, R_local[..., lv, :, :])
        o = off[..., lv, :] if off.dim() > 2 else off[lv]
        g_t[..., lv, :] = torch.einsum("...ab,...b->...a", pR, o) + pt
    return g_t


def cmu_like_skeleton(offsets: np.ndarray, parents: Sequence[int],
                      device="cuda") -> GenericSkeleton:
    """The reference's 31-joint CMU rig topology (skeleton_CMU.yml), or any
    other, from offsets normally read from a BVH or yml file."""
    return GenericSkeleton.build(parents, offsets, device=device)


def animate_bvh(bvh_data, device="cuda") -> Tensor:
    """Positions (F, J, 3) for a parsed BVH file (`utils.bvh.BvhData`), on
    `device` ("cuda" unless the caller asks for "cpu"), in the file's
    units."""
    skel = GenericSkeleton.build(bvh_data.parents, bvh_data.offsets, device=device)
    dev = skel.offsets.device
    roots = torch.as_tensor(np.asarray(bvh_data.roots), dtype=torch.float32, device=dev)
    eulers = torch.as_tensor(np.asarray(bvh_data.eulers), dtype=torch.float32, device=dev)
    return forward_kinematics_generic(skel, roots, eulers)
