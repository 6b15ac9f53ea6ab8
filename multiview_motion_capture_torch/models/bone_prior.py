"""Statistical bone-length / bone-direction priors (numpy, float64).

Port of `multiview_motion_capture_tpu/models/bone_prior.py`: fit per-bone
length distributions from a corpus of 3D poses (here, a tracklet's own
frames) and score a bone-length vector against them with a Mahalanobis
residual.  Its callers (`reid`, `crossings`) run on the host in float64 in
both packages, so this module is numpy only: the JAX package's
`prior_residual` is operators only and gives the same values on numpy
inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from multiview_motion_capture_torch.pose_def import BASIC_18_PARENTS, basic18_side_bone_maps


@dataclasses.dataclass(frozen=True)
class BonePrior:
    """Per-bone length statistics (index 0 = root, unused)."""

    mean: np.ndarray   # (J,)
    std: np.ndarray    # (J,)
    parents: np.ndarray

    def side_prior(self):
        """Collapse to the mirror-shared 11-length parameterization of the
        IK solver (left and right bones pooled)."""
        side_idx, side_to_full = basic18_side_bone_maps()
        n_side = len(side_idx)
        mean = np.zeros(n_side)
        var = np.zeros(n_side)
        count = np.zeros(n_side)
        for j in range(1, len(self.parents)):
            s = side_to_full[j]
            mean[s] += self.mean[j]
            var[s] += self.std[j] ** 2
            count[s] += 1
        count = np.maximum(count, 1)
        # the root's side entry has no incoming bone: keep its std positive
        # so the Mahalanobis residual stays finite (its mean stays 0)
        return mean / count, np.maximum(np.sqrt(var / count), 1e-6)


def fit_bone_prior(poses_3d: np.ndarray,
                   parents: Optional[Sequence[int]] = None) -> BonePrior:
    """Fit per-bone length statistics from (N, J, 3) poses."""
    parents = np.asarray(parents if parents is not None else BASIC_18_PARENTS)
    poses = np.asarray(poses_3d)
    lens = np.linalg.norm(poses - poses[:, parents, :], axis=-1)  # (N, J)
    return BonePrior(mean=lens.mean(axis=0), std=lens.std(axis=0) + 1e-6, parents=parents)


def bone_direction_stats(poses_3d: np.ndarray,
                         parents: Optional[Sequence[int]] = None) -> np.ndarray:
    """Mean unit bone directions in the root-relative frame."""
    parents = np.asarray(parents if parents is not None else BASIC_18_PARENTS)
    vecs = np.asarray(poses_3d) - np.asarray(poses_3d)[:, parents, :]
    norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
    dirs = vecs / np.maximum(norms, 1e-9)
    mean_dir = dirs.mean(axis=0)
    mean_dir[1:] /= np.maximum(np.linalg.norm(mean_dir[1:], axis=-1, keepdims=True), 1e-9)
    return mean_dir


def prior_residual(side_lens, prior_mean, prior_std, weight: float = 1.0):
    """Mahalanobis bone-length residual: weight * (l - mu) / sigma."""
    return weight * (side_lens - prior_mean) / prior_std
