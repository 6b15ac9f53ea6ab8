"""Metric-learned appearance embedding head, in PyTorch.

Port of `multiview_motion_capture_tpu/models/appearance_net.py`'s
inference side: a small MLP on the keypoint-color-layout descriptor
(`data.detect.appearance_from_keypoints`) that maps it to a unit
embedding for the tracker's appearance evidence (`config.appearance_dim`).
Zero rows (empty detection slots) stay zero, the tracker's "no appearance
evidence" sentinel: a biased MLP maps 0 to nonzero, so `apply_head` masks
its output by the input row's norm.  The layers are `torch.nn.Linear`
(the JAX package's are `nn.Dense`, no Pallas kernel).

The training side: `init_head` (flax Dense's initialisation, drawn from a
`torch.Generator`), the supervised NT-Xent loss `supcon_loss`, the
calibration statistic `cosine_gap` and the AdamW step `make_train_step`
(identity-labelled descriptors come from `data.appearance_train`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from multiview_motion_capture_torch.models.pose_net import lecun_normal_
from multiview_motion_capture_torch.utils.precision import high_precision, resolve_device


@dataclasses.dataclass(frozen=True)
class AppearanceHeadConfig:
    # keypoint-color-layout descriptor width: n_kps * 3 (COCO-17 -> 51)
    in_dim: int = 51
    hidden: Tuple[int, ...] = (128, 64)
    out_dim: int = 32


class AppearanceHead(nn.Module):
    """(N, in_dim) -> (N, out_dim) unit rows.  flax's layers `Dense_0..`
    are `layers[0..]`."""

    def __init__(self, cfg: AppearanceHeadConfig = AppearanceHeadConfig()):
        super().__init__()
        self.cfg = cfg
        dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.out_dim,)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        x = self.layers[-1](x)
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)


def apply_head(head: AppearanceHead, emb: torch.Tensor) -> torch.Tensor:
    """(..., in_dim) descriptors -> (..., out_dim) unit embeddings; rows
    that are zero in the input stay zero."""
    shape = emb.shape
    flat = emb.reshape(-1, shape[-1])
    z = head(flat)
    live = torch.linalg.vector_norm(flat, dim=-1, keepdim=True) > 1e-6
    z = torch.where(live, z, 0.0)
    return z.reshape(shape[:-1] + (head.cfg.out_dim,))


def init_head(generator: torch.Generator, cfg: AppearanceHeadConfig = AppearanceHeadConfig(),
              device="cuda") -> AppearanceHead:
    """A head initialised as flax's `Dense`: LeCun-normal kernels
    (`pose_net.lecun_normal_`) and zero biases, drawn from `generator` (so
    not JAX's numbers for the same seed), on `device`."""
    dev = resolve_device(device)
    head = AppearanceHead(cfg)
    with torch.no_grad():
        for layer in head.layers:
            lecun_normal_(layer.weight, layer.in_features, generator)
            layer.bias.zero_()
    return head.to(dev)


def supcon_loss(z: torch.Tensor, labels: torch.Tensor, tau: float = 0.1) -> torch.Tensor:
    """Supervised NT-Xent over one batch of unit embeddings z (N, D) with
    identity labels (N,): for each anchor, the positives are the other
    samples of its identity and everything else is a negative; self-pairs
    are left out (at -1e9) and anchors without a positive are excluded
    from the mean."""
    n = z.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    sim = torch.where(eye, -1e9, (z @ z.T) / tau)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    log_prob = sim - torch.logsumexp(sim, dim=1, keepdim=True)
    n_pos = pos.sum(dim=1)
    per_anchor = -(torch.where(pos, log_prob, 0.0).sum(dim=1) / torch.clamp(n_pos, min=1))
    has_pos = n_pos > 0
    return (per_anchor * has_pos).sum() / torch.clamp(has_pos.sum(), min=1)


def cosine_gap(z: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean same-identity cosine, mean different-identity cosine) over all
    off-diagonal pairs: the statistic the tracker's auto gain runs on."""
    cos = z @ z.T
    eye = torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
    same = (labels[:, None] == labels[None, :]) & ~eye
    diff = ~same & ~eye
    m_same = torch.where(same, cos, 0.0).sum() / torch.clamp(same.sum(), min=1)
    m_diff = torch.where(diff, cos, 0.0).sum() / torch.clamp(diff.sum(), min=1)
    return m_same, m_diff


def make_train_step(head: AppearanceHead, optimizer: torch.optim.Optimizer, tau: float = 0.1):
    """step(embs (N, in_dim), labels (N,)) -> the SupCon loss before the
    update (a 0-d tensor); `head` and `optimizer` are updated in place.
    Pins full-f32 matmuls (no TF32)."""
    high_precision()

    def step(embs, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = supcon_loss(head(embs), labels, tau)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
