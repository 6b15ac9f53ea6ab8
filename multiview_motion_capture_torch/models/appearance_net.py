"""Metric-learned appearance embedding head, in PyTorch.

Port of `multiview_motion_capture_tpu/models/appearance_net.py`'s
inference side: a small MLP on the keypoint-color-layout descriptor
(`data.detect.appearance_from_keypoints`) that maps it to a unit
embedding for the tracker's appearance evidence (`config.appearance_dim`).
Zero rows (empty detection slots) stay zero, the tracker's "no appearance
evidence" sentinel: a biased MLP maps 0 to nonzero, so `apply_head` masks
its output by the input row's norm.  The layers are `torch.nn.Linear`
(the JAX package's are `nn.Dense`, no Pallas kernel).

Not ported yet: the training side (`supcon_loss`, `cosine_gap`,
`make_train_step`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn


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
