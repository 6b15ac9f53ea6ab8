"""Camera-sharded similarity blocks for wide rigs.

Port of `multiview_motion_capture_tpu/parallel/sharded_association.py`.
The O(V^2 P^2 K) epipolar blocks of the association matrix are split over
the camera axis: device d computes the distance rows of its V/n cameras
against a copy of every view's keypoints (JAX's `all_gather`), and the rows
are concatenated on the caller's device.

Each device's rows come from the same operations as the unsharded block
(`ops.geometry`), on the row subset, in the dtype of the inputs (the
tracker passes `WORK_DTYPE`, f64, as its unsharded path computes), so the
result equals the unsharded block bit for bit; JAX's version matches its
unsharded block to a tolerance only.

The per-device F blocks can be prepared once (`affinity_constants`,
`st_epipolar_constants`; `TrackerContext` keeps them) and passed as
`consts`; without them they are cut from `F` and copied at each call.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from multiview_motion_capture_torch.ops.geometry import (
    _homo,
    _normalize_lines,
    masked_symmetric_epipolar_error,
)
from multiview_motion_capture_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def _row_blocks(V: int, mesh: Mesh, axis: str):
    """(device, rows slice) of each shard of the camera axis."""
    devices = mesh.axis_devices(axis)
    n_shard = len(devices)
    if V % n_shard != 0:
        raise ValueError(f"V={V} not divisible by mesh axis {axis}={n_shard}")
    Vl = V // n_shard
    return [(dev, slice(d * Vl, (d + 1) * Vl)) for d, dev in enumerate(devices)]


def affinity_constants(F: Tensor, mesh: Mesh, axis: str = "dp",
                       dtype: Optional[torch.dtype] = None) -> Tuple[Tuple[Tensor, Tensor], ...]:
    """Per shard, on its device: the F rows (Vl, V, 3, 3) and columns
    (V, Vl, 3, 3) of its cameras, for `sharded_affinity`."""
    F = F if dtype is None else F.to(dtype)
    return tuple((F[rows].to(dev).contiguous(), F[:, rows].to(dev).contiguous())
                 for dev, rows in _row_blocks(F.shape[0], mesh, axis))


def st_epipolar_constants(F: Tensor, mesh: Mesh, axis: str = "dp",
                          dtype: Optional[torch.dtype] = None) -> Tuple[Tensor, ...]:
    """Per shard, on its device: the F rows (Vl, V, 3, 3) of its cameras,
    for `sharded_st_epipolar`."""
    F = F if dtype is None else F.to(dtype)
    return tuple(F[rows].to(dev).contiguous()
                 for dev, rows in _row_blocks(F.shape[0], mesh, axis))


def sharded_affinity(kps: Tensor, F: Tensor, mesh: Mesh, axis: str = "dp",
                     consts: Optional[Sequence[Tuple[Tensor, Tensor]]] = None) -> Tensor:
    """All-pairs symmetric spatial epipolar distances, camera-sharded.

    The values of `ops.geometry.projected_distance_all_pairs` (the spatial
    affinity of ref:src/mv_math_util.py:288-343), with the V axis split
    over the mesh: device d holds cameras [d*Vl, (d+1)*Vl) and produces
    their distance rows from the lines of its points in every image and
    the lines of every image's points in its images.

    kps: (V, P, K, >=2); F: (V, V, 3, 3) (or `consts` from
    `affinity_constants`).  Returns (V, P, V, P) on the device of kps."""
    blocks = _row_blocks(kps.shape[0], mesh, axis)
    if consts is None:
        consts = affinity_constants(F, mesh, axis)
    rows_out = []
    for (dev, rows), (F_rows, F_cols) in zip(blocks, consts):
        homo = _homo(kps[..., :2].to(dev))                               # (V, P, K, 3)
        homo_l = homo[rows]
        # forward: lines of local points a in every image b (l = F_ab^T x_a)
        lines_f = _normalize_lines(torch.einsum("abyx,apky->abpkx", F_rows, homo_l))
        d_ab = torch.einsum("abpkx,bqkx->abpqk", lines_f, homo).abs().mean(dim=-1)
        # reverse: lines of every image's points b in local image a
        # (l = F_ba^T x_b), the transposed entries of the same block
        lines_r = _normalize_lines(torch.einsum("abyx,apky->abpkx", F_cols, homo))
        d_ba = torch.einsum("abpkx,bqkx->abpqk", lines_r, homo_l).abs().mean(dim=-1)
        sym = 0.5 * (d_ab + d_ba.permute(1, 0, 3, 2))                    # (Vl, V, P, P)
        rows_out.append(sym.permute(0, 2, 1, 3))                         # (Vl, P, V, P)
    return torch.cat([r.to(kps.device) for r in rows_out])


def sharded_st_epipolar(kps: Tensor, F: Tensor, min_pair_score: float, mesh: Mesh,
                        axis: str = "dp", consts: Optional[Sequence[Tensor]] = None) -> Tensor:
    """Camera-sharded score-gated symmetric epipolar block: the 2D-2D part
    of the spatial-time similarity matrix (ref:src/motion_capture.py:
    673-741, `ops.geometry.masked_symmetric_epipolar_error`).

    Device d computes the rows of its local cameras against a copy of every
    view's detections; the error is symmetric per (a, b) pair from F_ab
    alone, so the F rows of its cameras are all it needs.

    kps: (V, P, K, 3); F: (V, V, 3, 3) (or `consts` from
    `st_epipolar_constants`).  Returns (V, P, V, P) on the device of kps,
    NaN where no keypoint pair passes the score gate (same-view masking is
    the caller's job, as in the unsharded path)."""
    blocks = _row_blocks(kps.shape[0], mesh, axis)
    if consts is None:
        consts = st_epipolar_constants(F, mesh, axis)
    rows_out = []
    for (dev, rows), F_rows in zip(blocks, consts):
        k_all = kps.to(dev)
        ka = k_all[rows][:, :, None, None]          # (Vl, P, 1, 1, K, 3)
        kb = k_all[None, None]                      # (1, 1, V, P, K, 3)
        Fab = F_rows[:, None, :, None]              # (Vl, 1, V, 1, 3, 3)
        rows_out.append(masked_symmetric_epipolar_error(ka, kb, Fab, min_pair_score))
    return torch.cat([r.to(kps.device) for r in rows_out])
