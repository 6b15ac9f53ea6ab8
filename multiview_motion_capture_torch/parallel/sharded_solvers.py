"""Cluster-sharded ALS and track-sharded LM: one rig's independent solves
spread over the devices of a mesh.

Port of `multiview_motion_capture_tpu/parallel/sharded_solvers.py`.

- `sharded_cluster_als`: the C independent per-cluster ALS problems of a
  frame (`tracker._clustered_association`), C/n contiguous clusters to each
  device, solved there by ONE `als_kernel.match_als_batched` launch (B3 on
  a CUDA device, its plain version on the CPU), then gathered on the
  caller's device.  B3's per-problem results equal solo solves bit for bit
  (one thread-block cluster per problem, each stopping at its own test), so
  the decisions are bit-equal to the unsharded clustered tracker's.  The
  JAX package names B3 as the device-local solver on real hardware and
  certifies its XLA solver only because it had CPU meshes.
- `sharded_lm_solve`: `ops.ik.solve_two_stage` with the T track slots in
  n contiguous chunks, each solved on its device (B2 under "gj", B4 under
  "gj_fused", the f64 Cholesky under "chol"), then concatenated on the
  caller's device.  No collectives: the LM's every-few-iterations break
  test (`ops/ik.py`) is per device, as JAX's while loop is per shard.

The devices are driven one after another from the calling thread: work
for distinct GPUs is queued before any result is read back (the ALS), or
each shard's LM runs to its end before the next starts (its break test
reads the device).  A device may repeat in a mesh.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from multiview_motion_capture_torch.ops import als_kernel
from multiview_motion_capture_torch.ops import ik as ik_ops
from multiview_motion_capture_torch.ops.fk import Skeleton
from multiview_motion_capture_torch.parallel.mesh import Mesh, visible_devices

Tensor = torch.Tensor


def make_axis_mesh(n_devices: Optional[int] = None, axis_name: str = "x",
                   devices=None) -> Mesh:
    """A 1-axis mesh over the first `n_devices` devices (all visible CUDA
    devices by default; `devices=` gives them explicitly)."""
    return Mesh(visible_devices(n_devices, devices), axis_names=(axis_name,))


def make_cluster_mesh(n_devices: Optional[int] = None, axis_name: str = "cl",
                      devices=None) -> Mesh:
    """A 1-axis mesh over the cluster dimension (for `sharded_cluster_als`)."""
    return make_axis_mesh(n_devices, axis_name, devices)


def make_track_mesh(n_devices: Optional[int] = None, axis_name: str = "tk",
                    devices=None) -> Mesh:
    """A 1-axis mesh over the track-slot dimension (for `sharded_lm_solve`)."""
    return make_axis_mesh(n_devices, axis_name, devices)


def replicate(t: Tensor, devices: Sequence[torch.device]) -> Tuple[Tensor, ...]:
    """A copy of `t` on each device (the same tensor where it already lies
    there)."""
    return tuple(t.to(d) for d in devices)


def sharded_cluster_als(
    subs: Tensor,            # (C, nc, nc) stacked per-cluster similarity
    diag_mask,               # (nc, nc) shared same-group mask, or one per device
    init_A,                  # (nc, rank) shared seeded init factor, or one per device
    mesh: Mesh,
    axis: str = "cl",
    *,
    alpha: float,
    beta: float,
    mu0: float,
    tol: float,
    max_iter: int,
    stable_iters: int,
) -> Tuple[Tensor, Tensor]:
    """Solve every cluster's ALS with clusters sharded over `mesh[axis]`:
    one `match_als_batched` launch per device on its C/n clusters.

    `diag_mask` and `init_A` are one tensor (copied to each device) or a
    sequence of per-device copies (`TrackerContext` keeps them).  Returns
    (x_bin (C, nc, nc) bool, n_iters (C,) int32) on the device of `subs`."""
    C = subs.shape[0]
    devices = mesh.axis_devices(axis)
    n_shard = len(devices)
    if C % n_shard != 0:
        raise ValueError(
            f"assoc_clusters={C} not divisible by mesh axis {axis}={n_shard}")
    masks = diag_mask if isinstance(diag_mask, (tuple, list)) else replicate(diag_mask, devices)
    inits = init_A if isinstance(init_A, (tuple, list)) else replicate(init_A, devices)
    per = C // n_shard
    results = []
    for d, dev in enumerate(devices):
        # every device's launch is queued before any result is read back
        results.append(als_kernel.match_als_batched(
            subs[d * per:(d + 1) * per].to(dev).contiguous(), masks[d], inits[d],
            alpha=alpha, beta=beta, mu0=mu0, tol=tol, max_iter=max_iter,
            stable_iters=stable_iters))
    home = subs.device
    return (torch.cat([r.x_bin.to(home) for r in results]),
            torch.cat([r.n_iters.to(home) for r in results]))


def sharded_lm_solve(
    init: ik_ops.IkParams,   # (T, ...) leaves
    skel,                    # Skeleton, or one per device
    obs_coco: Tensor,        # (T, V, 17, 3) per-slot observations
    view_w: Tensor,          # (T, V) view weights
    Pmats: Tensor,           # (V, 3, 4) shared or (T, V, 3, 4) per-slot
    mesh: Mesh,
    axis: str = "tk",
    **solve_kw,
) -> Tuple[ik_ops.IkParams, Tensor]:
    """`ops.ik.solve_two_stage` with the track batch sharded over
    `mesh[axis]`: T/n contiguous slots to each device, no collectives.
    Per-slot `Pmats` (the `ik_max_views` case) shard with their slots.
    `skel` is one Skeleton (moved to each device) or a sequence of
    per-device copies.  Returns (params, joints (T, 18, 3)) on the device
    of `view_w`."""
    T = view_w.shape[0]
    devices = mesh.axis_devices(axis)
    n_shard = len(devices)
    if T % n_shard != 0:
        raise ValueError(
            f"max_tracks={T} not divisible by mesh axis {axis}={n_shard}")
    skels = (tuple(Skeleton(*(t.to(d) for t in skel)) for d in devices)
             if isinstance(skel, Skeleton) else skel)
    per = T // n_shard
    home = view_w.device
    params, joints = [], []
    for d, dev in enumerate(devices):
        sl = slice(d * per, (d + 1) * per)
        p_d, j_d = ik_ops.solve_two_stage(
            ik_ops.IkParams(*(x[sl].to(dev) for x in init)), skels[d],
            obs_coco[sl].to(dev), view_w[sl].to(dev),
            (Pmats[sl] if Pmats.dim() == 4 else Pmats).to(dev), **solve_kw)
        params.append(p_d)
        joints.append(j_d)
    out = ik_ops.IkParams(*(torch.cat([p[i].to(home) for p in params])
                            for i in range(len(ik_ops.IkParams._fields))))
    return out, torch.cat([j.to(home) for j in joints])
