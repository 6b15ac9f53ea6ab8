"""Device meshes for the port's multi-device paths.

Port of `multiview_motion_capture_tpu/parallel/mesh.py`.  JAX's `Mesh` (an
array of devices with named axes, entered by `shard_map`) becomes `Mesh`,
a small class of the port's own: an array of `torch.device`s, its axis
names and `shape[axis]`.  The sharded stages (`parallel.sharded_*`,
`parallel.streams`, `parallel.train`) run in one process over the mesh's
device list, as JAX's single controller does: each places its shard's
tensors on its device, launches there, and gathers the results on the
caller's device.

By default a mesh takes the first n visible CUDA devices and raises when
fewer are visible.  Every mesh-making function also takes an explicit
`devices=` list: `[torch.device("cpu")] * n` in the CPU tests (the
counterpart of XLA's `--xla_force_host_platform_device_count`),
`[torch.device("cuda:0")] * n` to exercise an n-way mesh on one card.  A
device may repeat; nothing falls back to another device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def pick_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Split devices into (dp, tp): the largest power-of-two tp <= 4 that
    divides the device count, data-parallel over the rest."""
    tp = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            tp = cand
            break
    return n_devices // tp, tp


class Mesh:
    """An array of devices with one name per axis.  `shape[axis]` is the
    size of that axis (a dict, as `jax.sharding.Mesh.shape`); `devices` is
    a numpy object array of `torch.device`s."""

    def __init__(self, devices, axis_names: Sequence[str]):
        """`devices`: a (nested) list or array of devices (or their names),
        one nesting level per axis."""
        given = np.asarray(devices, dtype=object)
        if given.ndim != len(axis_names):
            raise ValueError(f"devices of shape {given.shape} for axes {tuple(axis_names)}")
        self.devices = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            self.devices[idx] = torch.device(given[idx])
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` (a 1-axis mesh: all of them; else the
        first entry of every other axis)."""
        a = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[a] = slice(None)
        return list(self.devices[tuple(idx)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def visible_devices(n_devices: Optional[int] = None, devices=None) -> list:
    """`devices` as a list of `torch.device`s, cut to `n_devices`; by
    default the visible CUDA devices, raising when fewer than `n_devices`
    are visible."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"{n_devices} devices asked for, {len(devs)} given")
            devs = devs[:n_devices]
        return devs
    n_vis = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_vis == 0:
        raise RuntimeError("no CUDA device is visible; pass devices=[...] (e.g. "
                           "[torch.device('cpu')] * n) to build a mesh without one")
    n = n_vis if n_devices is None else n_devices
    if n > n_vis:
        raise ValueError(f"a mesh of {n} devices but only {n_vis} devices visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "tp"), devices=None) -> Mesh:
    devs = visible_devices(n_devices, devices)
    dp, tp = pick_mesh_shape(len(devs))
    return Mesh([devs[i * tp:(i + 1) * tp] for i in range(dp)], axis_names)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Composable multi-device sharding of ONE tracker (the JAX package's
    `MeshSpec`).

    Each field shards one sequential stage of the per-frame step over that
    many devices; the stages run one after another in the same step, so
    they reuse the same devices through three 1-axis meshes:

    - ``cameras``: the O(V^2 P^2 K) epipolar similarity blocks, camera-
      sharded (parallel.sharded_association),
    - ``clusters``: the C independent per-cluster ALS solves, one B3
      launch per device (parallel.sharded_solvers.sharded_cluster_als),
    - ``tracks``: the T independent per-slot LM IK solves
      (parallel.sharded_solvers.sharded_lm_solve).

    0 leaves a stage unsharded.  `TrackerContext.build` validates
    divisibility (n_views % cameras, assoc_clusters % clusters,
    max_tracks % tracks) with clear errors.
    """
    cameras: int = 0
    clusters: int = 0
    tracks: int = 0

    @classmethod
    def parse(cls, spec: str) -> "MeshSpec":
        """Parse ``"cameras=4,clusters=8,tracks=8"`` (any subset of keys)."""
        kw = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(
                    f"mesh spec item {part!r}: expected key=N with key in "
                    "{cameras, clusters, tracks}")
            k, v = part.split("=", 1)
            k = k.strip()
            if k not in ("cameras", "clusters", "tracks"):
                raise ValueError(
                    f"unknown mesh spec key {k!r} (cameras/clusters/tracks)")
            kw[k] = int(v)
        return cls(**kw)

    def context_kwargs(self, device="cuda") -> dict:
        """Mesh kwargs for :meth:`TrackerContext.build` on `device`: a CUDA
        device takes the first n visible cards (and raises when fewer are
        visible); the CPU repeats itself n times, as the JAX package's
        tests see 8 virtual CPU devices."""
        from multiview_motion_capture_torch.parallel.sharded_solvers import make_axis_mesh

        dev = torch.device(device)
        kw = {}
        if dev.type == "cuda":
            n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
            for field, n in (("cameras", self.cameras),
                             ("clusters", self.clusters),
                             ("tracks", self.tracks)):
                if n <= 0:
                    continue
                if n > n_dev:
                    raise ValueError(
                        f"MeshSpec.{field}={n} but only {n_dev} devices visible")

        def mesh(n, axis):
            return make_axis_mesh(n, axis, devices=[dev] * n if dev.type == "cpu" else None)

        if self.cameras > 0:
            kw["mesh"] = mesh(self.cameras, "dp")
        if self.clusters > 0:
            kw["cluster_mesh"] = mesh(self.clusters, "cl")
        if self.tracks > 0:
            kw["ik_mesh"] = mesh(self.tracks, "tk")
        return kw
