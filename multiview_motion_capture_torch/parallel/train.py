"""Multi-device training step for the keypoint CNN: dp x tp over a mesh.

Port of `multiview_motion_capture_tpu/parallel/train.py`.  The JAX step is
GSPMD: parameters and Adam moments carry NamedSharding constraints, XLA
places the collectives, and the math is the unsharded step's.  Here one
process drives the mesh's device list, as JAX's single controller does,
and the same storage and math are spelled out:

- dp (mesh rows): the batch is split into contiguous rows' shares; each
  row runs a replica of the forward and backward on its first device, on
  its share, its loss scaled by 1/dp (the unsharded loss is the mean over
  the whole batch, GroupNorm being per sample); the rows' gradients are
  summed in row order on row 0's first device.
- tp (mesh columns): a leaf that meets JAX's rule (`param_sharding_rules`:
  its out-channel axis divisible by tp and at least 128 wide) is stored as
  tp slices of that axis, slice j on the column-j devices of every row, and
  so are its Adam moments; the forward gathers the slices, the reduced
  gradient is cut back into them.  Other leaves are replicated on every
  device.  Every device updates its own leaves with its own AdamW
  (`models/optim.AdamW`, optax.adamw's values), so every copy of a leaf
  steps identically.

At dp = tp = 1 the step is the port's unsharded `train_step`, bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from multiview_motion_capture_torch.models.checkpoint import _posenet_leaves
from multiview_motion_capture_torch.models.optim import AdamW
from multiview_motion_capture_torch.models.pose_net import (
    PoseNet,
    PoseNetConfig,
    gaussian_heatmaps,
    heatmap_loss,
    init_posenet,
)
from multiview_motion_capture_torch.parallel.mesh import Mesh
from multiview_motion_capture_torch.utils.precision import high_precision

Tensor = torch.Tensor
# the out-channel axis of each kind of leaf in torch's layouts: OIHW
# convolutions, (in, out, kh, kw) transposed convolutions, vectors
_OUT_AXIS = {"conv": 0, "deconv": 1, "vec": 0}


def param_sharding_rules(params, mesh: Mesh, tp_axis: str = "tp") -> Dict[str, Optional[int]]:
    """For each parameter of a PoseNet (a module), the axis its tp slices
    cut, or None where it is replicated: JAX's rule (shard the out-channel
    axis of a 4-d kernel or a vector when tp divides it and it is at least
    128 wide), read on the torch layout's out-channel axis."""
    tp = mesh.shape[tp_axis]
    names = {id(p): n for n, p in params.named_parameters()}
    rules = {}
    for _, p, kind in _posenet_leaves(params):
        ax = _OUT_AXIS[kind]
        width = p.shape[ax]
        shard = p.dim() in (1, 4) and width % tp == 0 and width >= 128
        rules[names[id(p)]] = ax if shard else None
    return rules


class ShardedParams:
    """A PoseNet's parameters over a (dp, tp) mesh: per mesh device, its
    leaves (`local[(i, j)]`, name -> `nn.Parameter` on that device: slice j
    of a tp-sharded leaf, the whole of a replicated one).  After a step each
    leaf's `.grad` holds its slice of the reduced gradient."""

    def __init__(self, net: PoseNet, mesh: Mesh, dp_axis: str = "dp", tp_axis: str = "tp"):
        self.cfg = net.cfg
        self.mesh = mesh
        self.axes = (dp_axis, tp_axis)
        self.rules = param_sharding_rules(net, mesh, tp_axis)
        self.names = [n for n, _ in net.named_parameters()]
        dp, tp = mesh.shape[dp_axis], mesh.shape[tp_axis]
        self.local = {(i, j): {} for i in range(dp) for j in range(tp)}
        self.load_module(net)

    def device(self, i: int, j: int) -> torch.device:
        a = [0, 0]
        a[self.mesh.axis_names.index(self.axes[0])] = i
        a[self.mesh.axis_names.index(self.axes[1])] = j
        return self.mesh.devices[tuple(a)]

    def load_module(self, net: PoseNet) -> None:
        """Set every leaf from `net`'s parameters (e.g. a module from
        `models.checkpoint.posenet_from_flax`), in place: optimizers built
        on these leaves keep them."""
        tp = self.mesh.shape[self.axes[1]]
        values = dict(net.named_parameters())
        with torch.no_grad():
            for (i, j), leaves in self.local.items():
                dev = self.device(i, j)
                for name in self.names:
                    v = values[name].detach()
                    ax = self.rules[name]
                    if ax is not None:
                        v = v.chunk(tp, dim=ax)[j]
                    v = v.to(dev, torch.float32).contiguous()
                    if name in leaves:
                        leaves[name].copy_(v)
                    else:
                        leaves[name] = torch.nn.Parameter(v.clone())

    def gather(self, row: int = 0, grads: bool = False, device=None) -> Dict[str, Tensor]:
        """Each leaf whole (its tp slices of mesh row `row` concatenated) on
        `device` (the row's first device by default); with `grads=True`
        their gradients instead."""
        dev = self.device(row, 0) if device is None else torch.device(device)
        tp = self.mesh.shape[self.axes[1]]
        out = {}
        for name in self.names:
            parts = [self.local[(row, j)][name] for j in range(tp)]
            parts = [(p.grad if grads else p).detach().to(dev) for p in parts]
            ax = self.rules[name]
            out[name] = parts[0] if ax is None else torch.cat(parts, dim=ax)
        return out

    def module(self, device=None) -> PoseNet:
        """The whole network as one PoseNet on `device`."""
        dev = self.device(0, 0) if device is None else torch.device(device)
        net = PoseNet(self.cfg)
        net.load_state_dict(self.gather(device=dev))
        return net.to(dev)


class DataSharding:
    """The batch axis over the mesh rows: `put(x)` cuts a batch into dp
    contiguous shares, share i on row i's first device (JAX's
    `NamedSharding(mesh, P("dp"))`)."""

    def __init__(self, params: ShardedParams):
        self.params = params

    def put(self, x: Tensor) -> Tuple[Tensor, ...]:
        dp = self.params.mesh.shape[self.params.axes[0]]
        if x.shape[0] % dp != 0:
            raise ValueError(f"batch of {x.shape[0]} not divisible by dp={dp}")
        return tuple(c.to(self.params.device(i, 0))
                     for i, c in enumerate(torch.chunk(x, dp, dim=0)))


def sharded_train_step(mesh: Mesh, cfg: PoseNetConfig = None, lr: float = 1e-3,
                       dp_axis: str = "dp", tp_axis: str = "tp"):
    """Build (step_fn, params, opt_state, data_sharding) for the heatmap
    training step over `mesh` (axes `dp_axis` x `tp_axis`, e.g. from
    `parallel.mesh.make_mesh`).

    `params` is a `ShardedParams` of a PoseNet initialised from a seeded
    generator (seed 0; `params.load_module(net)` sets other weights, e.g.
    `models.checkpoint.posenet_from_flax`); `opt_state` one AdamW(lr) per
    mesh device over its leaves; `data_sharding.put(x)` shares a batch over
    the rows.  `step_fn(params, opt_state, images, kps, kp_mask)` takes
    whole batches (cut by the step) or shares from `data_sharding`, updates
    the leaves in place and returns (params, opt_state, loss), the loss of
    the whole batch before the update on row 0's first device."""
    cfg = cfg or PoseNetConfig()
    high_precision()
    net = init_posenet(cfg, torch.Generator().manual_seed(0))
    params = ShardedParams(net, mesh, dp_axis, tp_axis)
    opt_state = {k: AdamW([leaves[n] for n in params.names], lr)
                 for k, leaves in params.local.items()}
    data_sharding = DataSharding(params)
    dp, tp = mesh.shape[dp_axis], mesh.shape[tp_axis]
    with torch.device("meta"):
        replica = PoseNet(cfg)   # the graph; its leaves come from `params`

    def rows(x) -> Sequence[Tensor]:
        return x if isinstance(x, (tuple, list)) else data_sharding.put(x)

    def step(params: ShardedParams, opt_state, images, kps, kp_mask):
        shares = list(zip(rows(images), rows(kps), rows(kp_mask)))
        home = params.device(0, 0)
        losses, grads = [], []
        for i, (img_i, kps_i, mask_i) in enumerate(shares):
            full = {n: t.requires_grad_() for n, t in params.gather(row=i).items()}
            target = gaussian_heatmaps(kps_i, cfg.heatmap_hw)
            heat = functional_call(replica, full, (img_i,))
            loss_i = heatmap_loss(heat, target, mask_i) / dp
            grads.append(torch.autograd.grad(loss_i, [full[n] for n in params.names]))
            losses.append(loss_i.detach())
        # reduce over the rows, in row order
        total = [g.to(home) for g in grads[0]]
        loss = losses[0].to(home)
        for i in range(1, dp):
            total = [a + g.to(home) for a, g in zip(total, grads[i])]
            loss = loss + losses[i].to(home)
        # cut the reduced gradient into each device's slices, then every
        # device steps its own leaves
        for (i, j), leaves in params.local.items():
            dev = params.device(i, j)
            for name, g in zip(params.names, total):
                ax = params.rules[name]
                if ax is not None:
                    g = g.chunk(tp, dim=ax)[j]
                leaves[name].grad = g.to(dev).contiguous()
            opt_state[(i, j)].step()
        return params, opt_state, loss

    return step, params, opt_state, data_sharding
