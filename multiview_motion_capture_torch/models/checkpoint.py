"""Detector weights: the JAX package's single-file npz checkpoints, read
and written by the port, and flax parameter trees carried across.

Port of `multiview_motion_capture_tpu/models/checkpoint.py`'s
`save_posenet` / `load_posenet` / `save_appearance_head` /
`load_appearance_head`, in the same file format, so either package loads
the other's files:

- one compressed npz, a key per parameter leaf, named by its flax path as
  `jax.tree_util.keystr` writes it (`['ResBlock_2']['Conv_2']['kernel']`),
  in flax's layout (conv kernels (kh, kw, in, out), dense kernels (in,
  out));
- the config as JSON bytes under `__posenet_config__` /
  `__appearance_head_config__` (`compute_dtype` by name, e.g. "bfloat16");
- weights stored narrower (the shipped PoseNet's f16) are restored as f32.

`posenet_from_flax` and `head_from_flax` build the port's modules from a
flax parameter tree given as nested dicts of numpy arrays.  The loaders
put the module on `device` ("cuda" unless the caller asks for the CPU;
without a GPU the default raises).

`save_params` / `load_params` are the training side's parameter files in
the JAX package's npz format: `<path>.npz`, a key per leaf as above, no
config.  That is what the JAX package's `save_params` writes when orbax
cannot be imported; with orbax it writes a StandardCheckpointer directory
(tensorstore), which needs orbax to read, so `load_params` refuses one
with an error that names the format.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from multiview_motion_capture_torch.models.appearance_net import (
    AppearanceHead,
    AppearanceHeadConfig,
)
from multiview_motion_capture_torch.models.pose_net import PoseNet, PoseNetConfig
from multiview_motion_capture_torch.utils.precision import high_precision, resolve_device

POSENET_CONFIG_KEY = "__posenet_config__"
HEAD_CONFIG_KEY = "__appearance_head_config__"


# flax layout <-> torch layout, by kind of leaf
def _to_torch(a: np.ndarray, kind: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if kind == "conv":      # (kh, kw, in, out) -> (out, in, kh, kw)
        return t.permute(3, 2, 0, 1)
    if kind == "deconv":    # flax transpose_kernel=False: flip, -> (in, out, kh, kw)
        return t.flip(0, 1).permute(2, 3, 0, 1)
    if kind == "dense":     # (in, out) -> (out, in)
        return t.T
    return t


def _to_flax(t: torch.Tensor, kind: str) -> np.ndarray:
    t = t.detach().cpu()
    if kind == "conv":
        t = t.permute(2, 3, 1, 0)
    elif kind == "deconv":
        t = t.permute(2, 3, 0, 1).flip(0, 1)
    elif kind == "dense":
        t = t.T
    return t.contiguous().numpy()


def _norm_leaves(prefix: tuple, norm: nn.GroupNorm):
    yield prefix + ("scale",), norm.weight, "vec"
    yield prefix + ("bias",), norm.bias, "vec"


def _posenet_leaves(net: PoseNet):
    """(flax path, torch parameter, kind) for every leaf of the flax tree."""
    yield ("Conv_0", "kernel"), net.stem.weight, "conv"
    yield from _norm_leaves(("GroupNorm_0",), net.stem_norm)
    for i, block in enumerate(net.blocks):
        name = f"ResBlock_{i}"
        yield (name, "Conv_0", "kernel"), block.conv1.weight, "conv"
        yield from _norm_leaves((name, "GroupNorm_0"), block.norm1)
        yield (name, "Conv_1", "kernel"), block.conv2.weight, "conv"
        yield from _norm_leaves((name, "GroupNorm_1"), block.norm2)
        if block.proj is not None:
            yield (name, "Conv_2", "kernel"), block.proj.weight, "conv"
    for j, (deconv, norm) in enumerate(zip(net.deconvs, net.deconv_norms)):
        yield (f"ConvTranspose_{j}", "kernel"), deconv.weight, "deconv"
        yield from _norm_leaves((f"GroupNorm_{j + 1}",), norm)
    yield ("Conv_1", "kernel"), net.head.weight, "conv"
    yield ("Conv_1", "bias"), net.head.bias, "vec"


def _head_leaves(head: AppearanceHead):
    for i, layer in enumerate(head.layers):
        yield (f"Dense_{i}", "kernel"), layer.weight, "dense"
        yield (f"Dense_{i}", "bias"), layer.bias, "vec"


def keystr(path: tuple) -> str:
    """A dict path as `jax.tree_util.keystr` names it: "['a']['b']"."""
    return "".join(f"[{k!r}]" for k in path)


def _fill(module: nn.Module, leaves, read) -> nn.Module:
    with torch.no_grad():
        for path, param, kind in leaves:
            value = _to_torch(read(path), kind)
            if value.shape != param.shape:
                raise ValueError(f"{keystr(path)}: shape {tuple(value.shape)}, "
                                 f"the module's {tuple(param.shape)}")
            param.copy_(value)
    return module


def _nested(params: dict, path: tuple) -> np.ndarray:
    return functools.reduce(lambda d, k: d[k], path, params)


def posenet_from_flax(cfg: PoseNetConfig, params: dict) -> PoseNet:
    """The port's PoseNet (on the CPU) from a flax parameter tree."""
    net = PoseNet(cfg)
    return _fill(net, _posenet_leaves(net), functools.partial(_nested, params))


def head_from_flax(cfg: AppearanceHeadConfig, params: dict) -> AppearanceHead:
    head = AppearanceHead(cfg)
    return _fill(head, _head_leaves(head), functools.partial(_nested, params))


def _config_dict(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _save(path: Path, leaves, config_key: str, config: dict, dtype=None) -> None:
    arrays = {}
    for p, param, kind in leaves:
        a = _to_flax(param, kind)
        arrays[keystr(p)] = a.astype(dtype) if dtype else a
    arrays[config_key] = np.frombuffer(json.dumps(config).encode(), dtype=np.uint8)
    np.savez_compressed(str(path), **arrays)


def save_posenet(path: Path, cfg: PoseNetConfig, net: PoseNet, dtype=None) -> None:
    """Write `net` in the JAX package's format; `dtype` (e.g. np.float16)
    narrows the stored weights, which load back as f32."""
    d = _config_dict(cfg)
    d["compute_dtype"] = str(cfg.compute_dtype).removeprefix("torch.")
    _save(path, _posenet_leaves(net), POSENET_CONFIG_KEY, d, dtype)


def load_posenet(path: Path, device="cuda"):
    """Load a PoseNet checkpoint (either package's) -> (PoseNetConfig,
    PoseNet on `device`)."""
    dev = resolve_device(device)
    high_precision()
    with np.load(str(path)) as z:
        d = json.loads(bytes(z[POSENET_CONFIG_KEY]).decode())
        d["compute_dtype"] = getattr(torch, d["compute_dtype"])
        d["stage_features"] = tuple(d["stage_features"])
        d["img_hw"] = tuple(d["img_hw"])
        cfg = PoseNetConfig(**d)
        net = PoseNet(cfg)
        _fill(net, _posenet_leaves(net), lambda p: z[keystr(p)])
    return cfg, net.to(dev).eval()


def save_appearance_head(path: Path, cfg: AppearanceHeadConfig, head: AppearanceHead) -> None:
    _save(path, _head_leaves(head), HEAD_CONFIG_KEY, _config_dict(cfg))


def load_appearance_head(path: Path, device="cuda"):
    """Load an appearance-head checkpoint (either package's) ->
    (AppearanceHeadConfig, AppearanceHead on `device`)."""
    dev = resolve_device(device)
    high_precision()
    with np.load(str(path)) as z:
        d = json.loads(bytes(z[HEAD_CONFIG_KEY]).decode())
        d["hidden"] = tuple(d["hidden"])
        cfg = AppearanceHeadConfig(**d)
        head = AppearanceHead(cfg)
        _fill(head, _head_leaves(head), lambda p: z[keystr(p)])
    return cfg, head.to(dev).eval()


def _flat_params(params) -> dict:
    """{keystr: numpy array}: a PoseNet's or AppearanceHead's leaves in
    flax layout, or a nested dict's leaves as they are."""
    if isinstance(params, PoseNet):
        return {keystr(p): _to_flax(t, kind) for p, t, kind in _posenet_leaves(params)}
    if isinstance(params, AppearanceHead):
        return {keystr(p): _to_flax(t, kind) for p, t, kind in _head_leaves(params)}
    out = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out[keystr(prefix + (k,))] = (v.detach().cpu().numpy()
                                             if isinstance(v, torch.Tensor) else np.asarray(v))

    walk(params, ())
    return out


def save_params(path: Path, params) -> None:
    """Write `params` (a nested dict of tensors or arrays, or the port's
    `PoseNet` / `AppearanceHead`, stored under flax's leaf names in flax
    layout) to `<path>.npz`, the JAX package's npz parameter file."""
    np.savez_compressed(str(path) + ".npz", **_flat_params(params))


def load_params(path: Path, like):
    """Read a `save_params` file of either package into the structure of
    `like`: a `PoseNet` / `AppearanceHead` is filled in place and
    returned; a nested dict gives a nested dict of tensors (the stored
    dtype, on the device of `like`'s leaf where that is a tensor)."""
    npz = Path(str(path) + ".npz")
    if not npz.exists():
        if Path(path).is_dir():
            raise ValueError(
                f"{path} is an orbax StandardCheckpointer directory (tensorstore), "
                "which needs orbax to read; the port reads the npz format only "
                "(the JAX package writes it when orbax cannot be imported)")
        raise FileNotFoundError(npz)
    with np.load(str(npz)) as z:
        if isinstance(like, PoseNet):
            return _fill(like, _posenet_leaves(like), lambda p: z[keystr(p)])
        if isinstance(like, AppearanceHead):
            return _fill(like, _head_leaves(like), lambda p: z[keystr(p)])

        def build(d, prefix):
            out = {}
            for k, v in d.items():
                if isinstance(v, dict):
                    out[k] = build(v, prefix + (k,))
                else:
                    dev = v.device if isinstance(v, torch.Tensor) else "cpu"
                    out[k] = torch.as_tensor(z[keystr(prefix + (k,))]).to(dev)
            return out

        return build(like, ())
