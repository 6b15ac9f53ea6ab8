"""The 2D keypoint CNN and its decoders, in PyTorch.

Port of `multiview_motion_capture_tpu/models/pose_net.py`: a
SimpleBaseline-style network (ResNet-ish encoder + transposed-conv head ->
keypoint heatmaps, an optional person-center channel and optional
center->keypoint offset fields) and the decoders that turn its output into
keypoints on the device, with no host read.

Public shapes are the JAX package's: images (B, H, W, 3) in [0, 1] go in,
heat (B, H/4, W/4, C) comes out; inside, the activations are NCHW (the
NHWC input permuted, so channels-last in memory).  The arithmetic follows
flax's:

- `padding="SAME"` pads (total // 2, total - total // 2), so a stride-2
  layer on an even size pads one row and column at the END; the pads are
  derived from each input's size (the net is fully convolutional and also
  runs at sizes other than `img_hw`), and the max-pool pads with -inf;
- `nn.ConvTranspose(transpose_kernel=False, padding="SAME")` with a 4 x 4
  kernel at stride 2 is `F.conv_transpose2d(padding=1)` on the flax kernel
  flipped in both spatial dimensions;
- GroupNorm: 32 groups, epsilon 1e-6, statistics and output in f32 on the
  compute-dtype input, cast back to the compute dtype;
- `compute_dtype` (bf16 in the shipped checkpoint): every convolution's
  input and kernel are cast to it; the last 1x1 convolution, with its
  bias, runs in f32.

The parameters stay f32 (the checkpoint's values) and are cast at use, as
flax casts them, so their gradients are f32 too.  Convolutions are
PyTorch's (cuDNN on the card), forward and backward: the JAX package runs
them through XLA's `conv_general_dilated`, not a Pallas kernel.  The
decoders, the training targets (`gaussian_heatmaps`, `center_targets`,
`offset_targets`) and the losses are plain tensor code in both packages;
`create_train_state` / `train_step` are the keypoint-only AdamW step
(`models.optim.AdamW`: optax.adamw's hyper-parameters).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multiview_motion_capture_torch.models.optim import AdamW
from multiview_motion_capture_torch.utils.precision import high_precision, resolve_device

GROUPS = 32
GN_EPS = 1e-6  # flax.linen.GroupNorm's default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class PoseNetConfig:
    n_kps: int = 17
    stem_features: int = 64
    stage_features: Tuple[int, ...] = (128, 256, 512)
    blocks_per_stage: int = 2
    head_features: int = 256
    img_hw: Tuple[int, int] = (256, 192)
    compute_dtype: torch.dtype = torch.bfloat16
    # adds a person-center heatmap channel (channel n_kps): the proposal
    # stage of the full-frame multi-person cascade (data.detect)
    predict_center: bool = False
    # adds 2*n_kps center->keypoint offset channels (after the center
    # channel): the single-pass bottom-up decode (decode_bottom_up).
    # Requires predict_center.
    predict_offsets: bool = False

    @property
    def n_out(self) -> int:
        n = self.n_kps + (1 if self.predict_center else 0)
        if self.predict_offsets:
            assert self.predict_center, "offset head needs the center channel"
            n += 2 * self.n_kps
        return n

    @property
    def heatmap_hw(self) -> Tuple[int, int]:
        # stem /4, three stages with stride 2 on the last two, head x4 deconv
        return (self.img_hw[0] // 4, self.img_hw[1] // 4)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dimension: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    (t, b), (l, r) = (_same_pads(x.shape[-2], w.shape[-2], stride),
                      _same_pads(x.shape[-1], w.shape[-1], stride))
    if t == b and l == r:
        return F.conv2d(x, w, stride=stride, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)


def _max_pool_same(x: torch.Tensor, k: int, stride: int, fill: float) -> torch.Tensor:
    """`reduce_window(max)` with SAME padding filled with `fill`."""
    (t, b), (l, r) = _same_pads(x.shape[-2], k, stride), _same_pads(x.shape[-1], k, stride)
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=fill), k, stride)


def _group_norm(norm: nn.GroupNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.group_norm(x.float(), GROUPS, norm.weight, norm.bias, GN_EPS).to(dtype)


class ResBlock(nn.Module):
    """Two 3x3 convolutions with GroupNorm, and a 1x1 projection of the
    residual where the shape changes (flax: `Conv_0`, `GroupNorm_0`,
    `Conv_1`, `GroupNorm_1`, `Conv_2`)."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, bias=False)
        self.norm1 = nn.GroupNorm(GROUPS, features, eps=GN_EPS)
        self.conv2 = nn.Conv2d(features, features, 3, bias=False)
        self.norm2 = nn.GroupNorm(GROUPS, features, eps=GN_EPS)
        self.proj = (nn.Conv2d(in_features, features, 1, stride, bias=False)
                     if stride != 1 or in_features != features else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = _conv_same(x, self.conv1.weight.to(dtype), self.stride)
        y = F.relu(_group_norm(self.norm1, y, dtype))
        y = _conv_same(y, self.conv2.weight.to(dtype), 1)
        y = _group_norm(self.norm2, y, dtype)
        residual = x if self.proj is None else _conv_same(x, self.proj.weight.to(dtype),
                                                           self.stride)
        return F.relu(y + residual)


class PoseNet(nn.Module):
    """images (B, H, W, 3) in [0, 1] -> heat (B, H/4, W/4, cfg.n_out), f32.

    flax's module names, in order: `Conv_0` (stem), `GroupNorm_0`,
    `ResBlock_0..`, `ConvTranspose_0/1` with `GroupNorm_1/2`, `Conv_1`
    (the head); `models.checkpoint` maps them."""

    def __init__(self, cfg: PoseNetConfig = PoseNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.Conv2d(3, cfg.stem_features, 7, 2, bias=False)
        self.stem_norm = nn.GroupNorm(GROUPS, cfg.stem_features, eps=GN_EPS)
        blocks, feats_in = [], cfg.stem_features
        for i, feats in enumerate(cfg.stage_features):
            blocks.append(ResBlock(feats_in, feats, stride=1 if i == 0 else 2))
            blocks.extend(ResBlock(feats, feats) for _ in range(cfg.blocks_per_stage - 1))
            feats_in = feats
        self.blocks = nn.ModuleList(blocks)
        self.deconvs = nn.ModuleList([
            nn.ConvTranspose2d(feats_in, cfg.head_features, 4, 2, padding=1, bias=False),
            nn.ConvTranspose2d(cfg.head_features, cfg.head_features, 4, 2, padding=1,
                               bias=False)])
        self.deconv_norms = nn.ModuleList(
            [nn.GroupNorm(GROUPS, cfg.head_features, eps=GN_EPS) for _ in range(2)])
        self.head = nn.Conv2d(cfg.head_features, cfg.n_out, 1)

    def forward(self, images: torch.Tensor, return_features: bool = False):
        """`return_features=True` also returns the pre-head /4 feature map
        (B, H/4, W/4, head_features) in f32."""
        dt = self.cfg.compute_dtype
        x = images.to(dt).permute(0, 3, 1, 2)
        x = _conv_same(x, self.stem.weight.to(dt), 2)
        x = F.relu(_group_norm(self.stem_norm, x, dt))
        x = _max_pool_same(x, 3, 2, -math.inf)
        for block in self.blocks:
            x = block(x, dt)
        for deconv, norm in zip(self.deconvs, self.deconv_norms):
            x = F.conv_transpose2d(x, deconv.weight.to(dt), stride=2, padding=1)
            x = F.relu(_group_norm(norm, x, dt))
        feats = x.float()
        heat = F.conv2d(feats, self.head.weight, self.head.bias).permute(0, 2, 3, 1)
        if return_features:
            return heat, feats.permute(0, 2, 3, 1)
        return heat


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's LeCun-normal initialisation of `w` in place: a standard normal
    truncated at two standard deviations, drawn as JAX draws it (a uniform
    between the normal CDF's values at -2 and 2, through erfinv), scaled to
    unit variance over `fan_in`.  Only `uniform_` reads `generator`, so a
    seed gives the same weights under every torch release
    (`nn.init.trunc_normal_` changed its sampler between releases)."""
    lo, hi = (math.erf(x / math.sqrt(2.0)) for x in (-2.0, 2.0))
    w.uniform_(lo, hi, generator=generator).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return w.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def init_posenet(cfg: PoseNetConfig, generator: torch.Generator) -> PoseNet:
    """Random init as flax's: LeCun-normal kernels (`lecun_normal_`), zero
    biases, GroupNorm scale 1 and bias 0.  The numbers come from
    `generator`, so they are not JAX's for the same seed."""
    net = PoseNet(cfg)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                # torch layouts: conv (out, in, kh, kw), transpose (in, out, kh, kw)
                fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else w[:, 0].numel()
                lecun_normal_(w, fan_in, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return net


# ---------------------------------------------------------------------------
# decoders: heat (B, H, W, C) -> keypoints in heatmap pixels, on the device
# ---------------------------------------------------------------------------

def decode_heatmaps(heat: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Soft-argmax heatmap decoding: (B, H, W, K) -> (B, K, 3) with (x, y,
    score) in heatmap pixels; score = max softmax mass x H W / 16, clipped
    to [0, 1]."""
    B, H, W, K = heat.shape
    prob = torch.softmax(heat.reshape(B, H * W, K) / temperature, dim=1)
    grid = prob.reshape(B, H, W, K)
    ys = torch.arange(H, dtype=heat.dtype, device=heat.device)
    xs = torch.arange(W, dtype=heat.dtype, device=heat.device)
    y = torch.einsum("bhwk,h->bk", grid, ys)
    x = torch.einsum("bhwk,w->bk", grid, xs)
    score = torch.clamp(prob.amax(dim=1) * (H * W) / 16.0, 0.0, 1.0)
    return torch.stack([x, y, score], dim=-1)


def _windows(maps: torch.Tensor, n: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
             size: int) -> torch.Tensor:
    """The size x size windows of maps (N, H, W): window i reads map n[i]
    from (y0[i], x0[i]) (n broadcasts against the starts), by one gather:
    the JAX package's `dynamic_slice` windows, whose starts are already
    clamped.  Returns (..., size, size)."""
    r = torch.arange(size, device=maps.device)
    rows = (y0[..., None] + r)[..., :, None]
    cols = (x0[..., None] + r)[..., None, :]
    return maps[n[..., None, None], rows, cols]


def _window_soft_argmax(win: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                        temperature: float):
    """Soft-argmax inside windows (..., S, S) starting at (y0, x0): the
    expected (x, y) in map pixels."""
    S = win.shape[-1]
    p = torch.softmax(win.reshape(win.shape[:-2] + (S * S,)) / temperature, dim=-1)
    p = p.reshape(win.shape)
    r = torch.arange(S, dtype=win.dtype, device=win.device)
    y = (p.sum(dim=-1) * r).sum(dim=-1) + y0.to(win.dtype)
    x = (p.sum(dim=-2) * r).sum(dim=-1) + x0.to(win.dtype)
    return x, y


def decode_heatmaps_local(heat: torch.Tensor, window: int = 5,
                          temperature: float = 0.25,
                          center_prior_sigma: float = 0.0) -> torch.Tensor:
    """Peak-local decoding: hard argmax (first index on ties, as JAX's),
    then a soft-argmax inside the `window` x `window` patch around the
    peak, so a secondary peak elsewhere in the map cannot drag the
    keypoint.  `center_prior_sigma` > 0 runs the argmax on the map times a
    gaussian prior around the map center (sigma in units of the map
    half-diagonal); refinement and score use the raw map.

    heat (B, H, W, K) -> (B, K, 3): (x, y, score) in heatmap pixels, score
    the peak's raw value clipped to [0, 1]."""
    B, H, W, K = heat.shape
    hm = heat.permute(0, 3, 1, 2).reshape(B * K, H, W)
    sel = hm
    if center_prior_sigma > 0:
        ys = (torch.arange(H, dtype=heat.dtype, device=heat.device) - (H - 1) / 2) / (H / 2)
        xs = (torch.arange(W, dtype=heat.dtype, device=heat.device) - (W - 1) / 2) / (W / 2)
        d2 = ys[:, None] ** 2 + xs[None, :] ** 2
        sel = hm * torch.exp(-d2 / (2 * center_prior_sigma ** 2))[None]
    flat_idx = sel.reshape(B * K, H * W).argmax(dim=1)
    py, px = flat_idx // W, flat_idx % W
    half = window // 2
    y0 = torch.clamp(py - half, 0, max(H - window, 0))
    x0 = torch.clamp(px - half, 0, max(W - window, 0))
    n = torch.arange(B * K, device=heat.device)
    x, y = _window_soft_argmax(_windows(hm, n, y0, x0, window), y0, x0, temperature)
    score = torch.clamp(hm.reshape(B * K, H * W).gather(1, flat_idx[:, None])[:, 0], 0.0, 1.0)
    return torch.stack([x, y, score], dim=-1).reshape(B, K, 3)


def decode_center_peaks(center_heat: torch.Tensor, max_people: int,
                        min_score: float = 0.1, nms_window: int = 5):
    """Multi-peak NMS decode of a person-center heatmap: a peak is a pixel
    that equals the max of its `nms_window` neighbourhood and exceeds
    `min_score`; the strongest `max_people` are kept.

    Ties are broken as the JAX package breaks them: on a plateau of equal
    values only the highest-index candidate of each window stays (an exact
    max-pool of the candidates' indices, in f64 because CUDA pools no
    int64), and among equal values the lower index ranks first (a stable
    descending sort, as `lax.top_k`; `torch.topk` promises no order on
    ties).  The slots past the last peak hold -inf and are invalid; their
    centers still come from their indices, as in JAX.

    center_heat (B, H, W) -> (centers (B, max_people, 3) [x, y, score] in
    heatmap pixels, valid (B, max_people) bool)."""
    B, H, W = center_heat.shape
    pool = _max_pool_same(center_heat[:, None], nms_window, 1, -math.inf)[:, 0]
    cand = (center_heat >= pool) & (center_heat > min_score)
    idx = torch.arange(H * W, dtype=torch.float64,
                       device=center_heat.device).reshape(1, H, W)
    cand_idx = torch.where(cand, idx, -1.0)
    pool_idx = _max_pool_same(cand_idx[:, None], nms_window, 1, -1.0)[:, 0]
    is_peak = cand & (idx == pool_idx)
    vals = torch.where(is_peak, center_heat, -math.inf).reshape(B, H * W)
    top_vals, top_idx = torch.sort(vals, dim=1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :max_people], top_idx[:, :max_people]
    ys = (top_idx // W).to(center_heat.dtype)
    xs = (top_idx % W).to(center_heat.dtype)
    valid = torch.isfinite(top_vals) & (top_vals > min_score)
    centers = torch.stack([xs, ys, torch.where(valid, top_vals, 0.0)], dim=-1)
    return centers, valid


def decode_bottom_up(heat: torch.Tensor, n_kps: int, max_people: int,
                     min_score: float = 0.1, nms_window: int = 5,
                     snap_window: int = 7, snap_min: float = 0.15,
                     temperature: float = 0.25):
    """Single-pass multi-person decode: center peaks -> the offsets
    regressed at each center pixel -> a snap to the keypoint heatmap (a
    soft-argmax in the `snap_window` patch around the regressed position,
    where that patch's peak exceeds `snap_min`; else the regression
    stands).  Every window is one gather over (B, P, K): no loop over
    people or keypoints.

    heat (B, H, W, K + 1 + 2K) from a `predict_offsets=True` PoseNet.
    Returns (kps (B, P, K, 3) [x, y, score] in heatmap px, centers (B, P,
    3), valid (B, P)); invalid slots' keypoints are zero."""
    B, H, W, C = heat.shape
    K = n_kps
    assert C == 3 * K + 1, (C, K)
    centers, valid = decode_center_peaks(heat[..., K], max_people, min_score=min_score,
                                         nms_window=nms_window)
    cxy = centers[..., :2]
    cxi = torch.clamp(torch.round(cxy[..., 0]).long(), 0, W - 1)
    cyi = torch.clamp(torch.round(cxy[..., 1]).long(), 0, H - 1)
    b = torch.arange(B, device=heat.device)[:, None]
    offs = heat[..., K + 1:][b, cyi, cxi].reshape(B, max_people, K, 2)
    reg = cxy[:, :, None, :] + offs                               # (B, P, K, 2)

    half = snap_window // 2
    rx = torch.clamp(torch.round(reg[..., 0]).long(), 0, W - 1)
    ry = torch.clamp(torch.round(reg[..., 1]).long(), 0, H - 1)
    y0 = torch.clamp(ry - half, 0, max(H - snap_window, 0))
    x0 = torch.clamp(rx - half, 0, max(W - snap_window, 0))
    # the keypoint channels as (B * K) maps; window (b, p, k) reads map b K + k
    hm = heat[..., :K].permute(0, 3, 1, 2).reshape(B * K, H, W)
    bk = (torch.arange(B, device=heat.device)[:, None, None] * K
          + torch.arange(K, device=heat.device)[None, None, :])   # (B, 1, K)
    win = _windows(hm, bk, y0, x0, snap_window)                   # (B, P, K, S, S)
    peak = win.amax(dim=(-2, -1))
    sx, sy = _window_soft_argmax(win, y0, x0, temperature)
    use = (peak > snap_min)[..., None]
    xy = torch.where(use, torch.stack([sx, sy], dim=-1), reg)
    score = torch.clamp(peak, 0.0, 1.0)[..., None] * centers[..., None, 2:3]
    kps = torch.cat([xy, score], dim=-1)
    kps = kps * valid[..., None, None].to(kps.dtype)
    return kps, centers, valid


# ---------------------------------------------------------------------------
# training: targets, losses and the keypoint-only step
# ---------------------------------------------------------------------------

def _pixel_grid(hw: Tuple[int, int], device):
    H, W = hw
    return (torch.arange(H, dtype=torch.float32, device=device),
            torch.arange(W, dtype=torch.float32, device=device))


def offset_targets(centers: torch.Tensor, kps: torch.Tensor, valid: torch.Tensor,
                   kp_mask: torch.Tensor, hw: Tuple[int, int], radius: float = 2.0):
    """Ground truth for the offset head: at every pixel within `radius` of a
    person center, the (dx, dy) from that PIXEL to each of the person's
    keypoints (the decode gathers at the detected, not the exact, center
    pixel).

    centers (B, P, 2), kps (B, P, K, 2) in heatmap px, valid (B, P),
    kp_mask (B, P, K).  Overlapping discs: the nearest center wins, the
    first person on ties (argmin's first index); invalid people are at
    +inf, so a pixel of an image with no valid person belongs to person 0
    and lies within no disc.  Returns (targets (B, H, W, 2K), mask (B, H,
    W, K))."""
    B, P, K, _ = kps.shape
    ys, xs = _pixel_grid(hw, kps.device)
    px = xs[None, None, :, None]
    py = ys[None, :, None, None]
    d2 = ((px - centers[:, None, None, :, 0]) ** 2
          + (py - centers[:, None, None, :, 1]) ** 2)              # (B, H, W, P)
    d2 = torch.where(valid[:, None, None, :], d2, math.inf)
    min_d2, owner = d2.min(dim=-1)                                  # (B, H, W)
    within = min_d2 <= radius ** 2
    b = torch.arange(B, device=kps.device)[:, None, None]
    kps_at = kps[b, owner]                                          # (B, H, W, K, 2)
    mask_at = kp_mask[b, owner]                                     # (B, H, W, K)
    tx = kps_at[..., 0] - xs[None, None, :, None]
    ty = kps_at[..., 1] - ys[None, :, None, None]
    tgt = torch.stack([tx, ty], dim=-1).reshape(B, *hw, 2 * K)
    return tgt, mask_at * within[..., None]


def offset_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked smooth-L1 over the offset field.  pred/target (B, H, W, 2K),
    mask (B, H, W, K) (each keypoint's x and y share its mask entry)."""
    B, H, W, C = pred.shape
    d = (pred - target).reshape(B, H, W, C // 2, 2)
    ad = d.abs()
    l1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(-1)      # (B, H, W, K)
    return (l1 * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def center_targets(centers: torch.Tensor, valid: torch.Tensor, hw: Tuple[int, int],
                   sigma: float = 3.0) -> torch.Tensor:
    """Ground-truth person-center heatmap: per-person gaussians combined by
    max.  centers (B, P, 2) in heatmap pixels, valid (B, P) -> (B, H, W)."""
    ys, xs = _pixel_grid(hw, centers.device)
    cy = centers[:, None, None, :, 1]
    cx = centers[:, None, None, :, 0]
    g = torch.exp(-((ys[None, :, None, None] - cy) ** 2 + (xs[None, None, :, None] - cx) ** 2)
                  / (2 * sigma ** 2))
    return (g * valid[:, None, None, :].to(g.dtype)).amax(dim=-1)


def gaussian_heatmaps(kps: torch.Tensor, hw: Tuple[int, int], sigma: float = 2.0) -> torch.Tensor:
    """Render ground-truth gaussians: kps (B, K, 2) in heatmap pixels ->
    (B, H, W, K)."""
    ys, xs = _pixel_grid(hw, kps.device)
    cy = kps[:, None, None, :, 1]
    cx = kps[:, None, None, :, 0]
    return torch.exp(-((ys[None, :, None, None] - cy) ** 2 + (xs[None, None, :, None] - cx) ** 2)
                     / (2 * sigma ** 2))


def heatmap_loss(pred: torch.Tensor, target: torch.Tensor, kp_mask: torch.Tensor) -> torch.Tensor:
    """Masked MSE heatmap loss; kp_mask (B, K) zeroes invisible joints."""
    return torch.mean((pred - target) ** 2 * kp_mask[:, None, None, :])


def create_train_state(generator: torch.Generator, cfg: PoseNetConfig, lr: float = 1e-3,
                       device="cuda"):
    """A freshly initialised PoseNet on `device` (`init_posenet` from
    `generator`) and its optimizer, optax.adamw(lr) -> (net, optimizer)."""
    dev = resolve_device(device)
    high_precision()
    net = init_posenet(cfg, generator).to(dev)
    return net, AdamW(net.parameters(), lr)


def train_step(net: PoseNet, optimizer: torch.optim.Optimizer, images: torch.Tensor,
               target_heat: torch.Tensor, kp_mask: torch.Tensor) -> torch.Tensor:
    """One full supervised step of the keypoint heatmaps (loss, gradients,
    the optimizer's update, in place); returns the loss before the
    update."""
    optimizer.zero_grad(set_to_none=True)
    loss = heatmap_loss(net(images), target_heat, kp_mask)
    loss.backward()
    optimizer.step()
    return loss.detach()
