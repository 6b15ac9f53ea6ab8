"""Detection: camera images -> FrameBatch on the device, no OpenPose.

Port of `multiview_motion_capture_tpu/data/detect.py`.  The keypoint CNN
(`models.pose_net`) runs over all views of a frame in one batch, its
output decodes on the device, and the decoded (x, y, score) tensors feed
the tracker (`pipeline.run`).  Where the JAX package passes `params`, the
port passes the `PoseNet` module: `detect(net, images)`,
`frames_to_frame_batch(detect, net, images, cfg)`; each detector runs on
the device of the module it is given.

Three detectors:

- `make_detector` + `crops_to_frame_batch`: top-down on person crops
  from an upstream detector;
- `make_multi_person_detector`: the propose -> crop -> top-down cascade on
  full frames (the center channel proposes on the resized frame, fixed
  windows around the proposals are cropped and resized, the same CNN
  localizes on them);
- `make_bottom_up_detector`: one forward a frame, decoded by
  `decode_bottom_up`, optionally with per-detection appearance
  embeddings (`appearance_from_keypoints`, optionally through the
  metric-learned head).

`detect` reads nothing back to the host; `frames_to_frame_batch` reads it
once a frame.  The JAX package's `jax.image.resize(method="linear")`
antialiases when it downsamples: here `F.interpolate(mode="bilinear",
align_corners=False, antialias=True)`, the same weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiview_motion_capture_torch.config import PipelineConfig
from multiview_motion_capture_torch.data.ingest import FrameBatch
from multiview_motion_capture_torch.models.appearance_net import apply_head
from multiview_motion_capture_torch.models.pose_net import (
    PoseNetConfig,
    decode_bottom_up,
    decode_center_peaks,
    decode_heatmaps,
    decode_heatmaps_local,
    init_posenet,
)
from multiview_motion_capture_torch.utils.precision import high_precision, resolve_device


def _device_of(net) -> torch.device:
    return next(net.parameters()).device


def _as_input(images, dev: torch.device) -> torch.Tensor:
    """Images on the detector's device, uint8 turned into f32 in [0, 1]
    there (a camera frame crosses the link at 1 byte a channel).  The JAX
    package's `x / 255.0` compiles to x times the f32 reciprocal of 255,
    as CUDA's division by a scalar runs; torch's CPU division is exact, so
    the port multiplies on every device."""
    images = torch.as_tensor(images, device=dev)
    if images.dtype == torch.uint8:
        images = images.float() * (1.0 / 255.0)
    return images


def _scale_xy(pts: torch.Tensor, sxy: Tuple[float, float]) -> torch.Tensor:
    """pts[..., :2] scaled by (sx, sy), the scales rounded to the points'
    dtype as the JAX package's f32 scale array is; Python scalars, so no
    host-to-device copy (a pageable copy synchronises the stream)."""
    return torch.stack([pts[..., 0] * sxy[0], pts[..., 1] * sxy[1]], dim=-1)


def resize(images: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C): `jax.image.resize(method="linear")`,
    antialiased when it downsamples."""
    if tuple(images.shape[1:3]) == tuple(hw):
        return images
    x = F.interpolate(images.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def make_detector(model_cfg: Optional[PoseNetConfig] = None, net=None,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.05, device="cuda"):
    """Build (detect_fn, net): detect_fn(net, crops (N, H, W, 3)) -> (N, K,
    3) keypoints in crop pixels with confidence scores (soft-argmax at a
    low `temperature`: MSE-trained heatmaps peak near 1).

    Without `net`, a random-init PoseNet of `model_cfg` from `generator`
    (required then) on `device`."""
    model_cfg = model_cfg or PoseNetConfig()
    high_precision()
    if net is None:
        if generator is None:
            raise ValueError("a random-init detector needs a torch.Generator")
        net = init_posenet(model_cfg, generator).to(resolve_device(device)).eval()

    @torch.no_grad()
    def detect(net, crops):
        kps = decode_heatmaps(net(torch.as_tensor(crops, device=_device_of(net))),
                              temperature=temperature)
        return torch.cat([kps[..., :2] * 4.0, kps[..., 2:3]], dim=-1)

    return detect, net


def crops_to_frame_batch(detect_fn, net, crops, boxes, crop_valid, cfg: PipelineConfig,
                         min_score: float = 0.05) -> FrameBatch:
    """Run the CNN over every person crop (F, V, P, H, W, 3) and map the
    keypoints back to full-frame pixels through `boxes` (F, V, P, 4) [x1,
    y1, x2, y2]; slots where `crop_valid` (F, V, P) is false or no keypoint
    scores above `min_score` are invalid."""
    dev = _device_of(net)
    crops = torch.as_tensor(crops, device=dev)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    F_, V, P, H, W, _ = crops.shape
    kps = detect_fn(net, crops.reshape(F_ * V * P, H, W, 3)).reshape(F_, V, P, -1, 3)
    scale = (boxes[..., 2:4] - boxes[..., :2]) / torch.tensor([W, H], device=dev)
    xy = kps[..., :2] * scale[..., None, :] + boxes[..., None, :2]
    out = torch.cat([xy, kps[..., 2:3]], dim=-1).cpu().numpy()
    valid = np.asarray(crop_valid) & (kps[..., 2].amax(dim=-1) > min_score).cpu().numpy()
    return FrameBatch(kps=out.astype(np.float32), valid=valid)


# ---------------------------------------------------------------------------
# full-frame multi-person cascade (propose -> crop -> top-down)
# ---------------------------------------------------------------------------

def crop_windows(image: torch.Tensor, centers_xy: torch.Tensor, crop_hw: Tuple[int, int],
                 out_hw: Tuple[int, int]):
    """Fixed-size windows around centers, resized for the CNN.

    image (H, W, 3) with centers_xy (P, 2) in frame pixels, or a batch
    (V, H, W, 3) with (V, P, 2).  Each window's start is clamped into the
    image, as `lax.dynamic_slice` clamps; all windows are one gather.
    Returns (crops (..., P, out_h, out_w, 3), boxes (..., P, 4) [x1, y1, x2,
    y2])."""
    single = image.dim() == 3
    if single:
        image, centers_xy = image[None], centers_xy[None]
    V, H, W = image.shape[:3]
    ch, cw = crop_hw
    if ch > H or cw > W:
        raise ValueError(f"crop window {tuple(crop_hw)} exceeds the image ({H}, {W}); "
                         "dynamic_slice cannot produce out-of-bounds sizes")
    x0 = torch.clamp(torch.round(centers_xy[..., 0] - cw / 2).long(), 0, W - cw)
    y0 = torch.clamp(torch.round(centers_xy[..., 1] - ch / 2).long(), 0, H - ch)
    dev = image.device
    v = torch.arange(V, device=dev)[:, None, None, None]
    rows = (y0[..., None] + torch.arange(ch, device=dev))[..., :, None]
    cols = (x0[..., None] + torch.arange(cw, device=dev))[..., None, :]
    crops = image[v, rows, cols]                                  # (V, P, ch, cw, 3)
    P = crops.shape[1]
    crops = resize(crops.reshape(V * P, ch, cw, 3), out_hw).reshape(
        (V, P) + tuple(out_hw) + (3,))
    boxes = torch.stack([x0, y0, x0 + cw, y0 + ch], dim=-1).to(image.dtype)
    if single:
        return crops[0], boxes[0]
    return crops, boxes


def make_multi_person_detector(
    model_cfg: PoseNetConfig,
    max_people: int,
    crop_hw: Tuple[int, int],
    full_hw: Optional[Tuple[int, int]] = None,
    center_min_score: float = 0.1,
    center_nms_window: int = 5,
    kps_window: int = 5,
    kps_center_prior: float = 0.0,
):
    """Build detect_fn(net, images) for full multi-person frames: the
    cascade, 1 + max_people forwards a view.  `model_cfg` must have
    `predict_center=True`; the proposal pass runs at `full_hw` (default:
    the model input scaled to a 4:3-ish landscape), the crops at
    `model_cfg.img_hw`.

    detect_fn: (V, H, W, 3) images (f32 in [0, 1] or uint8) -> (kps (V,
    max_people, K, 3) in frame pixels, boxes (V, max_people, 4), valid (V,
    max_people))."""
    assert model_cfg.predict_center, "multi-person path needs the center channel"
    high_precision()
    mh, mw = model_cfg.img_hw
    K = model_cfg.n_kps
    if full_hw is None:
        full_hw = (mh, max(16, (mh * 4 // 3) // 16 * 16))

    @torch.no_grad()
    def detect(net, images):
        dev = _device_of(net)
        images = _as_input(images, dev)
        V, H, W = images.shape[:3]
        # stage 1: propose person centers on the resized full frame
        heat = net(resize(images, full_hw))
        centers_hm, valid = decode_center_peaks(heat[..., K], max_people,
                                                min_score=center_min_score,
                                                nms_window=center_nms_window)
        to_frame = (W / heat.shape[2], H / heat.shape[1])
        # stage 2: crop fixed windows, run the CNN top-down, peak-local decode
        crops, boxes = crop_windows(images, _scale_xy(centers_hm, to_frame), crop_hw,
                                    model_cfg.img_hw)
        kps_hm = decode_heatmaps_local(
            net(crops.reshape(V * max_people, mh, mw, 3))[..., :K],
            window=kps_window, center_prior_sigma=kps_center_prior,
        ).reshape(V, max_people, K, 3)
        # heatmap px -> model px -> crop px -> frame px
        xy = (_scale_xy(kps_hm, (crop_hw[1] / mw * 4.0, crop_hw[0] / mh * 4.0))
              + boxes[..., None, :2])
        score = kps_hm[..., 2:3] * centers_hm[..., None, 2:3]
        kps = torch.cat([xy, score], dim=-1) * valid[..., None, None].to(images.dtype)
        return kps, boxes, valid

    return detect


def _sample_bilinear(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling: feat (H, W, C), xy (P, 2) grid px -> (P, C); or
    batched, feat (V, H, W, C), xy (V, P, 2) -> (V, P, C)."""
    if feat.dim() == 3:
        return _sample_bilinear(feat[None], xy[None])[0]
    H, W = feat.shape[1:3]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    v = torch.arange(feat.shape[0], device=feat.device)[:, None]
    f00, f01 = feat[v, y0, x0], feat[v, y0, x0 + 1]
    f10, f11 = feat[v, y0 + 1, x0], feat[v, y0 + 1, x0 + 1]
    return ((1 - wy) * ((1 - wx) * f00 + wx * f01)
            + wy * ((1 - wx) * f10 + wx * f11))


def appearance_from_keypoints(images: torch.Tensor, kps: torch.Tensor, valid: torch.Tensor,
                              min_score: float = 0.1) -> torch.Tensor:
    """Keypoint-color-layout appearance descriptor: each detection's RGB
    sampled at its keypoints (keypoints scoring at most `min_score`
    zeroed), flattened to K*3 and unit-normalized.

    images (V, H, W, 3) f32 in [0, 1]; kps (V, P, K, 3) in IMAGE pixels of
    `images`; valid (V, P).  Returns (V, P, K*3) unit rows, zero for
    invalid detections."""
    V, P, K = kps.shape[:3]
    rgb = _sample_bilinear(images, kps[..., :2].reshape(V, P * K, 2)).reshape(V, P, K, 3)
    w = (kps[..., 2:3] > min_score).to(rgb.dtype)
    emb = (rgb * w).reshape(V, P, K * 3) * valid[..., None].to(rgb.dtype)
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-6)


def make_bottom_up_detector(
    model_cfg: PoseNetConfig,
    max_people: int,
    full_hw: Optional[Tuple[int, int]] = None,
    center_min_score: float = 0.1,
    center_nms_window: int = 5,
    snap_window: int = 7,
    snap_min: float = 0.15,
    det_min_score: float = 0.0,
    return_appearance: bool = False,
    appearance_head=None,
):
    """Single-pass full-frame multi-person detector: one forward a view
    (frames resized to `full_hw`, default `model_cfg.img_hw`), decoded by
    `decode_bottom_up`.

    detect_fn: (V, H, W, 3) images (f32 in [0, 1] or uint8) -> (kps (V,
    max_people, K, 3) in frame pixels, centers (V, max_people, 3), valid
    (V, max_people)), plus the appearance embeddings (V, max_people, K*3)
    when `return_appearance=True`: `appearance_from_keypoints` on the
    (resized) frames, through `appearance_head` (an `AppearanceHead`) when
    given, (V, max_people, head.cfg.out_dim)."""
    assert model_cfg.predict_offsets, "bottom-up path needs the offset head"
    high_precision()
    K = model_cfg.n_kps
    fh, fw = full_hw if full_hw is not None else model_cfg.img_hw

    @torch.no_grad()
    def detect(net, images):
        images = _as_input(images, _device_of(net))
        V, H, W = images.shape[:3]
        images = resize(images, (fh, fw))
        heat = net(images)
        kps_hm, centers, valid = decode_bottom_up(
            heat, K, max_people, min_score=center_min_score, nms_window=center_nms_window,
            snap_window=snap_window, snap_min=snap_min)
        hh, hw_ = heat.shape[1], heat.shape[2]
        if return_appearance:
            # heatmap px -> resized frame px is the /4 head stride
            kps_img = torch.cat([kps_hm[..., :2] * 4.0, kps_hm[..., 2:3]], dim=-1)
            emb = appearance_from_keypoints(images, kps_img, valid)
            if appearance_head is not None:
                emb = apply_head(appearance_head, emb)
        to_frame = (W / hw_, H / hh)
        kps = torch.cat([_scale_xy(kps_hm, to_frame), kps_hm[..., 2:3]], dim=-1)
        centers = torch.cat([_scale_xy(centers, to_frame), centers[..., 2:]], dim=-1)
        if det_min_score > 0:
            valid = valid & (kps[..., 2].amax(dim=-1) > det_min_score)
        if return_appearance:
            return kps, centers, valid, emb
        return kps, centers, valid

    return detect


class FrameUploader:
    """Host frames to the detector's device, each on a side stream from
    pinned memory, so frame f+1's copy overlaps frame f's forward:
    `start(frame)` begins a copy, `take(upload)` makes the current stream
    wait for it and returns the device tensor."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def start(self, frame):
        t = torch.as_tensor(frame)
        if self.stream is None or t.device.type == "cuda":
            return t.to(self.dev), None
        with torch.cuda.stream(self.stream):
            out = t.pin_memory().to(self.dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def take(self, upload):
        t, ready = upload
        if ready is not None:
            stream = torch.cuda.current_stream(self.dev)
            stream.wait_event(ready)
            t.record_stream(stream)
        return t


def frames_to_frame_batch(detect_fn, net, images, cfg: PipelineConfig,
                          collect_appearance: bool = False):
    """Run a multi-person detector over a whole sequence.

    images: (F, V, H, W, 3), f32 in [0, 1] or uint8, numpy or a tensor;
    one detector call a frame (all V views batched) on the device of `net`,
    so device memory stays bounded.  Frame f+1's upload is issued before
    frame f's forward; each frame's output comes to the host in one read.
    The result plugs into pipeline.run like prepared OpenPose data.

    `collect_appearance=True` (a detector built with
    `make_bottom_up_detector(return_appearance=True)`) also returns the
    per-detection embeddings (F, V, P, D): the return becomes
    `(FrameBatch, app)`."""
    F_ = images.shape[0]
    P = cfg.max_people
    kps_out = None  # allocated from the detector's own K on the first frame
    valid_out = np.zeros((F_, cfg.n_views, P), dtype=bool)
    app_out = None
    up = FrameUploader(_device_of(net))
    nxt = up.start(images[0]) if F_ else None
    for f in range(F_):
        cur = up.take(nxt)
        if f + 1 < F_:
            nxt = up.start(images[f + 1])
        out = detect_fn(net, cur)
        kps, valid = out[0], out[2]
        V, Pd, K = kps.shape[:3]
        parts = [kps.reshape(V, Pd, K * 3), valid[..., None].to(kps.dtype)]
        if collect_appearance:
            parts.append(out[3].to(kps.dtype))
        host = torch.cat(parts, dim=-1).cpu().numpy()          # the frame's one read
        if kps_out is None:
            kps_out = np.zeros((F_, cfg.n_views, P, K, 3), dtype=np.float32)
            if collect_appearance:
                app_out = np.zeros((F_, cfg.n_views, P, out[3].shape[-1]), dtype=np.float32)
        n = min(P, Pd)
        kps_out[f, :, :n] = host[:, :n, :K * 3].reshape(V, n, K, 3)
        valid_out[f, :, :n] = host[:, :n, K * 3] > 0.5
        if collect_appearance:
            app_out[f, :, :n] = host[:, :n, K * 3 + 1:]
    if kps_out is None:
        kps_out = np.zeros((F_, cfg.n_views, P, 17, 3), dtype=np.float32)
    batch = FrameBatch(kps=kps_out, valid=valid_out)
    if collect_appearance:
        if app_out is None:
            app_out = np.zeros((F_, cfg.n_views, P, 0), dtype=np.float32)
        return batch, app_out
    return batch
