"""Host-side visualization (the ops run on the device; drawing stays on the
host).

Port of `multiview_motion_capture_tpu/utils/viz.py`, the same drawing
calls.  `cv2`, `imageio` and `matplotlib` are imported inside the
functions that draw with them, so this module imports where they are not
installed; a missing one raises the ImportError that names it.

Covers the reference's `pose_viz.py` surface (SURVEY.md §2 row 15):
track-id colors, 2D skeleton drawing, crop strips, epipolar-line overlays,
and the 3D-plus-reprojection sequence renderer (matplotlib Agg — no GUI).
Video encoding goes through imageio/ffmpeg when frames are available.
"""
from __future__ import annotations

import colorsys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multiview_motion_capture_torch.pose_def import (
    BASIC_18_BONES,
    COCO_BONES,
    KpsFormat,
    kps_index,
)


def track_color(track_id: int) -> Tuple[int, int, int]:
    """Deterministic, well-separated BGR color per track id (golden-ratio
    hue walk instead of the reference's random palette,
    ref:src/pose_viz.py:20-66)."""
    hue = (track_id * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(hue, 0.85, 0.95)
    return int(b * 255), int(g * 255), int(r * 255)


def _coco_bone_idx() -> List[Tuple[int, int]]:
    idx = kps_index(KpsFormat.COCO)
    return [(idx[a], idx[b]) for a, b in COCO_BONES]


def draw_pose_2d(
    img: np.ndarray,
    kps: np.ndarray,
    color=(0, 255, 0),
    min_score: float = 0.1,
    bones: Optional[Sequence[Tuple[int, int]]] = None,
) -> np.ndarray:
    """Draw a COCO-17 (or generic) keypoint set with its bones."""
    import cv2

    if bones is None and len(kps) == 17:
        bones = _coco_bone_idx()
    for x, y, *rest in kps:
        s = rest[0] if rest else 1.0
        if s > min_score:
            cv2.circle(img, (int(x), int(y)), 3, color, -1)
    if bones is not None:
        for a, b in bones:
            if kps[a, -1] > min_score and kps[b, -1] > min_score:
                cv2.line(img, (int(kps[a, 0]), int(kps[a, 1])),
                         (int(kps[b, 0]), int(kps[b, 1])), color, 2)
    return img


def draw_crop_strip(
    imgs: List[np.ndarray],
    kps_list: List[np.ndarray],
    crop_height: int = 256,
    labels: Optional[List[str]] = None,
    min_score: float = 0.1,
) -> Optional[np.ndarray]:
    """Side-by-side crops of one person across views
    (ref:src/pose_viz.py:224-276 semantics)."""
    import cv2

    crops = []
    for i, (img, kps) in enumerate(zip(imgs, kps_list)):
        valid = kps[kps[:, -1] > min_score, :2]
        if len(valid) == 0:
            continue
        x1, y1 = np.maximum(valid.min(axis=0).astype(int) - 10, 0)
        x2, y2 = valid.max(axis=0).astype(int) + 10
        x2, y2 = min(x2, img.shape[1]), min(y2, img.shape[0])
        if x2 - x1 < 5 or y2 - y1 < 5:
            continue
        crop = img[y1:y2, x1:x2].copy()
        h, w = crop.shape[:2]
        crop = cv2.resize(crop, (max(int(w * crop_height / h), 1), crop_height))
        if labels:
            cv2.putText(crop, str(labels[i]), (5, 30), cv2.FONT_HERSHEY_SIMPLEX,
                        1, (255, 0, 0), 2)
        crops.append(crop)
    if not crops:
        return None
    return np.concatenate(crops, axis=1)


def draw_epipolar_lines(
    img_a: np.ndarray,
    img_b: np.ndarray,
    kps_a: np.ndarray,
    F_ab: np.ndarray,
    color=(0, 0, 255),
) -> Tuple[np.ndarray, np.ndarray]:
    """Overlay the epipolar lines of `kps_a` (image a) onto image b
    (ref:src/pose_viz.py:279-308)."""
    import cv2

    h, w = img_b.shape[:2]
    homo = np.concatenate([kps_a[:, :2], np.ones((len(kps_a), 1))], axis=1)
    lines = homo @ F_ab.T  # l = F x
    for (a, b, c), kp in zip(lines, kps_a):
        cv2.circle(img_a, (int(kp[0]), int(kp[1])), 3, color, -1)
        if abs(b) < 1e-9:
            continue
        y0 = int(-c / b)
        y1 = int(-(c + a * w) / b)
        cv2.line(img_b, (0, y0), (w, y1), color, 1)
    return img_a, img_b


def render_tracklets_video(
    tracklets,
    cams,
    out_path: Path,
    frame_images: Optional[Dict[int, List[np.ndarray]]] = None,
    img_wh: Tuple[int, int] = (1032, 776),
    fps: int = 24,
    max_tracklets: int = 10,
    thumb_w: int = 344,
) -> Path:
    """Per-frame grid: each view with every tracklet's 3D pose reprojected
    (ref:src/pose_viz.py:69-187 `plot_poses_3d_reprojects`, without the
    matplotlib 3D panel — pure cv2 for speed).  `frame_images` maps frame ->
    list of per-view BGR images; blank canvases are used when absent (the
    bundled dataset ships no videos)."""
    import cv2
    import imageio.v2 as imageio

    P = np.asarray(cams.P.detach().cpu(), dtype=np.float64)
    V = len(P)
    tracklets = tracklets[:max_tracklets]
    frames = sorted({f for t in tracklets for f in t.frame_idxs})
    # fall back to a directory of numbered JPEGs when no video encoder
    # (ffmpeg / imageio-ffmpeg) exists in the environment
    try:
        writer = imageio.get_writer(str(out_path), fps=fps)
    except Exception:
        frame_dir = Path(out_path).with_suffix("")
        frame_dir.mkdir(parents=True, exist_ok=True)

        class _DirWriter:
            def __init__(self):
                self.i = 0

            def append_data(self, rgb):
                imageio.imwrite(frame_dir / f"{self.i:06d}.jpg", rgb)
                self.i += 1

            def close(self):
                pass

        writer = _DirWriter()
        out_path = frame_dir
    w, h = img_wh
    scale = thumb_w / w
    thumb_h = int(h * scale)
    b18_bones = list(BASIC_18_BONES)

    for f in frames:
        views = []
        for v in range(V):
            if frame_images and f in frame_images:
                img = frame_images[f][v].copy()
            else:
                img = np.full((h, w, 3), 32, dtype=np.uint8)
            for t in tracklets:
                if f not in t.frame_idxs:
                    continue
                i = t.frame_idxs.index(f)
                X = t.poses_3d[i]
                homo = np.concatenate([X, np.ones((len(X), 1))], axis=1)
                uvw = homo @ P[v].T
                uv = uvw[:, :2] / uvw[:, 2:3]
                kps = np.concatenate([uv, np.ones((len(uv), 1))], axis=1)
                bones = b18_bones if len(X) == 18 else None
                draw_pose_2d(img, kps, color=track_color(t.track_id), bones=bones)
            img = cv2.resize(img, (thumb_w, thumb_h))
            cv2.putText(img, f"cam{v}", (8, 24), cv2.FONT_HERSHEY_SIMPLEX,
                        0.7, (255, 255, 255), 1)
            views.append(img)
        # grid: up to 3 per row
        rows = []
        for r in range(0, V, 3):
            row = views[r:r + 3]
            while len(row) < 3:
                row.append(np.zeros_like(views[0]))
            rows.append(np.concatenate(row, axis=1))
        canvas = np.concatenate(rows, axis=0)
        cv2.putText(canvas, f"frame {f}", (8, canvas.shape[0] - 12),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 255), 2)
        writer.append_data(canvas[:, :, ::-1])
    writer.close()
    return Path(out_path)


def plot_tracklets_3d(tracklets, out_path: Path, max_tracklets: int = 10) -> Path:
    """Static 3D trajectory plot (matplotlib Agg) — the offline counterpart
    of the reference's interactive animation (ref:src/pose_viz.py:189-215)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    for t in tracklets[:max_tracklets]:
        c = np.asarray(track_color(t.track_id))[::-1] / 255.0
        hips = t.poses_3d[:, 0] if t.poses_3d.shape[1] == 18 else t.poses_3d[:, 11:13].mean(1)
        ax.plot(hips[:, 0], hips[:, 1], hips[:, 2], color=c, label=f"track {t.track_id}")
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    ax.legend()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return Path(out_path)


def animate_tracklets_3d(
    tracklets,
    out_path: Path,
    max_tracklets: int = 10,
    fps: int = 24,
    trail: int = 40,
    elev: float = 20.0,
    azim: float = -60.0,
) -> Path:
    """Animated 3D skeleton playback — the offline equivalent of the
    reference's interactive matplotlib FuncAnimation window
    (ref:src/pose_viz.py:69-215 `plot_poses_3d_reprojects` 3D panel /
    189-215): per-frame 3D skeletons plus a fading hip trail, rendered
    headless (Agg) and written as mp4/gif via FuncAnimation's writers
    (PillowWriter fallback when ffmpeg is absent).  The reference shows this
    live in a window; a TPU batch pipeline has no display, so the animation
    is exported instead."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    tracklets = tracklets[:max_tracklets]
    frames = sorted({f for t in tracklets for f in t.frame_idxs})
    if not frames:
        raise ValueError("no frames to animate")
    b18_bones = list(BASIC_18_BONES)
    coco_bones = _coco_bone_idx()

    # world-extent box from all finite joints
    pts = np.concatenate([t.poses_3d.reshape(-1, 3) for t in tracklets])
    pts = pts[np.isfinite(pts).all(axis=1)]
    lo, hi = np.percentile(pts, 1, axis=0), np.percentile(pts, 99, axis=0)
    pad = 0.3 * (hi - lo + 1e-6)

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.view_init(elev=elev, azim=azim)

    def draw(fi):
        f = frames[fi]
        ax.cla()
        ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
        ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
        ax.set_zlim(max(0.0, lo[2] - pad[2]), hi[2] + pad[2])
        ax.set_title(f"frame {f}")
        for t in tracklets:
            if f not in t.frame_idxs:
                continue
            i = t.frame_idxs.index(f)
            X = t.poses_3d[i]
            c = np.asarray(track_color(t.track_id))[::-1] / 255.0
            bones = b18_bones if X.shape[0] == 18 else coco_bones
            for a, b in bones:
                seg = X[[a, b]]
                if np.isfinite(seg).all():
                    ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=c, lw=1.5)
            # fading hip trail over the last `trail` frames
            past = [j for j, fj in enumerate(t.frame_idxs)
                    if f - trail <= fj <= f]
            if len(past) > 1:
                hips = (t.poses_3d[past, 0] if X.shape[0] == 18
                        else t.poses_3d[past][:, 11:13].mean(1))
                ax.plot(hips[:, 0], hips[:, 1], hips[:, 2], color=c,
                        lw=0.8, alpha=0.5)
        return []

    anim = animation.FuncAnimation(fig, draw, frames=len(frames),
                                   interval=1000.0 / fps, blit=False)
    out_path = Path(out_path)
    try:
        if out_path.suffix == ".gif":
            raise RuntimeError("gif requested")
        anim.save(str(out_path), writer=animation.FFMpegWriter(fps=fps))
    except Exception:
        out_path = out_path.with_suffix(".gif")
        anim.save(str(out_path), writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
