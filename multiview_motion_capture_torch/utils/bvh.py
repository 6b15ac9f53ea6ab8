"""BVH skeleton animation: writer + reader.

Port of `multiview_motion_capture_tpu/utils/bvh.py` (numpy on the host, as
there; `ops.fk_generic.animate_bvh` replays a file on the device).  The
reference can only *read* BVH (ref:src/bvh.py:24-317, never imported);
the framework's output contract requires exporting tracked motion, so the
writer is the primary artifact here: a `Tracklet`'s per-frame
(root, euler_angles, side_bone_lens) maps directly onto a BVH HIERARCHY of
the BASIC_18 skeleton with `Xrotation Yrotation Zrotation` channels — the
same R = Rx @ Ry @ Rz composition the FK chain uses (ops/fk.py).

Units: BVH offsets/positions are written in centimeters (x100) since most
BVH tooling expects cm-scale skeletons; rotations in degrees.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple

import numpy as np

from multiview_motion_capture_torch.ops.fk import (
    REF_BONE_DIRS,
    SIDE_TO_FULL,
)
from multiview_motion_capture_torch.pose_def import (
    BASIC_18_ORDER,
    BASIC_18_PARENTS,
)

_SCALE = 100.0  # meters -> centimeters


def _children(parents: np.ndarray) -> List[List[int]]:
    ch: List[List[int]] = [[] for _ in parents]
    for j in range(1, len(parents)):
        ch[parents[j]].append(j)
    return ch


def write_bvh(
    path: Path,
    roots: np.ndarray,          # (F, 3) meters
    eulers: np.ndarray,         # (F, 18, 3) radians
    side_lens: np.ndarray,      # (11,) or (F, 11) meters
    frame_time: float = 1.0 / 25.0,
) -> None:
    parents = np.asarray(BASIC_18_PARENTS)
    names = [t.name for t in BASIC_18_ORDER]
    children = _children(parents)

    side = np.asarray(side_lens)
    if side.ndim == 2:
        side = side.mean(axis=0)  # BVH has one static skeleton
    offsets = REF_BONE_DIRS * side[np.asarray(SIDE_TO_FULL)][:, None] * _SCALE

    lines: List[str] = ["HIERARCHY"]

    def emit(j: int, depth: int) -> None:
        pad = "  " * depth
        tag = "ROOT" if j == 0 else "JOINT"
        off = offsets[j] if j != 0 else np.zeros(3)
        lines.append(f"{pad}{tag} {names[j]}")
        lines.append(pad + "{")
        lines.append(f"{pad}  OFFSET {off[0]:.6f} {off[1]:.6f} {off[2]:.6f}")
        if j == 0:
            lines.append(
                f"{pad}  CHANNELS 6 Xposition Yposition Zposition "
                "Xrotation Yrotation Zrotation"
            )
        else:
            lines.append(f"{pad}  CHANNELS 3 Xrotation Yrotation Zrotation")
        if children[j]:
            for c in children[j]:
                emit(c, depth + 1)
        else:
            lines.append(f"{pad}  End Site")
            lines.append(pad + "  {")
            # a short stub along the incoming bone direction
            stub = REF_BONE_DIRS[j] * 0.05 * _SCALE
            lines.append(f"{pad}    OFFSET {stub[0]:.6f} {stub[1]:.6f} {stub[2]:.6f}")
            lines.append(pad + "  }")
        lines.append(pad + "}")

    emit(0, 0)

    F = len(roots)
    lines.append("MOTION")
    lines.append(f"Frames: {F}")
    lines.append(f"Frame Time: {frame_time:.8f}")
    deg = np.degrees(np.asarray(eulers))
    pos = np.asarray(roots) * _SCALE
    for f in range(F):
        vals = [f"{v:.4f}" for v in pos[f]]
        for j in range(len(parents)):
            vals.extend(f"{v:.4f}" for v in deg[f, j])
        lines.append(" ".join(vals))

    Path(path).write_text("\n".join(lines) + "\n")


@dataclasses.dataclass
class BvhData:
    names: List[str]
    parents: np.ndarray         # (J,)
    offsets: np.ndarray         # (J, 3) (file units)
    roots: np.ndarray           # (F, 3)
    eulers: np.ndarray          # (F, J, 3) radians, xyz order
    frame_time: float


def read_bvh(path: Path) -> BvhData:
    """Minimal BVH reader (HIERARCHY + MOTION with 6-channel root and
    3-rotation joints, xyz rotation order) — covers files produced by
    `write_bvh` and common mocap exports (parity with the reference's
    read-only bvh.py)."""
    text = Path(path).read_text().splitlines()
    names: List[str] = []
    parents: List[int] = []
    offsets: List[List[float]] = []
    stack: List[int] = []
    channel_order: List[Tuple[int, List[str]]] = []
    i = 0
    in_end_site = False
    while i < len(text):
        tok = text[i].strip().split()
        if not tok:
            i += 1
            continue
        key = tok[0].upper()
        if key in ("ROOT", "JOINT"):
            parents.append(stack[-1] if stack else -1)
            names.append(tok[1])
            offsets.append([0.0, 0.0, 0.0])
        elif key == "OFFSET" and not in_end_site:
            if names:
                offsets[-1] = [float(v) for v in tok[1:4]]
        elif key == "CHANNELS":
            channel_order.append((len(names) - 1, tok[2:]))
        elif key == "END":
            in_end_site = True
        elif tok[0] == "{":
            if not in_end_site:
                stack.append(len(names) - 1)
        elif tok[0] == "}":
            if in_end_site:
                in_end_site = False
            elif stack:
                stack.pop()
        elif key == "MOTION":
            break
        i += 1

    n_frames = int(text[i + 1].split(":")[1])
    frame_time = float(text[i + 2].split(":")[1])
    rows = [
        [float(v) for v in text[k].split()]
        for k in range(i + 3, i + 3 + n_frames)
    ]
    data = np.asarray(rows)

    J = len(names)
    roots = np.zeros((n_frames, 3))
    eulers = np.zeros((n_frames, J, 3))
    col = 0
    for j, chans in channel_order:
        for c in chans:
            cl = c.lower()
            if cl.endswith("position"):
                roots[:, "xyz".index(cl[0])] = data[:, col]
            else:
                eulers[:, j, "xyz".index(cl[0])] = np.radians(data[:, col])
            col += 1

    return BvhData(
        names=names,
        parents=np.asarray(parents, dtype=np.int32),
        offsets=np.asarray(offsets),
        roots=roots,
        eulers=eulers,
        frame_time=frame_time,
    )


def export_tracklet_bvh(path: Path, tracklet, frame_time: float = 1.0 / 25.0) -> None:
    """Export one tracked person to BVH (pipeline.Tracklet -> file)."""
    write_bvh(
        path,
        roots=tracklet.roots,
        eulers=tracklet.eulers,
        side_lens=tracklet.side_lens,
        frame_time=frame_time,
    )
