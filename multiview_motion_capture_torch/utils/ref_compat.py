"""Loader for tracklet pickles produced by the reference implementation.

A copy of `multiview_motion_capture_tpu/utils/ref_compat.py` (numpy only).

The reference pickles live `MvTracklet` objects whose classes live in its own
modules (ref:src/motion_capture.py:1127-1129).  This loader unpickles such
files *without* the reference code by substituting lightweight stand-in
classes keyed on class name, and normalizes both the current schema and the
older schema of the shipped golden file `data/shelf/tracklets/traclets.pkl`
(2-tuple `poses` entries; see SURVEY.md §8 "schema skew").
"""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import List

import numpy as np


class _Record:
    """Accepts any pickled attribute layout."""

    def __init__(self, *args, **kwargs):
        self.args = args
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.state = state


class _AnyClassUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except Exception:
            return type(name, (_Record,), {"__module__": module})


@dataclasses.dataclass
class RefTrackletView:
    """Normalized view of one reference tracklet."""

    frame_idxs: List[int]
    roots: np.ndarray          # (L, 3)
    euler_angles: np.ndarray   # (L, J, 3)
    bone_lens: np.ndarray      # (L, B)
    poses_3d: np.ndarray       # (L, J, 3)

    def __len__(self):
        return len(self.frame_idxs)


def load_reference_tracklets(path: Path) -> List[RefTrackletView]:
    with open(path, "rb") as f:
        payload = _AnyClassUnpickler(f).load()
    tlets = payload["tracklets"] if isinstance(payload, dict) else payload
    out = []
    for t in tlets:
        poses = getattr(t, "poses", None)
        frame_idxs = list(getattr(t, "frame_idxs", []))
        roots, eulers, blens, kps = [], [], [], []
        for i, entry in enumerate(poses):
            # current schema: (frame_idx, PoseShapeParam, Pose);
            # golden-file schema: (PoseShapeParam, Pose)
            if len(entry) == 3:
                fidx, pparam, pose = entry
            else:
                pparam, pose = entry
                fidx = frame_idxs[i] if i < len(frame_idxs) else i
            roots.append(np.asarray(pparam.root))
            eulers.append(np.asarray(pparam.euler_angles))
            blens.append(np.asarray(pparam.bone_lens))
            kps.append(np.asarray(pose.keypoints))
        out.append(
            RefTrackletView(
                frame_idxs=frame_idxs if frame_idxs else list(range(len(poses))),
                roots=np.stack(roots),
                euler_angles=np.stack(eulers),
                bone_lens=np.stack(blens),
                poses_3d=np.stack(kps),
            )
        )
    return out
