"""Chunked checkpoint/resume for tracking runs.

Port of `multiview_motion_capture_tpu/utils/checkpoint.py`.  The offline
run is split into fixed-size chunks; after each chunk the tracker state and
that chunk's per-frame outputs are written to disk, and `resume_info` lets
a restarted run continue from the last completed chunk.

The files are the JAX package's: `chunk_%05d.npz` holding `state_<field>`
for every `TrackerState` field and `out_<field>` for every `FrameOutput`
field, and `meta.json` holding `last_chunk` and `end_frame`.  The two
packages' state and output fields are the same, so a checkpoint written by
either loads in the other.  `load_outputs` requires every output field, as
the JAX package's does (a file without `out_app_obs` raises a `KeyError`
that names it).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from multiview_motion_capture_torch.tracker import FrameOutput, TrackerState, from_numpy_state
from multiview_motion_capture_torch.utils.precision import resolve_device


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _chunk_path(ckpt_dir: Path, chunk_idx: int) -> Path:
    return Path(ckpt_dir) / f"chunk_{chunk_idx:05d}.npz"


def save_chunk(ckpt_dir: Path, chunk_idx: int, end_frame: int,
               state: TrackerState, outputs: FrameOutput) -> None:
    """Write chunk `chunk_idx` (the state after it and its outputs, tensors
    or numpy), then mark it as the last completed chunk."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        _chunk_path(ckpt_dir, chunk_idx),
        **{f"state_{f.name}": _numpy(getattr(state, f.name))
           for f in dataclasses.fields(TrackerState)},
        **{f"out_{name}": _numpy(getattr(outputs, name)) for name in FrameOutput._fields},
    )
    meta = {"last_chunk": chunk_idx, "end_frame": end_frame}
    (ckpt_dir / "meta.json").write_text(json.dumps(meta))


def resume_info(ckpt_dir: Path) -> Optional[dict]:
    """`{"last_chunk", "end_frame"}` of the last completed chunk, or None."""
    meta_path = Path(ckpt_dir) / "meta.json"
    if not meta_path.exists():
        return None
    return json.loads(meta_path.read_text())


def load_state(ckpt_dir: Path, chunk_idx: int, device="cuda") -> TrackerState:
    """The tracker state saved after chunk `chunk_idx`, on `device` ("cuda"
    unless the caller asks for "cpu")."""
    dev = resolve_device(device)
    with np.load(_chunk_path(ckpt_dir, chunk_idx)) as z:
        arrays = {f.name: z[f"state_{f.name}"] for f in dataclasses.fields(TrackerState)}
    return from_numpy_state(arrays, device=dev)


def load_outputs(ckpt_dir: Path, up_to_chunk: int) -> List[FrameOutput]:
    """The numpy outputs of chunks 0 .. `up_to_chunk`."""
    outs = []
    for c in range(up_to_chunk + 1):
        with np.load(_chunk_path(ckpt_dir, c)) as z:
            outs.append(FrameOutput(*[z[f"out_{n}"] for n in FrameOutput._fields]))
    return outs


def concat_outputs(chunks: List[FrameOutput]) -> FrameOutput:
    """The chunks' outputs as one run's (F, ...) numpy outputs."""
    return FrameOutput(*[np.concatenate([_numpy(getattr(c, name)) for c in chunks], axis=0)
                         for name in FrameOutput._fields])
