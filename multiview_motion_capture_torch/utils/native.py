"""The JAX package's host-runtime entry points (its `utils/native.py`), on
the port's own code.

The JAX package binds `native/libmvmc_native.so` (C++: OpenPose JSON
parsing, the Hungarian, union-find groups) and falls back to Python where
it cannot build it.  The port binds no host library: each function here is
numpy or Python that returns what the C++ routine returns.

- `hungarian`: `utils.hungarian`, a transcription of the C++ solver (the
  same assignments on ties);
- `parse_openpose_file`: the JSON parser `data.ingest` reads with;
- `extract_groups_host`: a union-find (the JAX module's own fallback).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from multiview_motion_capture_torch.data.ingest import _parse_openpose_json
from multiview_motion_capture_torch.utils.hungarian import hungarian  # noqa: F401


def native_available() -> bool:
    """False: the port does not bind `native/libmvmc_native.so`; every
    function of this module runs the port's numpy/Python code."""
    return False


def parse_openpose_file(path: Path, max_people: int = 32) -> Optional[np.ndarray]:
    """One OpenPose JSON file -> (n_people, 25, 3) float32, at most
    `max_people` people; a missing file raises FileNotFoundError."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(path)
    return _parse_openpose_json(path)[:max_people]


def extract_groups_host(x_bin: np.ndarray, valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Union-find group extraction on the host: (rep, group_size) with
    rep[i] the lowest-index member of i's component (n for an invalid i)
    and group_size[i] its size (0 for an invalid i)."""
    n = len(valid)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(n):
        if not valid[i]:
            continue
        for j in range(i + 1, n):
            if valid[j] and (x_bin[i, j] or x_bin[j, i]):
                ra, rb = find(i), find(j)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
    rep = np.array([find(i) if valid[i] else n for i in range(n)], np.int32)
    size = np.zeros(n, np.int32)
    for i in range(n):
        if valid[i]:
            size[rep[i]] += 1
    gs = np.array([size[rep[i]] if valid[i] else 0 for i in range(n)], np.int32)
    return rep, gs
