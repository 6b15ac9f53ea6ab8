"""The scipy oracle's run (`tests/torch_oracle_pipeline.run_oracle`),
cached on disk for the studies that compare the port's tracker with it
(`scripts/torch_fragmentation_study.py`,
`scripts/torch_oracle_parity_study.py`).  The oracle is a slow host
program (about a second a frame on Shelf), so one run serves both.

A cache entry is keyed by the data directory, the frame count and a digest
of what the oracle reads (the first `n_frames` frames' keypoints and valid
flags, the projection matrices), so a directory whose files changed is
solved again, and a batch loaded with more frames than the run reads
finds the same entry.  The default place is
`build/torch_oracle_cache/` inside the checkout.
"""
from __future__ import annotations

import hashlib
import importlib.util
import pickle
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CACHE_DIR = REPO / "build" / "torch_oracle_cache"
ORACLE = "torch_oracle_pipeline"


def oracle_module():
    """`tests/torch_oracle_pipeline.py` as the module `torch_oracle_pipeline`,
    loaded by its path: an installed package may own the name `tests`.  A
    module of that name already imported (pytest puts `tests/` on the path)
    is the one used, so pickled tracklets name one class."""
    if ORACLE not in sys.modules:
        spec = importlib.util.spec_from_file_location(ORACLE, REPO / "tests" / f"{ORACLE}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[ORACLE] = mod
        spec.loader.exec_module(mod)
    return sys.modules[ORACLE]


def cache_key(data_dir, n_frames: int, kps, valid, P) -> str:
    h = hashlib.sha256()
    h.update(str(Path(data_dir).resolve()).encode())
    h.update(str(int(n_frames)).encode())
    for a in (kps, valid, P):
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:24]


def run_oracle_cached(kps, valid, cams, n_frames: int, data_dir, cache_dir=None,
                      use_ik: bool = True):
    """`run_oracle(kps, valid, cams, n_frames, use_ik)`'s tracklets, read
    from the cache when this data directory, frame count and input were
    solved before, else solved and written there."""
    kps, valid = np.asarray(kps), np.asarray(valid)
    key = cache_key(data_dir, n_frames, kps[:n_frames], valid[:n_frames], np.asarray(cams.P))
    cache_dir = Path(cache_dir) if cache_dir is not None else CACHE_DIR
    path = cache_dir / f"oracle_{key}_ik{int(use_ik)}.pkl"
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    t0 = time.time()
    tlets = oracle_module().run_oracle(kps, valid, cams, n_frames, use_ik=use_ik)
    print(f"oracle run: {time.time() - t0:.0f}s, {len(tlets)} tracklets", file=sys.stderr)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(tlets, f)
    tmp.replace(path)
    return tlets
