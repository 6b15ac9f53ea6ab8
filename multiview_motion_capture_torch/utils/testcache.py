"""Train-once disk cache for CNN trainings in tests.

Port of `multiview_motion_capture_tpu/utils/testcache.py`.  A training is
deterministic given its seeds and sources, so a trained checkpoint can be
reused across test runs, provided the cache key changes whenever any code
that shapes the training changes: the fingerprint hashes the source files
the caller names plus the caller's hyper-parameter key (the JAX package's
hash, so the same files and key give the same fingerprint in both).

Cache location: $MVMC_TEST_CKPT_CACHE, else `mvmc_test_ckpt` in the
temporary directory.  Delete the directory to force retraining.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path
from typing import Iterable


def source_fingerprint(paths: Iterable[Path], key: str) -> str:
    """sha1 over the given source files' bytes + the hyper-parameter key."""
    h = hashlib.sha1()
    for p in sorted(str(p) for p in paths):
        h.update(Path(p).read_bytes())
    h.update(key.encode())
    return h.hexdigest()[:16]


def checkpoint_path(name: str, fingerprint: str) -> Path:
    base = Path(os.environ.get("MVMC_TEST_CKPT_CACHE",
                               Path(tempfile.gettempdir()) / "mvmc_test_ckpt"))
    base.mkdir(parents=True, exist_ok=True)
    return base / f"{name}-{fingerprint}.npz"
