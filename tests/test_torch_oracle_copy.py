"""`tests/torch_oracle_pipeline.py`, the scipy oracle with the port's
camera, skeleton and keypoint-format constants (the port's studies use it
without the JAX package), against `tests/oracle_pipeline.py` on the CPU:
on a 5-frame, 5-view, 3-person scene both give the same tracklets, frames,
poses, parameters and matches exactly (the same float64 host program).
The copy is loaded as the port's studies load it
(`scripts/torch_oracle_cache.oracle_module`)."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from multiview_motion_capture_tpu.config import SHELF_BENCH
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence
from tests import oracle_pipeline as j_oracle
from tests.torch_study_scene import one_thread

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import torch_oracle_cache  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def test_oracle_copy_equals_the_jax_oracle():
    cfg = dataclasses.replace(SHELF_BENCH, n_views=5, max_frames=None)
    seq = synthetic_sequence(n_frames=5, n_people=3, n_views=5, cfg=cfg, seed=0)
    kps, valid = np.asarray(seq.batch.kps), np.asarray(seq.batch.valid)
    ref = j_oracle.run_oracle(kps, valid, seq.cameras, 5, use_ik=True)
    got = torch_oracle_cache.oracle_module().run_oracle(kps, valid, seq.cameras, 5, use_ik=True)
    assert len(ref) == len(got) >= 3
    for a, b in zip(ref, got):
        assert a.frames == b.frames and a.matched == b.matched
        assert (a.hits, a.tsu, a.state) == (b.hits, b.tsu, b.state)
        for pa, pb in zip(a.poses, b.poses):
            np.testing.assert_array_equal(pa, pb)
        for qa, qb in zip(a.params, b.params):
            for x, y in zip(qa, qb):
                np.testing.assert_array_equal(x, y)
