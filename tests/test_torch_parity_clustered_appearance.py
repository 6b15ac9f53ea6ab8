"""The clustered association with appearance over a whole run, the port
against the JAX package on the CPU (`scripts/torch_parity_study.py
--study clustered_appearance`, here on tests/test_torch_appearance.py's
clustered rig: CLUSTERED and CLUSTERED_SCENE, 8 views in 2 clusters, seed
1, 9 frames, the auto gain at 8 px, the JAX side on its XLA ALS).

- The study runs both packages (the filter and one `run_offline` each) and
  finds the first frame whose decisions differ.  Before it the decisions
  are equal by its definition, and the poses must be within POSE_TOL_M.
  Where no frame differs, the whole run must be equal: tracklets, lengths,
  reprojection within REPROJ_TOL_PX (measured: equal decisions on all 9
  frames, poses within 3.0e-4 m, reprojection 5.8e-5 px apart).
- Where a frame differs, each cluster's ALS problem there, from the JAX
  run's state (`cluster_splits`): the port's ALS on JAX's own W must give
  JAX's grouping, and every cluster that binarizes otherwise must be split
  by a tie that rounding decides: at its flip with the smallest JAX margin,
  JAX's own X moves across 0.5 when its W moves to the port's W or by one
  unit in the last place (`als_split`).  A split with a wider margin fails.
- Frame 0 holds the same rule whatever the run does: its first cluster
  runs into the cap of 100 iterations in both packages and binarizes 6
  entries otherwise (groupings equal), the smallest JAX margin 0.0043
  against a reach of 0.34.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_appearance import CLUSTERED, CLUSTERED_SCENE, EMBED
from tests.torch_study_scene import one_thread

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import torch_parity_study as parity  # noqa: E402

POSE_TOL_M = 1e-3
REPROJ_TOL_PX = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def study():
    return parity.clustered_appearance_study(CLUSTERED, CLUSTERED_SCENE, EMBED)


def _assert_splits_are_ties(splits):
    assert len(splits) == CLUSTERED["assoc_clusters"]
    for c in splits:
        assert c["port_on_jax_w_gives_jax_grouping"], c
        if c["x_bin_entries_differing"]:
            assert c["near_tie"], c


def test_study_keys_and_rig(study):
    ref, seq = study["reference"], study["sequence"]
    assert (ref["study"], seq["study"]) == ("clustered_appearance_reference",
                                            "clustered_appearance_sequence")
    for line in (ref, seq):
        assert (line["frames"], line["views"], line["clusters"], line["seed"]) == (
            CLUSTERED_SCENE["n_frames"], CLUSTERED["n_views"], CLUSTERED["assoc_clusters"],
            CLUSTERED_SCENE["seed"])
        assert len(line["als_iters"]) == CLUSTERED_SCENE["n_frames"]
    assert ref["n_tracklets"] >= CLUSTERED_SCENE["n_people"]


def test_decisions_and_poses_equal_before_the_first_split(study):
    seq = study["sequence"]
    first = seq["first_diverging_frame"]
    assert first is None or first >= 0
    if first != 0:
        assert seq["max_pose_diff_m_before"] <= POSE_TOL_M


def test_whole_run_equal_or_split_by_a_tie(study):
    ref, seq = study["reference"], study["sequence"]
    if seq["first_diverging_frame"] is None:
        assert seq["n_tracklets"] == ref["n_tracklets"]
        assert seq["top_lengths"] == ref["top_lengths"]
        assert seq["n_degenerate_poses"] == ref["n_degenerate_poses"]
        for k in ("mean_reproj_px", "median_reproj_px"):
            assert abs(seq[k] - ref[k]) <= REPROJ_TOL_PX, k
        return
    assert seq["port_als_on_jax_w_gives_jax_grouping"], seq
    assert seq["split_is_rounding_tie"], seq
    _assert_splits_are_ties(seq["first_diverging_frame_clusters"])


def test_frame0_clusters_port_als_on_jax_w_gives_jax_grouping():
    from multiview_motion_capture_torch.config import PipelineConfig as TConfig
    from multiview_motion_capture_torch.data.synthetic import synthetic_appearance as t_app
    from multiview_motion_capture_tpu.config import PipelineConfig as JConfig

    jcfg, tcfg = JConfig(**CLUSTERED, als_backend="xla"), TConfig(**CLUSTERED)
    js, ts = parity.j_synth(cfg=jcfg, **CLUSTERED_SCENE), parity.t_synth(cfg=tcfg,
                                                                         **CLUSTERED_SCENE)
    tb = parity.t_filter(ts.batch, tcfg)
    splits = parity.cluster_splits(
        parity.j_tracker.TrackerContext.build(js.cameras, jcfg),
        parity.t_tracker.TrackerContext.build(ts.cameras, tcfg, device="cpu"),
        parity.j_tracker.TrackerState.zeros(jcfg), tb.kps[0], tb.valid[0],
        t_app(ts, **EMBED)[0])
    _assert_splits_are_ties(splits)
    # the frame is unsettled: a cluster at its cap in both packages
    assert any(c["at_cap_jax"] and c["at_cap_port"] for c in splits)
    assert np.isfinite([c["min_margin_jax"] for c in splits]).all()
