"""The port's detector studies against the JAX package's scripts on the
CPU: `scripts/torch_crowd_detect_study.py` (against `scripts/
crowd_detect_study.py`) and `scripts/torch_detector_style_holdout.py`
(against `scripts/detector_style_holdout.py`), on the shipped bottom-up
checkpoint in its bf16 compute.  XLA and PyTorch (oneDNN here, cuDNN on
the card) round the convolutions' bf16 sums at other places (PERF.md §4,
ROADMAP C "Detection in bf16"), so detections are held to PR 7's
detection bounds: recall within RECALL_TOL, error within ERR_TOL_PX.

- Crowd study: `gt_arrays`, `visibility_arrays` (the renderer's rng draws
  replayed), `center_stats` and `center_recall` equal on the same scene;
  `oracle_center_decode` equal given the same heat (a seeded random map
  handed to both as the network's output); then both `main`s at 1 frame
  and 4 people (`--people 4 --frames 1`): the stage recalls within
  RECALL_TOL, the errors within ERR_TOL_PX, the ground-truth-only fields
  equal.
- Style hold-out: `STYLES` equal to the JAX script's field for field;
  `eval_style` on one style and one seed within the same bounds.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.config import PipelineConfig as TConfig
from multiview_motion_capture_torch.data.detect import make_bottom_up_detector
from multiview_motion_capture_torch.data.render import RenderConfig as TRender
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_torch.models.checkpoint import load_posenet
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth

from tests.torch_study_scene import one_thread

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import crowd_detect_study as j_crowd  # noqa: E402
import detector_style_holdout as j_style  # noqa: E402
import torch_crowd_detect_study as t_crowd  # noqa: E402
import torch_detector_style_holdout as t_style  # noqa: E402

# the JAX scripts set the compilation cache at import; keep the suite's
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")

RECALL_TOL = 0.01
ERR_TOL_PX = 0.1
SCENE = dict(n_frames=1, n_people=4, n_views=5, seed=1, noise_px=0.0, drop_prob=0.0,
             min_person_distance=1.2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def shipped():
    return load_posenet(t_crowd.CKPT, device="cpu")


def test_crowd_helpers_match_jax(shipped):
    jseq = j_synth(cfg=JConfig(n_views=5, max_people=8), **SCENE)
    tseq = t_synth(cfg=TConfig(n_views=5, max_people=8), **SCENE)
    j_gt = j_crowd.gt_arrays(jseq, 1, 5)
    t_gt = t_crowd.gt_arrays(tseq, 1, 5)
    for a, b in zip(j_gt, t_gt):
        np.testing.assert_array_equal(a, b)
    rcfg = j_crowd.RenderConfig(hw=(192, 256))
    np.testing.assert_array_equal(j_crowd.visibility_arrays(jseq, 1, 5, rcfg, seed=2),
                                  t_crowd.visibility_arrays(tseq, 1, 5, TRender(hw=(192, 256)),
                                                            seed=2))
    assert t_crowd.center_stats(*t_gt) == j_crowd.center_stats(*j_gt)
    # centres detected by the port's detector, scored by both
    mcfg, net = shipped
    images = t_crowd.render_sequence(tseq, TRender(hw=(192, 256)), world_scale=t_crowd.WS,
                                     seed=2)
    _, centers, valid = make_bottom_up_detector(mcfg, max_people=8,
                                                center_min_score=0.2)(net, images[0])
    centers, valid = centers.numpy(), valid.numpy()
    assert valid.sum() >= 12
    assert t_crowd.center_recall(centers, valid, *t_gt) == \
        j_crowd.center_recall(centers, valid, *j_gt)
    # and with one detection moved off its person: the same miss in both
    moved = centers.copy()
    moved[0, np.argmax(valid[0])] += 30.0
    assert t_crowd.center_recall(moved, valid, *t_gt) == \
        j_crowd.center_recall(moved, valid, *j_gt) < 1.0


def test_oracle_center_decode_matches_jax_on_the_same_heat(shipped, monkeypatch):
    mcfg, _ = shipped
    jseq = j_synth(cfg=JConfig(n_views=5, max_people=8), **SCENE)
    gt_kps, gt_pres = j_crowd.gt_arrays(jseq, 1, 5)
    N = gt_kps.shape[0]
    rng = np.random.RandomState(0)
    heat = rng.uniform(0.0, 0.3, (N, 48, 64, mcfg.n_out)).astype(np.float32)
    heat[..., mcfg.n_kps + 1:] = rng.normal(0.0, 2.0, heat[..., mcfg.n_kps + 1:].shape)
    # each image carries its own index, so a fake network returns its map
    images = np.zeros((N, 192, 256, 3), np.float32)
    images[:, 0, 0, 0] = np.arange(N)

    class FakePoseNet:
        def __init__(self, cfg):
            pass

        def apply(self, variables, im):
            return jnp.asarray(heat)[im[:, 0, 0, 0].astype(jnp.int32)]

    monkeypatch.setattr(j_crowd, "PoseNet", FakePoseNet)
    j_det, j_val = j_crowd.oracle_center_decode(mcfg, None, images, gt_kps, gt_pres)
    t_det, t_val = t_crowd.oracle_center_decode(
        mcfg, lambda im: torch.as_tensor(heat)[im[:, 0, 0, 0].long()], images, gt_kps, gt_pres)
    np.testing.assert_array_equal(t_val, j_val)
    np.testing.assert_array_equal(t_det, j_det)
    assert t_val.sum() == gt_pres.sum() > 0


def test_crowd_detect_study_matches_jax(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["crowd_detect_study.py", "--people", "4", "--frames", "1"])
    j_crowd.main()
    j_out = json.loads(capsys.readouterr().out.split("\n", 1)[1])["extra"]
    out = t_crowd.main(["--people", "4", "--frames", "1", "--cpu"])["extra"]
    capsys.readouterr()
    assert list(out) == list(j_out) == ["p4_d1.2"]
    got, ref = out["p4_d1.2"], j_out["p4_d1.2"]
    assert set(got) == set(ref)
    for k in ("recall", "recall_detectable", "precision", "center_recall",
              "oracle_center_recall"):
        assert abs(got[k] - ref[k]) <= RECALL_TOL, (k, got[k], ref[k])
    for k in ("err_px", "oracle_center_err_px"):
        assert abs(got[k] - ref[k]) <= ERR_TOL_PX, (k, got[k], ref[k])
    assert got["frac_detectable"] == ref["frac_detectable"]
    assert got["centers"] == ref["centers"]
    assert got["recall"] >= 0.9


def test_styles_are_the_jax_scripts():
    assert list(t_style.STYLES) == list(j_style.STYLES)
    for name, rcfg in j_style.STYLES.items():
        assert dataclasses.asdict(t_style.STYLES[name]) == dataclasses.asdict(rcfg), name


def test_eval_style_matches_jax(shipped):
    mcfg, net = shipped
    jmcfg, params = j_style.load_posenet(j_style.CKPT)
    ref = j_style.eval_style(jmcfg, params, j_style.STYLES["dark_noisy"], [3000], 0.2)
    got = t_style.eval_style(mcfg, net, t_style.STYLES["dark_noisy"], [3000], 0.2)
    assert got["n_gt"] == ref["n_gt"] > 0
    assert abs(got["recall"] - ref["recall"]) <= RECALL_TOL
    assert abs(got["precision"] - ref["precision"]) <= RECALL_TOL
    assert abs(got["mean_err_px"] - ref["mean_err_px"]) <= ERR_TOL_PX
