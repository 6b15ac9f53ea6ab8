"""`scripts/torch_appearance_e2e_study.py` against `scripts/
appearance_e2e_study.py` on the CPU, at E2E_FRAMES frames of its scene (4
people, 5 views, the shipped bottom-up PoseNet with colour-layout
embeddings, then tracking in triangulation mode).

- `_label_detections` equal on the same batch (the JAX detector's): the
  same labels, the same cosines within 1e-6.
- The `geometry_only` and `appearance_auto_target8` rows of the port's
  study (its own detections, the shipped bf16 compute: XLA and cuDNN or
  oneDNN round the convolutions' sums at other places, PERF.md §4) within
  IDF1_TOL of the JAX script's, and every row of the port's JSON present
  with the JAX row's keys.  The JAX script tracks its nine rows, each a
  tracker program to compile (~10 s on this CPU); the test lets it track
  the two it compares and hands the other seven an empty run (its
  `pipeline` replaced by monkeypatch), so the file stays within a minute.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import appearance_e2e_study as j_app  # noqa: E402
import torch_appearance_e2e_study as t_app  # noqa: E402
from tests.torch_study_scene import json_of, one_thread  # noqa: E402

# the JAX script sets the compilation cache at import; keep the suite's
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")

E2E_FRAMES = 4
IDF1_TOL = 0.01
COMPARED = ("geometry_only", "appearance_auto_target8")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


class _TwoRows:
    """The JAX script's `pipeline`: `run` tracks the geometry-only and the
    auto-gain rows and returns no tracklets for the others."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.batches = []

    def run(self, batch, cams, cfg, use_ik=True, app=None, crossings=False, **kw):
        self.batches.append((batch, app))
        auto8 = (cfg.appearance_dim > 0 and cfg.appearance_auto_target_px == 8.0
                 and cfg.appearance_gain_px == type(cfg)().appearance_gain_px)
        if (cfg.appearance_dim == 0 or auto8) and not crossings:
            return self.pipeline.run(batch, cams, cfg, use_ik=use_ik, app=app,
                                     crossings=crossings, **kw)
        return SimpleNamespace(tracklets=[])


def test_appearance_e2e_study_matches_jax(monkeypatch, capsys):
    monkeypatch.setattr(j_app, "N_FRAMES", E2E_FRAMES)
    rows = _TwoRows(j_app.pipeline)
    monkeypatch.setattr(j_app, "pipeline", rows)
    labels = []
    real_label = j_app._label_detections

    def label(seq, batch, app):
        labels.append((seq, batch, app, real_label(seq, batch, app)))
        return labels[-1][-1]

    monkeypatch.setattr(j_app, "_label_detections", label)
    j_app.main()
    j_out = json_of(capsys.readouterr().out)["extra"]

    # the labels of the JAX detector's batch, by the port's function
    (seq, batch, app, (j_slots, (j_same, j_diff))), = labels
    t_slots, (t_same, t_diff) = t_app._label_detections(seq, batch, np.asarray(app))
    np.testing.assert_array_equal(t_slots, j_slots)
    assert abs(t_same - j_same) <= 1e-6 and abs(t_diff - j_diff) <= 1e-6
    assert (j_slots >= 0).sum() >= E2E_FRAMES * 5 * 3

    line = t_app.main(["--frames", str(E2E_FRAMES), "--cpu"])
    capsys.readouterr()
    out = line["extra"]
    assert line["metric"] == "appearance_e2e_study" and set(out) == set(j_out)
    for name, row in out.items():
        if isinstance(row, dict):
            assert set(row) == set(j_out[name]), name
    for name in COMPARED:
        for k in ("raw_idf1", "reid_idf1"):
            assert abs(out[name][k] - j_out[name][k]) <= IDF1_TOL, (name, k, out[name],
                                                                    j_out[name])
        assert out[name]["raw_tracks"] >= 4
    assert abs(out["extractor_cos_same"] - j_out["extractor_cos_same"]) <= 0.01
    assert abs(out["extractor_cos_diff"] - j_out["extractor_cos_diff"]) <= 0.01


def test_scale_wrapper_maps_back():
    """`--scale`'s wrapper divides keypoints and centres by the scale and
    leaves scores, valid flags and embeddings."""
    kps = torch.rand(2, 3, 17, 3)
    centers = torch.rand(2, 3, 3)
    valid = torch.ones(2, 3, dtype=torch.bool)
    emb = torch.rand(2, 3, 51)
    k, c, v, e = t_app.rescaled(lambda net, im: (kps, centers, valid, emb), 1.5)(None, None)
    torch.testing.assert_close(k[..., :2], kps[..., :2] / 1.5)
    torch.testing.assert_close(k[..., 2], kps[..., 2])
    torch.testing.assert_close(c[..., :2], centers[..., :2] / 1.5)
    torch.testing.assert_close(c[..., 2], centers[..., 2])
    assert v is valid and e is emb
