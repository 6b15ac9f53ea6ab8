"""`scripts/torch_fragmentation_study.py` against `scripts/
fragmentation_study.py` on the CPU, on a 12-frame scene written in Shelf's
layout in which tracks die and respawn (tests/torch_study_scene.py, drop
probability 0.2).  The JAX script reads Shelf from a fixed path and keeps
its oracle cache in /tmp; the test hands it the scene through its loader
and a cache in the test's directory (monkeypatch).

The tracker's tracklets and deaths, and the oracle's events, equal.  The
oracle is one host program in both (tests/test_torch_oracle_parity_study.py
holds the port's copy equal to it), so it runs once: the JAX script's
`run_oracle` reads the port's cached run.
Every oracle event ends a tracklet where the tracker's do on this scene,
so no death is in excess; so the oracle's events reach the alignment
with every other one withheld, in both scripts alike, and the shared and
the excess paths both run: the alignment's counts equal, and for each
excess death its support at the 0.5 cut and whether the f64
oracle-shaped ALS keeps it alive equal, its margin to 0.5 beside JAX's.
JAX re-solves with its XLA ALS (Cholesky ridge solves), the port with
B1's plain version (Gauss-Jordan, as the TPU kernel): the two stop at
other iterations, so X on the solved elements differs (ROADMAP C, "The
association dump's X"); the margins are held within X_TOL, the bound of
the association dump's X (tests/test_torch_debug.py), and the gap is
printed (measured: 0.0007 for the one excess death; 0.0032 at most when
all four deaths are excess).
"""
import jax
import pytest
import torch

from multiview_motion_capture_tpu.cameras import CameraBank as JCameraBank
from multiview_motion_capture_tpu.data.ingest import load_openpose_dir as j_load
from tests import oracle_pipeline as j_oracle
from tests.torch_study_scene import DEATHS_DROP_PROB, N_FRAMES, json_of, one_thread, write_scene

import fragmentation_study as j_frag  # noqa: E402  (scripts/ on the path)
import torch_fragmentation_study as t_frag  # noqa: E402
from torch_oracle_cache import run_oracle_cached  # noqa: E402

# the JAX script sets the compilation cache at import; keep the suite's
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")

X_TOL = 0.1
SETTLED_CAP = 1000      # PipelineConfig's ALS cap


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_fragmentation_study_matches_jax(tmp_path, monkeypatch, capsys):
    root = write_scene(tmp_path / "scene", DEATHS_DROP_PROB)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    monkeypatch.setattr(j_oracle, "run_oracle", lambda kps, valid, cams, n, use_ik=True:
                        run_oracle_cached(kps, valid, cams, n, root, out_dir, use_ik))
    monkeypatch.setattr(j_frag, "N_FRAMES", N_FRAMES)
    monkeypatch.setattr(j_frag, "ORACLE_CACHE", out_dir / "jax_oracle_events.pkl")

    def load_shelf(cfg):
        batch = j_frag.filter_bad_poses(j_load(root / "kps_opn", cfg, max_frames=N_FRAMES), cfg)
        return batch, JCameraBank.from_json_dir(root / "calibs")

    monkeypatch.setattr(j_frag, "load_shelf", load_shelf)
    events = {}

    def withheld(name, real):
        def oracle_tracklets(*a, **k):
            events[name] = real(*a, **k)
            return events[name][::2]
        return oracle_tracklets

    monkeypatch.setattr(j_frag, "oracle_tracklets", withheld("jax", j_frag.oracle_tracklets))
    monkeypatch.setattr(t_frag, "oracle_tracklets", withheld("port", t_frag.oracle_tracklets))
    j_frag.main()
    j_out = json_of(capsys.readouterr().out)
    got = {}
    out = t_frag.main(["--data_dir", str(root), "--max_frames", str(N_FRAMES),
                       "--oracle_cache", str(out_dir), "--cpu"], outputs=got)
    capsys.readouterr()

    assert events["port"] == events["jax"] and len(events["jax"]) >= 4
    assert (got["outs"].als_iters < SETTLED_CAP).all()
    assert set(out) == set(j_out)
    assert {k: v for k, v in out.items() if k != "detail"} == \
        {k: v for k, v in j_out.items() if k != "detail"}
    assert out["tracker_deaths"] > out["excess_deaths"] >= 1
    assert len(out["detail"]) == len(j_out["detail"]) == out["excess_deaths"]
    gaps = []
    for a, b in zip(out["detail"], j_out["detail"]):
        for k in ("frame", "slot", "support_f32", "support_f64_oracle_shape",
                  "f64_keeps_alive"):
            assert a[k] == b[k], (k, a, b)
        gaps.append(abs(a["margin_to_05"] - b["margin_to_05"]))
    print("margins to 0.5, port / JAX:",
          [(a["margin_to_05"], b["margin_to_05"]) for a, b in zip(out["detail"],
                                                                 j_out["detail"])],
          "largest gap", max(gaps))
    assert max(gaps) <= X_TOL
