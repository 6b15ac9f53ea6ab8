"""`scripts/torch_fragmentation_study.py` against `scripts/
fragmentation_study.py` on the CPU, on a 12-frame scene written in Shelf's
layout in which tracks die and respawn (tests/torch_study_scene.py, drop
probability 0.2).  The JAX script reads Shelf from a fixed path and keeps
its oracle cache in /tmp; the test hands it the scene through its loader
and a cache in the test's directory (monkeypatch).

The tracker's tracklets and deaths, and the oracle's events, equal.  The
oracle is one host program in both (tests/test_torch_oracle_copy.py holds
the port's copy equal to it), so it runs once for this file and
tests/test_torch_oracle_parity_study.py together: both read the scene
written once for the test run (`torch_study_scene.shared_deaths_scene`)
and the port's copy's run on it, cached beside it (`shared_oracle`), which
the JAX script's `run_oracle` and the port's study both read.
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
import contextlib
import io

import jax
import pytest

from multiview_motion_capture_tpu.cameras import CameraBank as JCameraBank
from multiview_motion_capture_tpu.data.ingest import load_openpose_dir as j_load
from tests import oracle_pipeline as j_oracle
from tests.torch_study_scene import N_FRAMES, json_of, one_thread, shared_deaths_scene
from tests.torch_study_scene import shared_oracle

import fragmentation_study as j_frag  # noqa: E402  (scripts/ on the path)
import torch_fragmentation_study as t_frag  # noqa: E402

# the JAX script sets the compilation cache at import; keep the suite's
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_cache")

X_TOL = 0.1
SETTLED_CAP = 1000      # PipelineConfig's ALS cap


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def frag(tmp_path_factory):
    """Both scripts' JSON on the scene, with the oracle events each aligned
    (every other one withheld) and the port's outputs."""
    root = shared_deaths_scene(tmp_path_factory)
    out_dir = tmp_path_factory.mktemp("fragmentation")

    def load_shelf(cfg):
        batch = j_frag.filter_bad_poses(j_load(root / "kps_opn", cfg, max_frames=N_FRAMES), cfg)
        return batch, JCameraBank.from_json_dir(root / "calibs")

    events = {}

    def withheld(name, real):
        def oracle_tracklets(*a, **k):
            events[name] = real(*a, **k)
            return events[name][::2]
        return oracle_tracklets

    got, printed = {}, io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_oracle, "run_oracle", lambda kps, valid, cams, n, use_ik=True:
                   shared_oracle(kps, valid, cams, n, root, use_ik))
        mp.setattr(j_frag, "N_FRAMES", N_FRAMES)
        mp.setattr(j_frag, "ORACLE_CACHE", out_dir / "jax_oracle_events.pkl")
        mp.setattr(j_frag, "load_shelf", load_shelf)
        mp.setattr(j_frag, "oracle_tracklets", withheld("jax", j_frag.oracle_tracklets))
        mp.setattr(t_frag, "oracle_tracklets", withheld("port", t_frag.oracle_tracklets))
        with contextlib.redirect_stdout(printed):
            j_frag.main()
        j_out = json_of(printed.getvalue())
        with contextlib.redirect_stdout(io.StringIO()):
            out = t_frag.main(["--data_dir", str(root), "--max_frames", str(N_FRAMES),
                               "--oracle_cache", str(root / "oracle_cache"), "--cpu"],
                              outputs=got)
    return dict(events=events, got=got, out=out, j_out=j_out)


def test_oracle_events_equal_and_frames_settle(frag):
    assert frag["events"]["port"] == frag["events"]["jax"] and len(frag["events"]["jax"]) >= 4
    assert (frag["got"]["outs"].als_iters < SETTLED_CAP).all()


def test_fragmentation_study_matches_jax(frag):
    out, j_out = frag["out"], frag["j_out"]
    assert set(out) == set(j_out)
    assert {k: v for k, v in out.items() if k != "detail"} == \
        {k: v for k, v in j_out.items() if k != "detail"}
    assert out["tracker_deaths"] > out["excess_deaths"] >= 1
    assert len(out["detail"]) == len(j_out["detail"]) == out["excess_deaths"]


def test_excess_deaths_match_jax(frag):
    out, j_out = frag["out"], frag["j_out"]
    gaps = []
    for a, b in zip(out["detail"], j_out["detail"]):
        for k in ("frame", "slot", "support_f32", "support_f64_oracle_shape",
                  "f64_keeps_alive"):
            assert a[k] == b[k], (k, a, b)
        gaps.append(abs(a["margin_to_05"] - b["margin_to_05"]))
    assert gaps
    print("margins to 0.5, port / JAX:",
          [(a["margin_to_05"], b["margin_to_05"]) for a, b in zip(out["detail"],
                                                                 j_out["detail"])],
          "largest gap", max(gaps))
    assert max(gaps) <= X_TOL
