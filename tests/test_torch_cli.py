"""The port's CLI (`python -m multiview_motion_capture_torch`) against the JAX
package's (`multiview_motion_capture_tpu.__main__`), on the CPU (`--cpu`):
the flag -> config mapping, `prepare`, `run` on a small synthetic scene
written as calibration and OpenPose files (tracklets, BVH files, the debug
dump), `detect` on PNG frames read with cv2, and `bench` on a scene in the
Shelf dataset's layout."""
import dataclasses
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from multiview_motion_capture_tpu import __main__ as j_cli
from multiview_motion_capture_torch import __main__ as t_cli
from multiview_motion_capture_torch import pipeline as t_pipeline
from multiview_motion_capture_torch.config import SHELF_BENCH as T_SHELF_BENCH
from multiview_motion_capture_torch.config import PipelineConfig as TConfig
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence
from multiview_motion_capture_torch.ops.fk_generic import animate_bvh
from multiview_motion_capture_torch.utils.bvh import read_bvh

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the scene writer the card's CLI phase uses)
from tests.torch_study_scene import one_thread  # noqa: E402

POSE_TOL_M = 1e-3     # port vs JAX poses (tests/test_torch_default_preset.py)
X_TOL = 0.1           # the dump's X on solved elements (tests/test_torch_debug.py)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.mark.parametrize("preset,n_views,kw", [
    ("default", 5, {}), ("parity", 5, {}), ("fast", 5, dict(max_frames=64)),
    ("crowded", 10, dict(max_tracks=24)), ("wide", 64, {}), ("wide", 20, {}),
    ("default", 5, dict(cut_gate=0.05, min_track_len=3)),
])
def test_config_and_crossings_flags_match_jax(preset, n_views, kw):
    a = chip_smoke.cli_args(preset=preset, **kw)
    t, j = t_cli._config(a, n_views), j_cli._config(a, n_views)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    tc, jc = t_cli._crossings_cfg(a), j_cli._crossings_cfg(a)
    if "cut_gate" in kw:
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc) and tc.cut_gate == 0.05
    else:
        assert tc is None and jc is None


def test_unported_modes_and_flags_are_absent(capsys, tmp_path):
    """Every mode of the JAX package's CLI is in the port's parser, `bench`
    included, and the help names nothing as unported (`run --mesh`:
    `test_run_mesh_spec`).  `bench --cpu` runs on a tiny scene written in
    the Shelf dataset's layout and prints bench.py's line (the scene misses
    Shelf's quality bands, so the gate then fails, as bench.py's does); a
    missing `--data_dir` raises FileNotFoundError."""
    modes = {}
    for name, cli in (("jax", j_cli), ("torch", t_cli)):
        with pytest.raises(SystemExit):
            cli.main(["--help"])
        out = capsys.readouterr().out
        modes[name] = set(re.search(r"\{([a-z_,]+)\}", out).group(1).split(","))
    assert modes["jax"] == modes["torch"] == {"prepare", "run", "detect", "viz", "bench"}
    assert "not ported" not in out.lower() and "--mesh" not in out
    with pytest.raises(SystemExit):
        t_cli.main(["bench", "--help"])
    assert {"--data_dir", "--cpu"} <= set(re.findall(r"--[a-z_]+", capsys.readouterr().out))

    cfg = dataclasses.replace(T_SHELF_BENCH, max_frames=None)
    seq = synthetic_sequence(cfg=cfg, n_frames=4, n_people=2, n_views=5, seed=2)
    chip_smoke.write_scene_files(seq, tmp_path / "shelf", 4, kps_dir="kps_opn")
    with pytest.raises(SystemExit, match="bench quality gate FAILED"):
        t_cli.main(["bench", "--data_dir", str(tmp_path / "shelf"), "--cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    line = json.loads(lines[-1])
    assert (line["metric"], line["unit"]) == ("shelf_e2e_fps_5cam_ik", "frames/s")
    assert line["extra"]["n_frames"] == 4 and line["extra"]["backend"] == "cpu"
    assert line["extra"]["n_tracklets"] > 0 and line["extra"]["n_degenerate_poses"] == 0
    with pytest.raises(FileNotFoundError, match="missing_shelf"):
        t_cli.main(["bench", "--data_dir", str(tmp_path / "missing_shelf"), "--cpu"])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_scene")
    seq = synthetic_sequence(cfg=TConfig(n_views=4, max_people=4, max_tracks=6), n_frames=8,
                             n_people=2, n_views=4, seed=3, drop_prob=0.1)
    chip_smoke.write_scene_files(seq, root, 8)
    return root


def test_prepare_matches_jax(scene, tmp_path, capsys):
    common = ["--kps_dir", str(scene / "kps"), "--max_frames", "6", "--max_people", "3"]
    assert t_cli.main(["prepare", "--out", str(tmp_path / "t.npz"), *common]) == 0
    assert j_cli.main(["prepare", "--out", str(tmp_path / "j.npz"), *common]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1].replace("j.npz", "t.npz")
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])


def test_run_matches_jax(scene, tmp_path, capsys):
    """Tracklets: ids, frames and matches equal, poses within POSE_TOL_M;
    each BVH replays within POSE_TOL_M of JAX's; the debug dump's files,
    groups and solved x_bin equal, X within X_TOL on solved elements."""
    common = ["--kps_dir", str(scene / "kps"), "--calib_dir", str(scene / "calibs"), "--bvh",
              "--reid", "--crossings", "--cpu", "--max_frames", "8", "--max_people", "4",
              "--max_tracks", "6", "--debug_frames", "0,5"]
    assert t_cli.main(["run", "--out_dir", str(tmp_path / "t"),
                       "--debug_dump", str(tmp_path / "tdbg"), *common]) == 0
    assert j_cli.main(["run", "--out_dir", str(tmp_path / "j"),
                       "--debug_dump", str(tmp_path / "jdbg"), *common]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    tl, jl = json.loads(lines[0]), json.loads(lines[1])
    for k in ("n_frames", "n_tracklets", "top_lengths"):
        assert tl[k] == jl[k]
    t = t_pipeline.load_tracklets(tmp_path / "t" / "tracklets.pkl")
    j = t_pipeline.load_tracklets(tmp_path / "j" / "tracklets.pkl")
    assert [(x.track_id, x.frame_idxs) for x in t] == [(x.track_id, x.frame_idxs) for x in j]
    assert len(t) == 2
    for x, y in zip(t, j):
        np.testing.assert_array_equal(x.matched_pose, y.matched_pose)
        np.testing.assert_allclose(x.poses_3d, y.poses_3d, atol=POSE_TOL_M)
        bt = read_bvh(tmp_path / "t" / f"track_{x.track_id:03d}.bvh")
        bj = read_bvh(tmp_path / "j" / f"track_{y.track_id:03d}.bvh")
        assert bt.names == bj.names
        pt = animate_bvh(bt, device="cpu").numpy() / 100.0
        pj = animate_bvh(bj, device="cpu").numpy() / 100.0
        np.testing.assert_allclose(pt, pj, atol=POSE_TOL_M)
        assert np.linalg.norm(pt - x.poses_3d, axis=-1).mean() < 0.02   # tests/test_bvh.py
    names = sorted(p.name for p in (tmp_path / "tdbg").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jdbg").iterdir())
    assert "frame_00005.npz" in names
    for name in ("frame_00000.npz", "frame_00005.npz"):
        with np.load(tmp_path / "tdbg" / name) as a, np.load(tmp_path / "jdbg" / name) as b:
            for k in ("rep", "member", "group_size", "elem_valid"):
                np.testing.assert_array_equal(a[k], b[k])
            ev = a["elem_valid"]
            solved = ev[:, None] & ev[None, :]
            np.testing.assert_array_equal(a["x_bin"][solved], b["x_bin"][solved])
            assert np.abs(a["x"] - b["x"])[solved].max() <= X_TOL


def test_run_mesh_spec(scene, tmp_path, monkeypatch, capsys):
    """`run --mesh tracks=2 --cpu` hands the spec to `pipeline.run` (a
    2-way track mesh over the CPU), with the tracklets of the run without
    it; a bad spec raises JAX's CLI's error, from the spec's parse or the
    context's divisibility check."""
    specs = []
    run = t_pipeline.run

    def spy(*args, **kw):
        specs.append(kw.get("mesh_spec"))
        return run(*args, **kw)

    monkeypatch.setattr(t_pipeline, "run", spy)
    common = ["--kps_dir", str(scene / "kps"), "--calib_dir", str(scene / "calibs"), "--cpu",
              "--max_frames", "4", "--max_people", "4", "--max_tracks", "6"]
    assert t_cli.main(["run", "--out_dir", str(tmp_path / "m"), "--mesh", "tracks=2",
                       *common]) == 0
    assert t_cli.main(["run", "--out_dir", str(tmp_path / "p"), *common]) == 0
    assert specs == ["tracks=2", None]
    m = t_pipeline.load_tracklets(tmp_path / "m" / "tracklets.pkl")
    p = t_pipeline.load_tracklets(tmp_path / "p" / "tracklets.pkl")
    assert len(m) == len(p) > 0
    for x, y in zip(m, p):
        assert x.frame_idxs == y.frame_idxs
        np.testing.assert_array_equal(x.matched_pose, y.matched_pose)
        np.testing.assert_array_equal(x.poses_3d, y.poses_3d)
    for bad in ("tracks=two", "tracks=4", "gpus=2"):
        argv = ["run", "--out_dir", str(tmp_path / "bad"), "--mesh", bad, *common]
        with pytest.raises(ValueError) as te:
            t_cli.main(argv)
        with pytest.raises(ValueError) as je:
            j_cli.main(argv)
        assert str(te.value) == str(je.value), bad


def test_detect_on_png_frames(tmp_path, capsys):
    """`detect --cpu --appearance --crossings` on 2 rendered frames written
    as PNG: the images read back are the frames, and the tracklets equal
    the library path's (`frames_to_frame_batch` + `pipeline.run`) on them."""
    import cv2

    seq, _, frames, cams = chip_smoke.detect_scene(2)
    root = tmp_path / "scene"
    for v in range(frames.shape[1]):
        d = root / "images" / f"cam{v:02d}"
        d.mkdir(parents=True)
        for f in range(2):
            cv2.imwrite(str(d / f"{f:06d}.png"), frames[f, v][..., ::-1])
    (root / "calibs").mkdir()
    K, Rt, wh = (getattr(cams, a).numpy().astype(np.float64) for a in ("K", "Rt", "img_wh"))
    for v in range(len(K)):
        (root / "calibs" / f"cam{v:02d}.json").write_text(json.dumps(
            {"K": K[v].ravel().tolist(), "RT": Rt[v].ravel().tolist(),
             "imgSize": wh[v].tolist()}))
    images = t_cli.read_image_dir(root / "images", len(K))
    np.testing.assert_array_equal(images, frames.astype(np.float32) / 255.0)
    assert t_cli.main(["detect", "--image_dir", str(root / "images"), "--calib_dir",
                       str(root / "calibs"), "--out_dir", str(tmp_path / "out"), "--cpu",
                       "--appearance", "--crossings", "--max_people", "8"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = t_pipeline.load_tracklets(tmp_path / "out" / "tracklets.pkl")
    assert line["n_frames"] == 2 and line["n_tracklets"] == len(got) > 0

    from multiview_motion_capture_torch.cameras import CameraBank
    from multiview_motion_capture_torch.data.detect import (
        frames_to_frame_batch,
        make_bottom_up_detector,
    )
    from multiview_motion_capture_torch.models.checkpoint import (
        load_appearance_head,
        load_posenet,
    )

    cfg = t_cli._config(chip_smoke.cli_args(max_people=8), len(K))
    mcfg, net = load_posenet(t_cli.CHECKPOINTS / "posenet_synth.npz", device="cpu")
    _, head = load_appearance_head(t_cli.CHECKPOINTS / "appearance_head.npz", device="cpu")
    detect = make_bottom_up_detector(mcfg, max_people=8, center_nms_window=cfg.detect_nms_window,
                                     return_appearance=True, appearance_head=head)
    batch, app = frames_to_frame_batch(detect, net, images, cfg, collect_appearance=True)
    cfg = dataclasses.replace(cfg, appearance_dim=app.shape[-1], appearance_gain_px=60.0)
    ref = t_pipeline.run(batch, CameraBank.from_json_dir(root / "calibs"), cfg, app=app,
                         crossings=True, device="cpu")
    assert chip_smoke.tracklets_equal(got, ref.tracklets)
    with pytest.raises(SystemExit):     # the random-init detector has no offsets head
        t_cli.main(["detect", "--image_dir", str(root / "images"), "--calib_dir",
                    str(root / "calibs"), "--out_dir", str(tmp_path / "o2"), "--cpu",
                    "--params", "", "--smoke", "--appearance"])
