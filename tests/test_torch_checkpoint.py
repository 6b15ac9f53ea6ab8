"""The port's chunked checkpoint/resume against the JAX package on the CPU.

- `run(checkpoint_dir=, checkpoint_every=4)` must give the plain run's
  tracklets bit for bit, with and without IK, and again after a resume
  from an earlier chunk (the crash `tests/test_components.py` simulates by
  rewriting `meta.json`).
- The file format is the JAX package's: chunks the JAX package wrote load
  in the port (`load_state(device="cpu")`) and resume to the JAX package's
  uninterrupted decisions; chunks the port wrote load in the JAX package.
- Across packages (triangulation mode): ids, frames and matched
  detections exactly, poses within TRI_TOL_M = 1e-5 m (the triangulation's
  f32 rounding, as in tests/test_torch_tracker.py).

Scene: tests/test_components.py's (4 views, 9 frames, 2 people, seed 4,
the default preset at 6 detection slots and 8 track slots).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from multiview_motion_capture_torch import pipeline as t_pipeline
from multiview_motion_capture_torch import tracker as TT
from multiview_motion_capture_torch.config import PipelineConfig as TConfig
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_torch.utils import checkpoint as t_ckpt
from multiview_motion_capture_tpu import pipeline as j_pipeline
from multiview_motion_capture_tpu import tracker as JT
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from multiview_motion_capture_tpu.utils import checkpoint as j_ckpt
from tests.torch_study_scene import one_thread

TRI_TOL_M = 1e-5
CFG = dict(n_views=4, max_people=6, max_tracks=8, max_frames=None)
SCENE = dict(n_frames=9, n_people=2, n_views=4, drop_prob=0.0, seed=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.track_id == y.track_id and list(x.frame_idxs) == list(y.frame_idxs)
        for f in ("roots", "eulers", "side_lens", "poses_3d", "poses_score", "matched_pose",
                  "app"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None and v is None) or np.array_equal(u, v, equal_nan=True), f


def _assert_decisions_equal(port, jax_):
    """Ids, frames and matched detections exactly; poses within TRI_TOL_M."""
    assert [(t.track_id, list(t.frame_idxs)) for t in port] == \
        [(t.track_id, list(t.frame_idxs)) for t in jax_]
    for x, y in zip(port, jax_):
        assert np.array_equal(x.matched_pose, np.asarray(y.matched_pose))
        np.testing.assert_allclose(x.poses_3d, np.asarray(y.poses_3d), atol=TRI_TOL_M)


def _rewind(ck, chunk, end_frame):
    (ck / "meta.json").write_text(json.dumps({"last_chunk": chunk, "end_frame": end_frame}))


@pytest.mark.parametrize("use_ik", [True, False], ids=["ik", "triangulation"])
def test_checkpointed_run_is_bit_equal_to_plain(tmp_path, use_ik):
    cfg = TConfig(**CFG)
    seq = t_synth(cfg=cfg, **SCENE)
    plain = t_pipeline.run(seq.batch, seq.cameras, cfg, use_ik=use_ik, device="cpu")
    ck = tmp_path / "ck"
    res = t_pipeline.run(seq.batch, seq.cameras, cfg, use_ik=use_ik, checkpoint_dir=ck,
                         checkpoint_every=4, device="cpu")
    assert len(plain.tracklets) == 2
    _assert_bit_equal(res.tracklets, plain.tracklets)
    assert sorted(p.name for p in ck.iterdir()) == [
        "chunk_00000.npz", "chunk_00001.npz", "chunk_00002.npz", "meta.json"]
    assert t_ckpt.resume_info(ck) == {"last_chunk": 2, "end_frame": 9}
    # a crash after chunk 0: the resumed run tracks chunks 1 and 2 again
    _rewind(ck, 0, 4)
    resumed = t_pipeline.run(seq.batch, seq.cameras, cfg, use_ik=use_ik, checkpoint_dir=ck,
                             checkpoint_every=4, device="cpu")
    _assert_bit_equal(resumed.tracklets, plain.tracklets)
    assert t_ckpt.resume_info(ck)["last_chunk"] == 2
    assert resumed.mean_concurrent_tracks == plain.mean_concurrent_tracks


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's plain run of the scene (triangulation mode) and the
    directory its checkpointed run wrote."""
    jcfg = JConfig(**CFG)
    js = j_synth(cfg=jcfg, **SCENE)
    ck = tmp_path_factory.mktemp("jax_ck")
    plain = j_pipeline.run(js.batch, js.cameras, jcfg, use_ik=False)
    j_pipeline.run(js.batch, js.cameras, jcfg, use_ik=False, checkpoint_dir=ck,
                   checkpoint_every=4)
    return plain.tracklets, ck


def test_jax_chunks_resume_in_the_port(jax_runs, tmp_path):
    j_plain, j_ck = jax_runs
    ck = tmp_path / "ck"
    ck.mkdir()
    for p in j_ck.iterdir():
        (ck / p.name).write_bytes(p.read_bytes())
    for c in range(3):
        state = t_ckpt.load_state(ck, c, device="cpu")
        ref = j_ckpt.load_state(ck, c)
        assert isinstance(state, TT.TrackerState) and state.active.device.type == "cpu"
        for f in dataclasses.fields(TT.TrackerState):
            assert np.array_equal(getattr(state, f.name).numpy(),
                                  np.asarray(getattr(ref, f.name))), f.name
    j_outs = j_ckpt.concat_outputs(j_ckpt.load_outputs(ck, 2))
    t_outs = t_ckpt.concat_outputs(t_ckpt.load_outputs(ck, 2))
    for f in TT.FrameOutput._fields:
        assert np.array_equal(getattr(t_outs, f), getattr(j_outs, f)), f
    # resume after the JAX package's chunk 0: the port tracks frames 4-8
    _rewind(ck, 0, 4)
    cfg = TConfig(**CFG)
    seq = t_synth(cfg=cfg, **SCENE)
    res = t_pipeline.run(seq.batch, seq.cameras, cfg, use_ik=False, checkpoint_dir=ck,
                         checkpoint_every=4, device="cpu")
    _assert_decisions_equal(res.tracklets, j_plain)


def test_port_chunks_load_in_jax(jax_runs, tmp_path):
    j_plain, _ = jax_runs
    cfg = TConfig(**CFG)
    seq = t_synth(cfg=cfg, **SCENE)
    ck = tmp_path / "ck"
    res = t_pipeline.run(seq.batch, seq.cameras, cfg, use_ik=False, checkpoint_dir=ck,
                         checkpoint_every=4, device="cpu")
    _assert_decisions_equal(res.tracklets, j_plain)
    state = j_ckpt.load_state(ck, 2)
    ref = t_ckpt.load_state(ck, 2, device="cpu")
    for f in dataclasses.fields(JT.TrackerState):
        a = np.asarray(getattr(state, f.name))
        b = getattr(ref, f.name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    j_outs = j_ckpt.concat_outputs(j_ckpt.load_outputs(ck, 2))
    tl = JT.assemble_tracklets(j_outs)
    _assert_decisions_equal(res.tracklets, tl)


def test_load_outputs_requires_every_field(tmp_path):
    cfg = TConfig(**CFG)
    state = TT.TrackerState.zeros(cfg)
    T, V = cfg.max_tracks, cfg.n_views
    out = TT.FrameOutput(
        track_id=np.full((1, T), -1, np.int32), active=np.zeros((1, T), np.int32),
        updated=np.zeros((1, T), bool), spawned=np.zeros((1, T), bool),
        died_track_id=np.full((1, T), -1, np.int32), root=np.zeros((1, T, 3), np.float32),
        euler=np.zeros((1, T, 18, 3), np.float32), side_lens=np.zeros((1, T, 11), np.float32),
        pose3d=np.zeros((1, T, 18, 3), np.float32), pose3d_score=np.zeros((1, T, 18), np.float32),
        matched_pose=np.full((1, T, V), -1, np.int32), app_obs=np.zeros((1, T, 0), np.float32),
        als_iters=np.zeros((1,), np.int32))
    t_ckpt.save_chunk(tmp_path, 0, 1, state, out)
    assert len(t_ckpt.load_outputs(tmp_path, 0)) == 1
    # a chunk without `out_app_obs` (written before that field existed)
    with np.load(tmp_path / "chunk_00000.npz") as z:
        arrays = {k: z[k] for k in z.files if k != "out_app_obs"}
    np.savez_compressed(tmp_path / "chunk_00000.npz", **arrays)
    with pytest.raises(KeyError, match="out_app_obs"):
        t_ckpt.load_outputs(tmp_path, 0)
    with pytest.raises(KeyError, match="out_app_obs"):
        j_ckpt.load_outputs(tmp_path, 0)


def test_checkpoint_path_runs_on_the_card_by_default(tmp_path, monkeypatch):
    cfg = TConfig(**CFG)
    t_ckpt.save_chunk(tmp_path, 0, 1, TT.TrackerState.zeros(cfg),
                      TT.FrameOutput(*[np.zeros(1)] * len(TT.FrameOutput._fields)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        t_ckpt.load_state(tmp_path, 0)
    seq = t_synth(cfg=cfg, **dict(SCENE, n_frames=2))
    with pytest.raises(RuntimeError, match="device='cuda'"):
        t_pipeline.run(seq.batch, seq.cameras, cfg, checkpoint_dir=tmp_path / "ck")
    assert not (tmp_path / "ck").exists()
