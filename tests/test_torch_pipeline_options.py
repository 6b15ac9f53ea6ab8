"""`pipeline.run`'s post-pass options and the pipeline / ingest helpers of
the port against the JAX package on the CPU.

- `run(reid=True)` (IK) and `run(crossings=True)` (appearance,
  triangulation mode) must equal the JAX package's runs: ids, frames and
  matched detections exactly; poses within POSE_TOL_M = 1e-3 m in IK mode
  (the LM's f32 rounding; the re-ID scene's poses differ by ~3e-5 m, as
  tests/test_torch_tracker.py allows) and TRI_TOL_M = 1e-5 m in
  triangulation mode; the tracklets' embeddings within 1e-5.
- `prepare` / `load_frame_batch` round trip (files of either package),
  `load_npy_keypoints` and `mpjpe_between` equal the JAX package's.
"""
import json

import numpy as np
import pytest

from multiview_motion_capture_torch import pipeline as t_pipeline
from multiview_motion_capture_torch import tracker as TT
from multiview_motion_capture_torch.config import PipelineConfig as TConfig
from multiview_motion_capture_torch.data import ingest as t_ingest
from multiview_motion_capture_torch.data.synthetic import synthetic_appearance as t_app
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_tpu import pipeline as j_pipeline
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.data import ingest as j_ingest
from multiview_motion_capture_tpu.data.synthetic import synthetic_appearance as j_app
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from tests.torch_study_scene import one_thread

POSE_TOL_M = 1e-3
TRI_TOL_M = 1e-5
CFG = dict(n_views=4, max_people=6, max_tracks=8, max_frames=None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _assert_decisions_equal(port, jax_, tol):
    """Ids, frames and matched detections exactly; poses within `tol`."""
    assert [(t.track_id, list(t.frame_idxs)) for t in port] == \
        [(t.track_id, list(t.frame_idxs)) for t in jax_]
    for x, y in zip(port, jax_):
        assert np.array_equal(x.matched_pose, np.asarray(y.matched_pose))
        np.testing.assert_allclose(x.poses_3d, np.asarray(y.poses_3d), atol=tol)


def test_pipeline_reid_matches_jax():
    """tests/test_components.py's re-ID scene: a one-frame hole at frame 7
    kills both tracks; `reid=True` re-joins each person's two fragments."""
    scene = dict(n_frames=14, n_people=2, n_views=4, drop_prob=0.0, seed=6,
                 min_person_distance=1.5)
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    js, ts = j_synth(cfg=jcfg, **scene), t_synth(cfg=tcfg, **scene)
    js.batch.valid[7] = False
    ts.batch.valid[7] = False
    j_res = j_pipeline.run(js.batch, js.cameras, jcfg, use_ik=True, reid=True)
    t_res = t_pipeline.run(ts.batch, ts.cameras, tcfg, use_ik=True, reid=True, device="cpu")
    _assert_decisions_equal(t_res.tracklets, j_res.tracklets, POSE_TOL_M)
    assert len(t_res.tracklets) == 2
    for t in t_res.tracklets:
        assert t.frame_idxs[0] < 7 < t.frame_idxs[-1]


def test_pipeline_crossings_matches_jax():
    """`crossings=True` (cuts, then the merge, then the ghost filter) on a
    small appearance scene: extractor-grade embeddings with the auto gain,
    three people, rescue off, min_track_length 2."""
    over = dict(CFG, max_people=4, max_tracks=6, als_max_iter=100, appearance_dim=8,
                appearance_auto_target_px=8.0, track_rescue_px=0.0, min_track_length=2)
    scene = dict(n_frames=12, n_people=3, n_views=4, seed=3, drop_prob=0.1)
    jcfg, tcfg = JConfig(**over), TConfig(**over)
    js, ts = j_synth(cfg=jcfg, **scene), t_synth(cfg=tcfg, **scene)
    embed = dict(dim=8, noise=0.05, shared_frac=0.83)
    ja, ta = j_app(js, **embed), t_app(ts, **embed)
    j_res = j_pipeline.run(js.batch, js.cameras, jcfg, use_ik=False, app=ja, crossings=True)
    t_res = t_pipeline.run(ts.batch, ts.cameras, tcfg, use_ik=False, app=ta, crossings=True,
                           device="cpu")
    _assert_decisions_equal(t_res.tracklets, j_res.tracklets, TRI_TOL_M)
    assert len(t_res.tracklets) > 0 and all(len(t) >= 2 for t in t_res.tracklets)
    for x, y in zip(t_res.tracklets, j_res.tracklets):
        np.testing.assert_allclose(x.app, np.asarray(y.app), atol=1e-5)


def _openpose_dir(root, n_views=2, n_frames=3, seed=0):
    rng = np.random.RandomState(seed)
    for v in range(n_views):
        d = root / f"cam{v}"
        d.mkdir(parents=True)
        for f in range(n_frames):
            people = [{"pose_keypoints_2d": (rng.rand(25, 3) * [640, 480, 1]).ravel().tolist()}
                      for _ in range(rng.randint(0, 4))]
            (d / f"{v}_{f:012d}_keypoints.json").write_text(json.dumps({"people": people}))


def test_prepare_round_trip_and_npy_ingest(tmp_path):
    _openpose_dir(tmp_path / "kps")
    tcfg, jcfg = TConfig(n_views=2, max_people=2), JConfig(n_views=2, max_people=2)
    batch = t_pipeline.prepare(tmp_path / "kps", tmp_path / "t.npz", tcfg)
    ref = j_pipeline.prepare(tmp_path / "kps", tmp_path / "j.npz", jcfg)
    back = t_ingest.load_frame_batch(tmp_path / "t.npz")
    for b in (back, t_ingest.load_frame_batch(tmp_path / "j.npz"),
              j_ingest.load_frame_batch(tmp_path / "t.npz")):
        assert np.array_equal(b.kps, batch.kps) and np.array_equal(b.valid, batch.valid)
    assert np.array_equal(batch.kps, ref.kps) and np.array_equal(batch.valid, ref.valid)
    assert batch.kps.shape == (3, 2, 2, 17, 3)

    rng = np.random.RandomState(3)
    paths = []
    for v in range(2):
        a = rng.rand(4, 3, 17, 3).astype(np.float32)
        a[1, 2, :, 2] = 0.0                    # one slot with no scored keypoint
        paths.append(tmp_path / f"cam{v}.npy")
        np.save(paths[-1], a)
    cfg5 = dict(n_views=2, max_people=5)
    b = t_ingest.load_npy_keypoints(paths, TConfig(**cfg5), max_frames=3)
    r = j_ingest.load_npy_keypoints(paths, JConfig(**cfg5), max_frames=3)
    assert b.kps.shape == (3, 2, 5, 17, 3)
    assert np.array_equal(b.kps, r.kps) and np.array_equal(b.valid, r.valid)
    assert not b.valid[1, :, 2].any() and b.valid[0, :, :3].all()


def test_mpjpe_between_matches_jax():
    rng = np.random.RandomState(1)

    def tracklet(frames):
        L = len(frames)
        return TT.Tracklet(track_id=0, frame_idxs=list(frames), roots=np.zeros((L, 3)),
                           eulers=np.zeros((L, 18, 3)), side_lens=np.zeros((L, 11)),
                           poses_3d=rng.rand(L, 18, 3), poses_score=np.ones((L, 18)),
                           matched_pose=np.zeros((L, 2), np.int32))

    a, b = tracklet(range(0, 10)), tracklet(range(5, 15))
    idx = np.arange(3, 9)
    for joint_idx in (None, idx):
        assert t_pipeline.mpjpe_between(a, b, joint_idx) == \
            j_pipeline.mpjpe_between(a, b, joint_idx)
    assert np.isnan(t_pipeline.mpjpe_between(a, tracklet(range(20, 22))))
