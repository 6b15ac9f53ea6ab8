"""The port's cameras, data, geometry and triangulation against the JAX
package, on the CPU, from the same numpy inputs.

Tolerances: the host-side float64 code (fundamental matrices, the synthetic
generator, the detection filter) is the same numpy in both packages and
must agree bit for bit; the f32 tensor code sums in other orders than XLA,
so it agrees to a few units in the last place of its outputs' scale (pixel
distances of ~1e2-1e3 px to ~1e-4 px, metres to ~1e-5 m).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch import cameras as TC
from multiview_motion_capture_torch.config import SHELF_BENCH as T_CFG
from multiview_motion_capture_torch.data import ingest as TI
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_torch.ops import geometry as TG
from multiview_motion_capture_torch.ops.triangulate import triangulate_points as t_tri
from multiview_motion_capture_tpu import cameras as JC
from multiview_motion_capture_tpu.config import SHELF_BENCH as J_CFG
from multiview_motion_capture_tpu.data import ingest as JI
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from multiview_motion_capture_tpu.ops import geometry as JG
from multiview_motion_capture_tpu.ops.triangulate import triangulate_points as j_tri
from tests.torch_study_scene import one_thread

PX_TOL = 1e-3     # px, on distances of up to ~1e3 px
M_TOL = 1e-4      # m


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_frames=6, n_people=3, n_views=4, seed=1)
    jc = dataclasses.replace(J_CFG, n_views=4)
    tc = dataclasses.replace(T_CFG, n_views=4)
    return j_synth(cfg=jc, **kw), t_synth(cfg=tc, **kw), jc, tc


def t(a):
    return torch.as_tensor(np.array(a))


def test_synthetic_sequence_is_bit_identical(scenes):
    js, ts, _, _ = scenes
    np.testing.assert_array_equal(js.batch.kps, ts.batch.kps)
    np.testing.assert_array_equal(js.batch.valid, ts.batch.valid)
    np.testing.assert_array_equal(js.gt_3d, ts.gt_3d)
    np.testing.assert_array_equal(js.gt_slot_person, ts.gt_slot_person)
    for f in ("K", "Rt", "P", "Kr_inv", "cam_loc", "img_wh"):
        np.testing.assert_array_equal(np.asarray(getattr(js.cameras, f)),
                                      getattr(ts.cameras, f).numpy())


def test_filter_bad_poses_matches(scenes):
    js, ts, jc, tc = scenes
    np.testing.assert_array_equal(JI.filter_bad_poses(js.batch, jc).valid,
                                  TI.filter_bad_poses(ts.batch, tc).valid)


def test_fundamental_matrices_bit_identical(scenes):
    js, _, _, _ = scenes
    K = np.asarray(js.cameras.K, dtype=np.float64)
    Rt = np.asarray(js.cameras.Rt, dtype=np.float64)
    P = np.asarray(js.cameras.P, dtype=np.float64)
    np.testing.assert_array_equal(TC.pairwise_fundamental_np(K, Rt),
                                  JC.pairwise_fundamental_np(K, Rt))
    np.testing.assert_array_equal(TC.pairwise_fundamental_det_np(P),
                                  JC.pairwise_fundamental_det_np(P))


def test_camera_bank_from_json_dir(tmp_path):
    rng = np.random.RandomState(0)
    for v in range(3):
        K = np.array([[1000 + v, 0, 500], [0, 1000, 400], [0, 0, 1.0]])
        Rt = np.concatenate([np.eye(3), rng.randn(3, 1)], axis=1)
        (tmp_path / f"cam{v}.json").write_text(json.dumps(
            {"K": K.reshape(-1).tolist(), "RT": Rt.reshape(-1).tolist(),
             "imgSize": [1000, 800]}))
    jb = JC.CameraBank.from_json_dir(tmp_path)
    tb = TC.CameraBank.from_json_dir(tmp_path)
    assert tb.n_views == 3
    for f in ("K", "Rt", "P", "Kr_inv", "cam_loc", "img_wh"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)), getattr(tb, f).numpy())


def test_load_openpose_dir(tmp_path):
    rng = np.random.RandomState(0)
    cfg_j = dataclasses.replace(J_CFG, n_views=2)
    cfg_t = dataclasses.replace(T_CFG, n_views=2)
    for cam in ("c0", "c1"):
        d = tmp_path / cam
        d.mkdir()
        for f in range(3):
            people = [{"pose_keypoints_2d": rng.rand(75).astype(np.float32).tolist()}
                      for _ in range(f)]
            (d / f"0_{f:012d}_keypoints.json").write_text(json.dumps({"people": people}))
    jb = JI.load_openpose_dir(tmp_path, cfg_j)
    tb = TI.load_openpose_dir(tmp_path, cfg_t)
    np.testing.assert_array_equal(jb.kps, tb.kps)
    np.testing.assert_array_equal(jb.valid, tb.valid)


def test_synthetic_camera_ring_matches():
    jb, tb = JC.synthetic_camera_ring(6), TC.synthetic_camera_ring(6)
    np.testing.assert_array_equal(np.asarray(jb.P), tb.P.numpy())


def test_projected_distance_all_pairs(scenes):
    js, ts, _, _ = scenes
    F = np.asarray(JC.pairwise_fundamental_np(np.asarray(js.cameras.K, np.float64),
                                              np.asarray(js.cameras.Rt, np.float64)),
                   dtype=np.float32)
    kps = js.batch.kps[2]
    d_j = np.asarray(JG.projected_distance_all_pairs(jnp.asarray(kps), jnp.asarray(F)))
    d_t = TG.projected_distance_all_pairs(t(kps), t(F)).numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=PX_TOL)


def test_masked_symmetric_epipolar_error(scenes):
    js, _, jc, _ = scenes
    F = np.asarray(JC.pairwise_fundamental_det_np(np.asarray(js.cameras.P, np.float64)),
                   dtype=np.float32)
    kps = js.batch.kps[3]                               # (V, P, K, 3)
    ka, kb, Fab = kps[:, :, None, None], kps[None, None], F[:, None, :, None]
    e_j = np.asarray(JG.masked_symmetric_epipolar_error(
        jnp.asarray(ka), jnp.asarray(kb), jnp.asarray(Fab), jc.epipolar_min_kps_score))
    e_t = TG.masked_symmetric_epipolar_error(
        t(ka), t(kb), t(Fab), jc.epipolar_min_kps_score).numpy()
    np.testing.assert_array_equal(np.isnan(e_j), np.isnan(e_t))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=PX_TOL)


def test_project_and_reprojection_error(scenes):
    js, _, jc, _ = scenes
    P = np.asarray(js.cameras.P)
    pts = js.gt_3d[1].astype(np.float32)                # (people, 17, 3)
    kps = js.batch.kps[1]                               # (V, P, 17, 3)
    uv_j = np.asarray(JG.project_points(jnp.asarray(P)[:, None], jnp.asarray(pts)[None]))
    uv_t = TG.project_points(t(P)[:, None], t(pts)[None]).numpy()
    np.testing.assert_allclose(uv_t, uv_j, rtol=1e-6, atol=PX_TOL)
    sc = np.ones(pts.shape[:2], np.float32)
    args = (pts[:, None, None], sc[:, None, None], kps[None], P[None, :, None])
    r_j = np.asarray(JG.masked_reprojection_error(*map(jnp.asarray, args),
                                                  jc.reproj_min_kps_score))
    r_t = TG.masked_reprojection_error(*map(t, args), jc.reproj_min_kps_score).numpy()
    np.testing.assert_array_equal(np.isnan(r_j), np.isnan(r_t))
    np.testing.assert_allclose(r_t, r_j, rtol=1e-5, atol=PX_TOL)


def test_triangulate_points(scenes):
    js, _, jc, _ = scenes
    P = np.asarray(js.cameras.P)
    K_inv = np.linalg.inv(np.asarray(js.cameras.K, np.float64)).astype(np.float32)
    f = 4
    # each ground-truth person's detections, one group per person
    groups = np.zeros((3, 4, 17, 3), np.float32)
    mask = np.zeros((3, 4), bool)
    for v in range(4):
        for p in range(js.gt_slot_person.shape[2]):
            pid = js.gt_slot_person[f, v, p]
            if pid >= 0 and js.batch.valid[f, v, p]:
                groups[pid, v] = js.batch.kps[f, v, p]
                mask[pid, v] = True
    tri_j = np.asarray(jax.vmap(j_tri, in_axes=(None, None, 0, 0, None, None))(
        jnp.asarray(P), jnp.asarray(K_inv), jnp.asarray(groups), jnp.asarray(mask),
        jc.triangulate_min_score, jc.triangulate_refine_iters))
    tri_t = t_tri(t(P), t(K_inv), t(groups), t(mask), jc.triangulate_min_score,
                  jc.triangulate_refine_iters).numpy()
    assert tri_t.shape == (3, 17, 4)
    np.testing.assert_allclose(tri_t[..., :3], tri_j[..., :3], atol=M_TOL)
    np.testing.assert_allclose(tri_t[..., 3], tri_j[..., 3], atol=1e-6)
    # and it lands on the ground truth within the detection noise
    err = np.linalg.norm(tri_t[..., :3] - js.gt_3d[f], axis=-1)
    assert np.median(err) < 0.02
