"""The port's forward kinematics, analytic LM jacobian, geometric cold init
and batched two-stage LM (`solver="gj"`, and the per-slot Cholesky route
`solver="chol"` of the JAX package's default preset) against the JAX
package, on the CPU, from the same numpy inputs.

Tolerances: FK and the jacobian are a few f32 products deep (1e-5 m,
1e-3 relative on jacobian entries of up to ~1e3 px/rad); the LM result goes
through tens of accept/reject steps on normal equations solved in another
order of rounding (the port's Cholesky factors in f64, JAX's in f32), and
agrees to 1e-3 m on well-observed slots.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.config import SHELF_BENCH as T_CFG
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_torch.ops import fk as TF
from multiview_motion_capture_torch.ops import ik as TK
from multiview_motion_capture_torch.ops.triangulate import triangulate_points as t_tri
from multiview_motion_capture_tpu.config import SHELF_BENCH as J_CFG
from multiview_motion_capture_tpu.ops import fk as JF
from multiview_motion_capture_tpu.ops import ik as JK
from tests.torch_study_scene import one_thread

EPS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def problem():
    """Ground-truth-grouped observations of 3 people in 4 views, plus one
    empty slot, and a geometric cold init from their triangulation."""
    cfg = dataclasses.replace(T_CFG, n_views=4)
    s = t_synth(n_frames=4, n_people=3, n_views=4, cfg=cfg, seed=2)
    f = 3
    obs = np.zeros((4, 4, 17, 3), np.float32)
    w = np.zeros((4, 4), np.float32)
    for v in range(4):
        for p in range(s.gt_slot_person.shape[2]):
            pid = s.gt_slot_person[f, v, p]
            if pid >= 0 and s.batch.valid[f, v, p]:
                obs[pid, v] = s.batch.kps[f, v, p]
                w[pid, v] = 1.0
    P = s.cameras.P.numpy()
    K_inv = np.linalg.inv(s.cameras.K.numpy().astype(np.float64)).astype(np.float32)
    skel = TF.Skeleton.default()
    obs18 = TK.add_mid_spine(t(obs))
    tri = t_tri(t(P), t(K_inv), obs18, t(w) > 0, cfg.triangulate_min_score,
                cfg.triangulate_refine_iters)
    tri = torch.nan_to_num(tri).clamp(-100.0, 100.0)
    root = 0.5 * (tri[:, TK._LHIP, :3] + tri[:, TK._RHIP, :3])   # hip midpoint
    return dict(obs=obs, w=w, P=P, tri=tri.numpy(), root=root.numpy(), skel=skel)


def test_add_mid_spine(problem):
    a = TK.add_mid_spine(t(problem["obs"])).numpy()
    b = np.asarray(JK.add_mid_spine(jnp.asarray(problem["obs"])))
    np.testing.assert_array_equal(a, b)


def test_forward_kinematics_matches():
    rng = np.random.RandomState(0)
    root = rng.randn(5, 3).astype(np.float32)
    euler = (0.4 * rng.randn(5, 18, 3)).astype(np.float32)
    side = (TF.REF_SIDE_BONE_LENS * (1 + 0.1 * rng.randn(5, 11))).astype(np.float32)
    a = TF.forward_kinematics(TF.Skeleton.default(), t(root), t(euler), t(side)).numpy()
    b = np.asarray(JF.forward_kinematics(JF.Skeleton.default(), jnp.asarray(root),
                                         jnp.asarray(euler), jnp.asarray(side)))
    np.testing.assert_allclose(a, b, atol=1e-5)
    for name in ("ANC_MASK", "ANC_SELF_MASK", "SIDE_ONE_HOT"):
        np.testing.assert_array_equal(np.asarray(getattr(TF, name)),
                                      np.asarray(getattr(JF, name)))
    np.testing.assert_array_equal(TF.Skeleton.default().bone_dirs.numpy(),
                                  np.asarray(JF.Skeleton.default().bone_dirs))


def test_geometric_init_matches(problem):
    a = TK.geometric_init(t(problem["tri"]), problem["skel"]).numpy()
    b = np.asarray(jax.vmap(JK.geometric_init, in_axes=(0, None))(
        jnp.asarray(problem["tri"]), JF.Skeleton.default()))
    # angles: atan2 near +-pi wraps; compare the rotations they make
    Ra = TF.euler_to_matrix(t(a)).numpy()
    Rb = np.asarray(JF.euler_to_matrix(jnp.asarray(b)))
    np.testing.assert_allclose(Ra, Rb, atol=1e-4)


def test_residual_and_jacobian_match(problem):
    rng = np.random.RandomState(1)
    obs18 = TK.add_mid_spine(t(problem["obs"])).numpy()
    x = np.concatenate([problem["root"], (0.2 * rng.randn(4, 54)).astype(np.float32),
                        np.tile(TF.REF_SIDE_BONE_LENS, (4, 1)).astype(np.float32)], axis=1)
    r_t, J_t = TK._residual_and_jacobian(t(x), problem["skel"], t(obs18), t(problem["w"]),
                                         t(problem["P"]), EPS)
    jf = jax.vmap(JK._residual_and_jacobian, in_axes=(0, None, 0, 0, None, None))
    r_j, J_j = jf(jnp.asarray(x), JF.Skeleton.default(), jnp.asarray(obs18),
                  jnp.asarray(problem["w"]), jnp.asarray(problem["P"]), EPS)
    r_j, J_j = np.asarray(r_j), np.asarray(J_j)
    assert J_t.shape == (4, 4 * 16 * 2, TK.N_PARAMS)
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=1e-4, atol=1e-2)
    scale = np.abs(J_j).max()
    np.testing.assert_allclose(J_t.numpy(), J_j, atol=1e-4 * scale)
    r_only = TK._residual(t(x), problem["skel"], t(obs18), t(problem["w"]),
                          t(problem["P"]), EPS)
    np.testing.assert_allclose(r_only.numpy(), r_t.numpy(), rtol=1e-5, atol=1e-3)


def test_solve_two_stage_gj_matches(problem):
    euler0 = TK.geometric_init(t(problem["tri"]), problem["skel"]).numpy()
    side0 = np.tile(TF.REF_SIDE_BONE_LENS, (4, 1)).astype(np.float32)
    kw = dict(n_iters=12, eps=J_CFG.ik_proj_eps, lam0=J_CFG.ik_lm_damping_init,
              lam_up=J_CFG.ik_lm_damping_up, lam_down=J_CFG.ik_lm_damping_down,
              stages=2, ftol=J_CFG.ik_ftol, xtol=J_CFG.ik_xtol)
    tp, tj = TK.solve_two_stage(TK.IkParams(t(problem["root"]), t(euler0), t(side0)),
                                problem["skel"], t(problem["obs"]), t(problem["w"]),
                                t(problem["P"]), solver="gj", **kw)
    jp, jj = JK.solve_two_stage(
        JK.IkParams(jnp.asarray(problem["root"]), jnp.asarray(euler0), jnp.asarray(side0)),
        JF.Skeleton.default(), jnp.asarray(problem["obs"]), jnp.asarray(problem["w"]),
        jnp.asarray(problem["P"]), solver="gj", interpret=True, **kw)
    tj, jj = tj.numpy(), np.asarray(jj)
    np.testing.assert_allclose(tj[:3], jj[:3], atol=1e-3)
    np.testing.assert_allclose(tp.side_lens.numpy()[:3], np.asarray(jp.side_lens)[:3],
                               atol=1e-3)
    # the empty slot starts frozen: its parameters come back untouched
    np.testing.assert_array_equal(tp.root.numpy()[3], problem["root"][3])
    np.testing.assert_array_equal(tp.euler.numpy()[3], euler0[3])


@pytest.mark.parametrize("stages", [1, 2])
def test_solve_two_stage_chol_matches(problem, stages):
    """The default preset's LM: JAX vmaps a per-slot `while_loop` with an
    f32 Cholesky (ik.py:280-357, 520-532); the port runs the masked batched
    loop with the factor in f64 and the step rounded once to f32.  Staged
    (pose, then pose + side lengths) and single, joints within 1e-3 m; the
    empty slot starts frozen and comes back untouched."""
    euler0 = TK.geometric_init(t(problem["tri"]), problem["skel"]).numpy()
    side0 = np.tile(TF.REF_SIDE_BONE_LENS, (4, 1)).astype(np.float32)
    kw = dict(n_iters=12, eps=J_CFG.ik_proj_eps, lam0=J_CFG.ik_lm_damping_init,
              lam_up=J_CFG.ik_lm_damping_up, lam_down=J_CFG.ik_lm_damping_down,
              stages=stages, ftol=J_CFG.ik_ftol, xtol=J_CFG.ik_xtol, solver="chol")
    tp, tj = TK.solve_two_stage(TK.IkParams(t(problem["root"]), t(euler0), t(side0)),
                                problem["skel"], t(problem["obs"]), t(problem["w"]),
                                t(problem["P"]), **kw)
    jp, jj = JK.solve_two_stage(
        JK.IkParams(jnp.asarray(problem["root"]), jnp.asarray(euler0), jnp.asarray(side0)),
        JF.Skeleton.default(), jnp.asarray(problem["obs"]), jnp.asarray(problem["w"]),
        jnp.asarray(problem["P"]), **kw)
    tj, jj = tj.numpy(), np.asarray(jj)
    assert tj.dtype == np.float32 and np.isfinite(tj).all()
    np.testing.assert_allclose(tj[:3], jj[:3], atol=1e-3)
    np.testing.assert_allclose(tp.side_lens.numpy()[:3], np.asarray(jp.side_lens)[:3],
                               atol=1e-3)
    np.testing.assert_array_equal(tp.root.numpy()[3], problem["root"][3])
    np.testing.assert_array_equal(tp.euler.numpy()[3], euler0[3])


def test_cholesky_step_of_a_failed_factor_is_nan():
    """A slot whose matrix is not positive definite gets a NaN step (its
    cost is then not finite, so the LM does not take it) and nothing
    raises; the other slots solve as `linalg.solve` does."""
    A = torch.eye(3, dtype=torch.float64).repeat(3, 1, 1) * 2.0
    A[1, 2, 2] = -1.0
    A[2] += 0.5 * torch.ones(3, 3, dtype=torch.float64)
    g = torch.arange(9, dtype=torch.float64).reshape(3, 3)
    x = TK._cholesky_solve(A, g)
    assert torch.isnan(x[1]).all()
    torch.testing.assert_close(x[[0, 2]], torch.linalg.solve(A[[0, 2]], g[[0, 2]]))


def test_unknown_solver_raises(problem):
    init = TK.IkParams(t(problem["root"]), torch.zeros(4, 18, 3), torch.ones(4, 11))
    with pytest.raises(ValueError, match="unknown ik solver"):
        TK.solve_two_stage(init, problem["skel"], t(problem["obs"]), t(problem["w"]),
                           t(problem["P"]), n_iters=1, solver="lu")
