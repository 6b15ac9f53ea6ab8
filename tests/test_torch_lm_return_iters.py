"""`ops/ik._lm_solve_batched(..., return_iters=True)` of the port against
the JAX package's on the CPU: on the same inputs it returns JAX's while
count (the iterations at whose start any slot was active), for the
pose-only and the all-parameter free masks, and its poses equal those of
`return_iters=False`.

The tolerances are loose (ftol 5e-2, xtol 1e-4) so that every slot stops
by the convergence test well above float32's resolution of the cost: at
the solve's default tolerances JAX's float32 cost cannot resolve a slot's
last gains (a step reads as no gain, is refused, and the slot runs to the
budget), where the port's float64 cost stops it
(tests/test_torch_studies.py names those margins).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.config import SHELF_BENCH as T_CFG
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence as t_synth
from multiview_motion_capture_torch.ops import fk as TF
from multiview_motion_capture_torch.ops import ik as TK
from multiview_motion_capture_tpu.ops import fk as JF
from multiview_motion_capture_tpu.ops import ik as JK
from tests.torch_study_scene import one_thread


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
def lm_problem():
    """Ground-truth-grouped observations of 3 people in 4 views and one
    empty slot, started from the reference bone lengths and a root at the
    hip midpoint's ground truth, angles zero."""
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
    root = np.zeros((4, 3), np.float32)
    root[:3] = s.gt_3d[f, :3, 11]
    x0 = np.concatenate([root, np.zeros((4, 54), np.float32),
                         np.tile(TF.REF_SIDE_BONE_LENS, (4, 1)).astype(np.float32)], axis=1)
    return dict(x0=x0, obs=obs, w=w, P=s.cameras.P.numpy())


@pytest.mark.parametrize("free", ["pose", "all"])
def test_lm_return_iters_is_the_jax_while_count(lm_problem, free):
    mask = {"pose": JK._FREE_POSE, "all": JK._FREE_ALL}[free]
    kw = dict(n_iters=30, eps=1e-5, lam0=1e-3, lam_up=10.0, lam_down=0.33,
              ftol=5e-2, xtol=1e-4)
    p = lm_problem
    _, jit = JK._lm_solve_batched(
        jnp.asarray(p["x0"]), JF.Skeleton.default(),
        JK.add_mid_spine(jnp.asarray(p["obs"])), jnp.asarray(p["w"]), jnp.asarray(p["P"]),
        jnp.asarray(mask), interpret=True, return_iters=True, **kw)
    args = (t(p["x0"]), TF.Skeleton.default(), TK.add_mid_spine(t(p["obs"])), t(p["w"]),
            t(p["P"]), t(mask))
    tx, tit = TK._lm_solve_batched(*args, solver="gj", return_iters=True, **kw)
    plain = TK._lm_solve_batched(*args, solver="gj", **kw)
    assert tit.dtype == torch.int32 and tit.dim() == 0
    assert 0 < int(tit) < kw["n_iters"]        # it converged: the count is the loop's own
    assert int(tit) == int(jit)
    torch.testing.assert_close(tx, plain, rtol=0, atol=0)
    # the empty slot starts frozen and comes back untouched
    np.testing.assert_array_equal(tx.numpy()[3], p["x0"][3])
