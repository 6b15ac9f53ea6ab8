"""Batched Levenberg-Marquardt inverse kinematics on reprojection residuals.

Port of `multiview_motion_capture_tpu/ops/ik.py` (ref:src/
inverse_kinematics.py:202-433): all T track slots solve at once.  Each LM
iteration either assembles the damped normal equations with two batched
products and solves them in one launch of the batched Gauss-Jordan kernel
(solver "gj"), hands [J | r] to the fused kernel that forms and solves them
in one launch (solver "gj_fused"; both in `ops/solve_kernel.py`), or solves
each slot's system by a Cholesky factor (solver "chol", the JAX package's
per-slot `_lm_solve`; a library factorization there as here, no TPU
kernel).  Projections are shared (V, 3, 4) or per slot (T, V, 3, 4): the
tracker's top-k view subset on wide rigs.

Parameter packing: x = [root(3) | euler(18*3) | side_bone_lens(11)] = 68.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from multiview_motion_capture_torch.ops import quaternions as Q
from multiview_motion_capture_torch.ops.consts import on_device
from multiview_motion_capture_torch.ops.fk import (
    ANC_MASK,
    ANC_SELF_MASK,
    N_JOINTS,
    N_SIDE_BONES,
    SIDE_ONE_HOT,
    Skeleton,
    euler_axis_matrices,
    forward_kinematics,
    forward_kinematics_full,
    mm3,
    mv3,
)
from multiview_motion_capture_torch.ops.solve_kernel import batched_spd_solve, fused_normal_solve
from multiview_motion_capture_torch.pose_def import (
    BASIC_18_PARENTS,
    IK_OBS_KPS_IDX,
    IK_SKEL_KPS_IDX,
    KpsFormat,
    KpsType,
    kps_index,
)
from multiview_motion_capture_torch.utils.precision import WORK_DTYPE

Tensor = torch.Tensor

N_PARAMS = 3 + N_JOINTS * 3 + N_SIDE_BONES  # 68

_COCO_IDX = kps_index(KpsFormat.COCO)
_LSH, _RSH = _COCO_IDX[KpsType.L_Shoulder], _COCO_IDX[KpsType.R_Shoulder]
_LHIP, _RHIP = _COCO_IDX[KpsType.L_Hip], _COCO_IDX[KpsType.R_Hip]

_PARENTS = np.asarray(BASIC_18_PARENTS, dtype=np.int64)

_FREE_POSE = np.zeros(N_PARAMS, dtype=np.float32)
_FREE_POSE[: 3 + N_JOINTS * 3] = 1.0
_FREE_ALL = np.ones(N_PARAMS, dtype=np.float32)

# the LM loop checks on the host whether any slot is still active once every
# this many iterations (frozen slots do not change, so iterations past the
# last active one are no-ops: the check saves work and changes no result)
LM_SYNC_EVERY = 5

SOLVERS = ("chol", "gj", "gj_fused")


class IkParams(NamedTuple):
    root: Tensor       # (..., 3)
    euler: Tensor      # (..., 18, 3)
    side_lens: Tensor  # (..., 11)

    def pack(self) -> Tensor:
        return torch.cat(
            [self.root, self.euler.reshape(self.euler.shape[:-2] + (N_JOINTS * 3,)),
             self.side_lens], dim=-1)

    @classmethod
    def unpack(cls, x: Tensor) -> "IkParams":
        root = x[..., :3]
        euler = x[..., 3:3 + N_JOINTS * 3].reshape(x.shape[:-1] + (N_JOINTS, 3))
        side = x[..., 3 + N_JOINTS * 3:]
        return cls(root=root, euler=euler, side_lens=side)


def add_mid_spine(obs: Tensor) -> Tensor:
    """Append the synthetic mid-spine keypoint to COCO-17 observations
    (ref:src/inverse_kinematics.py:339-348): midpoint of the shoulder and hip
    centers, score = product of the four scores.  (..., 17, 3) -> (..., 18, 3)."""
    mid_sh = 0.5 * (obs[..., _LSH, :2] + obs[..., _RSH, :2])
    mid_hip = 0.5 * (obs[..., _LHIP, :2] + obs[..., _RHIP, :2])
    spine_xy = 0.5 * (mid_sh + mid_hip)
    score = obs[..., _LSH, 2] * obs[..., _RSH, 2] * obs[..., _LHIP, 2] * obs[..., _RHIP, 2]
    spine = torch.cat([spine_xy, score[..., None]], dim=-1)
    return torch.cat([obs, spine[..., None, :]], dim=-2)


def _unit(v: Tensor) -> Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-9)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1, keepdim=True)


def geometric_init(tri18: Tensor, skel: Skeleton, min_score: float = 0.05) -> Tensor:
    """Closed-form joint-angle initialization from triangulated poses: each
    rest bone direction is rotated onto its triangulated bone, so the cold
    LM solve starts near the optimum instead of from zero angles.

    tri18: (..., 18, 4) triangulated COCO+spine points (x, y, z, score).
    Returns (..., 18, 3) euler angles (R = Rx @ Ry @ Rz)."""
    dev, dt = tri18.device, tri18.dtype
    skel_sel = on_device(IK_SKEL_KPS_IDX, dev)
    obs_sel = on_device(IK_OBS_KPS_IDX, dev)
    lead = tri18.shape[:-2]
    pos = torch.zeros(lead + (N_JOINTS, 3), dtype=dt, device=dev)
    pos[..., skel_sel, :] = tri18[..., obs_sel, :3]
    sc = torch.zeros(lead + (N_JOINTS,), dtype=dt, device=dev)
    sc[..., skel_sel] = tri18[..., obs_sel, 3]
    pos[..., 0, :] = 0.5 * (pos[..., 1, :] + pos[..., 4, :])        # Mid_Hip
    sc[..., 0] = torch.minimum(sc[..., 1], sc[..., 4])
    pos[..., 8, :] = 0.5 * (pos[..., 9, :] + pos[..., 12, :])       # Neck
    sc[..., 8] = torch.minimum(sc[..., 9], sc[..., 12])

    rest = skel.bone_dirs                                          # (18, 3)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dt, device=dev)

    def frame_quat(d_primary, rest_primary, d_secondary, rest_secondary, ok):
        """Rotation mapping rest_primary -> d_primary and (projected)
        rest_secondary -> d_secondary, as a quaternion; identity if not ok."""
        e1 = _unit(d_primary)
        r1 = _unit(rest_primary)
        e2 = _unit(d_secondary - _dot(d_secondary, e1) * e1)
        r2 = _unit(rest_secondary - _dot(rest_secondary, r1) * r1)
        Rsrc = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
        Rdst = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)
        R = Rdst @ Rsrc.transpose(-1, -2)
        q = Q.normalize(Q.from_matrix(R))
        return torch.where(ok[..., None], q, ident)

    ok_root = (sc[..., 0] > min_score) & (sc[..., 7] > min_score) & (sc[..., 1] > min_score)
    g_q0 = frame_quat(pos[..., 7, :] - pos[..., 0, :], rest[7],
                      pos[..., 1, :] - pos[..., 0, :], rest[1], ok_root)

    g_q = [None] * N_JOINTS
    local_q = [None] * N_JOINTS
    g_q[0] = g_q0
    local_q[0] = g_q0
    child_of = {j: [] for j in range(N_JOINTS)}
    for c in range(1, N_JOINTS):
        child_of[int(_PARENTS[c])].append(c)

    for j in range(1, N_JOINTS):
        p = int(_PARENTS[j])
        kids = child_of[j]
        if not kids:
            local_q[j] = ident.expand_as(g_q0)
            g_q[j] = g_q[p]
            continue
        c = kids[0]
        d_obs = pos[..., c, :] - pos[..., j, :]
        ok = ((sc[..., j] > min_score) & (sc[..., c] > min_score)
              & (torch.linalg.vector_norm(d_obs, dim=-1) > 1e-6))
        d_rest_world = Q.qrot(g_q[p], rest[c].expand_as(d_obs))
        align = Q.between(d_rest_world,
                          torch.where(ok[..., None], _unit(d_obs), d_rest_world))
        gq = Q.normalize(Q.qmul(align, g_q[p]))
        g_q[j] = torch.where(ok[..., None], gq, g_q[p])
        local_q[j] = Q.normalize(Q.qmul(Q.conjugate(g_q[p]), g_q[j]))

    return Q.to_euler(torch.stack(local_q, dim=-2)).to(dt)


def _project_sel(joints: Tensor, P: Tensor, eps: float):
    """Project the 16 observable joints through P (V, 3, 4) shared or
    (T, V, 3, 4) per slot: returns (uv (T, V, 16, 2), w (T, V, 16, 1))."""
    sel = joints[:, on_device(IK_SKEL_KPS_IDX, joints.device)]       # (T, 16, 3)
    homo = torch.cat([sel, torch.ones_like(sel[..., :1])], dim=-1)   # (T, 16, 4)
    spec = "tvab,tkb->tvka" if P.dim() == 4 else "vab,tkb->tvka"
    proj = torch.einsum(spec, P, homo)                               # (T, V, 16, 3)
    wq = eps + proj[..., 2:3]
    return proj[..., :2] / wq, wq


def _residual(x: Tensor, skel: Skeleton, obs: Tensor, view_w: Tensor, P: Tensor,
              eps: float) -> Tensor:
    """Score-weighted reprojection residual, batched over slots.

    x: (T, 68); obs: (T, V, 18, 3) COCO+spine; view_w: (T, V); P: (V, 3, 4)
    or (T, V, 3, 4).  Returns (T, V*16*2)."""
    p = IkParams.unpack(x)
    joints = forward_kinematics(skel, p.root, p.euler, p.side_lens)
    uv, _ = _project_sel(joints, P, eps)
    tgt = obs[:, :, on_device(IK_OBS_KPS_IDX, obs.device)]          # (T, V, 16, 3)
    diff = (uv - tgt[..., :2]) * tgt[..., 2:3] * view_w[:, :, None, None]
    return diff.reshape(x.shape[0], -1)


def _residual_and_jacobian(x: Tensor, skel: Skeleton, obs: Tensor, view_w: Tensor,
                           P: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """Residual and its analytic jacobian in one pass (the closed-form
    kinematic chain rule of the JAX package's `_residual_and_jacobian`):
      d pos_k / d root      = I,
      d pos_k / d angle_ja  = [j proper ancestor of k] *
                              g_R[parent(j)] @ dR_j/da @ g_R[j]^T (pos_k - t_j),
      d pos_k / d side_s    = sum_b [b ancestor-or-self of k][side(b)=s] *
                              g_R[parent(b)] @ dir_b,
    then the pinhole projection jacobian.  Returns (r (T, V*32), J (T, V*32, 68))."""
    T = x.shape[0]
    dev, dt = x.device, x.dtype
    p = IkParams.unpack(x)
    joints, g_R, (Rx, Ry, Rz), _ = forward_kinematics_full(
        skel, p.root, p.euler, p.side_lens)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    g_Rp = g_R[:, on_device(_PARENTS, dev)]
    g_Rp = torch.cat([eye3.expand(T, 1, 3, 3), g_Rp[:, 1:]], dim=1)

    _, _, _, dRx, dRy, dRz = euler_axis_matrices(p.euler)
    dR = torch.stack([mm3(mm3(dRx, Ry), Rz),
                      mm3(mm3(Rx, dRy), Rz),
                      mm3(mm3(Rx, Ry), dRz)], dim=2)          # (T, 18, 3angles, 3, 3)
    D = mm3(g_Rp[:, :, None], dR)                             # (T, 18, 3, 3, 3)

    diff = joints[:, None, :, :] - joints[:, :, None, :]      # [t, j, k] = pos_k - t_j
    u = mv3(g_R.transpose(-1, -2)[:, :, None], diff)          # (T, 18, 18, 3)

    anc = on_device(ANC_MASK, dev, dtype=dt)
    d_angle = torch.einsum("tjnax,tjkx,jk->tkjna", D, u, anc)
    d_angle = d_angle.reshape(T, N_JOINTS, N_JOINTS * 3, 3)

    C = mv3(g_Rp, skel.bone_dirs)                             # (T, 18, 3)
    d_side = torch.einsum("bk,bs,tba->tksa", on_device(ANC_SELF_MASK, dev, dtype=dt),
                          on_device(SIDE_ONE_HOT, dev, dtype=dt), C)

    d_root = eye3.expand(T, N_JOINTS, 3, 3)
    dX = torch.cat([d_root, d_angle, d_side], dim=2)          # (T, 18, 68, 3)
    dX_sel = dX[:, on_device(IK_SKEL_KPS_IDX, dev)]           # (T, 16, 68, 3)

    uv, wq = _project_sel(joints, P, eps)
    tgt = obs[:, :, on_device(IK_OBS_KPS_IDX, dev)]
    score = tgt[..., 2:3] * view_w[:, :, None, None]          # (T, V, 16, 1)
    r = ((uv - tgt[..., :2]) * score).reshape(T, -1)

    Pt = P if P.dim() == 4 else P[None]                       # (T or 1, V, 3, 4)
    duv = (Pt[:, :, None, :2, :3]
           - uv[..., None] * Pt[:, :, None, None, 2, :3]) / wq[..., None]
    J = torch.einsum("tvkix,tkpx->tvkip", duv, dX_sel) * score[..., None]
    return r, J.reshape(T, -1, N_PARAMS)


def _cholesky_solve(A: Tensor, g: Tensor) -> Tensor:
    """x with A[t] x[t] = g[t] by each slot's Cholesky factor and two
    triangular solves (ik.py:329-333 of the JAX package), in A's dtype.  A
    slot whose factor fails gets a NaN step, as the JAX factor of a matrix
    that is not positive definite gives one: its cost is then not finite,
    so the step is not taken.  Nothing is checked on the host."""
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, g[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
    return torch.where((info == 0)[:, None], x, torch.full_like(x, float("nan")))


def _lm_solve_batched(x0: Tensor, skel: Skeleton, obs: Tensor, view_w: Tensor,
                      P: Tensor, free_mask: Tensor, n_iters: int, eps: float,
                      lam0: float, lam_up: float, lam_down: float,
                      ftol: float = 2e-6, xtol: float = 1e-6,
                      solver: str = "gj", return_iters: bool = False):
    """Batched LM over all T slots, every slot's damped normal equations
    solved at once per iteration: by the batched Gauss-Jordan kernel on
    normal equations assembled by two batched products ("gj"), by the fused
    kernel that forms them from [J | r] itself ("gj_fused", ik.py:413-417 of
    the JAX package), or by each slot's Cholesky factor ("chol", the JAX
    package's per-slot `_lm_solve`, ik.py:280-357, whose vmapped
    `while_loop` runs each slot as this masked loop does).

    The parameters, the damping and the kernels' inputs are f32; residuals,
    jacobians, the normal equations and the costs are formed in
    `WORK_DTYPE` and rounded once where they enter a kernel
    (utils/precision.py), so the card and the CPU step alike.  The Cholesky
    route factors in `WORK_DTYPE` and rounds the step once to f32.

    A slot freezes once it converges; slots with no observations start
    frozen (they can never take a "better" step, ik.py:441-449).  Frozen
    slots keep x and lam, so running past the point where every slot froze
    changes nothing: the loop only checks for that on the host once every
    `LM_SYNC_EVERY` iterations.

    `return_iters=True` also returns the JAX package's iteration count
    (ik.py:382-385 there): the iterations at whose start any slot was
    active, which is what its `lax.while_loop` executes, since a frozen
    slot never thaws.  The count stays on the device, a () int32 tensor,
    and the host reads nothing more for it."""
    T, n = x0.shape
    dev, dt, wd = x0.device, x0.dtype, WORK_DTYPE
    eye = torch.eye(n, dtype=wd, device=dev)
    frozen_diag = torch.diag(1.0 - free_mask).to(wd)
    skel, obs, view_w, P = skel.to(wd), obs.to(wd), view_w.to(wd), P.to(wd)

    def residual(x):
        return _residual(x.to(wd), skel, obs, view_w, P, eps)

    x = x0
    r = residual(x0)
    lam = torch.full((T,), lam0, dtype=dt, device=dev)
    active = view_w.sum(dim=1) > 0
    n_run = torch.zeros((), dtype=torch.int32, device=dev) if return_iters else None
    for it in range(n_iters):
        if it > 0 and it % LM_SYNC_EVERY == 0 and not bool(active.any()):
            break
        if return_iters:
            n_run += active.any()
        _, J = _residual_and_jacobian(x.to(wd), skel, obs, view_w, P, eps)
        J = J * free_mask[None, None, :]
        if solver == "gj_fused":
            Jaug = torch.cat([J, r[:, :, None]], dim=2).to(dt)
            dx = -fused_normal_solve(Jaug, lam, 1.0 - free_mask) * free_mask[None, :]
        else:
            JtJ = torch.einsum("trd,tre->tde", J, J)
            g = torch.einsum("trd,tr->td", J, r)
            ridge = 1e-6 * (torch.diagonal(JtJ, dim1=1, dim2=2).sum(-1) / n) + 1e-6
            A = JtJ + (lam.to(wd) + ridge)[:, None, None] * eye + frozen_diag[None]
            if solver == "chol":
                step = _cholesky_solve(A, g).to(dt)
            else:
                step = batched_spd_solve(A.to(dt).contiguous(), g.to(dt).contiguous())
            dx = -step * free_mask[None, :]
        x_new = x + dx
        r_new = residual(x_new)
        c_old = (r * r).sum(dim=1)
        c_new = (r_new * r_new).sum(dim=1)
        better = (c_new < c_old) & torch.isfinite(c_new) & active
        x = torch.where(better[:, None], x_new, x)
        r = torch.where(better[:, None], r_new, r)
        lam = torch.where(active,
                          torch.where(better, (lam * lam_down).clamp(min=1e-6),
                                      (lam * lam_up).clamp(max=1e6)),
                          lam)
        small_gain = (c_old - c_new) <= ftol * (c_old + 1e-20)
        small_step = dx.abs().amax(dim=1) <= xtol * (1.0 + x.abs().amax(dim=1))
        converged = better & (small_gain | small_step)
        active = active & ~converged
    if return_iters:
        return x, n_run
    return x


def solve_two_stage(init: IkParams, skel: Skeleton, obs_coco: Tensor,
                    view_w: Tensor, P: Tensor, n_iters: int, eps: float = 1e-5,
                    lam0: float = 1e-3, lam_up: float = 10.0,
                    lam_down: float = 0.33, stages: int = 2, solver: str = "chol",
                    ftol: float = 2e-6, xtol: float = 1e-6) -> Tuple[IkParams, Tensor]:
    """The reference's solve(): pose-only then pose+bone-lengths
    (ref:src/inverse_kinematics.py:402-407), batched over track slots.

    init: IkParams batched (T, ...); obs_coco: (T, V, 17, 3); view_w: (T, V)
    weights, 0 for cameras not in the match; P: (V, 3, 4) shared, or
    (T, V, 3, 4) per slot (the tracker's top-k view subset on wide rigs,
    cfg.ik_max_views).  solver: "chol" (the JAX package's default), "gj" or
    "gj_fused".  stages=1 runs one all-parameter solve.  Returns (params,
    joints (T, 18, 3))."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown ik solver {solver!r}; expected one of {SOLVERS}")
    dev = obs_coco.device
    obs = add_mid_spine(obs_coco)
    free_pose = on_device(_FREE_POSE, dev)
    free_all = on_device(_FREE_ALL, dev)
    x0 = init.pack()

    def stage(x, mask):
        return _lm_solve_batched(x, skel, obs, view_w, P, mask, n_iters, eps,
                                 lam0, lam_up, lam_down, ftol=ftol, xtol=xtol,
                                 solver=solver)

    if stages == 1:
        x = stage(x0, free_all)
    else:
        x = stage(stage(x0, free_pose), free_all)
    params = IkParams.unpack(x)
    wd = WORK_DTYPE
    joints = forward_kinematics(skel.to(wd), params.root.to(wd), params.euler.to(wd),
                                params.side_lens.to(wd)).to(x.dtype)
    return params, joints
