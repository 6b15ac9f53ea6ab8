"""The wide-rig IK levers of the port against the JAX package, on the CPU,
from the same numpy inputs: the fused normal-equation solve (plain version
of the B4 kernel) against the JAX `fused_normal_solve` in interpret mode,
the batched LM with `solver="gj_fused"`, and the LM with per-slot
projections (the tracker's top-k view subset, cfg.ik_max_views).

Tolerances: the fused solve forms J^T J in another order of rounding than
the JAX kernel's dot and eliminates in f32: relative 1e-5.  Whole LM
solves go through accept/reject steps on those solves: 1e-4 m on a
well-observed scene, as the JAX package's own
`test_gj_fused_solver_matches_gj` holds its two solvers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.ops import cuda_lib
from multiview_motion_capture_torch.ops import fk as TF
from multiview_motion_capture_torch.ops import ik as TK
from multiview_motion_capture_torch.ops import solve_kernel
from multiview_motion_capture_tpu.cameras import synthetic_camera_ring
from multiview_motion_capture_tpu.ops import fk as JF
from multiview_motion_capture_tpu.ops import ik as JK
from multiview_motion_capture_tpu.ops import solve_pallas
from tests.torch_study_scene import one_thread

REL_TOL = 1e-5
POSE_TOL_M = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def t(a):
    return torch.as_tensor(np.array(a))


def _jaug(seed, T=4, V=4, D=68):
    """Seeded J (T, V*32, D), r (T, V*32) and damping lam (T,) shaped like
    one LM iteration's; the tests mask J's frozen columns themselves."""
    rng = np.random.RandomState(seed)
    R = V * 32
    J = rng.randn(T, R, D).astype(np.float32)
    r = rng.randn(T, R).astype(np.float32)
    lam = rng.uniform(1e-3, 1.0, size=T).astype(np.float32)
    return J, r, lam


@pytest.mark.parametrize("free", ["pose", "all", "mixed"])
def test_fused_normal_plain_matches_pallas(free):
    J, r, lam = _jaug({"pose": 0, "all": 1, "mixed": 2}[free])
    D = J.shape[2]
    if free == "pose":
        mask = np.asarray(TK._FREE_POSE)
    elif free == "all":
        mask = np.ones(D, np.float32)
    else:
        mask = (np.random.RandomState(3).rand(D) > 0.3).astype(np.float32)
    Jaug = np.concatenate([J * mask, r[:, :, None]], axis=2)
    frozen = (1.0 - mask).astype(np.float32)
    x_jax = np.asarray(solve_pallas.fused_normal_solve(
        jnp.asarray(Jaug), jnp.asarray(lam), jnp.asarray(frozen), interpret=True))
    before = cuda_lib.FUSED_NORMAL_GJ.launches
    x = solve_kernel.fused_normal_solve(t(Jaug), t(lam), t(frozen)).numpy()
    assert cuda_lib.FUSED_NORMAL_GJ.launches == before   # CPU: the plain version
    assert x.shape == (4, 68)
    rel = np.abs(x - x_jax).max() / np.abs(x_jax).max()
    assert rel < REL_TOL, rel
    # frozen parameters come back 0 (their row is the unit diagonal, g = 0)
    np.testing.assert_array_equal(x[:, mask == 0], 0.0)


def test_fused_normal_plain_equals_its_gj_route():
    """The fused function is the gj route's function: J^T J, J^T r, the
    ridge, the damping and the frozen diagonal, then the same elimination."""
    J, r, lam = _jaug(4, T=3, V=2)
    mask = np.asarray(TK._FREE_POSE)
    Jm = J * mask
    frozen = (1.0 - mask).astype(np.float32)
    x = solve_kernel.fused_normal_plain(
        t(np.concatenate([Jm, r[:, :, None]], 2)), t(lam), t(frozen)).numpy()
    JtJ = np.einsum("trd,tre->tde", Jm.astype(np.float64), Jm)
    ridge = 1e-6 * np.trace(JtJ, axis1=1, axis2=2) / 68 + 1e-6
    A = JtJ + (lam + ridge)[:, None, None] * np.eye(68) + np.diag(frozen)[None]
    g = np.einsum("trd,tr->td", Jm.astype(np.float64), r)
    ref = np.linalg.solve(A, g[..., None])[..., 0]
    assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-4


def _kernel_gram_tiles(D, blocks):
    """csrc/fused_normal_gj.cu's Gram tiles, rows 2u, 2u+1 and columns 4v ..
    4v+3 of G, those that reach its upper triangle or its last column (v >=
    u // 2), a contiguous range of them to each block of the cluster."""
    tiles = [(u, v) for u in range((D + 1) // 2) for v in range(u // 2, (D + 4) // 4)]
    per = -(-len(tiles) // blocks)
    return [tiles[b * per:(b + 1) * per] for b in range(blocks)]


def _ordered_entries(Jaug, rows, cols):
    """Entries (rows[e], cols[e]) of Jaug^T Jaug, each summed over the rows
    of Jaug in index order from the first row's product: one rounding per
    product and per sum."""
    s = Jaug[:, 0, rows] * Jaug[:, 0, cols]
    for r in range(1, Jaug.shape[1]):
        s = s + Jaug[:, r, rows] * Jaug[:, r, cols]
    return s


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("free", ["pose", "mixed"])
def test_symmetric_gram_tiles_equal_the_plain_product(free, blocks):
    """What the B4 kernel's Gram rests on: the tiles that reach the upper
    triangle of J^T [J | r], each entry summed in row order and mirrored,
    give the plain version's G bit for bit (a * b == b * a), whichever
    blocks of the cluster the tiles are dealt to; and the solve of that G is
    `fused_normal_plain`'s."""
    J, r, lam = _jaug(5)
    T, R, D = J.shape
    mask = (np.asarray(TK._FREE_POSE) if free == "pose"
            else (np.random.RandomState(7).rand(D) > 0.3).astype(np.float32))
    Jaug = t(np.concatenate([J * mask, r[:, :, None]], axis=2))
    frozen = t((1.0 - mask).astype(np.float32))
    # the plain version's G, as fused_normal_plain forms it
    Jd = Jaug[:, :, :D]
    G_plain = Jd[:, 0, :, None] * Jaug[:, 0, None, :]
    for row in range(1, R):
        G_plain = G_plain + Jd[:, row, :, None] * Jaug[:, row, None, :]

    G = torch.full((T, D, D + 1), float("nan"))
    computed = 0
    for block in _kernel_gram_tiles(D, blocks):
        ij = [(2 * u + p, 4 * v + q) for u, v in block for p in range(2) for q in range(4)]
        ij = [(i, j) for i, j in ij if i < D and j <= D]
        computed += len(ij)
        rows, cols = (torch.tensor(a) for a in zip(*ij))
        s = _ordered_entries(Jaug, rows, cols)
        G[:, rows, cols] = s
        lower = cols < D
        G[:, cols[lower], rows[lower]] = s[:, lower]
    assert computed < 0.6 * D * (D + 1)          # 2,516 of 4,692 entries at D = 68
    assert torch.equal(G, G_plain)

    # the shift and the solve of that G are the plain version's
    tr = torch.diagonal(G[:, :, :D], dim1=1, dim2=2)
    trace = tr[:, 0]
    for i in range(1, D):
        trace = trace + tr[:, i]
    ridge = 1e-6 * (trace / torch.tensor(float(D))) + 1e-6
    A = G[:, :, :D].clone()
    idx = torch.arange(D)
    A[:, idx, idx] = (A[:, idx, idx] + (t(lam) + ridge)[:, None]) + frozen[None]
    assert torch.equal(solve_kernel.gauss_jordan_plain(A, G[:, :, D].contiguous()),
                       solve_kernel.fused_normal_plain(Jaug, t(lam), frozen))


def test_fused_wrapper_rejects_other_devices_and_shapes():
    with pytest.raises(ValueError, match="unsupported device"):
        solve_kernel.fused_normal_solve(torch.zeros((2, 8, 5), device="meta"),
                                        torch.zeros(2, device="meta"),
                                        torch.zeros(4, device="meta"))


@pytest.fixture(scope="module")
def ring_problem():
    """tests/test_fk_ik.py::test_gj_fused_solver_matches_gj's scene: one
    skeleton seen by a 4-camera ring, 4 slots from perturbed inits."""
    cams = synthetic_camera_ring(4)
    skel = JF.Skeleton.default()
    rng = np.random.RandomState(6)
    T, V = 4, 4
    gt_root = np.array([0.0, 0.0, 0.95])
    gt_euler = np.zeros((18, 3))
    gt_euler[0] = [np.pi / 2, 0, 0]
    gt_side = np.asarray(JF.REF_SIDE_BONE_LENS)
    gt_joints = np.asarray(JF.forward_kinematics(
        skel, jnp.asarray(gt_root, dtype=jnp.float32),
        jnp.asarray(gt_euler, dtype=jnp.float32),
        jnp.asarray(gt_side, dtype=jnp.float32)))
    P = np.asarray(cams.P, dtype=np.float64)
    obs = np.zeros((T, V, 17, 3), dtype=np.float32)
    for v in range(V):
        homo = np.concatenate([gt_joints, np.ones((18, 1))], 1)
        uv = homo @ P[v].T
        uv = uv[:, :2] / uv[:, 2:3]
        for s_i, o_i in zip(np.asarray(JK._SKEL_SEL), np.asarray(JK._OBS_SEL)):
            if o_i < 17:
                obs[:, v, o_i, :2] = uv[s_i]
                obs[:, v, o_i, 2] = 1.0
    init = dict(root=np.tile(gt_root + 0.08, (T, 1)).astype(np.float32),
                euler=(np.tile(gt_euler[None], (T, 1, 1))
                       + rng.normal(0, 0.05, (T, 18, 3))).astype(np.float32),
                side_lens=np.tile(gt_side, (T, 1)).astype(np.float32))
    return dict(obs=obs, init=init, P=np.asarray(cams.P, np.float32),
                vw=np.ones((T, V), np.float32), gt_joints=gt_joints)


def _solve_both(pr, P, obs, vw, solver, **kw):
    kw = dict(n_iters=15, **kw)
    ti = TK.IkParams(t(pr["init"]["root"]), t(pr["init"]["euler"]), t(pr["init"]["side_lens"]))
    tp, tj = TK.solve_two_stage(ti, TF.Skeleton.default(), t(obs), t(vw), t(P),
                                solver=solver, **kw)
    ji = JK.IkParams(*(jnp.asarray(pr["init"][k]) for k in ("root", "euler", "side_lens")))
    jp, jj = JK.solve_two_stage(ji, JF.Skeleton.default(), jnp.asarray(obs), jnp.asarray(vw),
                                jnp.asarray(P), solver=solver, interpret=True, **kw)
    return tp, tj.numpy(), jp, np.asarray(jj)


def test_solve_two_stage_gj_fused_matches_jax(ring_problem):
    pr = ring_problem
    before = cuda_lib.FUSED_NORMAL_GJ.launches
    tp, tj, jp, jj = _solve_both(pr, pr["P"], pr["obs"], pr["vw"], "gj_fused")
    assert cuda_lib.FUSED_NORMAL_GJ.launches == before
    np.testing.assert_allclose(tj, jj, atol=POSE_TOL_M)
    np.testing.assert_allclose(tp.side_lens.numpy(), np.asarray(jp.side_lens), atol=POSE_TOL_M)
    sel = np.asarray(JK._SKEL_SEL)
    assert np.linalg.norm(tj[:, sel] - pr["gt_joints"][sel], axis=-1).max() < 0.02
    # and the port's two solvers agree as the JAX package's do
    _, tj_gj, _, _ = _solve_both(pr, pr["P"], pr["obs"], pr["vw"], "gj")
    np.testing.assert_allclose(tj, tj_gj, atol=POSE_TOL_M)


def test_solve_two_stage_per_slot_projections_match_jax(ring_problem):
    """Per-slot P (T, V, 3, 4): every slot sees the ring's views in its own
    order, and slot 3 only three of them (its fourth row's weight is 0), as
    the tracker's top-k gather hands them over."""
    pr = ring_problem
    T, V = pr["vw"].shape
    perms = [np.roll(np.arange(V), s) for s in range(T)]
    P = np.stack([pr["P"][p] for p in perms])                     # (T, V, 3, 4)
    obs = np.stack([pr["obs"][s, p] for s, p in enumerate(perms)])
    vw = pr["vw"].copy()
    vw[3, 3] = 0.0
    obs[3, 3] = 0.0
    tp, tj, jp, jj = _solve_both(pr, P, obs, vw, "gj")
    np.testing.assert_allclose(tj, jj, atol=POSE_TOL_M)
    np.testing.assert_allclose(tp.root.numpy(), np.asarray(jp.root), atol=POSE_TOL_M)
    # the same views in another order are the same problem as the shared P
    _, tj_shared, _, _ = _solve_both(pr, pr["P"], pr["obs"], pr["vw"], "gj")
    np.testing.assert_allclose(tj[:3], tj_shared[:3], atol=POSE_TOL_M)


def test_gj_lm_independent_of_summation_order(ring_problem):
    """The "gj" LM forms its normal equations and costs in WORK_DTYPE and
    rounds once, so the order of its sums does not reach the result: the
    same views handed over in reverse order (per-slot projections) give the
    same joints bit for bit.  That is what lets the card, whose reductions
    sum in another order than the CPU's, take the same LM steps (in f32
    the two orders part in the last bits)."""
    pr = ring_problem
    T, V = pr["vw"].shape
    rng = np.random.RandomState(0)
    obs = pr["obs"].copy()
    obs[..., :2] += rng.normal(0, 2.0, obs[..., :2].shape).astype(np.float32)
    rev = np.arange(V)[::-1].copy()
    init = TK.IkParams(t(pr["init"]["root"]), t(pr["init"]["euler"]),
                       t(pr["init"]["side_lens"]))
    kw = dict(n_iters=15, solver="gj")
    _, j_fwd = TK.solve_two_stage(init, TF.Skeleton.default(), t(obs), t(pr["vw"]),
                                  t(pr["P"]), **kw)
    _, j_rev = TK.solve_two_stage(init, TF.Skeleton.default(), t(obs[:, rev]),
                                  t(pr["vw"][:, rev]), t(np.stack([pr["P"][rev]] * T)), **kw)
    assert j_fwd.dtype == torch.float32
    assert torch.equal(j_fwd, j_rev)


def test_per_slot_residual_and_jacobian_match_shared(ring_problem):
    pr = ring_problem
    T = pr["vw"].shape[0]
    x = TK.IkParams(t(pr["init"]["root"]), t(pr["init"]["euler"]),
                    t(pr["init"]["side_lens"])).pack()
    obs18 = TK.add_mid_spine(t(pr["obs"]))
    P_per = t(np.broadcast_to(pr["P"][None], (T,) + pr["P"].shape).copy())
    r_s, J_s = TK._residual_and_jacobian(x, TF.Skeleton.default(), obs18, t(pr["vw"]),
                                         t(pr["P"]), 1e-5)
    r_p, J_p = TK._residual_and_jacobian(x, TF.Skeleton.default(), obs18, t(pr["vw"]),
                                         P_per, 1e-5)
    np.testing.assert_allclose(r_p.numpy(), r_s.numpy(), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(J_p.numpy(), J_s.numpy(), rtol=1e-6,
                               atol=1e-6 * np.abs(J_s.numpy()).max())
