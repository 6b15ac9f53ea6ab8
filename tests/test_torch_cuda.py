"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: they need an NVIDIA GPU with nvcc and skip elsewhere.  On a
machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(`--noconftest`: the suite's conftest configures JAX, which that machine
need not have.)

Every kernel runs the same f32 operations in the same order as its plain
version, so the results must be equal, bit for bit.
"""
import numpy as np
import pytest
import torch

from multiview_motion_capture_torch.ops import als_kernel, association, cuda_lib, solve_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU interpreter)")
    cuda_lib.build_all()
    return torch.device("cuda")


@pytest.mark.parametrize("sizes,rank", [((8, 6, 6, 6, 6, 6), 16), ((16,) + (10,) * 32, 32)])
def test_als_kernel_equals_plain(cuda, sizes, rank):
    rng = np.random.RandomState(0)
    n = sum(sizes)
    W = rng.rand(n, n).astype(np.float32) * 0.2
    W = torch.as_tensor(0.5 * (W + W.T), device=cuda)
    mask = torch.as_tensor(association.block_diag_mask(sizes), device=cuda)
    init = torch.as_tensor(association.default_init_factor(n, rank), device=cuda)
    before = (cuda_lib.ALS.launches, cuda_lib.ALS_BATCHED.launches)
    k = als_kernel.match_als(W, mask, init, max_iter=60, stable_iters=10)
    p = association.match_als(W, mask, init, max_iter=60, stable_iters=10)
    assert (cuda_lib.ALS.launches, cuda_lib.ALS_BATCHED.launches) == (before[0] + 1, before[1])
    assert torch.equal(k.x_bin, p.x_bin)
    assert int(k.n_iters) == int(p.n_iters)


@pytest.mark.parametrize("sizes,rank", [((8, 6, 6, 6, 6, 6), 16), ((16,) + (10,) * 5, 32),
                                        ((16,) + (10,) * 32, 32)])
def test_als_kernel_x_output_equals_plain(cuda, sizes, rank):
    """B1 writes the symmetrized X only when asked: then it equals the plain
    version's X bit for bit, and x_bin and the iteration count are those of
    the launch without it."""
    W, mask, init = _als_inputs(cuda, sizes, rank, 1, seed=7)
    kw = dict(max_iter=60, stable_iters=10)
    k = als_kernel.match_als(W[0], mask, init, **kw)
    kx = als_kernel.match_als(W[0], mask, init, return_x=True, **kw)
    p = association.match_als(W[0], mask, init, **kw)
    assert k.x is None and kx.x.dtype == torch.float32
    assert torch.equal(kx.x, p.x)
    assert torch.equal(kx.x_bin, k.x_bin) and int(kx.n_iters) == int(k.n_iters)


def test_als_batched_x_output_equals_plain(cuda):
    """B3's X output: each problem's X equals the plain version's."""
    W, mask, init = _als_inputs(cuda, (16,) + (10,) * 32, 32, 2, seed=8)
    kw = dict(max_iter=40, stable_iters=10)
    k = als_kernel.match_als_batched(W, mask, init, **kw)
    kx = als_kernel.match_als_batched(W, mask, init, return_x=True, **kw)
    assert k.x is None and kx.x.shape == W.shape
    assert torch.equal(kx.x_bin, k.x_bin) and torch.equal(kx.n_iters, k.n_iters)
    for c in range(W.shape[0]):
        assert torch.equal(kx.x[c], association.match_als(W[c], mask, init, **kw).x)


def _als_inputs(cuda, sizes, rank, C, seed):
    rng = np.random.RandomState(seed)
    n = sum(sizes)
    W = rng.rand(C, n, n).astype(np.float32) * 0.2
    W = torch.as_tensor(0.5 * (W + W.transpose(0, 2, 1)), device=cuda).contiguous()
    mask = torch.as_tensor(association.block_diag_mask(sizes), device=cuda)
    init = torch.as_tensor(association.default_init_factor(n, rank), device=cuda)
    return W, mask, init


def _assert_batched_equals_plain_and_solo(W, mask, init, **kw):
    k = als_kernel.match_als_batched(W, mask, init, **kw)
    for c in range(W.shape[0]):
        p = association.match_als(W[c], mask, init, **kw)
        solo = als_kernel.match_als(W[c], mask, init, **kw)
        assert torch.equal(k.x_bin[c], p.x_bin) and torch.equal(k.x_bin[c], solo.x_bin)
        assert int(k.n_iters[c]) == int(p.n_iters) == int(solo.n_iters)
    return k


def _largest_one_block_n(rank):
    return max(n for n in range(rank, als_kernel.MAX_N + 1)
               if als_kernel.launch_shape(n, rank).cluster == 1)


def test_als_launch_shape(cuda):
    """One block per problem at SHELF_BENCH's shape, a cluster of 16 at the
    wide rig's and at MAX_N; the card holds several such clusters at once."""
    assert als_kernel.launch_shape(38, 16).cluster == 1
    for n in (336, als_kernel.MAX_N):
        shape = als_kernel.launch_shape(n, 32)
        assert shape.cluster == 16 and shape.max_active_clusters >= 2
    assert 64 < _largest_one_block_n(32) < 336


@pytest.mark.parametrize("side", ["below", "above"])
def test_als_kernel_at_the_cluster_switch(cuda, side):
    """The last n solved by one block and the first solved by a cluster."""
    n = _largest_one_block_n(32) + (side == "above")
    assert als_kernel.launch_shape(n, 32).cluster == (16 if side == "above" else 1)
    sizes = (16,) + (8,) * ((n - 16) // 8) + (((n - 16) % 8,) if (n - 16) % 8 else ())
    W, mask, init = _als_inputs(cuda, sizes, 32, 1, seed=5)
    k = als_kernel.match_als(W[0], mask, init, max_iter=40, stable_iters=10)
    p = association.match_als(W[0], mask, init, max_iter=40, stable_iters=10)
    assert torch.equal(k.x_bin, p.x_bin) and int(k.n_iters) == int(p.n_iters)


def test_als_kernel_at_max_n(cuda):
    sizes = (16,) + (8,) * 46
    assert sum(sizes) == als_kernel.MAX_N
    W, mask, init = _als_inputs(cuda, sizes, 32, 2, seed=6)
    _assert_batched_equals_plain_and_solo(W, mask, init, max_iter=30, stable_iters=10)


@pytest.mark.parametrize("rank", [16, 24, 32])
@pytest.mark.parametrize("where", ["above_switch", "max_n"])
def test_als_cluster_shape_at_each_rank(cuda, rank, where):
    """The 16-block cluster at each width of its split ridge solve (rank 16:
    two right-hand columns a warp; 24: padded rows and columns; 32): the
    first n a cluster solves and MAX_N."""
    n = _largest_one_block_n(rank) + 1 if where == "above_switch" else als_kernel.MAX_N
    assert als_kernel.launch_shape(n, rank).cluster == 16
    sizes = (16,) + (8,) * ((n - 16) // 8) + (((n - 16) % 8,) if (n - 16) % 8 else ())
    W, mask, init = _als_inputs(cuda, sizes, rank, 1, seed=11 + rank)
    k = als_kernel.match_als(W[0], mask, init, max_iter=30, stable_iters=10)
    p = association.match_als(W[0], mask, init, max_iter=30, stable_iters=10)
    assert torch.equal(k.x_bin, p.x_bin) and int(k.n_iters) == int(p.n_iters)


def test_als_batched_problems_stop_apart(cuda):
    """B3 at C 4 on the cluster shape (N 116, rank 32), on problems from
    well separated to noise, which stop at different iterations: each
    equals the plain version and B1 alone."""
    import chip_smoke  # beside tests/; on sys.path under `python -m pytest`

    sizes = (16,) + (10,) * 10
    n = sum(sizes)
    rng = np.random.RandomState(9)
    Ws = []
    for c, noise in enumerate((0.0, 0.3, 0.6, 1.0)):
        R = rng.rand(n, n).astype(np.float32) * 0.2
        clean = chip_smoke.als_problem(20 + c, sizes, n_people=16)
        Ws.append(((1 - noise) * clean + noise * 0.5 * (R + R.T)).astype(np.float32))
    W = torch.as_tensor(np.stack(Ws), device=cuda).contiguous()
    mask = torch.as_tensor(association.block_diag_mask(sizes), device=cuda)
    init = torch.as_tensor(association.default_init_factor(n, 32), device=cuda)
    assert als_kernel.launch_shape(n, 32).cluster == 16
    k = _assert_batched_equals_plain_and_solo(W, mask, init, max_iter=60, stable_iters=10)
    assert len(set(k.n_iters.tolist())) >= 3


def test_als_batched_wide_rig_frame0_to_the_cap(cuda):
    """The wide rig's own problems (PipelineConfig.wide(64): two clusters of
    N = 336, rank 32) on its scene's first frame, whose ALS runs to the
    100-iteration cap: every rounding counts there."""
    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    cfg = PipelineConfig.wide(64, max_frames=None)
    seq = synthetic_sequence(n_frames=1, n_people=10, n_views=64, seed=0, noise_px=1.0,
                             drop_prob=0.05, cfg=cfg)
    b = filter_bad_poses(seq.batch, cfg)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=cuda)
    kps = torch.as_tensor(b.kps[0], device=cuda)
    valid = torch.as_tensor(b.valid[0], device=cuda)
    W = torch.stack([tracker._spatial_similarity(ctx, kps, valid, view_idx=cl.views,
                                                 view_valid=cl.view_valid)[0]
                     for cl in ctx.clusters]).contiguous()
    assert tuple(W.shape) == (2, 336, 336) and ctx.cluster_init_A.shape[1] == 32
    k = _assert_batched_equals_plain_and_solo(
        W, ctx.cluster_diag_mask, ctx.cluster_init_A, max_iter=cfg.als_max_iter,
        stable_iters=cfg.als_stable_iters)
    assert k.n_iters.tolist() == [cfg.als_max_iter] * 2


def _spd_systems(cuda, T, D, seed):
    import chip_smoke  # beside tests/; on sys.path under `python -m pytest`

    return chip_smoke.spd_systems(torch, cuda, T, D, seed)


@pytest.mark.parametrize("T", [8, 16, 64])
def test_gj_kernel_equals_plain(cuda, T):
    A, b = _spd_systems(cuda, T, 68, T)
    before = (cuda_lib.GJ_SOLVE.launches, cuda_lib.GJ_SOLVE_GRID.launches)
    x = solve_kernel.batched_spd_solve(A, b)
    assert (cuda_lib.GJ_SOLVE.launches, cuda_lib.GJ_SOLVE_GRID.launches) == \
           (before[0] + 1, before[1])
    assert torch.equal(x, solve_kernel.gauss_jordan_plain(A, b))


@pytest.mark.parametrize("sizes,rank,max_iter", [((8, 6, 6, 6, 6, 6), 16, 60),
                                                ((16,) + (10,) * 32, 32, 20)])
def test_als_batched_kernel_equals_plain_and_solo(cuda, sizes, rank, max_iter):
    W, mask, init = _als_inputs(cuda, sizes, rank, 3, seed=1)
    kw = dict(max_iter=max_iter, stable_iters=10)
    before = (cuda_lib.ALS.launches, cuda_lib.ALS_BATCHED.launches)
    als_kernel.match_als_batched(W, mask, init, **kw)
    assert (cuda_lib.ALS.launches, cuda_lib.ALS_BATCHED.launches) == (before[0], before[1] + 1)
    _assert_batched_equals_plain_and_solo(W, mask, init, **kw)


@pytest.mark.parametrize("D", [1, 15, 16, 33, 68, 69, solve_kernel.MAX_D])
def test_gj_kernel_equals_plain_at_tile_edges(cuda, D):
    """Each thread of the 16 x 16 grid holds a P x P tile, P = ceil((D + 1)
    / 16): D = 1; 15 and 16 on both sides of the step from P = 1 to 2; 33,
    68 and 69 (P = 3, 5, 5); the register limit MAX_D (P = 12)."""
    A, b = _spd_systems(cuda, 3, D, D)
    assert torch.equal(solve_kernel.batched_spd_solve(A, b), solve_kernel.gauss_jordan_plain(A, b))


def _lm_inputs(cuda, T, R, D, seed):
    """Jaug, lam and frozen of chip_smoke.lm_inputs, a seeded fifth of the
    columns frozen."""
    import chip_smoke

    _, _, lam, frozen, Jaug = chip_smoke.lm_inputs(torch, cuda, T, R, D, seed)
    return Jaug, lam, frozen


def test_fused_normal_kernel_equals_plain(cuda):
    Jaug, lam, frozen = _lm_inputs(cuda, 16, 512, 68, 2)
    before = cuda_lib.FUSED_NORMAL_GJ.launches
    x = solve_kernel.fused_normal_solve(Jaug, lam, frozen)
    assert cuda_lib.FUSED_NORMAL_GJ.launches == before + 1
    assert torch.equal(x, solve_kernel.fused_normal_plain(Jaug, lam, frozen))


@pytest.mark.parametrize("R", [1, 37, 512])
def test_fused_normal_kernel_chunk_tails(cuda, R):
    """One row (only the first product of each entry), a chunk and a tail
    of 5 rows, and 16 full chunks of 32."""
    Jaug, lam, frozen = _lm_inputs(cuda, 4, R, 68, R)
    assert torch.equal(solve_kernel.fused_normal_solve(Jaug, lam, frozen),
                       solve_kernel.fused_normal_plain(Jaug, lam, frozen))


@pytest.mark.parametrize("D", [68, solve_kernel.FUSED_MAX_D])
def test_fused_normal_kernel_equals_plain_up_to_its_limit(cuda, D):
    Jaug, lam, frozen = _lm_inputs(cuda, 3, 96, D, D)
    assert bool((frozen == 1).any()) and bool((frozen == 0).any())
    assert torch.equal(solve_kernel.fused_normal_solve(Jaug, lam, frozen),
                       solve_kernel.fused_normal_plain(Jaug, lam, frozen))


@pytest.mark.parametrize("T", [1, 16])
def test_gj_one_program_false_launch_equals_plain(cuda, T):
    A, b = _spd_systems(cuda, T, 68, 16)
    before = (cuda_lib.GJ_SOLVE.launches, cuda_lib.GJ_SOLVE_GRID.launches)
    x = solve_kernel.batched_spd_solve(A, b, one_program=False)
    assert (cuda_lib.GJ_SOLVE.launches, cuda_lib.GJ_SOLVE_GRID.launches) == \
           (before[0], before[1] + 1)
    assert torch.equal(x, solve_kernel.gauss_jordan_plain(A, b))


def test_solve_limits_and_launch_shapes(cuda):
    """The wrappers' limits are the kernels'; the LM's D = 68 runs one
    16 x 16 block per system (B2) and a cluster of 4 blocks per slot (B4),
    16 of which the card holds at once, neither with local memory."""
    assert cuda_lib.GJ_LIB.lib().gj_max_d() == solve_kernel.MAX_D
    assert cuda_lib.FUSED_NORMAL_GJ_LIB.lib().fused_normal_max_d() == solve_kernel.FUSED_MAX_D
    gj = solve_kernel.gj_launch_shape(68)
    assert (gj.threads, gj.blocks_per_system, gj.local_bytes) == (256, 1, 0)
    fused = solve_kernel.fused_launch_shape(68)
    assert (fused.cluster, fused.threads, fused.local_bytes) == (4, 256, 0)
    assert fused.max_active_clusters >= 16
    for D in (solve_kernel.MAX_D, solve_kernel.FUSED_MAX_D):
        assert solve_kernel.gj_launch_shape(D).threads == 256
    assert solve_kernel.fused_launch_shape(solve_kernel.FUSED_MAX_D).cluster == 4


def test_solve_wrappers_raise_above_their_limits(cuda):
    D = solve_kernel.MAX_D + 1
    with pytest.raises(ValueError, match="MAX_D"):
        solve_kernel.batched_spd_solve(torch.zeros(1, D, D, device=cuda),
                                       torch.zeros(1, D, device=cuda))
    D = solve_kernel.FUSED_MAX_D + 1
    with pytest.raises(ValueError):
        solve_kernel.fused_normal_solve(torch.zeros(1, 8, D + 1, device=cuda),
                                        torch.zeros(1, device=cuda), torch.zeros(D, device=cuda))


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        solve_kernel.batched_spd_solve(torch.zeros(2, 4, 4, device=cuda, dtype=torch.float64),
                                       torch.zeros(2, 4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        als_kernel.match_als(torch.zeros(400, 400, device=cuda),
                             torch.zeros(400, 400, dtype=torch.bool, device=cuda),
                             torch.zeros(400, 8, device=cuda))
    with pytest.raises(ValueError):
        als_kernel.match_als_batched(torch.zeros(2, 400, 400, device=cuda),
                                     torch.zeros(400, 400, dtype=torch.bool, device=cuda),
                                     torch.zeros(400, 8, device=cuda))
    with pytest.raises(ValueError, match="MAX_RANK"):
        als_kernel.match_als(torch.zeros(64, 64, device=cuda),
                             torch.zeros(64, 64, dtype=torch.bool, device=cuda),
                             torch.zeros(64, 33, device=cuda))
    with pytest.raises(ValueError, match="MAX_RANK"):
        als_kernel.match_als_batched(torch.zeros(2, 64, 64, device=cuda),
                                     torch.zeros(64, 64, dtype=torch.bool, device=cuda),
                                     torch.zeros(64, 33, device=cuda))
    with pytest.raises(ValueError):
        solve_kernel.fused_normal_solve(torch.zeros(2, 8, 100, device=cuda),
                                        torch.zeros(2, device=cuda), torch.zeros(99, device=cuda))


def _default_scene_frame0(cuda):
    """PipelineConfig(n_views=5), the JAX package's default preset, on the
    first frame of synthetic_sequence(4 people, 5 views, seed 0)."""
    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    cfg = PipelineConfig(n_views=5, max_frames=None)
    seq = synthetic_sequence(n_frames=1, n_people=4, n_views=5, seed=0, cfg=cfg)
    return cfg, seq, filter_bad_poses(seq.batch, cfg), tracker


def test_als_kernel_at_the_default_preset(cuda):
    """B1 at the default preset's N = 66, rank 32 (one block) on its first
    frame's spatial-only problem, to its own iteration count under the
    1,000-iteration cap, and on a seeded problem of that shape."""
    cfg, seq, b, tracker = _default_scene_frame0(cuda)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=cuda)
    W, _ = tracker._spatial_similarity(ctx, torch.as_tensor(b.kps[0], device=cuda),
                                       torch.as_tensor(b.valid[0], device=cuda))
    assert tuple(ctx.init_A.shape) == (66, 32) and als_kernel.launch_shape(66, 32).cluster == 1
    kw = dict(max_iter=cfg.als_max_iter, stable_iters=cfg.als_stable_iters)
    problems = [(W.contiguous(), ctx.diag_mask, ctx.init_A),
                _als_inputs(cuda, (16,) + (10,) * 5, 32, 1, seed=7)]
    for W_, mask, init in problems:
        W_ = W_.reshape(66, 66)
        k = als_kernel.match_als(W_, mask, init, **kw)
        p = association.match_als(W_, mask, init, **kw)
        assert torch.equal(k.x_bin, p.x_bin) and int(k.n_iters) == int(p.n_iters)


def test_chol_lm_card_equals_cpu(cuda):
    """The default preset's staged Cholesky LM (f64 factor, the step
    rounded once to f32) from the same inputs on the card and the CPU: each
    person's cold solve from a geometric init, joints within 1e-3 m, and
    none of the port's kernels launched."""
    import numpy as np

    from multiview_motion_capture_torch.ops import ik
    from multiview_motion_capture_torch.ops.triangulate import triangulate_points

    cfg, seq, b, _ = _default_scene_frame0(cuda)
    T, V = 6, 5
    obs = np.zeros((T, V, 17, 3), np.float32)
    w = np.zeros((T, V), np.float32)
    for v in range(V):
        for p in range(seq.gt_slot_person.shape[2]):
            pid = seq.gt_slot_person[0, v, p]
            if pid >= 0 and b.valid[0, v, p]:
                obs[pid, v], w[pid, v] = b.kps[0, v, p], 1.0
    skel = ik.Skeleton.default()
    P = seq.cameras.P.cpu().to(torch.float64)
    K_inv = torch.linalg.inv(seq.cameras.K.cpu().to(torch.float64))
    tri = triangulate_points(P, K_inv, ik.add_mid_spine(torch.as_tensor(obs)).double(),
                             torch.as_tensor(w) > 0, cfg.triangulate_min_score, 2)
    tri = torch.nan_to_num(tri).clamp(-100.0, 100.0)
    init = ik.IkParams(root=(0.5 * (tri[:, ik._LHIP, :3] + tri[:, ik._RHIP, :3])).float(),
                       euler=ik.geometric_init(tri, skel.to(torch.float64)).float(),
                       side_lens=skel.side_bone_lens.expand(T, -1))
    kw = dict(n_iters=cfg.ik_cold_iters, eps=cfg.ik_proj_eps, lam0=cfg.ik_lm_damping_init,
              lam_up=cfg.ik_lm_damping_up, lam_down=cfg.ik_lm_damping_down,
              stages=cfg.ik_cold_stages, solver="chol", ftol=cfg.ik_ftol, xtol=cfg.ik_xtol)
    before = [k.launches for k in cuda_lib.ALL_KERNELS]
    _, j_card = ik.solve_two_stage(ik.IkParams(*(a.to(cuda) for a in init)),
                                   ik.Skeleton.default(device=cuda),
                                   torch.as_tensor(obs, device=cuda),
                                   torch.as_tensor(w, device=cuda), seq.cameras.P.to(cuda), **kw)
    _, j_cpu = ik.solve_two_stage(init, skel, torch.as_tensor(obs), torch.as_tensor(w),
                                  seq.cameras.P.cpu(), **kw)
    assert [k.launches for k in cuda_lib.ALL_KERNELS] == before
    assert torch.isfinite(j_card).all()
    np.testing.assert_allclose(j_card.cpu().numpy(), j_cpu.numpy(), atol=1e-3)


def _bottom_up_detector(dev, dtype=None):
    """The shipped PoseNet and appearance head on `dev` with the detect
    phase's bottom-up detector; `dtype` overrides the compute dtype."""
    import dataclasses

    import chip_smoke
    from multiview_motion_capture_torch.data.detect import make_bottom_up_detector
    from multiview_motion_capture_torch.models.checkpoint import (
        load_appearance_head,
        load_posenet,
    )
    from multiview_motion_capture_torch.models.pose_net import PoseNet

    mcfg, net = load_posenet(chip_smoke.CHECKPOINTS / "posenet_synth.npz", device=dev)
    _, head = load_appearance_head(chip_smoke.CHECKPOINTS / "appearance_head.npz", device=dev)
    if dtype is not None:
        mcfg = dataclasses.replace(mcfg, compute_dtype=dtype)
        n = PoseNet(mcfg).to(dev).eval()
        n.load_state_dict(net.state_dict())
        net = n
    return net, make_bottom_up_detector(mcfg, appearance_head=head, **chip_smoke.DETECTOR)


def _detect_frames():
    import chip_smoke

    return chip_smoke.detect_scene(2)[2]            # (2, 5, 192, 256, 3) uint8


def _run(detect, net, frames):
    return [[a.cpu().numpy() for a in detect(net, fr)] for fr in frames]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_detector_card_equals_cpu(cuda, dtype):
    """The bottom-up detector with the shipped weights on the card and the
    CPU: valid masks equal; in f32 centers equal and keypoints within
    chip_smoke.DETECT_F32_KPS_TOL_PX; in bf16 (cuDNN rounds its sums
    elsewhere) centers within one heatmap pixel and the 90th percentile of
    the keypoint differences at equal centers within the detect_parity
    phase's bound."""
    import chip_smoke

    frames = _detect_frames()
    dt = getattr(torch, dtype)
    card = _run(*reversed(_bottom_up_detector(cuda, dt)), frames)
    cpu = _run(*reversed(_bottom_up_detector("cpu", dt)), frames)
    cmp = chip_smoke.compare_detections([r[:3] for r in cpu], [r[:3] for r in card])
    assert cmp["valid_equal"] == cmp["images"], cmp
    if dtype == "float32":
        assert cmp["centers_equal"] == cmp["images"], cmp
        assert cmp["max_kps_diff_px"] <= chip_smoke.DETECT_F32_KPS_TOL_PX, cmp
    else:
        assert cmp["max_center_shift_px"] <= 4.0, cmp
        assert cmp["p90_kps_diff_px"] <= chip_smoke.DETECT_BF16_KPS_P90_TOL_PX, cmp


def test_detector_card_runs_bit_equal_and_uint8_equals_f32(cuda):
    """Two card runs give the same bits (cuDNN pinned to deterministic
    algorithms, no autotuning), and uint8 frames the bits of the same
    frames given as f32 (normalised as the detector does: times the f32
    reciprocal of 255)."""
    net, detect = _bottom_up_detector(cuda)
    frames = _detect_frames()
    a, b = _run(detect, net, frames), _run(detect, net, frames)
    c = _run(detect, net, frames.astype(np.float32) * np.float32(1 / 255))
    for x, y, z in zip(a, b, c):
        for u, v, w in zip(x, y, z):
            assert np.array_equal(u, v) and np.array_equal(u, w)


def test_frames_to_frame_batch_on_card_equals_detector_calls(cuda):
    """The prefetching loop (uploads on a side stream from pinned memory)
    gives exactly the detector's own outputs, frame by frame."""
    import chip_smoke
    from multiview_motion_capture_torch.config import PipelineConfig
    from multiview_motion_capture_torch.data.detect import frames_to_frame_batch

    net, detect = _bottom_up_detector(cuda)
    frames = _detect_frames()
    batch, app = frames_to_frame_batch(detect, net, frames, PipelineConfig(**chip_smoke.DETECT_CFG),
                                       collect_appearance=True)
    for f, (kps, _, valid, emb) in enumerate(_run(detect, net, frames)):
        assert np.array_equal(batch.kps[f], kps) and np.array_equal(batch.valid[f], valid)
        assert np.array_equal(app[f], emb)


# ---------------------------------------------------------------------------
# training.  f32: tests/test_torch_train.py's tolerances (losses 1e-5
# relative, gradients 1e-4 of each leaf's largest magnitude).  bf16: cuDNN
# and oneDNN round the bf16 sums at other places and three AdamW steps
# from a random init carry the difference on: losses within 2e-2 relative
# (chip_smoke.TRAIN_BF16_LOSS_RTOL; measured on the card 5.0e-3 and
# 6.6e-3), first-step gradient cosines >= 0.95 (measured 0.986)
# ---------------------------------------------------------------------------

TRAIN_SMALL = dict(img_hw=(64, 48), stage_features=(64, 64, 128), blocks_per_stage=1,
                   head_features=64, predict_center=True, predict_offsets=True)


def _train_batch(seed=0, n=4):
    from multiview_motion_capture_torch.models import pose_net as T

    rng = np.random.RandomState(seed)
    images = torch.as_tensor(rng.rand(n, 64, 48, 3).astype(np.float32))
    centers = torch.as_tensor(rng.uniform(2, [10, 14], size=(n, 2, 2)).astype(np.float32))
    kps = centers[:, :, None] + torch.as_tensor(rng.uniform(-3, 3, (n, 2, 17, 2)).astype(np.float32))
    valid = torch.ones(n, 2, dtype=torch.bool)
    jw = torch.ones(n, 2, 17)
    kt = (T.gaussian_heatmaps(kps.reshape(n, 34, 2), (16, 12)).reshape(n, 16, 12, 2, 17)
          .amax(dim=3))
    ct = T.center_targets(centers, valid.float(), (16, 12), 1.5)
    ot, om = T.offset_targets(centers, kps, valid, jw, (16, 12))
    return images, torch.cat([kt, ct[..., None]], -1), ot, om


def _train_run(dev, dtype, steps=3, seed=0):
    """`steps` AdamW steps of the bottom-up step at the SMALL width from one
    seeded init -> (losses, first-step gradients by leaf)."""
    from multiview_motion_capture_torch.data.detect_train import make_train_step
    from multiview_motion_capture_torch.models.optim import AdamW
    from multiview_motion_capture_torch.models.pose_net import PoseNetConfig, init_posenet

    cfg = PoseNetConfig(compute_dtype=dtype, **TRAIN_SMALL)
    net = init_posenet(cfg, torch.Generator().manual_seed(seed)).to(dev)
    step = make_train_step(cfg, net, AdamW(net.parameters(), 1e-3))
    batch = [t.to(dev) for t in _train_batch(seed)]
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(*batch)))
        if i == 0:
            grads = {n: p.grad.detach().cpu().numpy() for n, p in net.named_parameters()}
    return losses, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_card_equals_cpu(cuda, dtype):
    import chip_smoke

    dt = getattr(torch, dtype)
    card, card_g = _train_run(cuda, dt)
    cpu, cpu_g = _train_run("cpu", dt)
    rel = max(chip_smoke.rel_diffs(card, cpu))
    agree = chip_smoke.grad_agreement(cpu_g, card_g)
    if dtype == "float32":
        assert rel <= 1e-5 and agree["max_rel_err"] <= 1e-4, (rel, agree)
    else:
        assert rel <= 2e-2 and agree["min_cos"] >= 0.95, (rel, agree)


def test_train_step_card_runs_bit_equal_deterministic(cuda):
    """Two card runs of the step under torch.use_deterministic_algorithms
    (cuDNN already pinned to deterministic algorithms): bit-equal losses and
    gradients, in the shipped bf16 compute and in f32."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for dt in (torch.bfloat16, torch.float32):
            (a, ga), (b, gb) = _train_run(cuda, dt), _train_run(cuda, dt)
            assert a == b and all(np.array_equal(ga[k], gb[k]) for k in ga)
    finally:
        torch.use_deterministic_algorithms(before)


def test_generate_samples_targets_card_equal_cpu(cuda):
    from multiview_motion_capture_torch.data.detect_train import generate_samples
    from multiview_motion_capture_torch.data.render import RenderConfig

    for va in (False, True):
        kw = dict(n_frames=2, n_views=3, n_people_range=(3, 5), visibility_aware=va)
        card = generate_samples([5, 6], RenderConfig(hw=(96, 128)), device=cuda, **kw)
        cpu = generate_samples([5, 6], RenderConfig(hw=(96, 128)), device="cpu", **kw)
        assert np.array_equal(card.images, cpu.images) and np.array_equal(card.off_mask,
                                                                            cpu.off_mask)
        for f in ("heat_tgt", "off_tgt"):
            np.testing.assert_allclose(getattr(card, f), getattr(cpu, f), atol=1e-6, rtol=0)


def test_head_step_card_equals_cpu(cuda):
    from multiview_motion_capture_torch.models.appearance_net import (
        AppearanceHeadConfig,
        init_head,
        make_train_step,
    )
    from multiview_motion_capture_torch.models.optim import AdamW

    rng = np.random.RandomState(0)
    x = rng.randn(40, 51).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    labels = np.repeat(np.arange(8), 5).astype(np.int32)
    runs = []
    for dev in (cuda, "cpu"):
        head = init_head(torch.Generator().manual_seed(0), AppearanceHeadConfig(), device=dev)
        step = make_train_step(head, AdamW(head.parameters(), 1e-3), tau=0.1)
        e, lab = torch.as_tensor(x, device=dev), torch.as_tensor(labels, device=dev)
        runs.append(([float(step(e, lab)) for _ in range(5)],
                     [p.detach().cpu().numpy() for p in head.parameters()]))
    (lc, pc), (lq, pq) = runs
    np.testing.assert_allclose(lc, lq, rtol=1e-5)
    for a, b in zip(pc, pq):
        assert np.abs(a - b).max() <= 0.05 * 1e-3


def _every_kernel_once(dev):
    """B1 (N 336, a cluster of 16), B3, B2, B5 and B4 once each on `dev`:
    each launch's result against its plain version."""
    W, mask, init = _als_inputs(dev, (16,) + (10,) * 32, 32, 2, seed=9)
    kw = dict(max_iter=20, stable_iters=10)
    one = als_kernel.match_als(W[0], mask, init, **kw)
    assert torch.equal(one.x_bin, association.match_als(W[0], mask, init, **kw).x_bin)
    _assert_batched_equals_plain_and_solo(W, mask, init, **kw)
    A, g = _spd_systems(dev, 16, 68, seed=3)
    for one_program in (True, False):
        assert torch.equal(solve_kernel.batched_spd_solve(A, g, one_program),
                           solve_kernel.gauss_jordan_plain(A, g))
    Jaug, lam, frozen = _lm_inputs(dev, 16, 512, 68, 2)
    assert torch.equal(solve_kernel.fused_normal_solve(Jaug, lam, frozen),
                       solve_kernel.fused_normal_plain(Jaug, lam, frozen))


def test_kernels_launch_from_worker_threads(cuda):
    """Every wrapper from four threads at once (as `parallel.streams`
    launches), each on a stream of its own: results equal the plain
    versions and the launch counts add up (the increment is locked)."""
    import threading

    before = {k.name: k.launches for k in cuda_lib.ALL_KERNELS}
    errors = []

    def worker():
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                _every_kernel_once(cuda)
                torch.cuda.current_stream(cuda).synchronize()
        except BaseException as e:   # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    # per thread: B1 three times (once alone, then as the solo reference of
    # each of B3's two problems), B3 once, B2 and B5 once each, B4 once
    want = {"als": 3, "als_batched": 1, "gj_solve": 1, "gj_solve_grid": 1,
            "fused_normal_gj": 1}
    assert {k.name: k.launches - before[k.name] for k in cuda_lib.ALL_KERNELS} == {
        n: 4 * c for n, c in want.items()}


def test_kernels_launch_on_a_second_device():
    """Tensors on cuda:1 launch there while cuda:0 is current: the kernels'
    shared-memory and cluster attributes are set on the tensor's device."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    cuda_lib.build_all()
    torch.cuda.set_device(0)
    _every_kernel_once(torch.device("cuda", 1))
    assert torch.cuda.current_device() == 0


# ---------------------------------------------------------------------------
# the run programs (scripts/torch_bench_detect.py, examples/torch_e2e_*.py)
# ---------------------------------------------------------------------------

def _program(folder, name):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / folder))
    return __import__(name)


def test_bench_detect_upload_modes_give_equal_detections(cuda):
    """torch_bench_detect hands the bottom-up detector each frame three
    ways: copied from pageable memory in the loop, staged on the card, and
    copied from pinned memory on a side stream ahead of the forward
    (`FrameUploader`).  The detections are the same bits."""
    from multiview_motion_capture_torch.data.detect import FrameUploader

    bd = _program("scripts", "torch_bench_detect")
    cfg, _, _, _, images = bd.make_frames(3, 3, 5)
    d = bd.detectors(cfg, cuda)
    detect, net = d["detect_bu"], d["bu_net"]
    u8 = (images * 255).astype(np.uint8)

    def host(out):
        return [a.cpu().numpy() for a in out]

    pageable = [detect(net, torch.as_tensor(u8[f], device=cuda)) for f in range(len(u8))]
    staged_t = torch.as_tensor(u8, device=cuda)
    staged = [detect(net, staged_t[f]) for f in range(len(u8))]
    up = FrameUploader(cuda)
    overlapped, nxt = [], up.start(u8[0])
    for f in range(len(u8)):
        cur = up.take(nxt)
        if f + 1 < len(u8):
            nxt = up.start(u8[f + 1])
        overlapped.append(detect(net, cur))
    assert any(bool(o[2].any()) for o in pageable)
    for a, b, c in zip(pageable, staged, overlapped):
        for x, y, z in zip(host(a), host(b), host(c)):
            assert np.array_equal(x, y) and np.array_equal(x, z)


def test_e2e_synthetic_card_runs_bit_equal(cuda, monkeypatch):
    """Two card runs of the synthetic example (a short training from the
    same seeds, detection, tracking) give the same detections, tracklets
    and numbers, bit for bit: cuDNN runs deterministic algorithms
    (`utils.precision.high_precision`) and every other step is
    deterministic."""
    from multiview_motion_capture_torch import pipeline

    ex = _program("examples", "torch_e2e_synthetic")
    runs = []
    real = pipeline.run

    def recording(batch, *args, **kwargs):
        res = real(batch, *args, **kwargs)
        runs[-1]["batch"], runs[-1]["tracklets"] = batch, res.tracklets
        return res

    monkeypatch.setattr(pipeline, "run", recording)
    for _ in range(2):
        runs.append({})
        runs[-1]["out"] = ex.main(steps=20, n_frames=4, device=cuda)
    a, b = runs
    assert a["out"] == b["out"]
    assert np.array_equal(a["batch"].kps, b["batch"].kps)
    assert np.array_equal(a["batch"].valid, b["batch"].valid)
    assert len(a["tracklets"]) == len(b["tracklets"]) > 0
    for s, t in zip(a["tracklets"], b["tracklets"]):
        assert s.frame_idxs == t.frame_idxs and np.array_equal(s.poses_3d, t.poses_3d)


def test_profile_report_reads_the_card_trace_as_the_profiler_does(cuda):
    """torch_profile_bench reads a card trace from the profiler's raw records;
    the profiler's own parse (`prof.events()`) of the same trace gives the
    same kernels, counts and durations (3 SHELF_BENCH frames, B1 and B2
    among them)."""
    import dataclasses

    from multiview_motion_capture_torch import tracker
    from multiview_motion_capture_torch.config import SHELF_BENCH
    from multiview_motion_capture_torch.data.ingest import filter_bad_poses
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    pb = _program("scripts", "torch_profile_bench")
    cfg = dataclasses.replace(SHELF_BENCH, max_frames=None)
    seq = synthetic_sequence(cfg=cfg, n_frames=3, n_people=3, n_views=5, seed=2)
    b = filter_bad_poses(seq.batch, cfg)
    ctx = tracker.TrackerContext.build(seq.cameras, cfg, device=cuda)
    kps, valid = torch.as_tensor(b.kps, device=cuda), torch.as_tensor(b.valid, device=cuda)
    tracker.run_offline(ctx, kps, valid)
    prof, _, _ = pb.trace(lambda: tracker.run_offline(ctx, kps, valid), cuda)
    ours, theirs = {}, {}
    for name, ns in pb.device_events(prof, cuda):
        t, n = ours.get(pb.kernel_label(name), (0.0, 0))
        ours[pb.kernel_label(name)] = (t + ns, n + 1)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = theirs.get(pb.kernel_label(e.name), (0.0, 0))
            theirs[pb.kernel_label(e.name)] = (t + e.time_range.elapsed_us() * 1e3, n + 1)
    assert pb.B_KERNELS["als_kernel"] in ours and pb.B_KERNELS["gj_solve_kernel"] in ours
    assert sorted(ours) == sorted(theirs)
    for k, (ns, n) in ours.items():
        assert n == theirs[k][1] and abs(ns - theirs[k][0]) <= n, k
