"""The port's identity post-passes against the JAX package on the CPU, on
the same input tracklets: the Hungarian, the bone prior, the identity
metrics, the re-ID merge and the crossing repair.

Each case builds its tracklets once (numpy, the port's FK, or a small JAX
run), hands the very same arrays to both packages, and requires the
results to be equal: assignments, merge pairs, crossing logs and every
field of every output tracklet bit for bit, metrics exactly.  The JAX
package's Hungarian is its C++ library when that builds; where it does not,
the JAX package falls back to scipy, whose ties break its own way, and the
Hungarian case then holds the port's optimal cost to scipy's instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from multiview_motion_capture_torch import crossings as t_crossings
from multiview_motion_capture_torch import eval as t_eval
from multiview_motion_capture_torch import reid as t_reid
from multiview_motion_capture_torch.models import bone_prior as t_bone
from multiview_motion_capture_torch.ops.fk import Skeleton, forward_kinematics
from multiview_motion_capture_torch.pose_def import BASIC_18_PARENTS, basic18_side_bone_maps
from multiview_motion_capture_torch.tracker import Tracklet as TTracklet
from multiview_motion_capture_torch.utils.hungarian import hungarian as t_hungarian
from multiview_motion_capture_tpu import crossings as j_crossings
from multiview_motion_capture_tpu import eval as j_eval
from multiview_motion_capture_tpu import reid as j_reid
from multiview_motion_capture_tpu.config import PipelineConfig as JConfig
from multiview_motion_capture_tpu.data.ingest import filter_bad_poses as j_filter
from multiview_motion_capture_tpu.data.synthetic import synthetic_sequence as j_synth
from multiview_motion_capture_tpu.models import bone_prior as j_bone
from multiview_motion_capture_tpu.tracker import (
    TrackerContext as JContext,
    Tracklet as JTracklet,
    assemble_tracklets as j_assemble,
    run_offline as j_run_offline,
)
from multiview_motion_capture_tpu.utils import native
from tests.torch_study_scene import one_thread


# ---------------------------------------------------------------------------
# helpers: the same tracklets for both packages, compared field by field

def _both(tracklets):
    """(JAX tracklets, port tracklets) holding the very same arrays."""
    fields = [f.name for f in dataclasses.fields(TTracklet)]
    port = [TTracklet(**{k: getattr(t, k) for k in fields}) for t in tracklets]
    jax_ = [JTracklet(**{k: getattr(t, k) for k in fields}) for t in tracklets]
    return jax_, port


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for torch and the BLAS and OpenMP pools, at a lower CPU
    priority: the suite runs several workers at once
    (tests/torch_study_scene.one_thread)."""
    with one_thread():
        yield


def _assert_tracklets_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in dataclasses.fields(TTracklet):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if f.name == "frame_idxs":
                assert [int(q) for q in u] == [int(q) for q in v]
            elif u is None or v is None:
                assert u is None and v is None, f.name
            else:
                u, v = np.asarray(u), np.asarray(v)
                assert u.dtype == v.dtype and np.array_equal(u, v, equal_nan=True), f.name


# ---------------------------------------------------------------------------
# Hungarian

def _cost_matrices(kind: str):
    rng = np.random.default_rng({"random": 0, "tied": 1, "big_padded": 2}[kind])
    out = []
    for _ in range(40):
        n, m = (int(x) for x in rng.integers(1, 13, 2))
        if kind == "random":
            c = rng.random((n, m))
        elif kind == "tied":      # eval.identity_metrics: negated integer overlaps
            c = np.zeros((max(n, m),) * 2)
            c[:n, :m] = -rng.integers(0, 4, (n, m))
        else:                     # reid.match_fragments: gated entries at BIG
            c = np.where(rng.random((n, m)) < 0.3, rng.random((n, m)), 1e9)
        out += [c, c.T.copy()]
    return out


@pytest.mark.parametrize("kind", ["random", "tied", "big_padded"])
def test_hungarian_matches_the_cpp_solver(kind):
    for c in _cost_matrices(kind):
        rows, cols = t_hungarian(c)
        assert len(rows) == min(c.shape) and np.all(np.diff(rows) > 0)
        if native.native_available():
            jr, jc = native.hungarian(c)
            assert np.array_equal(rows, jr) and np.array_equal(cols, jc), c
        else:
            # the JAX package runs scipy here: only the optimum is comparable
            sr, sc = linear_sum_assignment(c)
            assert c[rows, cols].sum() == pytest.approx(c[sr, sc].sum(), rel=1e-12, abs=1e-9)


# ---------------------------------------------------------------------------
# bone prior and config copies

def test_bone_prior_matches_jax():
    rng = np.random.RandomState(0)
    poses = rng.standard_normal((7, 18, 3))
    jp, tp = j_bone.fit_bone_prior(poses), t_bone.fit_bone_prior(poses)
    for f in ("mean", "std", "parents"):
        assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
    for a, b in zip(jp.side_prior(), tp.side_prior()):
        assert np.array_equal(a, b)
    assert np.array_equal(j_bone.bone_direction_stats(poses), t_bone.bone_direction_stats(poses))
    parents = rng.randint(0, 5, 18)
    assert np.array_equal(j_bone.fit_bone_prior(poses, parents).std,
                          t_bone.fit_bone_prior(poses, parents).std)
    side, mu, sd = rng.random(11), rng.random(11), rng.random(11) + 0.1
    assert np.array_equal(np.asarray(j_bone.prior_residual(side, mu, sd, 0.5)),
                          t_bone.prior_residual(side, mu, sd, 0.5))


@pytest.mark.parametrize("pair", [(j_reid.ReidConfig, t_reid.ReidConfig),
                                  (j_crossings.CrossingConfig, t_crossings.CrossingConfig)],
                         ids=["ReidConfig", "CrossingConfig"])
def test_config_copies_field_for_field(pair):
    j, t = pair
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(t)]
    assert jf == tf


# ---------------------------------------------------------------------------
# re-ID: tests/test_reid.py's scenarios, with the port's FK

SKEL = Skeleton.default(dtype=torch.float64)


def _fragment(track_id, frames, root_fn, side_scale=1.0, seed=0, app=None):
    """A fragment whose poses are FK output: its bone lengths are one
    person's throughout (float32, as the tracker emits them)."""
    rng = np.random.RandomState(seed)
    frames = list(frames)
    L = len(frames)
    side = SKEL.side_bone_lens.numpy() * side_scale
    roots = np.stack([root_fn(f) for f in frames]).astype(np.float32)
    eulers = 0.05 * rng.standard_normal((L, 18, 3)).astype(np.float32)
    joints = forward_kinematics(SKEL, torch.as_tensor(roots, dtype=torch.float64),
                                torch.as_tensor(eulers, dtype=torch.float64),
                                torch.as_tensor(side).expand(L, 11))
    return TTracklet(
        track_id=track_id, frame_idxs=frames, roots=roots, eulers=eulers,
        side_lens=np.tile(side.astype(np.float32), (L, 1)),
        poses_3d=joints.numpy().astype(np.float32),
        poses_score=np.ones((L, 18), dtype=np.float32),
        matched_pose=np.zeros((L, 5), dtype=np.int32),
        app=None if app is None else _noisy_app(app, L, seed),
    )


def _noisy_app(ident, n, seed, noise=0.02):
    rng = np.random.RandomState(100 + seed)
    a = ident[None, :] + noise * rng.randn(n, len(ident))
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _walk(start, vel):
    return lambda f: np.asarray(start) + f * np.asarray(vel)


def _small_jax_run(seed, hole=None, use_ik=False, n_frames=14, varied=False):
    """Raw tracklets of a small JAX tracking run (2 or 3 people, 4-5 views):
    the detection filter and `run_offline`, as its `pipeline.run` does."""
    if varied:
        cfg = JConfig(n_views=5, max_people=4, max_tracks=6, als_max_iter=100,
                      ik_warm_stages=1, ik_solver="gj", max_frames=None)
        seq = j_synth(n_frames=n_frames, n_people=3, n_views=5, cfg=cfg, seed=seed,
                      drop_prob=0.0, noise_px=1.0, person_scale_std=0.1,
                      bone_jitter_std=0.04)
    else:
        cfg = JConfig(n_views=4, max_people=6, max_tracks=8, max_frames=None)
        seq = j_synth(n_frames=n_frames, n_people=2, n_views=4, cfg=cfg, drop_prob=0.0,
                      seed=seed, min_person_distance=1.5)
    if hole is not None:
        seq.batch.valid[hole] = False
        seq.gt_slot_person[hole] = -1
    batch = j_filter(seq.batch, cfg)
    ctx = JContext.build(seq.cameras, cfg, use_ik=use_ik)
    _, out = j_run_offline(ctx, jnp.asarray(batch.kps), jnp.asarray(batch.valid))
    return seq, j_assemble(jax.device_get(out))


def _reid_scenario(name):
    """(tracklets, ReidConfig or None) of one scenario."""
    walk = _walk([0, 0, 1.0], [0.01, 0, 0])
    if name == "same_person_fragments":
        return [_fragment(0, range(0, 30), walk, seed=1),
                _fragment(1, range(35, 80), _walk([3.0, 3.0, 1.0], [0, 0.01, 0]),
                          side_scale=1.3, seed=3),
                _fragment(3, range(40, 70), walk, seed=2)], None
    if name == "chains":
        return [_fragment(i, range(40 * i, 40 * i + 30), _walk([0, 0, 1.0], [0.008, 0, 0]),
                          seed=i) for i in range(3)], None
    if name == "bone_gate":
        return [_fragment(0, range(0, 30), walk, seed=1),
                _fragment(1, range(40, 70), walk, side_scale=1.6, seed=2)], \
            t_reid.ReidConfig(bone_sigma_floor_m=0.005)
    if name == "gap_and_overlap":
        return [_fragment(0, range(0, 30), walk, seed=1),
                _fragment(2, range(200, 230), _walk([2.0, 0, 1.0], [0.01, 0, 0]), seed=1),
                _fragment(3, range(20, 50), _walk([0.2, 0, 1.0], [0.01, 0, 0]), seed=1)], None
    if name == "trajectory_extrapolation":
        vel = [0.05, 0.0, 0.0]
        return [_fragment(0, range(0, 30), _walk([0, 0, 1.0], vel), seed=4),
                _fragment(1, range(55, 85), _walk([0, 0, 1.0], vel), seed=5)], None
    if name.startswith("bone_beats_trajectory"):
        end = np.asarray([0.29, 0, 1.0])
        tl = [_fragment(0, range(0, 30), walk, seed=1),
              _fragment(1, range(40, 70), _walk(end + [0.0, 0.25, 0], [0.01, 0, 0]), seed=2),
              _fragment(2, range(40, 70), _walk(end + [0.0, 0.10, 0], [0.01, 0, 0]),
                        side_scale=1.15, seed=3)]
        cfg = t_reid.ReidConfig(min_frames_for_prior=10**9) if name.endswith("only") else None
        return tl, cfg
    if name == "triangulation_mode":
        return _small_jax_run(seed=6, hole=7)[1], None
    if name == "varied_skeletons":
        return [t for t in _small_jax_run(seed=0, use_ik=True, n_frames=25, varied=True)[1]
                if len(t) >= 2], None
    if name == "strong_bone_and_appearance":
        # both bone and appearance evidence strong: the position gate (0.82 m
        # at the 11-frame gap) widens by strong_bone_pos_factor squared, to
        # 5.125 m; widened once (2.05 m) it would reject the 2.9 m jump
        ident = np.random.RandomState(9).randn(8)
        ident /= np.linalg.norm(ident)
        return [_fragment(0, range(0, 30), walk, seed=1, app=ident),
                _fragment(1, range(40, 70), _walk([2.9, 0, 1.0], [0.01, 0, 0]), seed=2,
                          app=ident)], None
    raise KeyError(name)


REID_SCENARIOS = ["same_person_fragments", "chains", "bone_gate", "gap_and_overlap",
                  "triangulation_mode", "trajectory_extrapolation", "bone_beats_trajectory",
                  "bone_beats_trajectory_only", "varied_skeletons", "strong_bone_and_appearance"]


@pytest.mark.parametrize("name", REID_SCENARIOS)
def test_reid_matches_jax(name):
    tracklets, cfg = _reid_scenario(name)
    jcfg = None if cfg is None else j_reid.ReidConfig(**dataclasses.asdict(cfg))
    jt, tt = _both(tracklets)
    pairs = t_reid.match_fragments(tt, cfg)
    assert pairs == j_reid.match_fragments(jt, jcfg)
    _assert_tracklets_equal(t_reid.merge_tracklets(tt, cfg), j_reid.merge_tracklets(jt, jcfg))
    # what each scenario is about holds in the port too
    expect = {"same_person_fragments": [(0, 2)], "chains": [(0, 1), (1, 2)],
              "bone_gate": [], "gap_and_overlap": [], "trajectory_extrapolation": [(0, 1)],
              "bone_beats_trajectory": [(0, 1)], "bone_beats_trajectory_only": [(0, 2)],
              "strong_bone_and_appearance": [(0, 1)]}
    if name in expect:
        assert pairs == expect[name]
    if name == "triangulation_mode":
        assert len(tt) == 4 and len(t_reid.merge_tracklets(tt, cfg)) == 2


def test_reid_gate_widens_twice_with_strong_bone_and_appearance():
    """The squared widening is what merges the strong-evidence scenario:
    with the factor's square root it stays apart."""
    tracklets, _ = _reid_scenario("strong_bone_and_appearance")
    frags = [t_reid._fragment_features(t, i, t_reid.ReidConfig())
             for i, t in enumerate(tracklets)]
    assert np.isfinite(t_reid._pair_cost(*frags, t_reid.ReidConfig()))
    once = t_reid.ReidConfig(strong_bone_pos_factor=2.5 ** 0.5 * 1.0001)
    assert not np.isfinite(t_reid._pair_cost(*frags, once))
    jfrags = [j_reid._fragment_features(t, i, j_reid.ReidConfig())
              for i, t in enumerate(_both(tracklets)[0])]
    assert j_reid._pair_cost(*jfrags, j_reid.ReidConfig()) == \
        t_reid._pair_cost(*frags, t_reid.ReidConfig())


# ---------------------------------------------------------------------------
# crossings: tests/test_crossings.py's scenes

F, T_CROSS, D = 100, 50, 8


def _person_paths():
    t = np.arange(F, dtype=np.float64)
    pa = np.stack([0.05 * (t - T_CROSS), np.zeros(F), np.ones(F)], axis=1)
    pb = np.stack([-0.05 * (t - T_CROSS), 0.02 * np.ones(F), np.ones(F)], axis=1)
    return pa, pb


def _ident_app(seed):
    v = np.random.RandomState(seed).randn(D)
    return v / np.linalg.norm(v)


def _skel_poses(roots, sides):
    parents = np.asarray(BASIC_18_PARENTS)
    _, side_to_full = basic18_side_bone_maps()
    dirs = np.random.RandomState(3).randn(18, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    poses = np.zeros((len(roots), 18, 3))
    poses[:, 0] = roots
    pending = list(range(1, 18))
    while pending:
        j = pending.pop(0)
        p = int(parents[j])
        if p != 0 and p in pending:
            pending.append(j)
            continue
        poses[:, j] = poses[:, p] + sides[:, side_to_full[j], None] * dirs[j]
    return poses


def _crossing_tracklet(tid, roots, app_rows=None, sides=None):
    L = len(roots)
    if sides is not None:
        poses = _skel_poses(np.asarray(roots, np.float64), np.asarray(sides))
    else:
        poses = np.zeros((L, 18, 3))
        poses[:, :, :] = roots[:, None, :]
    return TTracklet(
        track_id=tid, frame_idxs=list(range(L)), roots=np.asarray(roots, np.float64),
        eulers=np.zeros((L, 18, 3)),
        side_lens=np.asarray(sides) if sides is not None else np.zeros((L, 11)),
        poses_3d=poses, poses_score=np.ones((L, 18)),
        matched_pose=np.zeros((L, 5), np.int32), app=app_rows)


def _crossed(swap: bool, app=True, sides=False, far=False):
    pa, pb = _person_paths()
    if far:
        pb = pb + np.array([0.0, 5.0, 0.0])
    ia, ib = _ident_app(0), _ident_app(1)
    rng = np.random.RandomState(7)

    def noisy(ident, n):
        a = ident[None, :] + 0.05 * rng.randn(n, D)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    sa = np.tile(np.linspace(0.30, 0.40, 11), (F, 1))
    sb = np.tile(np.linspace(0.20, 0.28, 11), (F, 1))
    if swap:
        c = T_CROSS
        r0, r1 = np.concatenate([pa[:c], pb[c:]]), np.concatenate([pb[:c], pa[c:]])
        a0 = np.concatenate([noisy(ia, c), noisy(ib, F - c)])
        a1 = np.concatenate([noisy(ib, c), noisy(ia, F - c)])
        s0, s1 = np.concatenate([sa[:c], sb[c:]]), np.concatenate([sb[:c], sa[c:]])
    else:
        r0, r1, a0, a1, s0, s1 = pa, pb, noisy(ia, F), noisy(ib, F), sa, sb
    return [_crossing_tracklet(0, r0, a0 if app else None, s0 if sides else None),
            _crossing_tracklet(1, r1, a1 if app else None, s1 if sides else None)]


def _oscillating():
    pa, pb = _person_paths()
    ia, ib = _ident_app(0), _ident_app(1)
    rng = np.random.RandomState(11)

    def noisy(ident, n):
        a = ident[None, :] + 0.05 * rng.randn(n, D)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    runs = [(ia, pa), (ib, pb), (ia, pa), (ib, pb), (ia, pa)]
    roots = np.concatenate([p[i * 20:(i + 1) * 20] for i, (_, p) in enumerate(runs)])
    app = np.concatenate([noisy(ident, 20) for ident, _ in runs])
    return [_crossing_tracklet(0, roots, app)]


def _frame_apps_as_stranded(t):
    """The JAX package's stranded `_frame_apps` body (crossings.py:409-419),
    as a function: frame -> unit per-frame appearance row."""
    out = {}
    if t.app is None:
        return out
    a = np.asarray(t.app, dtype=np.float64)
    fr = np.asarray(t.frame_idxs)
    n = np.linalg.norm(a, axis=-1)
    for k in np.flatnonzero(n > 0.5):
        out[int(fr[k])] = a[k] / n[k]
    return out


CROSSING_SCENES = {
    "swapped_appearance": (lambda: _crossed(True), {}),
    "correct_crossing": (lambda: _crossed(False), {}),
    "swapped_bones_no_appearance": (lambda: _crossed(True, app=False, sides=True), {}),
    "never_close": (lambda: _crossed(False, app=False, far=True), {}),
    "no_evidence_channel": (lambda: _crossed(True, app=False), {}),
    "short_evidence_window": (lambda: _crossed(True), {"min_side_frames": 60}),
    "oscillating": (_oscillating, {}),
    "smooth_swapped": (lambda: _crossed(True), {"smooth": True, "cut_gate": 10.0}),
    "smooth_correct": (lambda: _crossed(False), {"smooth": True, "cut_gate": 10.0}),
}


@pytest.mark.parametrize("name", list(CROSSING_SCENES))
def test_crossings_match_jax(name, monkeypatch):
    make, over = CROSSING_SCENES[name]
    jt, tt = _both(make())
    if over.get("smooth"):
        # the JAX module lacks `_frame_apps`'s def line: hand it the body
        monkeypatch.setattr(j_crossings, "_frame_apps", _frame_apps_as_stranded, raising=False)
    tcfg = t_crossings.CrossingConfig(**over)
    jcfg = j_crossings.CrossingConfig(**over)
    t_out, t_log = t_crossings.resolve_crossings(tt, tcfg, return_log=True)
    j_out, j_log = j_crossings.resolve_crossings(jt, jcfg, return_log=True)
    assert t_log == j_log
    _assert_tracklets_equal(t_out, j_out)
    tc, tc_log = t_crossings.cut_identity_breaks(_both(make())[1], tcfg, return_log=True)
    jc, jc_log = j_crossings.cut_identity_breaks(_both(make())[0], jcfg, return_log=True)
    assert tc_log == jc_log
    _assert_tracklets_equal(tc, jc)
    # what each scene is about holds in the port too
    if name == "swapped_appearance":
        assert len([e for e in t_log if "cut_track" in e]) == 2
    elif name == "swapped_bones_no_appearance":
        assert [e["swap"] for e in t_log if e.get("swap")] == [True]
    elif name in ("never_close", "short_evidence_window"):
        assert t_log == []
    elif name == "oscillating":
        assert len(tc) == 5
    elif name.startswith("smooth"):
        assert any(e.get("smooth") for e in t_log)
    if name in ("correct_crossing", "no_evidence_channel", "smooth_correct"):
        assert not any(e.get("swap") for e in t_log)


def test_crossings_then_merge_matches_jax():
    """The pipeline's order on the swapped crossing: cut, then merge."""
    jt, tt = _both(_crossed(True))
    t_out = t_reid.merge_tracklets(t_crossings.resolve_crossings(tt))
    j_out = j_reid.merge_tracklets(j_crossings.resolve_crossings(jt))
    _assert_tracklets_equal(t_out, j_out)
    assert len(t_out) == 2


# ---------------------------------------------------------------------------
# identity metrics

def _fragmented(tracklets, every=5):
    """Hand-fragmented copies: each tracklet cut into `every`-frame pieces
    with fresh ids, plus one piece whose matched detections are moved to
    another slot (a wrong-person stretch)."""
    out, tid = [], 100
    for t in tracklets:
        for s in range(0, len(t), every):
            sl = slice(s, s + every)
            out.append(TTracklet(
                track_id=tid, frame_idxs=list(t.frame_idxs[sl]), roots=t.roots[sl],
                eulers=t.eulers[sl], side_lens=t.side_lens[sl], poses_3d=t.poses_3d[sl],
                poses_score=t.poses_score[sl], matched_pose=t.matched_pose[sl], app=None))
            tid += 1
    out[1] = dataclasses.replace(out[1], matched_pose=np.where(
        out[1].matched_pose >= 0, (out[1].matched_pose + 1) % 6, -1).astype(np.int32))
    return out


@pytest.fixture(scope="module")
def identity_run():
    return _small_jax_run(seed=2, hole=8, n_frames=16)


@pytest.mark.parametrize("variant", ["raw", "fragmented", "merged"])
def test_identity_metrics_match_jax(identity_run, variant):
    seq, raw = identity_run
    tracklets = {"raw": raw, "fragmented": _fragmented(raw),
                 "merged": j_reid.merge_tracklets(raw)}[variant]
    jt, tt = _both(tracklets)
    for min_views in (2, 3):
        m_t = t_eval.identity_metrics(tt, seq.gt_slot_person, min_views=min_views)
        m_j = j_eval.identity_metrics(jt, seq.gt_slot_person, min_views=min_views)
        assert m_t.as_dict() == m_j.as_dict()
    for i in (0, len(tt) - 1):
        assert np.array_equal(t_eval._tracklet_gt_ids(tt[i], seq.gt_slot_person),
                              j_eval._tracklet_gt_ids(jt[i], seq.gt_slot_person))
    gt = seq.gt_3d
    assert t_eval.mpjpe_vs_ground_truth(tt, gt) == j_eval.mpjpe_vs_ground_truth(jt, gt)
    jm = (np.arange(17), np.arange(17))
    assert t_eval.mpjpe_vs_ground_truth(tt, gt, jm) == j_eval.mpjpe_vs_ground_truth(jt, gt, jm)
    other = _both(_fragmented(raw, every=3))
    assert (t_eval.run_consistency_mpjpe(tt, other[1])
            == j_eval.run_consistency_mpjpe(jt, other[0]))
    if variant == "raw":
        m = t_eval.identity_metrics(tt, seq.gt_slot_person)
        assert m.n_gt_identities == 2 and m.id_switches == 2 and m.idf1 < 0.8
    if variant == "merged":
        m = t_eval.identity_metrics(tt, seq.gt_slot_person)
        assert m.id_switches == 0 and m.idf1 > 0.95
