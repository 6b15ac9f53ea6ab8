"""Tracklet re-identification: merge fragments of the same person.

Port of `multiview_motion_capture_tpu/reid.py` (host numpy, float64, as
there).  The tracker's lifecycle kills a track at its first missed frame,
so a long run fragments each person into many tracklets.  This offline
pass merges fragments by the identity evidence the tracker already
computes:

- bone lengths: each fragment fits a bone prior over its own frames
  (`models.bone_prior.fit_bone_prior`) and a candidate continuation is
  scored with the Mahalanobis residual (`models.bone_prior.prior_residual`);
- appearance (runs with `Tracklet.app`): whole-fragment mean embeddings,
  self-normalised by each fragment's own first-half / second-half cosine;
- trajectory: a fragment's root is extrapolated at constant velocity
  across the death -> spawn gap and compared with the candidate's start.

Merging is a bipartite assignment (`utils.hungarian`, the C++ solver's
assignments) between fragment ends and temporally compatible fragment
starts, with hard gates on gap length, predicted-position distance, bone
Mahalanobis and appearance; chains are composed with union-find.  The pass
only relabels and concatenates: per-frame poses are untouched.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from multiview_motion_capture_torch.models.bone_prior import fit_bone_prior, prior_residual
from multiview_motion_capture_torch.tracker import Tracklet
from multiview_motion_capture_torch.utils.hungarian import hungarian


@dataclasses.dataclass(frozen=True)
class ReidConfig:
    max_gap_frames: int = 45        # longest death->spawn hole to bridge
    max_position_m: float = 0.6     # gate on extrapolated-root distance
    position_slack_m_per_frame: float = 0.02  # extra allowance per gap frame
    max_bone_mahalanobis: float = 4.0  # gate on bone-length residual RMS
    # a track's final frames often drift as its views disappear, so the
    # position gate can reject a continuation the bone evidence proves.
    # When BOTH fragments' bone statistics agree this strongly (measured on
    # Shelf: same-person RMS ~0.3 sigma vs 0.65+ for different people), the
    # position gate is widened by the factor below.
    strong_bone_mahalanobis: float = 0.5
    strong_bone_pos_factor: float = 2.5
    bone_sigma_floor_m: float = 0.02   # std floor: long stable tracks would
                                       # otherwise reject everything
    velocity_window: int = 5        # frames used for the velocity estimate
    w_position: float = 1.0         # cost weights (gates do the real work)
    w_bone: float = 0.1
    min_frames_for_prior: int = 2   # fragments shorter than this skip the
                                    # bone gate (their stats mean nothing)
    # appearance evidence: when tracklets carry
    # per-frame matched-detection embeddings (Tracklet.app, appearance runs)
    # the merge compares whole-fragment mean embeddings.  The score is
    # SELF-NORMALIZED — d_app = max(0, self_cos - pair_cos), where self_cos
    # is the fragment's own first-half vs second-half cosine — so no
    # extractor-dependent absolute threshold is needed (raw descriptors sit
    # at cross-person cos ~0.83, the trained head at ~0.2; both give
    # d_app ~0 for same-person and >> gate for cross-person).
    app_gate: float = 0.12          # reject continuation when d_app exceeds
    strong_app_d: float = 0.04      # d_app below this = strong identity
                                    # evidence -> widen the position gate
                                    # (same factor as strong bones)
    w_app: float = 2.0


@dataclasses.dataclass
class _Fragment:
    idx: int
    t0: int
    t1: int
    root_start: np.ndarray
    root_end: np.ndarray
    vel_start: np.ndarray   # m/frame near the start
    vel_end: np.ndarray     # m/frame near the end
    bone_mean: Optional[np.ndarray]  # (11,)
    bone_std: Optional[np.ndarray]   # (11,)
    side_mean: Optional[np.ndarray]  # (11,) raw mean of solved side lengths
    app_start: Optional[np.ndarray] = None  # unit window-mean embedding
    app_end: Optional[np.ndarray] = None
    app_self: float = 1.0            # cos(app_start, app_end): the fragment's
                                     # own appearance consistency (the
                                     # same-person cosine floor)


def _root_of(t: Tracklet, i: int) -> np.ndarray:
    if t.roots is not None and len(t.roots):
        return np.asarray(t.roots[i], dtype=np.float64)
    # triangulation-only tracklets: hip midpoint of the COCO pose
    p = np.asarray(t.poses_3d[i], dtype=np.float64)
    return 0.5 * (p[11] + p[12]) if p.shape[0] == 17 else 0.5 * (p[1] + p[4])


def _fragment_features(t: Tracklet, idx: int, cfg: ReidConfig) -> _Fragment:
    frames = np.asarray(t.frame_idxs)
    L = len(frames)
    k = min(cfg.velocity_window, L)
    r0, rk = _root_of(t, 0), _root_of(t, k - 1)
    re, rs = _root_of(t, L - 1), _root_of(t, L - k)
    span_s = max(int(frames[k - 1] - frames[0]), 1)
    span_e = max(int(frames[L - 1] - frames[L - k]), 1)
    vel_start = (rk - r0) / span_s if k > 1 else np.zeros(3)
    vel_end = (re - rs) / span_e if k > 1 else np.zeros(3)

    bone_mean = bone_std = side_mean = None
    # bone evidence only exists for IK tracklets: triangulation-mode output
    # carries all-zero side_lens and COCO+spine-ordered points (NOT BASIC_18
    # skeleton order), so fitting a skeleton bone prior there would produce
    # garbage statistics that wrongly reject every continuation — such
    # fragments fall back to the trajectory gate alone.
    is_ik = (
        t.side_lens is not None
        and len(t.side_lens)
        and bool(np.any(np.asarray(t.side_lens)))
    )
    if L >= cfg.min_frames_for_prior and is_ik:
        side_mean = np.asarray(t.side_lens, dtype=np.float64).mean(axis=0)
        if t.poses_3d.shape[1] == 18:
            prior = fit_bone_prior(np.asarray(t.poses_3d, dtype=np.float64))
            m, s = prior.side_prior()
            bone_mean = m
            bone_std = np.maximum(s, cfg.bone_sigma_floor_m)
    app_start = app_end = None
    app_self = 1.0
    if t.app is not None and len(t.app):
        a = np.asarray(t.app, dtype=np.float64)
        good = np.flatnonzero(np.linalg.norm(a, axis=-1) > 0.5)
        if len(good):

            def win_mean(rows):
                m = a[rows].mean(axis=0)
                n = np.linalg.norm(m)
                return m / n if n > 1e-6 else None

            # WHOLE-fragment mean, not a boundary window: fragments die
            # DURING crossings, so the frames adjacent to the boundary are
            # exactly the contaminated ones (the mis-association being
            # bridged); identity is constant within a fragment, and the
            # full mean dilutes the contaminated tail (measured: boundary
            # windows under-merge, IDF1 0.855 -> 0.772 on the 10x10
            # extractor-grade crowd)
            app_start = app_end = win_mean(good)
            h = len(good) // 2
            if h:
                m1, m2 = win_mean(good[:h]), win_mean(good[h:])
                if m1 is not None and m2 is not None:
                    app_self = float(np.dot(m1, m2))
    return _Fragment(
        idx=idx, t0=int(frames[0]), t1=int(frames[-1]),
        root_start=r0, root_end=re,
        vel_start=vel_start, vel_end=vel_end,
        bone_mean=bone_mean, bone_std=bone_std, side_mean=side_mean,
        app_start=app_start, app_end=app_end, app_self=app_self,
    )


def _pair_cost(a: _Fragment, b: _Fragment, cfg: ReidConfig) -> float:
    """Cost of continuing fragment `a` with fragment `b`; inf if gated out."""
    gap = b.t0 - a.t1
    if gap < 1 or gap > cfg.max_gap_frames:
        return np.inf

    # bone-length identity evidence (Mahalanobis under a's fitted prior and
    # b's, symmetrized); None when either side has no meaningful statistics
    d_bone = 0.0
    n_tests = 0
    for x, y in ((a, b), (b, a)):
        if x.bone_mean is not None and y.side_mean is not None:
            r = np.asarray(prior_residual(y.side_mean, x.bone_mean, x.bone_std))
            d_bone += float(np.sqrt(np.mean(r * r)))
            n_tests += 1
    if n_tests:
        d_bone /= n_tests
        if d_bone > cfg.max_bone_mahalanobis:
            return np.inf

    # appearance identity evidence: window-mean embedding at a's end vs b's
    # start, self-normalized by each fragment's own internal consistency
    # (see ReidConfig) — None when either side has no embedded frames
    d_app = None
    if a.app_end is not None and b.app_start is not None:
        pair_cos = float(np.dot(a.app_end, b.app_start))
        self_floor = min(a.app_self, b.app_self)
        d_app = max(0.0, self_floor - pair_cos)
        if d_app > cfg.app_gate:
            return np.inf

    # trajectory gate: forward and backward constant-velocity extrapolation;
    # widened when the bone OR appearance evidence is strong (see ReidConfig)
    fwd = a.root_end + a.vel_end * gap
    bwd = b.root_start - b.vel_start * gap
    d_pos = min(
        float(np.linalg.norm(fwd - b.root_start)),
        float(np.linalg.norm(bwd - a.root_end)),
        float(np.linalg.norm(a.root_end - b.root_start)),
    )
    gate = cfg.max_position_m + cfg.position_slack_m_per_frame * gap
    # kept as the JAX package has it: with strong bone AND strong appearance
    # evidence the gate widens twice (strong_bone_pos_factor squared), so
    # both packages make the same merges
    if n_tests and d_bone < cfg.strong_bone_mahalanobis:
        gate *= cfg.strong_bone_pos_factor
    if d_app is not None and d_app < cfg.strong_app_d:
        gate *= cfg.strong_bone_pos_factor
    if d_pos > gate:
        return np.inf

    return (cfg.w_position * d_pos + cfg.w_bone * d_bone
            + (cfg.w_app * d_app if d_app is not None else 0.0))


def match_fragments(
    tracklets: List[Tracklet], cfg: Optional[ReidConfig] = None
) -> List[Tuple[int, int]]:
    """Return (end_fragment_idx, start_fragment_idx) continuation pairs."""
    cfg = cfg or ReidConfig()
    frags = [_fragment_features(t, i, cfg) for i, t in enumerate(tracklets)]
    n = len(frags)
    if n < 2:
        return []
    cost = np.full((n, n), np.inf, dtype=np.float64)
    for a in frags:
        for b in frags:
            if a.idx != b.idx:
                cost[a.idx, b.idx] = _pair_cost(a, b, cfg)
    if not np.isfinite(cost).any():
        return []

    # exact assignment on the finite entries (one continuation per fragment
    # end, one predecessor per fragment start)
    BIG = 1e9
    rows, cols = hungarian(np.where(np.isfinite(cost), cost, BIG))
    return [
        (int(r), int(c)) for r, c in zip(rows, cols) if cost[int(r), int(c)] < BIG
    ]


def merge_tracklets(
    tracklets: List[Tracklet], cfg: Optional[ReidConfig] = None
) -> List[Tracklet]:
    """Merge re-identified fragments into whole-identity tracklets.

    Returns new tracklets sorted by descending length; merged tracklets keep
    the earliest fragment's track_id.  Per-frame data is concatenated in
    frame order and never modified.
    """
    pairs = match_fragments(tracklets, cfg)

    parent = list(range(len(tracklets)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    groups = {}
    for i in range(len(tracklets)):
        groups.setdefault(find(i), []).append(i)

    merged: List[Tracklet] = []
    for members in groups.values():
        members = sorted(members, key=lambda i: tracklets[i].frame_idxs[0])
        if len(members) == 1:
            merged.append(tracklets[members[0]])
            continue
        parts = [tracklets[i] for i in members]
        merged.append(
            Tracklet(
                track_id=min(p.track_id for p in parts),
                frame_idxs=[f for p in parts for f in p.frame_idxs],
                roots=np.concatenate([p.roots for p in parts]),
                eulers=np.concatenate([p.eulers for p in parts]),
                side_lens=np.concatenate([p.side_lens for p in parts]),
                poses_3d=np.concatenate([p.poses_3d for p in parts]),
                poses_score=np.concatenate([p.poses_score for p in parts]),
                matched_pose=np.concatenate([p.matched_pose for p in parts]),
                app=(np.concatenate([p.app for p in parts])
                     if all(p.app is not None for p in parts) else None),
            )
        )
    return sorted(merged, key=lambda t: -len(t))
