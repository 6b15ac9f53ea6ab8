"""Hindsight resolution of track crossings.

Port of `multiview_motion_capture_tpu/crossings.py` (host numpy, float64,
as there), with the same decisions and logs.  The tracker's per-frame
association commits identity decisions the instant two people cross; when
it binds track A to person B's detections mid-crossing, the track carries
the wrong identity onward, an in-fragment switch that the fragment merge
(`reid`, which bridges death -> spawn holes) cannot see.  This pass repairs
identity with hindsight:

1. `cut_identity_breaks`: per track, 2-means identity clustering of the
   per-frame matched-detection embeddings (`Tracklet.app`), cut at the
   label-run transitions, with a self-normalised separation gate; the
   appearance-aware merge then reassembles the pure pieces.
2. Event detection: pairs of concurrently updated tracklets whose 3D root
   distance dips below `radius_m` for a contiguous interval.
3. Per event without appearance evidence: the 2x2 head/tail continuation
   hypotheses scored on bone length (symmetrised Mahalanobis under fitted
   priors, `models.bone_prior`) and velocity direction; the tails are
   swapped when `swapped` wins by `min_margin`.  With `smooth=True` (off by
   default) a two-state Viterbi over the interval re-decides every frame
   from the pre-event appearance anchors first.
4. Identity-break cut at t* for a spanning track whose own appearance
   disagrees across the interval.

Poses are moved between tracks, never modified.

The JAX package's module lost the `def` line of `_frame_apps` (its body
stands after `cut_identity_breaks`'s return), so there `smooth=True` raises
`NameError`; here the function has its `def` back and the option runs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from multiview_motion_capture_torch.models.bone_prior import fit_bone_prior, prior_residual
from multiview_motion_capture_torch.tracker import Tracklet


@dataclasses.dataclass(frozen=True)
class CrossingConfig:
    radius_m: float = 0.8        # root distance defining "crossing"
    window: int = 12             # evidence frames on each side of the event
    min_side_frames: int = 3     # head/tail must have this many evidence rows
    min_margin: float = 0.10     # swapped must beat straight by this much
    w_app: float = 1.0           # appearance-cosine weight
    w_bone: float = 0.25         # bone-Mahalanobis weight (per sigma RMS)
    w_vel: float = 0.05          # velocity-direction weight
    bone_sigma_floor_m: float = 0.02
    # identity-break CUT (the dominant crowd pattern is NOT the clean 2x2
    # live swap — it is a track dying inside the crossing while another
    # continues onto the wrong person; the continuing track then carries an
    # in-fragment switch no merge pass can see).  When a track that spans a
    # crossing interval disagrees with ITSELF across it — self-normalized
    # appearance drop d = min(purity_pre, purity_post) - cos(pre, post)
    # above `cut_gate` — the track is cut at t*, and the (appearance-aware)
    # reid merge reassembles the now-pure pieces with hindsight evidence.
    # Cuts are near-reversible: a cut whose sides agree is re-joined by
    # reid's strong-appearance widening.
    cut_gate: float = 0.03      # 2-means separation above which a track's
                                # rows carry two identities.  Swept on the
                                # 10x10 extractor-grade crowd: 0.03 -> 39
                                # cuts, post-merge IDF1 0.953/42 sw (the
                                # oracle-cut bound is 0.963); 0.06 -> 0.911;
                                # 0.12 -> 0.815.  Self-normalized, and the
                                # high-noise distinct-identity scene shows
                                # no over-cut damage (merge re-joins pure
                                # pieces).  The JAX package's docs/PERF.md.
    max_events: int = 256        # safety bound on the resolve loop
    # sliding-window joint re-assignment over the crossing interval, with
    # hindsight: the measured crowd switch
    # structure is per-frame OSCILLATION — a track alternates between two
    # people's detections for tens of frames while they walk together (10x10
    # study: e.g. one track with 30 straight/swapped runs).  Tail swaps fix
    # at most the net displacement; the oscillation itself needs every frame
    # of the interval re-decided JOINTLY.  `_smooth_interval` runs a
    # two-state Viterbi over the interval frames — state z_t in {straight,
    # swapped}, emission = appearance cosine of each track's per-frame
    # matched-detection embedding against the PRE-event anchor signatures
    # (the only uncontaminated identity evidence), transition = `switch_cost`
    # per z change (oscillation is physically implausible; the true parse
    # changes z at most once or twice per encounter).  Frames with z_t =
    # swapped exchange their rows between the two tracklets; the final state
    # decides the tails.  Enabled whenever both tracks carry appearance.
    smooth: bool = False         # MEASURED NEGATIVE on the 10x10 extractor-
                                 # grade crowd (docs/PERF.md): post-merge
                                 # IDF1 0.739 vs the 0.768 control, and the
                                 # GT-ORACLE version of pairwise interval
                                 # re-assignment bounds the whole approach
                                 # at +0.007 IDF1 — crossing rows are not
                                 # pairwise-exchangeable here.  Kept for
                                 # scenes with genuinely exchangeable 2x2
                                 # crossings; `cut_identity_breaks` is the
                                 # measured repair path.
    switch_cost: float = 0.35    # Viterbi z-transition penalty (cos units;
                                 # per-frame same-vs-cross gap is ~0.17 at
                                 # extractor grade, so ~2 frames of evidence
                                 # overcome one transition)
    smooth_min_gain: float = 0.0  # total-path margin required over the
                                  # all-straight path before applying
    smooth_min_anchor_sep: float = 0.02  # anchors must be at least this far
                                         # apart (purity floor - cross cos)
                                         # — two same-looking people carry
                                         # no per-frame signal to smooth on


@dataclasses.dataclass
class _Segment:
    rows: np.ndarray             # row indices into the tracklet
    app_mean: Optional[np.ndarray]
    bone_mean: Optional[np.ndarray]   # fitted prior mean (11,)
    bone_std: Optional[np.ndarray]
    side_mean: Optional[np.ndarray]   # raw mean side lengths (11,)
    vel: Optional[np.ndarray]         # (3,) m/frame over the segment
    app_purity: float = 1.0           # first-half vs second-half cosine of
                                      # the segment's own app rows (identity
                                      # self-consistency floor)


def _roots(t: Tracklet) -> np.ndarray:
    if t.roots is not None and len(t.roots) and np.any(np.asarray(t.roots)):
        return np.asarray(t.roots, dtype=np.float64)
    p = np.asarray(t.poses_3d, dtype=np.float64)
    if p.shape[1] == 17:
        return 0.5 * (p[:, 11] + p[:, 12])
    return 0.5 * (p[:, 1] + p[:, 4])


def _segment(t: Tracklet, rows: np.ndarray, cfg: CrossingConfig) -> _Segment:
    rows = np.asarray(rows, dtype=int)
    app_mean = None
    app_purity = 1.0
    if t.app is not None and len(rows):
        a = np.asarray(t.app, dtype=np.float64)[rows]
        good = np.flatnonzero(np.linalg.norm(a, axis=-1) > 0.5)  # unit rows

        def unit_mean(sel):
            m = a[sel].mean(axis=0)
            n = np.linalg.norm(m)
            return m / n if n > 1e-6 else None

        if len(good):
            app_mean = unit_mean(good)
            h = len(good) // 2
            if h:
                m1, m2 = unit_mean(good[:h]), unit_mean(good[h:])
                if m1 is not None and m2 is not None:
                    app_purity = float(np.dot(m1, m2))
    bone_mean = bone_std = side_mean = None
    if len(rows) >= 2:
        sides = np.asarray(t.side_lens, dtype=np.float64)[rows]
        if np.any(sides):  # all-zero = triangulation mode, no bone evidence
            side_mean = sides.mean(axis=0)
            if t.poses_3d.shape[1] == 18:
                prior = fit_bone_prior(
                    np.asarray(t.poses_3d, dtype=np.float64)[rows])
                m, s = prior.side_prior()
                bone_mean = m
                bone_std = np.maximum(s, cfg.bone_sigma_floor_m)
    vel = None
    if len(rows) >= 2:
        r = _roots(t)[rows]
        fr = np.asarray(t.frame_idxs)[rows].astype(np.float64)
        span = max(fr[-1] - fr[0], 1.0)
        vel = (r[-1] - r[0]) / span
    return _Segment(rows=rows, app_mean=app_mean, bone_mean=bone_mean,
                    bone_std=bone_std, side_mean=side_mean, vel=vel,
                    app_purity=app_purity)


def _channel_scores(h: _Segment, t: _Segment, cfg: CrossingConfig):
    """Per-channel continuation scores (None = channel unmeasurable)."""
    app = None
    if h.app_mean is not None and t.app_mean is not None:
        app = float(np.dot(h.app_mean, t.app_mean))
    bone = None
    n_tests = 0
    acc = 0.0
    for x, y in ((h, t), (t, h)):
        if x.bone_mean is not None and y.side_mean is not None:
            r = np.asarray(prior_residual(y.side_mean, x.bone_mean, x.bone_std))
            acc += float(np.sqrt(np.mean(r * r)))
            n_tests += 1
    if n_tests:
        bone = -acc / n_tests
    vel = None
    if h.vel is not None and t.vel is not None:
        nh, nt = np.linalg.norm(h.vel), np.linalg.norm(t.vel)
        if nh > 1e-9 and nt > 1e-9:
            vel = float(np.dot(h.vel, t.vel) / (nh * nt))
    return {"app": app, "bone": bone, "vel": vel}


def _decide(heads, tails, cfg: CrossingConfig) -> Tuple[bool, dict]:
    """True if the swapped pairing wins.  heads/tails: [a, b] segments."""
    pairs = {
        (hi, ti): _channel_scores(heads[hi], tails[ti], cfg)
        for hi in (0, 1) for ti in (0, 1)
    }
    weights = {"app": cfg.w_app, "bone": cfg.w_bone, "vel": cfg.w_vel}
    straight = swapped = 0.0
    used = []
    for ch, w in weights.items():
        if w == 0.0 or any(pairs[k][ch] is None for k in pairs):
            continue  # a channel votes only when measurable for all 4 pairs
        used.append(ch)
        straight += w * (pairs[(0, 0)][ch] + pairs[(1, 1)][ch])
        swapped += w * (pairs[(0, 1)][ch] + pairs[(1, 0)][ch])
    # velocity alone is too weak to overrule geometry's own decision
    decisive = [c for c in used if c != "vel"]
    do_swap = bool(decisive) and (swapped - straight) > cfg.min_margin
    return do_swap, {"channels": used, "straight": round(straight, 4),
                     "swapped": round(swapped, 4)}


def _detect_events(tracklets: List[Tracklet], cfg: CrossingConfig):
    """(t_star, i, j, t_enter, t_exit) crossing events, time-ordered."""
    events = []
    info = []
    for t in tracklets:
        fr = np.asarray(t.frame_idxs)
        info.append((fr, {int(f): k for k, f in enumerate(fr)}, _roots(t)))
    for i in range(len(tracklets)):
        fr_i, map_i, r_i = info[i]
        for j in range(i + 1, len(tracklets)):
            fr_j, map_j, r_j = info[j]
            common = np.asarray(
                sorted(set(map_i) & set(map_j)), dtype=int)
            if len(common) < 2:
                continue
            d = np.linalg.norm(
                r_i[[map_i[int(f)] for f in common]]
                - r_j[[map_j[int(f)] for f in common]], axis=-1)
            close = d < cfg.radius_m
            if not close.any():
                continue
            # maximal runs of close common frames
            edges = np.flatnonzero(np.diff(close.astype(np.int8)))
            starts = [0] if close[0] else []
            starts += [int(e) + 1 for e in edges if close[int(e) + 1]]
            ends = [int(e) for e in edges if close[int(e)]]
            if close[-1]:
                ends.append(len(close) - 1)
            for s, e in zip(starts, ends):
                t_enter, t_exit = int(common[s]), int(common[e])
                spans_i = fr_i[0] < t_enter and fr_i[-1] > t_exit
                spans_j = fr_j[0] < t_enter and fr_j[-1] > t_exit
                # at least one track must pass THROUGH the interval: a pure
                # death->spawn handoff has no in-fragment identity risk and
                # is reid's case, not ours
                if not (spans_i or spans_j):
                    continue
                k = s + int(np.argmin(d[s:e + 1]))
                events.append((int(common[k]), i, j, t_enter, t_exit))
    return sorted(events)


def _unit(v: np.ndarray) -> Optional[np.ndarray]:
    n = np.linalg.norm(v)
    return v / n if n > 1e-6 else None


def _two_means_labels(apps: np.ndarray, gate: float,
                      iters: int = 10) -> Optional[np.ndarray]:
    """2-means on the unit sphere over a track's appearance rows.

    Returns per-row labels (n,) int8 when the two clusters are separated by
    more than `gate` — i.e. the track's rows carry TWO identities — else
    None.  Separation statistic is self-normalized: (mean cosine of rows to
    their own center) - cos(center_1, center_2); a single-identity track
    splits only its noise, leaving the statistic near 0 regardless of the
    extractor's absolute cosine scale.

    Windowed change-point detection was measured insufficient here: the
    dominant in-fragment switch pattern is per-frame OSCILLATION between
    two people's detections, which window means blend away (gate sweeps
    topped at post-merge IDF1 0.823 vs the 0.963 oracle-cut bound).
    Per-row cluster labels recover the oscillation runs directly.
    """
    n = len(apps)
    # farthest-pair init: the row most distant from the mean, then the row
    # most distant from that row
    m = _unit(apps.mean(axis=0))
    if m is None:
        return None
    c1 = apps[int(np.argmin(apps @ m))]
    c2 = apps[int(np.argmin(apps @ c1))]
    lab = np.zeros(n, dtype=np.int8)
    for _ in range(iters):
        s1 = apps @ c1
        s2 = apps @ c2
        new = (s2 > s1).astype(np.int8)
        if np.all(new == lab) and _ > 0:
            break
        lab = new
        if lab.all() or not lab.any():
            return None  # degenerate: one cluster
        u1, u2 = _unit(apps[lab == 0].mean(axis=0)), _unit(
            apps[lab == 1].mean(axis=0))
        if u1 is None or u2 is None:
            return None
        c1, c2 = u1, u2
    own = np.where(lab == 0, apps @ c1, apps @ c2)
    sep = float(own.mean()) - float(np.dot(c1, c2))
    if sep <= gate:
        return None
    # median-of-3 smoothing: single-frame label flips are extractor noise,
    # not 1-frame identity visits
    sm = lab.copy()
    for i in range(1, n - 1):
        sm[i] = np.median(lab[i - 1:i + 2])
    sm[0], sm[-1] = sm[1], sm[-2]
    if sm.all() or not sm.any():
        return None
    return sm


def cut_identity_breaks(
    tracklets: List[Tracklet],
    cfg: Optional[CrossingConfig] = None,
    return_log: bool = False,
):
    """Cut every tracklet at its appearance identity change-points.

    The measured structure of crowd identity damage (10x10 extractor-grade
    study, docs/PERF.md): the per-frame parse binds a live track to the
    WRONG person's detections mid-crossing and the track carries the new
    identity onward — an in-fragment switch.  A GT decomposition on that
    scene bounds the repair stages: oracle pairwise interval re-assignment
    between crossing tracks gains +0.007 post-merge IDF1 (the rows are NOT
    pairwise-exchangeable), while oracle change-point CUTS followed by the
    shipped appearance-aware reid merge reach 0.963 (vs 0.970 with an
    oracle merge) from the 0.768 control.  So the merge already carries its
    weight; the missing stage is cutting.  This pass approximates the
    oracle cut from appearance alone: per track, recursively split at the
    largest self-normalized windowed cosine drop above `cut_gate`
    (`_change_points`).  Over-cutting is cheap by construction — the merge
    re-joins pure same-person pieces (measured 124 oracle fragments ->
    IDF1 0.963); under-cutting is what costs.
    """
    cfg = cfg or CrossingConfig()
    log = []
    next_id = max((t.track_id for t in tracklets), default=0) + 1
    pending = list(tracklets)
    out: List[Tracklet] = []
    rounds = 0
    while pending and rounds < 6:  # re-check fragments: a track can pass
        rounds += 1                # through MORE than two identities
        nxt: List[Tracklet] = []
        for t in pending:
            if t.app is None or len(t) < 2 * cfg.min_side_frames:
                out.append(t)
                continue
            a = np.asarray(t.app, dtype=np.float64)
            nn = np.linalg.norm(a, axis=-1)
            valid = np.flatnonzero(nn > 0.5)
            if len(valid) < 2 * cfg.min_side_frames:
                out.append(t)
                continue
            apps = a[valid] / nn[valid, None]
            lab = _two_means_labels(apps, cfg.cut_gate)
            if lab is None:
                out.append(t)
                continue
            splits = list(np.flatnonzero(np.diff(lab) != 0) + 1)
            if not splits:
                out.append(t)
                continue
            fr = np.asarray(t.frame_idxs)
            rest = t
            for p in splits:  # frame numbers are global, so successive
                              # cuts of `rest` at ascending frames align
                t_cut = int(fr[valid[p] - 1])
                head, tail = _cut(rest, t_cut, next_id)
                log.append({"cut_track": t.track_id, "t_cut": t_cut,
                            "n_head": len(head), "n_tail": len(tail)})
                next_id += 1
                nxt.append(head)
                rest = tail
            nxt.append(rest)
        pending = nxt
    out.extend(pending)
    out = sorted(out, key=lambda t: -len(t))
    return (out, log) if return_log else out


def _frame_apps(t: Tracklet) -> dict:
    """frame -> unit per-frame appearance row (only frames with a valid
    embedded observation)."""
    out = {}
    if t.app is None:
        return out
    a = np.asarray(t.app, dtype=np.float64)
    fr = np.asarray(t.frame_idxs)
    n = np.linalg.norm(a, axis=-1)
    for k in np.flatnonzero(n > 0.5):
        out[int(fr[k])] = a[k] / n[k]
    return out


def _smooth_interval(
    a: Tracklet, b: Tracklet,
    anchor_a: np.ndarray, anchor_b: np.ndarray,
    t_enter: int, t_exit: int, cfg: CrossingConfig,
):
    """Two-state Viterbi joint re-assignment over the crossing interval.

    State z_t: 0 = straight (each track keeps its rows at frame t),
    1 = swapped (the two tracks exchange their rows at frame t).  Emission:
    appearance cosine of each track's per-frame matched-detection embedding
    against the PRE-event anchor signatures.  Transitions cost
    `cfg.switch_cost` and are only allowed up to one frame past t_exit —
    once the people separate, the per-frame association is unambiguous
    again, so a later identity change is not physical.  The final state
    decides the tails.

    Returns (swap_frames, tail_swap, gain) or None when the interval
    carries no appearance evidence.  `gain` is the cost margin of the best
    path over the all-straight path.
    """
    apps_a = _frame_apps(a)
    apps_b = _frame_apps(b)
    fa = np.asarray(a.frame_idxs)
    fb = np.asarray(b.frame_idxs)
    hi = t_exit + cfg.window
    frames = sorted(set(fa[(fa >= t_enter) & (fa <= hi)])
                    | set(fb[(fb >= t_enter) & (fb <= hi)]))
    if not frames:
        return None

    # emission[k][z]: negative summed anchor cosine at frames[k] under z
    em = np.zeros((len(frames), 2))
    n_obs = 0
    for k, f in enumerate(frames):
        oa, ob = apps_a.get(f), apps_b.get(f)
        for z in (0, 1):
            s = 0.0
            if oa is not None:
                s += float(np.dot(oa, anchor_a if z == 0 else anchor_b))
            if ob is not None:
                s += float(np.dot(ob, anchor_b if z == 0 else anchor_a))
            em[k, z] = -s
        n_obs += (oa is not None) + (ob is not None)
    if n_obs < 2 * cfg.min_side_frames:
        return None

    # Viterbi: entering the interval already swapped costs one transition
    cost = np.array([em[0, 0], em[0, 1] + cfg.switch_cost])
    back = np.zeros((len(frames), 2), dtype=np.int8)
    for k in range(1, len(frames)):
        allow_switch = frames[k] <= t_exit + 1
        new = np.empty(2)
        for z in (0, 1):
            stay = cost[z]
            move = cost[1 - z] + cfg.switch_cost if allow_switch else np.inf
            if move < stay:
                new[z] = move + em[k, z]
                back[k, z] = 1
            else:
                new[z] = stay + em[k, z]
        cost = new
    z_end = int(np.argmin(cost))
    path = np.empty(len(frames), dtype=np.int8)
    z = z_end
    for k in range(len(frames) - 1, -1, -1):
        path[k] = z
        if back[k, z]:
            z = 1 - z
    gain = float(em[:, 0].sum() - cost[z_end])
    swap_frames = [f for k, f in enumerate(frames)
                   if path[k] == 1 and f <= t_exit]
    tail_swap = bool(path[-1] == 1)
    return swap_frames, tail_swap, gain


def _relabel(a: Tracklet, b: Tracklet,
             swap_at: np.ndarray) -> Tuple[Tracklet, Tracklet]:
    """Exchange the two tracklets' rows at the given frame numbers (rows
    present in only one track move to the other)."""
    fa = np.asarray(a.frame_idxs)
    fb = np.asarray(b.frame_idxs)
    ma = np.isin(fa, swap_at)
    mb = np.isin(fb, swap_at)

    def rebuild(keep_t, keep_m, take_t, take_m):
        frames = np.concatenate([np.asarray(keep_t.frame_idxs)[keep_m],
                                 np.asarray(take_t.frame_idxs)[take_m]])
        order = np.argsort(frames, kind="stable")

        def cat(f):
            x, y = getattr(keep_t, f), getattr(take_t, f)
            if x is None or y is None:
                return None
            return np.concatenate(
                [np.asarray(x)[keep_m], np.asarray(y)[take_m]])[order]

        return Tracklet(
            track_id=keep_t.track_id,
            frame_idxs=list(frames[order]),
            roots=cat("roots"), eulers=cat("eulers"),
            side_lens=cat("side_lens"), poses_3d=cat("poses_3d"),
            poses_score=cat("poses_score"), matched_pose=cat("matched_pose"),
            app=cat("app"),
        )

    return rebuild(a, ~ma, b, mb), rebuild(b, ~mb, a, ma)


def _cut(t: Tracklet, t_cut: int, tail_id: int) -> Tuple[Tracklet, Tracklet]:
    """Split a tracklet at t_cut (head keeps the id, tail gets `tail_id`)."""
    fr = np.asarray(t.frame_idxs)
    hm, tm = fr <= t_cut, fr > t_cut

    def take(f, m):
        x = getattr(t, f)
        return None if x is None else np.asarray(x)[m]

    def part(m, tid):
        return Tracklet(
            track_id=tid,
            frame_idxs=list(fr[m]),
            roots=take("roots", m), eulers=take("eulers", m),
            side_lens=take("side_lens", m), poses_3d=take("poses_3d", m),
            poses_score=take("poses_score", m),
            matched_pose=take("matched_pose", m), app=take("app", m),
        )

    return part(hm, t.track_id), part(tm, tail_id)


def _swap_tails(a: Tracklet, b: Tracklet, t_cut: int) -> Tuple[Tracklet, Tracklet]:
    fa = np.asarray(a.frame_idxs)
    fb = np.asarray(b.frame_idxs)
    ha, ta = fa <= t_cut, fa > t_cut
    hb, tb = fb <= t_cut, fb > t_cut

    def rebuild(head_t, head_m, tail_t, tail_m):
        def cat(f):
            x, y = getattr(head_t, f), getattr(tail_t, f)
            if x is None or y is None:
                return None
            return np.concatenate([np.asarray(x)[head_m], np.asarray(y)[tail_m]])
        return Tracklet(
            track_id=head_t.track_id,
            frame_idxs=(list(np.asarray(head_t.frame_idxs)[head_m])
                        + list(np.asarray(tail_t.frame_idxs)[tail_m])),
            roots=cat("roots"), eulers=cat("eulers"),
            side_lens=cat("side_lens"), poses_3d=cat("poses_3d"),
            poses_score=cat("poses_score"), matched_pose=cat("matched_pose"),
            app=cat("app"),
        )

    return rebuild(a, ha, b, tb), rebuild(b, hb, a, ta)


def resolve_crossings(
    tracklets: List[Tracklet],
    cfg: Optional[CrossingConfig] = None,
    return_log: bool = False,
):
    """Re-decide every crossing event with hindsight evidence windows.

    Returns relabeled tracklets (per-frame poses are exchanged between the
    two involved tracks, never modified — reprojection metrics of the frame
    SET are unchanged by construction).  With `return_log=True` also returns
    the per-event decision records.
    """
    cfg = cfg or CrossingConfig()
    # stage 1 — appearance change-point cuts (the measured repair path; see
    # cut_identity_breaks).  Runs before event detection so the event pass
    # sees identity-pure fragments.
    tracklets, log = cut_identity_breaks(tracklets, cfg, return_log=True)
    done = set()
    next_id = max((t.track_id for t in tracklets), default=0) + 1
    for _ in range(cfg.max_events):
        events = _detect_events(tracklets, cfg)
        ev = next((e for e in events if e not in done), None)
        if ev is None:
            break
        done.add(ev)
        t_star, i, j, t_enter, t_exit = ev
        a, b = tracklets[i], tracklets[j]
        fa, fb = np.asarray(a.frame_idxs), np.asarray(b.frame_idxs)

        def side_rows(fr, lo, hi):
            return np.flatnonzero((fr >= lo) & (fr <= hi))

        heads = [
            _segment(a, side_rows(fa, t_enter - cfg.window, t_enter - 1)[-cfg.window:], cfg),
            _segment(b, side_rows(fb, t_enter - cfg.window, t_enter - 1)[-cfg.window:], cfg),
        ]
        tails = [
            _segment(a, side_rows(fa, t_exit + 1, t_exit + cfg.window)[:cfg.window], cfg),
            _segment(b, side_rows(fb, t_exit + 1, t_exit + cfg.window)[:cfg.window], cfg),
        ]
        spans = [fa[0] < t_enter and fa[-1] > t_exit,
                 fb[0] < t_enter and fb[-1] > t_exit]
        enough = [len(h.rows) >= cfg.min_side_frames
                  and len(t_.rows) >= cfg.min_side_frames
                  for h, t_ in zip(heads, tails)]

        # sliding-window joint re-assignment (appearance Viterbi over the
        # interval): needs only PRE-event anchors, so it also covers tracks
        # that die inside the crossing — the case the 2x2 tail swap can't
        # reach.  Falls through to the channels below when appearance is
        # absent or the two anchors are indistinguishable.
        if (cfg.smooth
                and heads[0].app_mean is not None
                and heads[1].app_mean is not None
                and len(heads[0].rows) >= cfg.min_side_frames
                and len(heads[1].rows) >= cfg.min_side_frames):
            sep = (min(heads[0].app_purity, heads[1].app_purity)
                   - float(np.dot(heads[0].app_mean, heads[1].app_mean)))
            if sep >= cfg.smooth_min_anchor_sep:
                r = _smooth_interval(a, b, heads[0].app_mean,
                                     heads[1].app_mean, t_enter, t_exit, cfg)
                if r is not None:
                    swap_frames, tail_swap, gain = r
                    applied = (gain > cfg.smooth_min_gain
                               and (bool(swap_frames) or tail_swap))
                    log.append({
                        "t_star": t_star, "pair": (i, j), "smooth": True,
                        "swap": tail_swap, "n_frames": len(swap_frames),
                        "gain": round(gain, 4), "anchor_sep": round(sep, 4),
                        "interval": (t_enter, t_exit), "applied": applied,
                    })
                    if applied:
                        swap_at = np.asarray(sorted(
                            set(swap_frames)
                            | (set(fa[fa > t_exit]) | set(fb[fb > t_exit])
                               if tail_swap else set())), dtype=int)
                        tracklets[i], tracklets[j] = _relabel(a, b, swap_at)
                    continue

        # clean 2x2 live swap: both tracks pass through with evidence
        if all(spans) and all(enough):
            do_swap, rec = _decide(heads, tails, cfg)
            rec.update({"t_star": t_star, "pair": (i, j), "swap": do_swap,
                        "interval": (t_enter, t_exit)})
            log.append(rec)
            if do_swap:
                tracklets[i], tracklets[j] = _swap_tails(a, b, t_star)
                continue

        # identity-break cut: a spanning track that disagrees with ITSELF
        # across the interval (appearance channel) carries an in-fragment
        # switch — cut it at t* so the reid merge can reassemble the pure
        # pieces with hindsight evidence (the die-during-crossing pattern:
        # the swap partner is a dead fragment + a later spawn, out of reach
        # of the 2x2 exchange above)
        for k, (idx, tr) in enumerate(((i, a), (j, b))):
            if not (spans[k] and enough[k]):
                continue
            h, t_ = heads[k], tails[k]
            if h.app_mean is None or t_.app_mean is None:
                continue
            d_self = (min(h.app_purity, t_.app_purity)
                      - float(np.dot(h.app_mean, t_.app_mean)))
            if d_self > cfg.cut_gate:
                head, tail = _cut(tracklets[idx], t_star, next_id)
                next_id += 1
                tracklets[idx] = head
                tracklets.append(tail)
                log.append({"t_star": t_star, "pair": (i, j), "swap": False,
                            "cut": idx, "d_self": round(d_self, 4),
                            "interval": (t_enter, t_exit)})
    out = sorted(tracklets, key=lambda t: -len(t))
    return (out, log) if return_log else out
