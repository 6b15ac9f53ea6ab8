"""Per-frame association debug artifacts (the reference's debug surface as a
first-class switch).

Port of `multiview_motion_capture_tpu/debug.py`, with its file names, npz
keys, csv headers and summary fields.  The reference, when debugging
association, dumps its cost matrices to xlsx and annotated match/unmatch
crop strips to disk (ref:src/motion_capture.py:885-921).  For any tracked
sequence this dumps, per requested frame:

- the similarity matrix fed to the ALS (csv + npz),
- the continuous ALS ``X`` and its ``|X - 0.5|`` decision margins
  (bistable near-threshold associations show up as small margins),
- the parsed groups (leader / members / sizes) and each track's match,
- the raw track->detection reprojection distances behind the 2D-3D block
  (what the rescue pass gates on),
- with ``images``: a crop strip per dying track of its nearest detections
  across views (the reference's unmatched-crop dump).

The replay runs the tracker's own step on the context's device, so it
launches the tracker's kernels (the ALS kernel B1, or B3 on clustered rigs,
and the LM solve where the config's IK takes it).  Each dumped frame's
association is solved again by the ALS kernel with its X output
(`als_kernel.match_als(..., return_x=True)`; one call per camera cluster
on clustered rigs): the same kernel on the same matrix as the step, so the
dumped ``x_bin`` is the grouping the step used, and ``X`` comes from the
solve that produced it.  The JAX package solves these frames with its XLA
ALS instead, because its fused kernel never writes X out.  CLI: ``run
--debug_dump DIR [--debug_frames 3,17]``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from multiview_motion_capture_torch import tracker as trk
from multiview_motion_capture_torch.ops import als_kernel
from multiview_motion_capture_torch.ops import association as assoc
from multiview_motion_capture_torch.tracker import (
    TrackerContext,
    TrackerState,
    make_step,
    stack_outputs,
)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def replay_states(ctx: TrackerContext, kps, valid, app=None):
    """Step the sequence frame by frame on the context's device, keeping
    each frame's PRE-step state on the host beside the outputs (the
    debug/replay entry point shared with the study scripts).  `app`
    (F, V, P, D) is required for appearance-enabled contexts.  Returns
    (pre_states, outs): a `TrackerState` and a `FrameOutput` of numpy
    arrays with a leading frame axis; the outputs equal `run_offline`'s."""
    if ctx.cfg.appearance_dim > 0 and app is None:
        raise ValueError("cfg.appearance_dim > 0: replay_states needs "
                         "app=(F, V, P, D) detection embeddings")
    kps, valid, app = trk._frames_to_device(ctx, kps, valid, app)
    step = make_step(ctx)
    state = TrackerState.zeros(ctx.cfg, device=ctx.device)
    pre, outs = [], []
    for f in range(kps.shape[0]):
        pre.append({fld.name: _np(getattr(state, fld.name))
                    for fld in dataclasses.fields(TrackerState)})
        state, out = step(state, kps[f], valid[f], None if app is None else app[f])
        outs.append(out)
    pre_states = TrackerState(**{name: np.stack([p[name] for p in pre]) for name in pre[0]})
    return pre_states, trk.outputs_to_numpy(stack_outputs(outs))


def _state_at(pre_states, f: int, device) -> TrackerState:
    """Frame f's pre-step state on `device` (by field name)."""
    return TrackerState(**{
        fld.name: torch.as_tensor(np.asarray(getattr(pre_states, fld.name))[f], device=device)
        for fld in dataclasses.fields(TrackerState)
    })


def _als_with_x(ctx: TrackerContext, sim, diag_mask, init_A):
    cfg = ctx.cfg
    return als_kernel.match_als(
        sim.contiguous(), diag_mask, init_A,
        alpha=cfg.als_alpha, beta=cfg.als_beta, mu0=cfg.als_mu,
        tol=cfg.als_tol, max_iter=cfg.als_max_iter,
        stable_iters=cfg.als_stable_iters, return_x=True)


def frame_debug(ctx: TrackerContext, state: TrackerState, kps, valid,
                app=None) -> dict:
    """Re-run ONE frame's association with full diagnostics.

    `state` is the PRE-step state (before the time_since_update predict);
    `app` (V, P, D) is this frame's detection embeddings (appearance
    contexts); returns a dict of numpy arrays / nested summaries, one
    entry per cluster on hierarchical rigs.
    """
    cfg = ctx.cfg
    T, V, P = cfg.max_tracks, cfg.n_views, cfg.max_people
    dev = ctx.device
    kps = torch.as_tensor(kps, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    if app is not None:
        app = torch.as_tensor(app, dtype=torch.float32, device=dev)
    # replicate the step's predict
    state = trk.predict(state)
    any_alive = bool((state.active > 0).any())
    gain = None if app is None else trk._appearance_gain(cfg, state)

    clusters = []
    if cfg.assoc_clusters > 1:
        for c, cl in enumerate(ctx.clusters):
            sim_st, _, _ = trk._spatial_time_similarity(
                ctx, state, kps, valid, view_idx=cl.views, view_valid=cl.view_valid,
                app=app, app_gain=gain)
            sim_sp, _ = trk._spatial_similarity(
                ctx, kps, valid, view_idx=cl.views, view_valid=cl.view_valid,
                app=app, app_gain=gain)
            sim = sim_st if any_alive else sim_sp
            als = _als_with_x(ctx, sim, ctx.cluster_diag_mask, ctx.cluster_init_A)
            clusters.append({
                "views": np.arange(c, V, cfg.assoc_clusters), "sim": _np(sim),
                "x": _np(als.x), "x_bin": _np(als.x_bin), "n_iters": int(als.n_iters),
            })
        # the global picture: the step's own clustered association (B3),
        # its distances and validity
        a = trk._clustered_association(ctx, state, kps, valid, app)
        x_bin, x_soft, n_iters = _np(a.x_bin), None, int(a.n_iters)
        elem_valid, d23 = a.elem_valid, a.d23
    else:
        sim_st, ev_st, d23 = trk._spatial_time_similarity(ctx, state, kps, valid,
                                                          app=app, app_gain=gain)
        sim_sp, ev_sp = trk._spatial_similarity(ctx, kps, valid, app=app, app_gain=gain)
        sim = sim_st if any_alive else sim_sp
        elem_valid = ev_st if any_alive else ev_sp
        als = _als_with_x(ctx, sim, ctx.diag_mask, ctx.init_A)
        x_bin, x_soft, n_iters = _np(als.x_bin), _np(als.x), int(als.n_iters)
        clusters.append({"views": np.arange(V), "sim": _np(sim), "x": x_soft,
                         "x_bin": x_bin, "n_iters": n_iters})

    groups = assoc.extract_groups(torch.as_tensor(x_bin, device=dev), elem_valid)
    rep, member, gsize = _np(groups.rep), _np(groups.member), _np(groups.group_size)
    d23 = _np(d23)

    # per-track association summary
    tracks = []
    active = _np(state.active)
    track_id, tsu = _np(state.track_id), _np(state.time_since_update)
    for t in range(T):
        if active[t] == 0:
            continue
        dmin = d23[t][np.isfinite(d23[t])]
        row = {
            "slot": t,
            "track_id": int(track_id[t]),
            "active": int(active[t]),
            "time_since_update": int(tsu[t]),
            "is_group_leader": bool(member[t] and rep[t] == t),
            "group_size": int(gsize[t]),
            "nearest_det_px": float(dmin.min()) if dmin.size else None,
        }
        if x_soft is not None:
            sub = x_soft[t, T:][_np(valid).reshape(-1)]
            row["best_soft_x"] = float(sub.max()) if sub.size else None
            row["margin_to_05"] = float(np.abs(sub - 0.5).min()) if sub.size else None
        tracks.append(row)

    # detection-group summary (spawn candidates)
    det_groups = []
    rep_det = rep[T:]
    for e in range(V * P):
        if member[T + e] and rep_det[e] == T + e:
            members = np.nonzero(member[T:] & (rep_det == T + e))[0]
            det_groups.append({
                "leader": int(T + e),
                "views": sorted({int(m // P) for m in members}),
                "slots": [[int(m // P), int(m % P)] for m in members],
            })

    return {
        "any_alive": any_alive,
        "clusters": clusters,
        "x_bin": x_bin,
        "x": x_soft,
        "elem_valid": _np(elem_valid),
        "d23": d23,
        "rep": rep,
        "member": member,
        "group_size": gsize,
        "n_iters": n_iters,
        "tracks": tracks,
        "det_groups": det_groups,
    }


def _write_csv(path: Path, mat: np.ndarray, T: int, V: int, P: int) -> None:
    """The similarity/X matrix with [trk*|v*p*] headers (the reference's
    xlsx cost-matrix dump, ref:src/motion_capture.py:885-899, as csv)."""
    names = [f"trk{t}" for t in range(T)] + [
        f"v{v}p{p}" for v in range(V) for p in range(P)
    ]
    with open(path, "w") as fh:
        fh.write("," + ",".join(names) + "\n")
        for name, row in zip(names, mat):
            fh.write(name + "," + ",".join(f"{x:.4f}" for x in row) + "\n")


def dump_association_debug(
    ctx: TrackerContext,
    kps,
    valid,
    out_dir: Path,
    frames: Optional[Sequence[int]] = None,
    images: Optional[np.ndarray] = None,
    max_auto_frames: int = 20,
    app: Optional[np.ndarray] = None,
) -> List[Path]:
    """Dump per-frame association diagnostics for a sequence.

    frames: frame indices to dump; None = every frame where a track DIES
    (the moments the studies keep re-deriving), capped at `max_auto_frames`.
    images: optional (F, V, H, W, 3) uint8 frames for crop strips.
    Returns the list of per-frame npz paths written.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = ctx.cfg
    T, V, P = cfg.max_tracks, cfg.n_views, cfg.max_people
    kps, valid = _np(kps), _np(valid)
    app = None if app is None else _np(app)

    pre_states, outs = replay_states(ctx, kps, valid, app=app)
    died = np.asarray(outs.died_track_id)  # (F, T)
    if frames is None:
        frames = [f for f in range(died.shape[0]) if (died[f] >= 0).any()]
        frames = frames[:max_auto_frames]

    written = []
    for f in frames:
        state = _state_at(pre_states, f, ctx.device)
        dbg = frame_debug(ctx, state, kps[f], valid[f],
                          app=None if app is None else app[f])
        base = out_dir / f"frame_{f:05d}"
        npz_path = base.with_suffix(".npz")
        arrays = {
            "x_bin": dbg["x_bin"], "elem_valid": dbg["elem_valid"],
            "d23": dbg["d23"], "rep": dbg["rep"], "member": dbg["member"],
            "group_size": dbg["group_size"],
        }
        if dbg["x"] is not None:
            arrays["x"] = dbg["x"]
            arrays["margin"] = np.abs(dbg["x"] - 0.5)
        for ci, cl in enumerate(dbg["clusters"]):
            arrays[f"cluster{ci}_sim"] = cl["sim"]
            arrays[f"cluster{ci}_x"] = cl["x"]
            arrays[f"cluster{ci}_views"] = cl["views"]
        np.savez_compressed(npz_path, **arrays)
        written.append(npz_path)

        # cost-matrix csv (monolithic rigs get the full matrix; clustered
        # rigs one csv per cluster over [T | Vc*P])
        if cfg.assoc_clusters == 1:
            _write_csv(base.parent / f"{base.name}_sim.csv",
                       dbg["clusters"][0]["sim"], T, V, P)
            if dbg["x"] is not None:
                _write_csv(base.parent / f"{base.name}_x.csv", dbg["x"],
                           T, V, P)
        else:
            for ci, cl in enumerate(dbg["clusters"]):
                _write_csv(base.parent / f"{base.name}_sim_c{ci}.csv",
                           cl["sim"], T, len(cl["views"]), P)

        summary = {
            "frame": int(f),
            "any_alive": dbg["any_alive"],
            "als_iters": dbg["n_iters"],
            "died_track_ids": [int(x) for x in died[f][died[f] >= 0]],
            "tracks": dbg["tracks"],
            "det_groups": dbg["det_groups"],
        }
        with open(base.parent / f"{base.name}_summary.json", "w") as fh:
            json.dump(summary, fh, indent=2)

        if images is not None:
            _dump_death_strips(ctx, dbg, died[f], kps[f], images[f], base)
    return written


def _dump_death_strips(ctx, dbg, died_f, kps_f, imgs_f, base: Path) -> None:
    """Crop strips of each dying track's nearest detections per view (the
    reference's unmatched-crops debug dump, ref:src/motion_capture.py:
    901-921).  Needs `cv2`."""
    import cv2

    from multiview_motion_capture_torch.utils.viz import draw_crop_strip

    V = ctx.cfg.n_views
    kps_f = np.asarray(kps_f)
    d23 = dbg["d23"]
    for t in np.nonzero(died_f >= 0)[0]:
        imgs, kp_list, labels = [], [], []
        for v in range(V):
            dv = d23[t, v]
            if not np.isfinite(dv).any():
                continue
            p = int(np.nanargmin(np.where(np.isfinite(dv), dv, np.nan)))
            imgs.append(np.asarray(imgs_f[v]))
            kp_list.append(kps_f[v, p])
            labels.append(f"v{v} {dv[p]:.0f}px")
        strip = draw_crop_strip(imgs, kp_list, labels=labels)
        if strip is not None:
            cv2.imwrite(
                str(base.parent / f"{base.name}_death_t{int(died_f[t])}.png"),
                strip[..., ::-1],
            )
