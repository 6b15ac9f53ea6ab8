"""LM iterations the warm solve executes a frame, on the PyTorch/CUDA port:
the counterpart of `scripts/ik_iteration_study.py`.

What the device pays for the batched LM is its slowest active slot's
iteration count.  This replays a wide-rig scene (64 cameras, 10 people,
2 camera clusters: the ALS on B3), rebuilds every update frame's
warm-solve inputs as the tracker builds them (`_gather_obs` on the
step's post-step matches, then each slot's `ik_max_views` best views by a
stable sort, with per-slot cameras), and counts the iterations the LM
executes (`ops/ik._lm_solve_batched(..., return_iters=True)`: the JAX
package's while count; the solves on B2) under four budget and tolerance
variants; then the mean, median and largest count and how often a frame
spends its whole budget.

    python scripts/torch_ik_iteration_study.py [--cpu]

Runs on the card unless `--cpu` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from multiview_motion_capture_torch.config import PipelineConfig  # noqa: E402
from multiview_motion_capture_torch.data.synthetic import synthetic_sequence  # noqa: E402
from multiview_motion_capture_torch.debug import _state_at, replay_states  # noqa: E402
from multiview_motion_capture_torch.ops import ik as ik_ops  # noqa: E402
from multiview_motion_capture_torch.ops.consts import on_device  # noqa: E402
from multiview_motion_capture_torch.tracker import (  # noqa: E402
    TrackerContext,
    _gather_obs,
    _top_views,
)
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402

N_VIEWS = 64
N_PEOPLE = 10
N_FRAMES = 30
# label -> (stages, ftol, xtol, budget), scripts/ik_iteration_study.py:75-80
VARIANTS = {
    "warm_default(stages1,ftol2e-6,b5)": (1, 2e-6, 1e-6, 5),
    "warm_loose(ftol1e-4)": (1, 1e-4, 1e-4, 5),
    "warm_budget3": (1, 2e-6, 1e-6, 3),
    "warm_stages2(parity)": (2, 2e-6, 1e-6, 5),
}
LM_KW = dict(eps=1e-5, lam0=1e-3, lam_up=10.0, lam_down=0.33, solver="gj",
             return_iters=True)


def study_config(n_views=N_VIEWS, n_people=N_PEOPLE, max_tracks=16, assoc_clusters=2,
                 ik_max_views=16) -> PipelineConfig:
    return PipelineConfig(
        n_views=n_views, max_people=n_people, max_tracks=max_tracks, max_frames=None,
        als_max_iter=100, ik_warm_stages=1, ik_solver="gj",
        assoc_clusters=assoc_clusters, ik_max_views=ik_max_views,
    )


def warm_iters(x0, skel, obs, view_w, P, n_iters, stages, ftol, xtol):
    """The executed iterations of the warm solve's stages: (first, second)
    as () int32 tensors on the device; the second is 0 for one stage."""
    dev = x0.device
    obs18 = ik_ops.add_mid_spine(obs)
    free_pose = on_device(ik_ops._FREE_POSE, dev)
    free_all = on_device(ik_ops._FREE_ALL, dev)
    kw = dict(LM_KW, n_iters=n_iters, ftol=ftol, xtol=xtol)
    if stages == 1:
        _, it = ik_ops._lm_solve_batched(x0, skel, obs18, view_w, P, free_all, **kw)
        return it, torch.zeros((), dtype=torch.int32, device=dev)
    x1, it1 = ik_ops._lm_solve_batched(x0, skel, obs18, view_w, P, free_pose, **kw)
    _, it2 = ik_ops._lm_solve_batched(x1, skel, obs18, view_w, P, free_all, **kw)
    return it1, it2


def warm_inputs(ctx, state, kps_f, matched_f, upd):
    """A frame's warm-solve inputs as the tracker builds them: (x0, obs,
    view weights, P) for the slots in `upd` (updated, not spawned), capped
    to each slot's `ik_max_views` best views."""
    dev = ctx.device
    kps_f = torch.as_tensor(kps_f, dtype=torch.float32, device=dev)
    m = torch.as_tensor(matched_f, device=dev)
    upd = torch.as_tensor(upd, device=dev)
    exists = (m >= 0) & upd[:, None]
    obs, w = _gather_obs(kps_f, m, exists)
    w = w * upd[:, None].to(w.dtype)
    k = ctx.cfg.ik_max_views
    if k is not None and k < kps_f.shape[0]:
        obs, w, idx = _top_views(obs, w, k)
        P = ctx.cams.P[idx]
    else:
        P = ctx.cams.P
    x0 = ik_ops.IkParams(state.root, state.euler, state.side_lens).pack()
    return x0, obs, w, P


def frame_counts(ctx, pre_states, outs, kps, variant) -> list:
    """Each update frame's executed iterations (both stages) under one
    variant, (frame, count) pairs; one host read a frame."""
    stages, ftol, xtol, budget = variant
    updated, spawned = np.asarray(outs.updated), np.asarray(outs.spawned)
    matched = np.asarray(outs.matched_pose)  # POST-step matches
    counts = []
    for f in range(updated.shape[0]):
        upd = updated[f] & ~spawned[f]
        if not upd.any():
            continue
        state = _state_at(pre_states, f, ctx.device)
        x0, obs, w, P = warm_inputs(ctx, state, kps[f], matched[f], upd)
        it1, it2 = warm_iters(x0, ctx.skel, obs, w, P, budget, stages, ftol, xtol)
        counts.append((f, int((it1 + it2).item())))
    return counts


def main(argv=None, n_views=N_VIEWS, n_people=N_PEOPLE, n_frames=N_FRAMES,
         outputs: dict = None, **cfg_overrides) -> dict:
    """The study's JSON line.  The rig's size and `study_config`'s
    keywords can be set for a smaller run; `outputs`: a dict that receives
    each variant's (frame, count) pairs and the replay's `outs`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = study_config(n_views, n_people, **cfg_overrides)
    seq = synthetic_sequence(n_frames=n_frames, n_people=n_people, n_views=n_views,
                             cfg=cfg, seed=0, noise_px=1.0, drop_prob=0.05)
    ctx = TrackerContext.build(seq.cameras, cfg, use_ik=True, device=dev)
    pre_states, outs = replay_states(ctx, seq.batch.kps, seq.batch.valid)
    if outputs is not None:
        outputs["outs"] = outs

    warm_counts = {}
    for label, variant in VARIANTS.items():
        pairs = frame_counts(ctx, pre_states, outs, seq.batch.kps, variant)
        if outputs is not None:
            outputs[label] = pairs
        counts = np.asarray([c for _, c in pairs])
        stages, budget = variant[0], variant[3]
        warm_counts[label] = {
            "frames": int(counts.size),
            "mean": round(float(counts.mean()), 2),
            "p50": int(np.percentile(counts, 50)),
            "max": int(counts.max()),
            "budget_hit_frac": round(float((counts >= budget * stages).mean()), 2),
        }
        print(label, warm_counts[label], file=sys.stderr)

    line = {"metric": "ik_iteration_stats",
            "extra": {"rig": f"{n_views}cam_x_{n_people}", **warm_counts}}
    print(json.dumps(line, indent=1), flush=True)
    return line


if __name__ == "__main__":
    main()
