"""Identity study on the scaled rigs, on the PyTorch/CUDA port: the
counterpart of `scripts/identity_study.py`.  IDF1, ID switches and
fragments per identity against the synthetic ground truth, raw and after
each host post-pass (hindsight crossing repair when asked, the re-ID
merge, the ghost filter), on the nine configurations of the JAX script:
10, 20 and 32 cameras x 10 people, varied skeletons, the shared-skeleton
gate ablation, idealized and extractor-grade appearance embeddings at the
default gain and with the auto gain, and the crossing repair.

The tracking runs on the device (`tracker.run_offline`: B1 as one matrix
or a cluster of 16 blocks, the LM on B2); the post-passes and the scores
are host numpy.

    python scripts/torch_identity_study.py [--cpu]

Runs on the card unless `--cpu` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multiview_motion_capture_torch.bench import backend_name  # noqa: E402
from multiview_motion_capture_torch.config import PipelineConfig  # noqa: E402
from multiview_motion_capture_torch.crossings import resolve_crossings  # noqa: E402
from multiview_motion_capture_torch.data.synthetic import (  # noqa: E402
    synthetic_appearance,
    synthetic_sequence,
)
from multiview_motion_capture_torch.eval import identity_metrics  # noqa: E402
from multiview_motion_capture_torch.pipeline import filter_ghost_tracklets  # noqa: E402
from multiview_motion_capture_torch.reid import ReidConfig, merge_tracklets  # noqa: E402
from multiview_motion_capture_torch.tracker import (  # noqa: E402
    TrackerContext,
    assemble_tracklets,
    outputs_to_numpy,
    run_offline,
)
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402

_EXTRACTOR = dict(appearance_dim=16, appearance_noise=0.05, appearance_shared_frac=0.83)
# scripts/identity_study.py:116-155: name -> study_config's arguments
CONFIGS = {
    "10cam_x_10ppl_f200": dict(n_views=10, n_people=10, n_frames=200),
    "20cam_x_10ppl_f100": dict(n_views=20, n_people=10, n_frames=100),
    "32cam_x_10ppl_f60": dict(n_views=32, n_people=10, n_frames=60),
    # anthropometric variation on (heights ~N(1, 0.06^2), bone groups
    # ~N(1, 0.04^2)) under heavier occlusion: the bone-length gate has
    # signal, reid against reid_trajectory_only
    "10cam_x_10ppl_f200_varied": dict(
        n_views=10, n_people=10, n_frames=200, drop_prob=0.15, person_scale_std=0.06,
        bone_jitter_std=0.04, compare_bone_gate=True),
    "10cam_x_10ppl_f200_shared_gate_ablation": dict(
        n_views=10, n_people=10, n_frames=200, compare_bone_gate=True),
    # idealized unit-identity embeddings + noise 0.25 at the default gain
    "10cam_x_10ppl_f200_appearance": dict(
        n_views=10, n_people=10, n_frames=200, appearance_dim=16),
    # extractor-grade embeddings (shared_frac 0.83) at the default gain
    # 20, then with the online auto gain, then with the crossing repair
    "10cam_x_10ppl_f200_appearance_extractorgrade_gain20": dict(
        n_views=10, n_people=10, n_frames=200, **_EXTRACTOR),
    "10cam_x_10ppl_f200_appearance_extractorgrade_auto8": dict(
        n_views=10, n_people=10, n_frames=200, appearance_auto_target_px=8.0, **_EXTRACTOR),
    "10cam_x_10ppl_f200_appearance_extractorgrade_crossings": dict(
        n_views=10, n_people=10, n_frames=200, crossings=True, **_EXTRACTOR),
}


def study_config(n_views, n_people, n_frames, use_ik=True, drop_prob=0.05,
                 min_track_length=2, person_scale_std=0.0,
                 bone_jitter_std=0.0, compare_bone_gate=False,
                 appearance_dim=0, appearance_noise=0.25,
                 appearance_gain_px=None, appearance_shared_frac=0.0,
                 appearance_auto_target_px=None, crossings=False, device="cuda",
                 **cfg_overrides) -> dict:
    """One configuration's scores (`scripts/identity_study.py:25-113`, the
    same keywords, plus `device`)."""
    dev = resolve_device(device)
    cfg = PipelineConfig(
        n_views=n_views, max_people=n_people, max_tracks=16,
        max_frames=None, als_max_iter=100, ik_warm_stages=1, ik_solver="gj",
        # identity first: rescue off (PipelineConfig.crowded()'s semantics);
        # rescue adoption in crowds swaps identities mid-fragment
        track_rescue_px=0.0,
        appearance_dim=appearance_dim,
        **({} if appearance_gain_px is None
           else {"appearance_gain_px": appearance_gain_px}),
        **({} if appearance_auto_target_px is None
           else {"appearance_auto_target_px": appearance_auto_target_px}),
        **cfg_overrides,
    )
    seq = synthetic_sequence(n_frames=n_frames, n_people=n_people,
                             n_views=n_views, cfg=cfg, seed=0,
                             noise_px=1.0, drop_prob=drop_prob,
                             person_scale_std=person_scale_std,
                             bone_jitter_std=bone_jitter_std)
    app = None
    if appearance_dim > 0:
        app = synthetic_appearance(seq, dim=appearance_dim, noise=appearance_noise,
                                   shared_frac=appearance_shared_frac)
    ctx = TrackerContext.build(seq.cameras, cfg, use_ik=use_ik, device=dev)
    _, out = run_offline(ctx, seq.batch.kps, seq.batch.valid, app=app)
    tlets = assemble_tracklets(outputs_to_numpy(out))

    def score(ts):
        m = identity_metrics(ts, seq.gt_slot_person)
        return {
            "n_tracks": m.n_pred_tracks,
            "idf1": round(m.idf1, 3),
            "id_switches": m.id_switches,
            "fragments": m.fragments_per_identity,
            "gt_identities": m.n_gt_identities,
        }

    raw = score(tlets)
    if crossings:
        # hindsight crossing resolution before the fragment merge: repairs
        # in-fragment identity swaps the merge cannot see
        tlets, xlog = resolve_crossings(tlets, return_log=True)
    merged = merge_tracklets(tlets)
    after = score(merged)
    final = score(filter_ghost_tracklets(merged, min_track_length))
    res = {"raw": raw, "reid": after, "reid+ghost_filter": final}
    if crossings:
        res["crossings_resolved"] = score(tlets)
        res["crossing_events"] = len(xlog)
        res["crossing_swaps"] = sum(1 for e in xlog if e.get("swap"))
    if compare_bone_gate:
        # trajectory-only lower bound: bone statistics never fit, so the
        # bone gate and its strong-evidence widening both disappear
        no_bone = ReidConfig(min_frames_for_prior=10**9)
        merged_nb = merge_tracklets(tlets, no_bone)
        res["reid_trajectory_only"] = score(merged_nb)
        res["reid_trajectory_only+ghost_filter"] = score(
            filter_ghost_tracklets(merged_nb, min_track_length))
    return res


def main(argv=None, names=None, n_frames=None) -> dict:
    """The study's JSON line over CONFIGS (or the `names` among them), each
    at its frame count or at `n_frames`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    results = {}
    for name in (names or CONFIGS):
        kw = dict(CONFIGS[name])
        if n_frames is not None:
            kw["n_frames"] = n_frames
        results[name] = study_config(device=dev, **kw)
        print(name, json.dumps(results[name]), file=sys.stderr, flush=True)
    line = {"metric": "identity_study",
            "extra": {**results, "backend": backend_name(dev)}}
    print(json.dumps(line, indent=2), flush=True)
    return line


if __name__ == "__main__":
    main()
