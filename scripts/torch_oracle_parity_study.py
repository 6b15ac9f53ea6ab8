"""Full-sequence parity study of the PyTorch/CUDA port's tracker against the
float64 scipy oracle (`tests/torch_oracle_pipeline.py`): the
counterpart of `scripts/parity_study.py`, with its zoom on the reference's documented
frame-131 failure (ref:README.md:55-56 "debug frame 131").  (The port's
`scripts/torch_parity_study.py` is another program: the port against the
JAX package.)

The tracker runs `PipelineConfig.parity` (the strict reference lifecycle,
no track rescue) through `pipeline.run` on the device; the oracle, a slow
host program, on the same filtered detections.  The JSON keeps the JAX
script's keys: "tpu" holds the tracker's side (the port's, on its
device), "oracle" the oracle's; then the tracklets matched by overlap and
their MPJPE, the active-track counts around frame 131 and the fragment
events there.

    python scripts/torch_oracle_parity_study.py [--data_dir DIR] [--max_frames N]
        [--out docs/torch_oracle_parity_study.json] [--cpu]

`--data_dir` holds Shelf's layout (`kps_opn/`, `calibs/`); the default is
`data/shelf` inside the checkout, and a missing directory raises
`FileNotFoundError`.  The oracle's tracklets are cached under
`--oracle_cache` (default `build/torch_oracle_cache/`) and shared with
`scripts/torch_fragmentation_study.py`.  Runs on the card unless `--cpu`
is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import numpy as np  # noqa: E402

from multiview_motion_capture_torch import PipelineConfig, pipeline  # noqa: E402
from multiview_motion_capture_torch.bench import SHELF_DIR, backend_name  # noqa: E402
from multiview_motion_capture_torch.cameras import CameraBank  # noqa: E402
from multiview_motion_capture_torch.data.ingest import (  # noqa: E402
    filter_bad_poses,
    load_openpose_dir,
)
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402
from torch_oracle_cache import run_oracle_cached  # noqa: E402

N_FRAMES = 300
OUT = REPO / "docs" / "torch_oracle_parity_study.json"


def active_per_frame(tracklets, n_frames, min_len=1):
    counts = np.zeros(n_frames, dtype=int)
    for t in tracklets:
        frames = t.frames if hasattr(t, "frames") else list(t.frame_idxs)
        if len(frames) < min_len:
            continue
        for f in frames:
            counts[f] += 1
    return counts


def coverage(tracklets, n_frames):
    return float((active_per_frame(tracklets, n_frames) > 0).mean())


def matched_mpjpe(ours, oracle):
    """Match each oracle tracklet to the best-overlapping tracker tracklet:
    (oracle length, MPJPE m) pairs."""
    pairs = []
    for ot in oracle:
        if len(ot.frames) < 5:
            continue
        omap = {f: i for i, f in enumerate(ot.frames)}
        best = None
        for t in ours:
            common = [(omap[f], i) for i, f in enumerate(t.frame_idxs) if f in omap]
            if len(common) < max(2, len(ot.frames) // 2):
                continue
            oi, ti = zip(*common)
            a = np.stack([ot.poses[i] for i in oi])
            b = np.asarray(t.poses_3d)[list(ti)]
            if a.shape[1] != b.shape[1]:
                continue
            d = float(np.linalg.norm(a - b, axis=-1).mean())
            if best is None or d < best:
                best = d
        if best is not None:
            pairs.append((len(ot.frames), best))
    return pairs


def events(tracklets, lo: int = 120, hi: int = 145):
    """Tracklets that end or start in frames lo..hi (fragmentation events)."""
    ends, starts = {}, {}
    for t in tracklets:
        frames = t.frames if hasattr(t, "frames") else list(t.frame_idxs)
        if not len(frames):
            continue
        if lo <= frames[-1] <= hi:
            ends[int(frames[-1])] = ends.get(int(frames[-1]), 0) + 1
        if lo <= frames[0] <= hi:
            starts[int(frames[0])] = starts.get(int(frames[0]), 0) + 1
    return {"ends": ends, "starts": starts}


def _stat(values, fn):
    return float(fn(values) * 100) if len(values) else float("nan")


def main(argv=None, outputs: dict = None) -> dict:
    """The study's JSON object, also written to `--out`.  `outputs`: a dict
    that receives the tracker's `RunResult` (`result`) and the oracle's
    tracklets (`oracle`)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", default=str(SHELF_DIR))
    ap.add_argument("--max_frames", type=int, default=N_FRAMES)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--oracle_cache", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    data_dir = Path(args.data_dir)
    if not data_dir.is_dir():
        raise FileNotFoundError(f"no study data directory at {data_dir}")
    # strict reference lifecycle (no track rescue): the oracle implements
    # the reference's raw semantics (the CLI's `--preset parity`)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = PipelineConfig.parity(max_frames=args.max_frames)
    batch = filter_bad_poses(load_openpose_dir(data_dir / "kps_opn", cfg), cfg)
    cams = CameraBank.from_json_dir(data_dir / "calibs")
    n = min(args.max_frames, batch.kps.shape[0])

    t0 = time.time()
    res = pipeline.run(batch, cams, cfg, use_ik=True, device=dev)
    ours = res.tracklets
    t_ours = time.time() - t0
    print(f"tracker: {len(ours)} tracklets in {t_ours:.1f}s", file=sys.stderr)

    t0 = time.time()
    oracle = run_oracle_cached(batch.kps, batch.valid, cams, n, data_dir, args.oracle_cache)
    t_oracle = time.time() - t0
    print(f"oracle: {len(oracle)} tracklets in {t_oracle:.1f}s", file=sys.stderr)
    if outputs is not None:
        outputs.update(result=res, oracle=oracle)

    our_lens = sorted([len(t.frame_idxs) for t in ours], reverse=True)
    ora_lens = sorted([len(t.frames) for t in oracle], reverse=True)
    pairs = matched_mpjpe(ours, oracle)
    our_active = active_per_frame(ours, n)
    ora_active = active_per_frame(oracle, n)
    # frame-131 zoom: active tracks around the reference's documented failure
    zoom = {f: {"tpu_active": int(our_active[f]), "oracle_active": int(ora_active[f])}
            for f in range(120, min(146, n))}
    errs = [e for _, e in pairs]
    out = {
        "n_frames": n,
        "tpu": {
            "n_tracklets": len(our_lens),
            "lengths_top10": our_lens[:10],
            "coverage": coverage(ours, n),
            "mean_active": float(our_active.mean()),
            "runtime_s": round(t_ours, 1),
        },
        "oracle": {
            "n_tracklets": len(ora_lens),
            "lengths_top10": ora_lens[:10],
            "coverage": coverage(oracle, n),
            "mean_active": float(ora_active.mean()),
            "runtime_s": round(t_oracle, 1),
        },
        "matched_pairs": len(pairs),
        "matched_oracle_frames": int(sum(k for k, _ in pairs)),
        "mpjpe_cm": {
            "mean": _stat(errs, np.mean),
            "median": _stat(errs, np.median),
            "max": _stat(errs, np.max),
            "weighted_mean": float(
                sum(k * e for k, e in pairs) / max(sum(k for k, _ in pairs), 1) * 100),
        },
        "frame131_zoom": zoom,
        "tpu_events_120_145": events(ours),
        "oracle_events_120_145": events(oracle),
        "active_count_agreement": float((our_active == ora_active).mean()),
        "backend": backend_name(dev),
    }
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
