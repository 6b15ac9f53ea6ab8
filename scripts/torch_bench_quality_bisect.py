"""The benchmark's pipeline under config variants, on the PyTorch/CUDA port:
the counterpart of `scripts/bench_quality_bisect.py`.  It runs what the
CLI's `bench` mode runs (SHELF_BENCH at 300 frames, IK on, through
`load_openpose_dir` -> `pipeline.run` -> `eval.reprojection_metrics`)
under four variants that undo one lifecycle or cold-solve choice each,
and prints, per variant, frames/s, the mean and median reprojection, the
tracklet count and the top lengths, then one JSON object of all four.

    python scripts/torch_bench_quality_bisect.py [--data_dir DIR] [--max_frames N] [--cpu]

`--data_dir` holds Shelf's layout (`kps_opn/`, `calibs/`); the default is
`data/shelf` inside the checkout, and a missing directory raises
`FileNotFoundError` (no other scene is put in its place).  Runs on the
card unless `--cpu` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multiview_motion_capture_torch import config  # noqa: E402
from multiview_motion_capture_torch.bench import SHELF_DIR  # noqa: E402
from multiview_motion_capture_torch.cameras import CameraBank  # noqa: E402
from multiview_motion_capture_torch.data.ingest import load_openpose_dir  # noqa: E402
from multiview_motion_capture_torch.eval import reprojection_metrics  # noqa: E402
from multiview_motion_capture_torch.pipeline import run  # noqa: E402
from multiview_motion_capture_torch.utils.precision import resolve_device  # noqa: E402

# scripts/bench_quality_bisect.py:38-48
VARIANTS = {
    # the bench config as it stands
    "current_r4": {},
    # the two-stage cold schedule
    "cold_stages_2": {"ik_cold_stages": 2},
    # the two-stage cold schedule with track rescue off
    "cold2_rescue_off": {"ik_cold_stages": 2, "track_rescue_px": 0.0},
    # track rescue off alone (rescue against the cold schedule)
    "rescue_off": {"track_rescue_px": 0.0},
}


def main(argv=None, outputs: dict = None) -> dict:
    """The study's JSON object (variant -> its numbers).  `outputs`: a dict
    that receives each variant's `RunResult` by name."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", default=str(SHELF_DIR))
    ap.add_argument("--max_frames", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    data_dir = Path(args.data_dir)
    if not data_dir.is_dir():
        raise FileNotFoundError(f"no benchmark data directory at {data_dir}")
    dev = resolve_device("cpu" if args.cpu else "cuda")
    # SHELF_BENCH as the config module holds it (the `bench` mode's reading)
    base = dataclasses.replace(config.SHELF_BENCH, max_frames=args.max_frames)
    batch = load_openpose_dir(data_dir / "kps_opn", base)
    cams = CameraBank.from_json_dir(data_dir / "calibs")

    out = {}
    for name, kw in VARIANTS.items():
        cfg = dataclasses.replace(base, **kw)
        res = run(batch, cams, cfg, use_ik=True, device=dev)
        m = reprojection_metrics(res.tracklets, batch, cams)
        out[name] = {
            "fps": round(res.fps, 1),
            "mean_px": round(m.mean_reproj_px, 3),
            "median_px": round(m.median_reproj_px, 3),
            "n_tracklets": len(res.tracklets),
            "top_lengths": m.lengths[:5],
        }
        if outputs is not None:
            outputs[name] = res
        print(name, out[name], file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
