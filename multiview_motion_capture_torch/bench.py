"""The CLI's `bench` mode: end-to-end frames/s of `pipeline.run` on the
Shelf sequence, with its quality, as one JSON line.

The counterpart of the repository's root `bench.py` (what the JAX
package's `bench` mode imports), inside the port's package:

- `measure(data_dir)` loads `data_dir/kps_opn` (OpenPose JSON, one
  sub-directory per camera) and `data_dir/calibs` (one calibration JSON
  per camera), runs `pipeline.run` on SHELF_BENCH in IK mode (its second
  pass timed) and returns the numbers, the reprojection metrics and
  `bench.py`'s quality gate;
- `main(data_dir)` prints `bench.py`'s JSON line from them and raises
  `SystemExit` when the gate fails.

The gate's bands are the Shelf sequence's own (tracklets, reprojection,
the two long tracks); on another scene call `measure`, whose gate is only
reported.  A missing `data_dir` raises `FileNotFoundError`: no other scene
is ever put in its place.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# the Shelf dataset's place inside the checkout (`data/shelf`, the layout
# the CLI's examples name); absent until the dataset is committed there
SHELF_DIR = REPO / "data" / "shelf"
BASELINE_FPS = 100.0


def backend_name(dev) -> str:
    """The device type, with the card's name on a GPU."""
    import torch

    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return dev.type


def measure(data_dir=SHELF_DIR, max_frames: int = 300, device="cuda") -> dict:
    """Track `data_dir`'s sequence as `bench.py` does (SHELF_BENCH at
    `max_frames`, IK on) on `device` ("cuda" unless the caller asks for
    "cpu").  Returns a dict: `result` (the `RunResult`), `metrics`
    (`eval.reprojection_metrics`), `gate` (bench.py's quality bands, each
    True or False), `quality_ok`, `compile_s` (the first pass's time beyond
    the timed one) and `backend`."""
    from multiview_motion_capture_torch import pipeline
    from multiview_motion_capture_torch.cameras import CameraBank
    from multiview_motion_capture_torch.config import SHELF_BENCH
    from multiview_motion_capture_torch.data.ingest import load_openpose_dir
    from multiview_motion_capture_torch.eval import reprojection_metrics
    from multiview_motion_capture_torch.utils.precision import resolve_device

    data_dir = Path(data_dir)
    if not data_dir.is_dir():
        raise FileNotFoundError(f"no benchmark data directory at {data_dir}")
    dev = resolve_device(device)
    cfg = dataclasses.replace(SHELF_BENCH, max_frames=max_frames)
    batch = load_openpose_dir(data_dir / "kps_opn", cfg)
    cams = CameraBank.from_json_dir(data_dir / "calibs")

    res = pipeline.run(batch, cams, cfg, use_ik=True, device=dev)
    m = reprojection_metrics(res.tracklets, batch, cams)
    # bench.py's bands (bench.py:43-62): the Shelf sequence's envelope
    gate = {
        "median_le": m.median_reproj_px <= 6.6,
        "mean_le": m.mean_reproj_px <= 9.3,
        "tracklet_band": 20 <= len(res.tracklets) <= 32,
        "long_tracks": len([x for x in m.lengths if x >= 190]) >= 2,
        "no_degenerate": m.n_degenerate_poses == 0,
    }
    return {"result": res, "metrics": m, "gate": gate, "quality_ok": all(gate.values()),
            "compile_s": res.timings.get("warmup+track", 0.0) - res.track_time_s,
            "backend": backend_name(dev)}


def reproj_mean_trend(root: Path = REPO) -> dict:
    """The mean reprojection (px) of each earlier run recorded in the
    repository's `BENCH_r0*.json` files, keyed by run ("r01", ...), as
    bench.py reads them (bench.py:63-73)."""
    trend = {}
    for p in sorted(Path(root).glob("BENCH_r0*.json")):
        try:
            rec = json.loads(p.read_text())
            line = [ln for ln in rec.get("tail", "").splitlines() if ln.startswith("{")][0]
            trend[p.stem.replace("BENCH_", "")] = json.loads(line)["extra"]["reproj_px_mean"]
        except Exception:
            pass
    return trend


def main(data_dir=SHELF_DIR, device="cuda") -> dict:
    """Print bench.py's one JSON line (metric, value, unit, vs_baseline,
    extra) for `data_dir`'s 300 frames; raise `SystemExit` when bench.py's
    quality gate fails, after the line.  Returns the line."""
    out = measure(data_dir, device=device)
    res, m = out["result"], out["metrics"]
    fps = res.fps
    line = {
        "metric": "shelf_e2e_fps_5cam_ik",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "extra": {
            "n_frames": res.n_frames,
            "n_tracklets": len(res.tracklets),
            "top_track_lengths": m.lengths[:5],
            "reproj_px_mean": round(m.mean_reproj_px, 2),
            "reproj_px_median": round(m.median_reproj_px, 2),
            "n_degenerate_poses": m.n_degenerate_poses,
            "track_time_s": round(res.track_time_s, 4),
            "compile_s": round(out["compile_s"], 2),
            "backend": out["backend"],
            "reproj_mean_trend": {**reproj_mean_trend(), "now": round(m.mean_reproj_px, 2)},
            "quality_ok": out["quality_ok"],
            **({} if out["quality_ok"] else {"quality_gate": out["gate"]}),
        },
    }
    print(json.dumps(line), flush=True)
    if not out["quality_ok"]:
        raise SystemExit(f"bench quality gate FAILED: {out['gate']}")
    return line
