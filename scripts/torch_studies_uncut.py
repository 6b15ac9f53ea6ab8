"""The eight research studies' ports at their own sizes, on the card, one
after another in one process: each study's JSON with the B-kernel
launches it made (the counters set to 0 just before it and read just
after) and its wall seconds, one JSON line a study.

    python scripts/torch_studies_uncut.py [--data_dir DIR] [--only NAME ...] [--out FILE]

The three Shelf-layout studies (bench_quality_bisect, fragmentation,
oracle_parity) read `--data_dir`; without it they run on the smoke test's
300-frame, 4-person, 5-camera scene written in that layout (the `bench`
phase's, `chip_smoke.write_scene_files`) under `build/studies_scene/`.
The fragmentation and parity studies share one oracle run (cached under
`build/studies_oracle/`).  Runs on the card only; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

STUDIES = ("ik_iteration", "bench_quality_bisect", "crowd_detect", "style_holdout",
           "appearance_e2e", "identity", "fragmentation", "oracle_parity")


def scene_dir() -> Path:
    """The smoke test's slice scene as Shelf-layout files (written once)."""
    from multiview_motion_capture_torch.cameras import camera_ring_k_rt
    from multiview_motion_capture_torch.config import SHELF_BENCH
    from multiview_motion_capture_torch.data.synthetic import synthetic_sequence

    root = REPO / "build" / "studies_scene"
    n = chip_smoke.SCENE["n_frames"]
    if not (root / "calibs").is_dir():
        seq = synthetic_sequence(cfg=dataclasses.replace(SHELF_BENCH, max_frames=None),
                                 **chip_smoke.SCENE)
        chip_smoke.write_scene_files(seq, root, n, kps_dir="kps_opn",
                                     calib=camera_ring_k_rt(chip_smoke.SCENE["n_views"])[:2])
    return root


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--only", nargs="+", choices=STUDIES, default=list(STUDIES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from multiview_motion_capture_torch.ops import cuda_lib
    from multiview_motion_capture_torch.utils.precision import resolve_device

    resolve_device("cuda")
    smi = chip_smoke.phase_env(torch)
    cuda_lib.build_all()
    data = args.data_dir or str(scene_dir())
    cache = str(REPO / "build" / "studies_oracle")
    calls = {
        "ik_iteration": ("torch_ik_iteration_study", []),
        "bench_quality_bisect": ("torch_bench_quality_bisect", ["--data_dir", data]),
        "crowd_detect": ("torch_crowd_detect_study", []),
        "style_holdout": ("torch_detector_style_holdout", []),
        "appearance_e2e": ("torch_appearance_e2e_study", []),
        "identity": ("torch_identity_study", []),
        "fragmentation": ("torch_fragmentation_study",
                          ["--data_dir", data, "--oracle_cache", cache]),
        "oracle_parity": ("torch_oracle_parity_study",
                          ["--data_dir", data, "--oracle_cache", cache, "--out",
                           str(REPO / "build" / "studies_oracle_parity.json")]),
    }
    out = open(args.out, "w") if args.out else None
    lines = []
    for name in args.only:
        script, argv_ = calls[name]
        try:
            res, launches, wall = chip_smoke.study_call(
                chip_smoke.script_module(script).main, argv_)
            line = {"study": name, "device": smi, "wall_s": wall, "launches": launches,
                    "json": res}
        except Exception:
            line = {"study": name, "device": smi, "error": traceback.format_exc()[-3000:]}
        lines.append(line)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return lines


if __name__ == "__main__":
    sys.exit(1 if any("error" in ln for ln in main()) else 0)
