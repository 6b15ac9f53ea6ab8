"""The readings that the output check's limits are set from.

    python3 -m mocap_bench.control --workload <name> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 5] [--frames 160] [--fault NAME]

- The program's readings: for each program seed, one run of the cell as
  `run.py` makes it (set-up, warm-up, a window of `--seconds`, the judge),
  its numbers printed; with `--fault`, with that fault (`faults.py`)
  planted under the timed path.
- The control's: the reference itself, computed one precision below the
  configuration's (float32 where the tracker's working precision is
  float64, the ALS's products in TF32 where the kernel computes in float32
  with TF32 off), put in the program's place: it tracks the take's
  warm-up and `--frames` more frames from the empty state, and the float64
  reference judges its frames as it judges the program's (the take's first
  frame and as many window frames as a run judges, drawn from the seed).

Each reading is one JSON line on standard output.  Runs on the card;
`control_reading` takes the CPU and `run.run_cell`'s overrides for a
rehearsal at a size the CPU holds (`tests/test_control.py`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def control_outputs(rc_low, kps: np.ndarray, valid: np.ndarray, n: int):
    """The low-precision reference tracking the take's first `n` frames
    from the empty state: its output frames and their take frame ids."""
    from mocap_bench import reference as ref

    st = ref.RefState.zeros(rc_low.T)
    outs = []
    for f in range(n):
        st, out = ref.step(rc_low, st, kps[f], valid[f])
        outs.append(out)
    return outs, list(range(n))


def control_reading(cell, seed: int, frames: int, device: str, overrides: dict = None) -> dict:
    import torch

    from mocap_bench import check, reference, scene, spec

    pipeline, rig, traffic, scn = spec.merged(cell, overrides)
    dev = torch.device(device)
    cal = scene.camera_ring(rig)
    warm = int(traffic["warmup_frames"])
    n = warm + frames
    take = scene.make_take(cal, scn, int(pipeline["max_people"]), n, seed, dev)
    kps, valid = take.kps.cpu().numpy(), take.valid.cpu().numpy()
    t0 = time.perf_counter()
    low = reference.RefContext(cal.K, cal.Rt, pipeline, work=np.float32, device=dev,
                               als_tf32=True)
    outs, ids = control_outputs(low, kps, valid, n)
    t1 = time.perf_counter()
    rc = reference.RefContext(cal.K, cal.Rt, pipeline, device=dev)
    judged = sorted(set([0] + check.sample(list(range(warm, n)), int(traffic["check_frames"]),
                                           seed)))
    numbers = check.judge(rc, kps, valid, ids, outs, judged)
    numbers.update(track_s=t1 - t0, judge_s=time.perf_counter() - t1)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--frames", type=int, default=160)
    p.add_argument("--fault", default=None, help="plant this fault (faults.py) under the "
                   "program's runs")
    a = p.parse_args(argv)
    import contextlib

    from mocap_bench import check, faults, run, spec

    cell = spec.load_cell(a.workload)
    seeds = [int(s) for s in a.program_seeds.split(",") if s]
    for s in seeds:
        t0 = time.perf_counter()
        with faults.planted(a.fault) if a.fault else contextlib.nullcontext():
            out = run.run_cell(cell, s, a.seconds, False, t_start=t0)
        print(json.dumps({"side": a.fault or "program", "seed": s, "numbers": out["numbers"],
                          "counts": out["counts"], "correct": out["line"]["correct"]}), flush=True)
    for s in [int(s) for s in a.control_seeds.split(",") if s]:
        numbers = control_reading(cell, s, a.frames, "cuda")
        print(json.dumps({"side": "control", "seed": s, "numbers": numbers,
                          "correct": check.verdict(numbers, cell.limits["limits"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
