#!/usr/bin/env python3
"""Where one ALS iteration's time goes inside `csrc/als.cu`, on one GPU.

    python scripts/torch_als_phases.py [--cases b1_frame0,b3_wide64]

Builds an instrumented copy of `multiview_motion_capture_torch/csrc/als.cu`
into `build/torch_kernels/`: thread 0 of the first block reads the SM clock
(`clock64()`) at the top of every iteration and after every barrier of the
loop, so each phase's time includes the wait for the slowest thread (and,
at a cluster barrier, the slowest block).  The kernel's arithmetic is
unchanged.  Cycles are turned into microseconds with the launch's own
CUDA-event time.  The cases are those of `scripts/torch_als_timing.py`.
Prints one JSON line: per case the mean microseconds per iteration of each
phase, their sum, and the card's `nvidia-smi` name and power limit.  Needs
a GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# The loop's phases, in order: each ends at the barrier after it.  The last
# runs from the partials' cluster barrier to the top of the next iteration.
PHASES = ("X step", "Gram + right side (B^T)", "ridge solve (B^T) + cluster barrier",
          "gather B^T and X-step rows", "Gram + right side (A^T)",
          "ridge solve (A^T) + cluster barrier", "gather A^T",
          "X = A B^T, projection, Y, partials", "cluster barrier (partials)",
          "totals, stop test")
MAX_ITERS = 128
LOOP_HEAD = "  while (it < max_iter && !done) {\n"
LOOP_END = "\n  // x_bin = (X + X^T) / 2"
PRELUDE = f"""
__device__ long long als_clk[{MAX_ITERS} * {len(PHASES)}];
#define ALS_STAMP()                                                        \\
  if (threadIdx.x == 0 && blockIdx.x == 0 && it < {MAX_ITERS})            \\
    als_clk[it * {len(PHASES)} + (slot++)] = clock64();
"""
READER = """
extern "C" int als_read_clocks(void* host, int count) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, als_clk, count * sizeof(long long)));
}
"""


def instrumented_source(src: str) -> str:
    start = src.index(LOOP_HEAD)
    end = src.index(LOOP_END, start)
    out, stamps = [], 0
    for line in src[start:end].split("\n"):
        out.append(line)
        if line == LOOP_HEAD.rstrip("\n"):
            out += ["    int slot = 0;", "    ALS_STAMP();"]
            stamps += 1
        elif line.strip() in ("__syncthreads();", "cluster.sync();"):
            out.append(line[:len(line) - len(line.lstrip())] + "ALS_STAMP();")
            stamps += 1
    if stamps != len(PHASES):
        raise SystemExit(f"als.cu's loop has {stamps} barriers + top, expected {len(PHASES)}: "
                         "update PHASES")
    body = src[:start] + "\n".join(out) + src[end:]
    anchor = "namespace {\n"
    i = body.index(anchor) + len(anchor)
    return body[:i] + PRELUDE + body[i:] + READER


def build(torch_kernels: Path) -> ctypes.CDLL:
    from multiview_motion_capture_torch.ops import cuda_lib

    src = instrumented_source(cuda_lib.ALS_LIB.source_path.read_text())
    torch_kernels.mkdir(parents=True, exist_ok=True)
    cu = torch_kernels / "als_phases.cu"
    so = torch_kernels / "libals_phases.so"
    cu.write_text(src)
    subprocess.run([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in cuda_lib.ALS_LIB.signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    lib.als_read_clocks.restype = ctypes.c_int
    lib.als_read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main() -> int:
    import argparse

    import numpy as np
    import torch

    from torch_als_timing import _frame0_problems

    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="b1_frame0,b3_wide64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_als_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multiview_motion_capture_torch.config import SHELF_BENCH, PipelineConfig

    lib = build(ROOT / "build" / "torch_kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"nvidia_smi": smi.splitlines()[0], "cases": {}}
    for case in args.cases.split(","):
        if case == "b1_frame0":
            cfg = SHELF_BENCH
            W, mask, init = _frame0_problems(torch, cfg, 5, 4)
        elif case == "b3_wide64":
            cfg = PipelineConfig.wide(64, max_frames=None)
            W, mask, init = _frame0_problems(torch, cfg, 64, 10, noise_px=1.0, drop_prob=0.05)
        else:
            raise SystemExit(f"unknown case {case}")
        C = W.shape[0] if W.dim() == 3 else 1
        n, rank = W.shape[-1], init.shape[1]
        x_bin = torch.empty((C, n, n), dtype=torch.bool, device="cuda")
        iters = torch.empty((C,), dtype=torch.int32, device="cuda")

        def launch():
            err = lib.als_solve_f32(
                W.data_ptr(), mask.data_ptr(), init.data_ptr(), C, n, rank,
                float(cfg.als_alpha), float(cfg.als_beta), float(cfg.als_mu),
                float(cfg.als_tol), cfg.als_max_iter, cfg.als_stable_iters,
                x_bin.data_ptr(), iters.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"instrumented als_solve_f32 failed: cudaError {err}")

        launch()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        it = min(int(iters[0]), MAX_ITERS)
        clk = np.zeros(MAX_ITERS * len(PHASES), dtype=np.int64)
        if lib.als_read_clocks(clk.ctypes.data, clk.size) != 0:
            raise RuntimeError("als_read_clocks failed")
        clk = clk.reshape(MAX_ITERS, len(PHASES))[:it]
        # phase p ends at stamp p + 1; the last ends at the next iteration's top
        d = np.diff(np.concatenate([clk.reshape(-1), [clk[-1, -1]]]).astype(np.float64))
        d = d.reshape(it, len(PHASES))[:-1]          # whole iterations only
        us_per_cycle = ms * 1e3 / float(clk[-1, -1] - clk[0, 0]) if it > 1 else float("nan")
        per_phase = d.mean(0) * us_per_cycle
        out["cases"][case] = {
            "shape": list(W.shape), "rank": rank, "iters": iters.tolist(), "launch_ms": ms,
            "us_per_iter_by_phase": dict(zip(PHASES, per_phase.tolist())),
            "us_per_iter": float(per_phase.sum()), "mhz_implied": 1.0 / us_per_cycle}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
