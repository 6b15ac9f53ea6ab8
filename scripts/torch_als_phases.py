#!/usr/bin/env python3
"""Where one ALS iteration's time goes inside `csrc/als.cu`, on one GPU.

    python scripts/torch_als_phases.py [--cases b1_frame0,b1_n336,b3_rig128]

Builds an instrumented copy of `multiview_motion_capture_torch/csrc/als.cu`
into `build/torch_kernels/`: thread 0 of the first block (warp 0, which
eliminates the left blocks) reads the SM clock (`clock64()`) at the top of
every iteration, after every barrier of the loop and after its Gram gather
and its elimination, so each phase's time includes the wait for the
slowest thread (and, at a cluster barrier, the slowest block); the phase
after an elimination is the time the product side took beyond it.  Thread
32 (warp 1, on the product side) stamps its own phases: the X step, its
products and applied steps, the barriers and the shared phases.  The
kernel's arithmetic is unchanged.  Cycles are turned into microseconds
with the launch's own CUDA-event time.  The cases are those of
`scripts/torch_als_timing.py`.  Prints one JSON line: per case the mean
microseconds per iteration of each phase on both sides, their sum, and the
card's `nvidia-smi` name and power limit.  Needs a GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# The loop's phases, in order: each ends at the stamp after it.  The last
# runs from the partials' cluster barrier to the top of the next iteration.
PHASES = ("Gram share (A^T A) + split barrier", "gather Gram (A^T A)", "left elimination (A^T A)",
          "X step, products, applied steps (B^T) beyond it, cluster barrier",
          "gather B^T and X-step rows", "Gram share (B^T B) + split barrier",
          "gather Gram (B^T B)", "left elimination (B^T B)",
          "products, applied steps (A^T) beyond it, cluster barrier", "gather A^T",
          "X = A B^T, projection, Y, partials", "cluster barrier (partials)",
          "totals (warp 0)", "stop test")
# Lines of the loop after which thread 0 stamps the clock.
STAMPED = ("__syncthreads();", "cluster.sync();", "cluster_wait();",
           "if (elim_side) gather_gram(gram, S, r, R, pcol);",
           "if (warp == 0) eliminate(R, r, lam, pcol, rcps, &progress, base);")
# The product side's phases (thread 32 of the first block), the same way.
PRODUCT_PHASES = ("X step", "products, applied steps (B^T)", "cluster barrier (B^T)",
                  "gather B^T and X-step rows", "products, applied steps (A^T)",
                  "cluster barrier (A^T)", "gather A^T", "X = A B^T, projection, Y, partials",
                  "cluster barrier (partials)", "totals (warp 0)", "stop test")
PRODUCT_STAMPED = ("__syncthreads();", "cluster.sync();", "product_warps_sync();",
                   "solve_right(R, F, ldF, Xn, ldS, n, r, wq, pcol, rcps, &progress, base, Bq, w);",
                   "if (!elim_side) solve_right(R, F, ldF, Zb, ldS, n, r, wq, pcol, rcps, "
                   "&progress, base, Aq, w);")
MAX_ITERS = 128
LOOP_HEAD = "  while (it < max_iter && !done) {\n"
LOOP_END = "\n  // x_bin = (X + X^T) / 2"
PRELUDE = f"""
__device__ long long als_clk[{MAX_ITERS} * {len(PHASES)}];
__device__ long long als_clk2[{MAX_ITERS} * {len(PRODUCT_PHASES)}];
#define ALS_STAMP()                                                        \\
  if (threadIdx.x == 0 && blockIdx.x == 0 && it < {MAX_ITERS})            \\
    als_clk[it * {len(PHASES)} + (slot++)] = clock64();
#define ALS_STAMP2()                                                       \\
  if (threadIdx.x == 32 && blockIdx.x == 0 && it < {MAX_ITERS})           \\
    als_clk2[it * {len(PRODUCT_PHASES)} + (slot2++)] = clock64();
"""
READER = """
extern "C" int als_read_clocks(void* host, int count, int side) {
  const size_t bytes = count * sizeof(long long);
  return static_cast<int>(side ? cudaMemcpyFromSymbol(host, als_clk2, bytes)
                               : cudaMemcpyFromSymbol(host, als_clk, bytes));
}
"""


def instrumented_source(src: str) -> str:
    start = src.index(LOOP_HEAD)
    end = src.index(LOOP_END, start)
    out, stamps, stamps2 = [], 0, 0
    for line in src[start:end].split("\n"):
        out.append(line)
        indent = line[:len(line) - len(line.lstrip())]
        if line == LOOP_HEAD.rstrip("\n"):
            out += ["    int slot = 0, slot2 = 0;", "    ALS_STAMP();", "    ALS_STAMP2();"]
            stamps += 1
            stamps2 += 1
            continue
        if line.strip() in STAMPED:
            out.append(indent + "ALS_STAMP();")
            stamps += 1
        if line.strip() in PRODUCT_STAMPED:
            out.append(indent + "ALS_STAMP2();")
            stamps2 += 1
    if stamps != len(PHASES) or stamps2 != len(PRODUCT_PHASES):
        raise SystemExit(f"als.cu's loop has {stamps} / {stamps2} stamps, expected "
                         f"{len(PHASES)} / {len(PRODUCT_PHASES)}: update the phases")
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
    subprocess.run([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC_DIR),
                    "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in cuda_lib.ALS_LIB.signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    lib.als_read_clocks.restype = ctypes.c_int
    lib.als_read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    return lib


def main() -> int:
    import argparse

    import numpy as np
    import torch

    from torch_als_timing import case_problems

    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="b1_frame0,b1_n336,b3_rig128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_als_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    lib = build(ROOT / "build" / "torch_kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"nvidia_smi": smi.splitlines()[0], "cases": {}}
    for case in args.cases.split(","):
        cfg, W, mask, init = case_problems(torch, case)
        C = W.shape[0] if W.dim() == 3 else 1
        n, rank = W.shape[-1], init.shape[1]
        x_bin = torch.empty((C, n, n), dtype=torch.bool, device="cuda")
        iters = torch.empty((C,), dtype=torch.int32, device="cuda")

        def launch():
            err = lib.als_solve_f32(
                W.data_ptr(), mask.data_ptr(), init.data_ptr(), C, n, rank,
                float(cfg.als_alpha), float(cfg.als_beta), float(cfg.als_mu),
                float(cfg.als_tol), cfg.als_max_iter, cfg.als_stable_iters,
                x_bin.data_ptr(), None, iters.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
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
        sides = {}
        for side, names in enumerate((PHASES, PRODUCT_PHASES)):
            clk = np.zeros(MAX_ITERS * len(names), dtype=np.int64)
            if lib.als_read_clocks(clk.ctypes.data, clk.size, side) != 0:
                raise RuntimeError("als_read_clocks failed")
            clk = clk.reshape(MAX_ITERS, len(names))[:it]
            # phase p ends at stamp p + 1; the last ends at the next iteration's top
            d = np.diff(np.concatenate([clk.reshape(-1), [clk[-1, -1]]]).astype(np.float64))
            d = d.reshape(it, len(names))[:-1]          # whole iterations only
            if side == 0:   # the stamped span covers it of the launch's iters[0] iterations
                us_per_cycle = (ms * 1e3 * it / (float(clk[-1, -1] - clk[0, 0]) * int(iters[0]))
                                if it > 1 else float("nan"))
            sides[side] = dict(zip(names, (d.mean(0) * us_per_cycle).tolist()))
        out["cases"][case] = {
            "shape": list(W.shape), "rank": rank, "iters": iters.tolist(), "launch_ms": ms,
            "us_per_iter_by_phase": sides[0], "us_per_iter": float(sum(sides[0].values())),
            "product_side_us_per_iter_by_phase": sides[1], "mhz_implied": 1.0 / us_per_cycle}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
