#!/usr/bin/env python3
"""Time the port's LM solve kernels (B2 Gauss-Jordan, B4 fused normal
equations) on one GPU, and what their design choices are worth.

    python scripts/torch_solve_timing.py [--root DIR] [--reps 200] [--rounds 5]
    python scripts/torch_solve_timing.py --variants base,fdiv,tile1x4,threads64,cluster2

Imports `multiview_motion_capture_torch` from the checkout at DIR (default:
the one holding this script) and builds its kernels.  The inputs and the
timing come from `chip_smoke.py` beside this script (`spd_systems`,
`lm_inputs`, `gj_route_systems`, `cuda_time_ms`, `device_ms`), so every
checkout timed gets the same inputs and the same clocks.

Without --variants it times, through the wrappers, by CUDA events (median
over rounds of the mean of back-to-back calls) and by device time (the
summed kernel durations of as many calls by torch.profiler):

- `b2_t8`, `b2_t16`: `batched_spd_solve` on T = 8 (SHELF_BENCH's track
  slots) and T = 16 (the wide rig's) seeded damped SPD systems of D = 68;
- `b4_wide`: `fused_normal_solve` on the wide rig's LM shape (T = 16 slots,
  R = 512 rows, D = 68, the side-length columns frozen), and beside it the
  "gj route" (two `torch.einsum` and B2) on the same systems.

Each case prints whether x equals the plain version bit for bit and a
digest of x (equal across checkouts whose kernels are bit-equal).  To
compare two checkouts, run it for each in turn on one card (parent,
change, change, parent).

With --variants it builds copies of the checkout's `csrc/gj_solve.cu`,
`fused_normal_gj.cu` and `gj_elim.cuh` into
`build/torch_kernels/variants/<variant>/`, each with one design choice
changed and B4 instrumented: thread 0 of the first block reads the global
timer (ns) at the kernel's start, after the Gram's last chunk, after the
cluster barrier that closes the gather into the leader block, after the
diagonal shift and at the end, so each phase includes the wait for the
slowest thread (at the cluster barrier, the slowest block).  The
arithmetic is unchanged.  Variants:

- `base`: the sources as they are;
- `fdiv`: each quotient of the elimination by `__fdiv_rn` instead of the
  product with the double reciprocal of the pivot (gj_elim.cuh);
- `tileRxC`: B4's Gram tiles of R rows x C columns of G (R in 1, 2, 4; C in
  2, 4) instead of 2 x 4;
- `threadsN`: B2 with N threads per block (64: 8 x 8 threads holding 9 x 9
  tiles; 1024: 32 x 32 holding 3 x 3) instead of 256 (16 x 16, 5 x 5);
- `clusterN`: B4 in clusters of N blocks (2 or 8) instead of 4.

On the wide rig's LM shape (B4 on [J | r], B2 on the gj route's systems),
each variant prints the device time per launch of B2 and B4 (50 launches),
B4's phases in microseconds (median of 20 launches), and whether each
equals its plain version bit for bit.  Prints one JSON line, with the
card's `nvidia-smi` name and power limit.  Needs a GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

PHASES = ("gram", "gather", "shift", "elimination")
PRELUDE = """
__device__ unsigned long long phase_ns[8];
#define PHASE_STAMP(i)                                                      \\
  if (blockIdx.x == 0 && threadIdx.x == 0) {                                \\
    unsigned long long t_;                                                  \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \\
    phase_ns[i] = t_;                                                       \\
  }
"""
READER = """
extern "C" int read_phase_ns(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, phase_ns, sizeof(phase_ns)));
}
"""
ELIMINATE_END = "slots, x + static_cast<size_t>(slot) * D);\n"
FIXED_TILING = """
template <int S, int P, class F>
cudaError_t fixed_tiling(int D, F&& f) {
  return (D >= 1 && D <= gj::Tiling<S, P>::kMaxD) ? f(gj::Tiling<S, P>{}) : cudaErrorInvalidValue;
}
"""
B2_LAUNCH = "(D, [&](auto tl) {\n    using Tl = decltype(tl);\n    gj_solve_kernel<Tl><<<"
# threads per block -> (threads per row of the grid, tile side) at D = 68
B2_SHAPES = {64: (8, 9), 256: (16, 5), 1024: (32, 3)}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(x) -> str:
    return hashlib.sha1(x.cpu().numpy().tobytes()).hexdigest()[:12]


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def replace_once(src: str, old: str, new: str, what: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"{what}: the source no longer has the text this variant rewrites")
    return src.replace(old, new)


def insert(src: str, anchor: str, text: str, after: bool = False) -> str:
    i = src.index(anchor) + (len(anchor) if after else 0)
    return src[:i] + text + src[i:]


def instrumented_fused(src: str) -> str:
    src = insert(src, "namespace {\n", PRELUDE, after=True)
    src = insert(src, '  asm volatile("barrier.cluster.arrive', "  PHASE_STAMP(0);\n")
    src = insert(src, "  // the tiles and their mirror images", "  PHASE_STAMP(1);\n")
    src = insert(src, "  if (rank != 0) return;", "  PHASE_STAMP(2);\n")
    src = insert(src, "  gj::eliminate<Tl>(", "  PHASE_STAMP(3);\n")
    src = insert(src, ELIMINATE_END, "  PHASE_STAMP(4);\n", after=True)
    return src + READER


def variant_sources(csrc: Path, name: str) -> dict:
    files = {f: (csrc / f).read_text() for f in ("gj_elim.cuh", "gj_solve.cu",
                                                 "fused_normal_gj.cu")}
    if name == "fdiv":
        files["gj_elim.cuh"] = replace_once(files["gj_elim.cuh"],
                                            "slot[c] = quotient(nr[j], rcp);",
                                            "slot[c] = __fdiv_rn(nr[j], piv);", name)
    elif name.startswith("tile"):
        rows, cols = (int(v) for v in name[4:].split("x"))
        files["fused_normal_gj.cu"], n = re.subn(
            r"constexpr int kTU = \d+, kTV = \d+;", f"constexpr int kTU = {rows}, kTV = {cols};",
            files["fused_normal_gj.cu"])
        if n != 1:
            raise RuntimeError(f"{name}: fused_normal_gj.cu no longer sets its tile in one line")
    elif name.startswith("threads"):
        S, P = B2_SHAPES[int(name[7:])]
        src = insert(files["gj_solve.cu"], "namespace {\n", FIXED_TILING, after=True)
        files["gj_solve.cu"] = replace_once(src, "with_tiling" + B2_LAUNCH,
                                            f"fixed_tiling<{S}, {P}>" + B2_LAUNCH, name)
    elif name.startswith("cluster"):
        files["fused_normal_gj.cu"] = replace_once(
            files["fused_normal_gj.cu"], "constexpr int kCluster = 4;",
            f"constexpr int kCluster = {int(name[7:])};", name)
    elif name != "base":
        raise SystemExit(f"unknown variant {name}")
    files["fused_normal_gj.cu"] = instrumented_fused(files["fused_normal_gj.cu"])
    return files


def build_variant(cuda_lib, name: str) -> tuple:
    out = cuda_lib.BUILD_DIR / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for f, text in variant_sources(cuda_lib.CSRC_DIR, name).items():
        (out / f).write_text(text)
    procs = {cu: subprocess.Popen([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                                   str(out / f"lib{Path(cu).stem}.so"), str(out / cu)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cu in ("gj_solve.cu", "fused_normal_gj.cu")}
    for cu, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{cu}:\n{log}")
    gj = ctypes.CDLL(str(out / "libgj_solve.so"))
    gj.gj_solve_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fused = ctypes.CDLL(str(out / "libfused_normal_gj.so"))
    fused.fused_normal_gj_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fused.read_phase_ns.argtypes = [ctypes.c_void_p]
    return gj, fused


def time_wrappers(torch, cs, args) -> dict:
    """B2 at T 8 and 16 and B4 on the wide shape through the wrappers."""
    from multiview_motion_capture_torch.ops import cuda_lib, ik, solve_kernel

    cuda_lib.build_all()

    def timed(fn) -> dict:
        return {"ms": cs.cuda_time_ms(fn, args.reps, args.rounds),
                "device_ms": cs.device_ms(fn, args.reps)}

    cases = {}
    for T, seed in ((8, 0), (16, 4)):
        A, b = cs.spd_systems(torch, "cuda", T, 68, seed)
        x = solve_kernel.batched_spd_solve(A, b)
        cases[f"b2_t{T}"] = {"T": T, "D": 68, "x_digest": digest(x),
                             "bit_equal": torch.equal(x, solve_kernel.gauss_jordan_plain(A, b)),
                             **timed(lambda: solve_kernel.batched_spd_solve(A, b))}
    T, R, D = 16, 512, 68
    J, r, lam, frozen, Jaug = cs.lm_inputs(torch, "cuda", T, R, D, 2, free=ik._FREE_POSE)
    eye = torch.eye(D, device="cuda")

    def gj_route():
        return solve_kernel.batched_spd_solve(*cs.gj_route_systems(torch, J, r, lam, frozen, eye))

    x = solve_kernel.fused_normal_solve(Jaug, lam, frozen)
    route = timed(gj_route)
    cases["b4_wide"] = {"T": T, "R": R, "D": D, "x_digest": digest(x),
                        "bit_equal": torch.equal(x, solve_kernel.fused_normal_plain(Jaug, lam,
                                                                                   frozen)),
                        **timed(lambda: solve_kernel.fused_normal_solve(Jaug, lam, frozen)),
                        "gj_route_ms": route["ms"], "gj_route_device_ms": route["device_ms"]}
    return cases


def time_variants(torch, cs, names) -> dict:
    from multiview_motion_capture_torch.ops import cuda_lib, ik, solve_kernel

    T, R, D = 16, 512, 68
    J, r, lam, frozen, Jaug = cs.lm_inputs(torch, "cuda", T, R, D, 2, free=ik._FREE_POSE)
    A, g = cs.gj_route_systems(torch, J, r, lam, frozen, torch.eye(D, device="cuda"))
    plain_b2 = solve_kernel.gauss_jordan_plain(A, g)
    plain_b4 = solve_kernel.fused_normal_plain(Jaug, lam, frozen)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in names:
        gj, fused = build_variant(cuda_lib, name)
        x2 = torch.empty_like(g)
        x4 = torch.empty_like(g)

        def b2():
            err = gj.gj_solve_f32(A.data_ptr(), g.data_ptr(), x2.data_ptr(), T, D, stream)
            if err != 0:
                raise RuntimeError(f"{name}: gj_solve_f32 cudaError {err}")

        def b4():
            err = fused.fused_normal_gj_f32(Jaug.data_ptr(), lam.data_ptr(), frozen.data_ptr(),
                                            x4.data_ptr(), T, R, D, stream)
            if err != 0:
                raise RuntimeError(f"{name}: fused_normal_gj_f32 cudaError {err}")

        res = {"b2_us": cs.device_ms(b2, 50) * 1e3, "b4_us": cs.device_ms(b4, 50) * 1e3}
        torch.cuda.synchronize()
        res["b2_bit_equal"] = torch.equal(x2, plain_b2)
        res["b4_bit_equal"] = torch.equal(x4, plain_b4)
        phases = []
        for _ in range(20):
            b4()
            torch.cuda.synchronize()
            ns = (ctypes.c_ulonglong * 8)()
            fused.read_phase_ns(ns)
            phases.append([(ns[i + 1] - ns[i]) / 1e3 for i in range(len(PHASES))])
        res["b4_phases_us"] = {p: statistics.median(v[i] for v in phases)
                               for i, p in enumerate(PHASES)}
        out[name] = res
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--variants", default="",
                    help="comma-separated design variants to build and time instead")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("torch_solve_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from multiview_motion_capture_torch.utils.precision import high_precision

    high_precision()
    cs = load_chip_smoke()
    out = {"root": args.root, "nvidia_smi": nvidia_smi()}
    if args.variants:
        out["variants"] = time_variants(torch, cs, args.variants.split(","))
    else:
        out["cases"] = time_wrappers(torch, cs, args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
