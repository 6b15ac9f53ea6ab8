// Batched no-pivot Gauss-Jordan solve of damped SPD systems, for Hopper.
//
// Replaces: multiview_motion_capture_tpu/ops/solve_pallas.py:_gj_kernel_3d
// (entry `batched_spd_solve(one_program=True)`) and _gj_kernel (one program
// per system, `one_program=False`): on Hopper both launch shapes are this
// one, a block per system (ops/solve_kernel.py counts the two entries
// apart).  It solves the T Levenberg-Marquardt normal-equation systems
//   (J^T J + (lam + ridge) I + frozen_diag) x = g,  D = 68 parameters,
// one per track slot, once per LM iteration (ops/ik.py).
//
// What bounds it on this card: at the main path's shape (T = 8, D = 68) the
// bytes are ~150 KB in and 2 KB out (about 50 ns at 3.35 TB/s) and the
// arithmetic ~5 MFLOP (under 0.1 us at 67 TFLOP/s f32), so neither the
// memory nor the FP32 units are the limit: the D pivot steps are a chain,
// each needing the previous one's row and column, and the kernel is
// latency-bound by that chain.
//
// Design (the elimination is gj_elim.cuh's, shared with B4): one block of
// 16 x 16 threads per system, the T blocks side by side on T SMs.  Each
// thread holds a P x P tile of [A | g] in registers, P = ceil((D + 1) / 16)
// (5 at D = 68), every register index known at compile time.  A pivot step
// is one block barrier, two short reads of the pivot row's quotients and
// column from shared memory, the multiply-subtracts of the tile's live
// columns, and the look-ahead of the next pivot row and column by the
// threads that own them; the solution column is written straight to x
// (T, D).  No pivoting: the damped systems are SPD with a ridge on the
// diagonal (the TPU kernel pivots no more than this).
//
// Limit: the whole block lives in the block's registers, so D is at most
// 191 (P = 12: 144 tile registers of a thread's 255; at the earlier limit of
// 230, P = 15 and a thread would need 225 registers for its tile alone, and
// the D x (D + 1) block would fill 81% of the SM's 65,536 registers).
#include <cuda_runtime.h>

#include "gj_elim.cuh"

namespace {

constexpr int kMaxP = 12;

template <class Tl>
__global__ void __launch_bounds__(Tl::kThreads)
gj_solve_kernel(const float* __restrict__ A, const float* __restrict__ g,
                float* __restrict__ x, int D) {
  __shared__ float slots[Tl::kSmemFloats];
  const size_t t = blockIdx.x;
  const float* At = A + t * D * D;
  const float* gt = g + t * D;
  gj::eliminate<Tl>(
      D, [=](int r, int c) { return c < D ? At[r * D + c] : gt[r]; }, slots, x + t * D);
}

// Calls f(Tiling) for the 16 x 16-thread tiling of side D;
// cudaErrorInvalidValue where there is none.
template <class F>
cudaError_t with_tiling(int D, F&& f) {
  auto fits = [&](auto tl) {
    return (D >= 1 && D <= decltype(tl)::kMaxD) ? f(tl) : cudaErrorInvalidValue;
  };
  switch ((D + 16) / 16) {  // P = ceil((D + 1) / 16)
    case 1: return fits(gj::Tiling<16, 1>{});
    case 2: return fits(gj::Tiling<16, 2>{});
    case 3: return fits(gj::Tiling<16, 3>{});
    case 4: return fits(gj::Tiling<16, 4>{});
    case 5: return fits(gj::Tiling<16, 5>{});
    case 6: return fits(gj::Tiling<16, 6>{});
    case 7: return fits(gj::Tiling<16, 7>{});
    case 8: return fits(gj::Tiling<16, 8>{});
    case 9: return fits(gj::Tiling<16, 9>{});
    case 10: return fits(gj::Tiling<16, 10>{});
    case 11: return fits(gj::Tiling<16, 11>{});
    case kMaxP: return fits(gj::Tiling<16, kMaxP>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest D the kernel takes.
extern "C" int gj_max_d() { return gj::Tiling<16, kMaxP>::kMaxD; }

// Solve T systems of side D: A (T, D, D), g and x (T, D).  Returns the
// launch's cudaError_t.
extern "C" int gj_solve_f32(const void* A, const void* g, void* x, int T, int D,
                            void* stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_tiling(D, [&](auto tl) {
    using Tl = decltype(tl);
    gj_solve_kernel<Tl><<<T, Tl::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<const float*>(g), static_cast<float*>(x), D);
    return cudaGetLastError();
  }));
}

// The launch shape at D, into out[0..4]: threads per block, blocks per
// system, shared memory bytes per block, registers per thread and local
// (spill) bytes per thread, as ptxas assigned them.  Returns a cudaError_t.
extern "C" int gj_launch_shape(int D, void* out) {
  return static_cast<int>(with_tiling(D, [&](auto tl) {
    using Tl = decltype(tl);
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, gj_solve_kernel<Tl>);
    if (err != cudaSuccess) return err;
    int* o = static_cast<int*>(out);
    o[0] = Tl::kThreads;
    o[1] = 1;
    o[2] = static_cast<int>(fa.sharedSizeBytes);
    o[3] = fa.numRegs;
    o[4] = static_cast<int>(fa.localSizeBytes);
    return cudaSuccess;
  }));
}
