// Batched no-pivot Gauss-Jordan solve of damped SPD systems, for Hopper.
//
// Replaces: multiview_motion_capture_tpu/ops/solve_pallas.py:_gj_kernel_3d
// (entry `batched_spd_solve(one_program=True)`) and _gj_kernel (one program
// per system, `one_program=False`): on Hopper both launch shapes are this
// one, a block per system (ops/solve_kernel.py counts the two entries
// apart).  It solves the
// T Levenberg-Marquardt normal-equation systems
//   (J^T J + (lam + ridge) I + frozen_diag) x = g,  D = 68 parameters,
// one per track slot, once per LM iteration (ops/ik.py).
//
// What bounds it on this card: at the main path's shape (T = 8, D = 68) the
// bytes are ~150 KB in and 2 KB out (about 50 ns at 3.35 TB/s) and the
// arithmetic ~5 MFLOP (under 0.1 us at 67 TFLOP/s f32), so neither the
// memory nor the FP32 units are the limit: the 68 pivot steps are a chain of
// dependent steps, each needing the previous one's row, and the kernel is
// latency-bound by that chain (two block barriers per step).
//
// Design: one thread block per system holds its augmented block [A | g]
// (D x (D+1) f32, ~19 KB) in shared memory for the whole elimination; the
// T blocks run side by side on T SMs.  Each step scales the pivot row into a
// buffer and copies column k, then every thread eliminates its share of the
// block.  No pivoting: the damped systems are SPD with a ridge on the
// diagonal (the TPU kernel pivots no more than this).  The solution column
// is written straight to x (T, D).  The products and differences use the
// round-to-nearest intrinsics so no multiply-add is contracted: the kernel
// then rounds exactly as the plain torch version (ops/solve_kernel.py).
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
gj_solve_kernel(const float* __restrict__ A, const float* __restrict__ g,
                float* __restrict__ x, int D) {
  extern __shared__ float4 smem_f4[];
  float* aug = reinterpret_cast<float*>(smem_f4);
  const int C = D + 1;
  float* prow = aug + D * C;
  float* pcol = prow + C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* At = A + static_cast<size_t>(blockIdx.x) * D * D;
  const float* gt = g + static_cast<size_t>(blockIdx.x) * D;

  for (int e = tid; e < D * C; e += nt) {
    const int i = e / C, j = e - i * C;
    aug[e] = (j < D) ? At[i * D + j] : gt[i];
  }
  __syncthreads();

  for (int k = 0; k < D; ++k) {
    const float piv = aug[k * C + k];
    for (int j = tid; j < C; j += nt) prow[j] = __fdiv_rn(aug[k * C + j], piv);
    for (int i = tid; i < D; i += nt) pcol[i] = aug[i * C + k];
    __syncthreads();
    for (int e = tid; e < D * C; e += nt) {
      const int i = e / C, j = e - i * C;
      aug[e] = (i == k) ? prow[j]
                        : __fsub_rn(aug[e], __fmul_rn(pcol[i], prow[j]));
    }
    __syncthreads();
  }

  float* xt = x + static_cast<size_t>(blockIdx.x) * D;
  for (int i = tid; i < D; i += nt) xt[i] = aug[i * C + D];
}

}  // namespace

extern "C" int gj_solve_f32(const void* A, const void* g, void* x, int T,
                            int D, void* stream) {
  if (T <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (static_cast<size_t>(D) * (D + 1) + (D + 1) + D) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gj_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gj_solve_kernel<<<T, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(g),
      static_cast<float*>(x), D);
  return static_cast<int>(cudaGetLastError());
}
