// Fused LM normal-equation assembly and Gauss-Jordan solve, for Hopper.
//
// Replaces: multiview_motion_capture_tpu/ops/solve_pallas.py:_fused_normal_gj_kernel
// (entry `fused_normal_solve`, ik_solver="gj_fused", once per LM iteration
// in ops/ik.py).  For every track slot t, from Jaug_t = [J_t | r_t]
// (R x (D+1)):
//   G    = Jaug_t^T Jaug_t, first D rows: [J^T J | J^T r]   (D x (D+1))
//   tr   = trace of G[:, :D];  ridge = 1e-6 * (tr / D) + 1e-6
//   G   += (lam_t + ridge) I + diag(frozen)                  (first D columns)
//   x_t  = the solution column after no-pivot Gauss-Jordan on G
//
// What bounds it on this card: at the wide rig's shape (T = 16 slots,
// R = 512 residual rows of 16 views, D = 68) the input is 2.3 MB (0.7 us at
// 3.35 TB/s) and the work ~77 MFLOP for the products plus ~10 MFLOP for the
// eliminations (1.3 us at 67 TFLOP/s f32): the bound is the arithmetic, but
// the elimination's 68 dependent pivot steps, two block barriers each, and
// the R-long dependent sum of each entry are what the kernel waits on.
//
// Design: one block of 1024 threads per slot.  The rows of Jaug stream
// through shared memory in chunks of 32 (coalesced loads); every entry of
// the D x (D+1) block is owned by one thread, which keeps its running sum in
// a register and adds the chunk's products in row order, so J^T J and J^T r
// never leave the SM and the (T, D, D) normal matrices never round-trip
// device memory.  The diagonal shift and the elimination then run in place
// on the block in shared memory, as in gj_solve.cu, and the solution column
// is written straight to x (T, D).
//
// Rounding: every product and sum is one round-to-nearest intrinsic, each
// entry summed over the rows in index order and the trace over the diagonal
// in index order by one thread; the plain torch version
// (ops/solve_kernel.py:fused_normal_plain) performs the same operations in
// the same order, so the two agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPerThread = 8;   // entries a thread owns: D (D + 1) <= 8192
constexpr int kRowsPerChunk = 32;

size_t smem_bytes(int D) {
  const size_t C = static_cast<size_t>(D) + 1;
  return (D * C + C + D + kRowsPerChunk * C) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
fused_normal_gj_kernel(const float* __restrict__ Jaug, const float* __restrict__ lam,
                       const float* __restrict__ frozen, float* __restrict__ x,
                       int R, int D) {
  extern __shared__ float4 smem_f4[];
  __shared__ float shift;
  const int C = D + 1, n_el = D * C;
  float* aug = reinterpret_cast<float*>(smem_f4);  // D x C
  float* prow = aug + n_el;                        // C
  float* pcol = prow + C;                          // D
  float* rows = pcol + D;                          // kRowsPerChunk x C
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* Jt = Jaug + static_cast<size_t>(blockIdx.x) * R * C;

  // G = Jaug^T Jaug (first D rows), each entry summed over the rows in order
  float acc[kMaxPerThread] = {};
  for (int r0 = 0; r0 < R; r0 += kRowsPerChunk) {
    const int nr = min(kRowsPerChunk, R - r0);
    for (int e = tid; e < nr * C; e += nt) rows[e] = Jt[static_cast<size_t>(r0) * C + e];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxPerThread; ++q) {
      const int e = tid + q * nt;
      if (e < n_el) {
        const int i = e / C, j = e - i * C;
        float s = acc[q];
        int rr = 0;
        if (r0 == 0) {
          s = __fmul_rn(rows[i], rows[j]);
          rr = 1;
        }
        for (; rr < nr; ++rr) s = __fadd_rn(s, __fmul_rn(rows[rr * C + i], rows[rr * C + j]));
        acc[q] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kMaxPerThread; ++q) {
    const int e = tid + q * nt;
    if (e < n_el) aug[e] = acc[q];
  }
  __syncthreads();

  // (lam + ridge) I + diag(frozen) on the first D columns
  if (tid == 0) {
    float tr = aug[0];
    for (int i = 1; i < D; ++i) tr = __fadd_rn(tr, aug[i * C + i]);
    const float ridge = __fadd_rn(__fmul_rn(1e-6f, __fdiv_rn(tr, static_cast<float>(D))), 1e-6f);
    shift = __fadd_rn(lam[blockIdx.x], ridge);
  }
  __syncthreads();
  for (int i = tid; i < D; i += nt)
    aug[i * C + i] = __fadd_rn(__fadd_rn(aug[i * C + i], shift), frozen[i]);
  __syncthreads();

  // no-pivot Gauss-Jordan on [A | g], as gj_solve.cu
  for (int k = 0; k < D; ++k) {
    const float piv = aug[k * C + k];
    for (int j = tid; j < C; j += nt) prow[j] = __fdiv_rn(aug[k * C + j], piv);
    for (int i = tid; i < D; i += nt) pcol[i] = aug[i * C + k];
    __syncthreads();
    for (int e = tid; e < n_el; e += nt) {
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

// Largest D the kernel takes (every entry of the D x (D+1) block is owned by
// one of the block's threads).
extern "C" int fused_normal_max_d() {
  int d = 1;
  while ((d + 1) * (d + 2) <= kThreads * kMaxPerThread) ++d;
  return d;
}

extern "C" int fused_normal_gj_f32(const void* Jaug, const void* lam,
                                   const void* frozen, void* x, int T, int R,
                                   int D, void* stream) {
  if (T <= 0 || R <= 0 || D <= 0 || D > fused_normal_max_d())
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(D);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_normal_gj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_normal_gj_kernel<<<T, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Jaug), static_cast<const float*>(lam),
      static_cast<const float*>(frozen), static_cast<float*>(x), R, D);
  return static_cast<int>(cudaGetLastError());
}
