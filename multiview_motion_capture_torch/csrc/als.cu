// ALS multi-way matching solves, one thread block per problem, for Hopper.
//
// Replaces: multiview_motion_capture_tpu/ops/als_pallas.py:_als_kernel
// (entry `match_als_pallas`, called once per frame by tracker._run_als: one
// problem) and _als_kernel_batched (entry `match_als_pallas_batched`, called
// once per frame by tracker._clustered_association when cfg.assoc_clusters >
// 1: the C camera clusters' [T track slots | Vc views] problems, which share
// one layout and differ in W).  Both are this launch, with C = 1 or C
// blocks.  Block b solves problem b: its own W, x_bin, iteration count and
// slice of scratch; the same-group mask and the initial factor are shared.
// Each problem freezes at its own stop test, so its x_bin and iteration
// count do not depend on which block or launch solves it.
//
// It runs the ADMM/ALS loop of ref:src/mv_association.py:222-318 to its stop
// test on the device and writes the binarized match matrix and the
// iteration count:
//   W <- (W + W^T) / 2;  X = Z = W, Y = 0, A = init_A, mu = mu0
//   repeat until max_iter or done:
//     X  = Z - (Y - W + beta) / mu
//     B  = ((A^T A + (alpha/mu) I)^-1 A^T X)^T      ridge solve
//     A  = ((B^T B + (alpha/mu) I)^-1 B^T X^T)^T    ridge solve
//     X  = A B^T
//     Z  = clip((X + Y/mu) off the same-group blocks, 1 on the diagonal, 0, 1)
//     Y += mu (X - Z)
//     p = |X - Z| / n,  d = mu |X - X_prev| / n
//     done = (p < tol and d < tol) or X > 0.5 unchanged for stable_iters
//     mu = 2 mu if p > 10 d, mu / 2 if d > 10 p
//   x_bin = (X + X^T) / 2 > 0.5
//
// What bounds it on this card: at the SHELF_BENCH shape (one problem, n =
// 38, rank 16, up to 100 iterations) the bytes are a few KB and one
// iteration is ~0.1 MFLOP; at the wide rig's (C = 2 clusters, n = 336, rank
// 32) one iteration is ~20 MFLOP per problem (3 us at 67 TFLOP/s f32) and
// the inputs ~0.5 MB.  So neither memory nor the FP32 units are the limit:
// each problem is a chain of ~2 (rank + 4) dependent block-wide phases per
// iteration, each ended by a barrier, and the kernel is latency-bound by
// that chain (and, at n = 336, by L2 round trips).
//
// Design: one block keeps all state of its problem (W, X, the next X and its
// transpose, Z, Y, the factors A^T and B^T, and the rank x (rank + n)
// augmented block of the ridge solve) in shared memory for the whole loop,
// so one launch replaces ~15 dispatched ops per iteration and the stop test
// never returns to the host.  The ridge solves are the TPU kernels'
// no-pivot Gauss-Jordan (SPD plus a ridge needs no pivoting).  The 128-lane
// padding of the TPU kernels is a TPU layout rule and is dropped: the kernel
// runs at the true n.  Factors are kept transposed (rank x n) so that
// neighbouring threads read neighbouring words.  Where the state does not
// fit one block's shared memory (n above ~90, e.g. n = 336 for a 32-cam x
// 10-people rig or cluster) the same code runs on a caller-provided scratch
// buffer in device memory, one slice per problem (~2.8 MB at n = 336), which
// stays resident in the 50 MB L2.  The TPU batched kernel ran the C problems
// in one program to pay its dependency chain once for all of them, and
// split larger batches to fit its VMEM budget (als_pallas.max_als_batch); on
// Hopper the C chains run side by side on C SMs, so all C problems go in one
// launch as long as C fits the 132 SMs (more problems queue for a free SM
// and stay correct).
//
// Rounding: the iteration often does not converge within max_iter, and then
// its result depends on every rounding.  Each output element is therefore
// summed by one thread in index order, every product, sum and quotient is
// one round-to-nearest intrinsic (no multiply-add is contracted), and the
// residual sums are taken in f64 and reduced so that every thread gets the
// same totals.  The plain torch version (ops/association.py:match_als)
// performs the same f32 operations in the same order, so the two return the
// same x_bin and iteration count, and the loop condition is uniform across
// the block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t kSmemLimit = 230000;  // of the 232448 B a block may opt into

__host__ __device__ inline size_t state_floats(int n, int r) {
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t C = static_cast<size_t>(r) + n;
  return 6 * nn + 2 * static_cast<size_t>(r) * n + r * C + C + r;
}

inline size_t smem_bytes(int n, int r) {
  return state_floats(n, r) * sizeof(float) + static_cast<size_t>(n) * n;
}

// Sum a, b, c over the block; every thread gets the totals, summed in the
// same order by every thread.
__device__ void block_sum3(double& a, double& b, double& c, double* red) {
  const unsigned full = 0xffffffffu;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(full, a, o);
    b += __shfl_xor_sync(full, b, o);
    c += __shfl_xor_sync(full, c, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
    red[64 + warp] = c;
  }
  __syncthreads();
  a = 0.0;
  b = 0.0;
  c = 0.0;
  for (int w = 0; w < nw; ++w) {
    a += red[w];
    b += red[32 + w];
    c += red[64 + w];
  }
}

// aug[a][a] += lam, then no-pivot Gauss-Jordan on the (rows, cols) block
// `aug` in place: the solution of [G + lam I | R] ends in columns
// rows..cols-1.
__device__ void ridge_gauss_jordan(float* aug, int rows, int cols, float lam,
                                   float* prow, float* pcol) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int a = tid; a < rows; a += nt)
    aug[a * cols + a] = __fadd_rn(aug[a * cols + a], lam);
  __syncthreads();
  for (int k = 0; k < rows; ++k) {
    const float piv = aug[k * cols + k];
    for (int j = tid; j < cols; j += nt) prow[j] = __fdiv_rn(aug[k * cols + j], piv);
    for (int i = tid; i < rows; i += nt) pcol[i] = aug[i * cols + k];
    __syncthreads();
    for (int e = tid; e < rows * cols; e += nt) {
      const int i = e / cols, j = e - i * cols;
      aug[e] = (i == k) ? prow[j] : __fsub_rn(aug[e], __fmul_rn(pcol[i], prow[j]));
    }
    __syncthreads();
  }
}

// aug (r x (r + n)) = [F F^T | F R] for F (r x n) and R (n x n), both
// row-major: every entry summed over k = 0..n-1 in index order.
__device__ void normal_block(const float* Ft, const float* R, float* aug,
                             int n, int r) {
  const int tid = threadIdx.x, nt = blockDim.x, C = r + n;
  for (int e = tid; e < r * C; e += nt) {
    const int a = e / C, c = e - a * C;
    const float* fa = Ft + a * n;
    float s;
    if (c < r) {
      const float* fc = Ft + c * n;
      s = __fmul_rn(fa[0], fc[0]);
      for (int k = 1; k < n; ++k) s = __fadd_rn(s, __fmul_rn(fa[k], fc[k]));
    } else {
      const int j = c - r;
      s = __fmul_rn(fa[0], R[j]);
      for (int k = 1; k < n; ++k) s = __fadd_rn(s, __fmul_rn(fa[k], R[k * n + j]));
    }
    aug[e] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
als_kernel(const float* __restrict__ W_in, const uint8_t* __restrict__ dmask_in,
           const float* __restrict__ A_in, int n, int r, float alpha,
           float beta, float mu0, float tol, int max_iter, int stable_iters,
           uint8_t* __restrict__ x_bin, int* __restrict__ iters_out,
           float* gscratch) {
  extern __shared__ float4 smem_f4[];
  __shared__ double red[96];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nn = n * n, C = r + n;
  // this block's problem
  W_in += static_cast<size_t>(blockIdx.x) * nn;
  x_bin += static_cast<size_t>(blockIdx.x) * nn;
  iters_out += blockIdx.x;
  if (gscratch) gscratch += static_cast<size_t>(blockIdx.x) * state_floats(n, r);

  float* base = gscratch ? gscratch : reinterpret_cast<float*>(smem_f4);
  float* W = base;
  float* X = W + nn;     // current X
  float* Xs = X + nn;    // the ADMM X step, transposed: Xs[j * n + i] = X_step[i][j]
  float* Xn = Xs + nn;   // the ADMM X step, then the next X = A B^T
  float* Z = Xn + nn;
  float* Y = Z + nn;
  float* At = Y + nn;    // A^T (r x n)
  float* Bt = At + r * n;  // B^T (r x n)
  float* aug = Bt + r * n;  // r x (r + n)
  float* prow = aug + r * C;
  float* pcol = prow + C;
  const uint8_t* dmask = dmask_in;
  if (!gscratch) {
    uint8_t* dm = reinterpret_cast<uint8_t*>(pcol + r);
    for (int e = tid; e < nn; e += nt) dm[e] = dmask_in[e];
    dmask = dm;
  }

  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, j = e - i * n;
    const float w = __fmul_rn(0.5f, __fadd_rn(W_in[i * n + j], W_in[j * n + i]));
    W[e] = w;
    X[e] = w;
    Z[e] = w;
    Y[e] = 0.f;
  }
  for (int e = tid; e < n * r; e += nt) {
    const int i = e / r, a = e - i * r;
    At[a * n + i] = A_in[e];
  }
  __syncthreads();

  const double tol_d = static_cast<double>(tol);
  float mu = mu0;
  int it = 0, stable = 0;
  bool done = false;
  while (it < max_iter && !done) {
    const float lam = __fdiv_rn(alpha, mu);

    // ADMM X step: Xn = Z - (Y - W + beta) / mu, and its transpose Xs
    for (int e = tid; e < nn; e += nt) {
      const int i = e / n, j = e - i * n;
      const float v = __fsub_rn(
          Z[e], __fdiv_rn(__fadd_rn(__fsub_rn(Y[e], W[e]), beta), mu));
      Xn[e] = v;
      Xs[j * n + i] = v;
    }
    __syncthreads();

    // B^T = solve([A^T A + lam I | A^T X])
    normal_block(At, Xn, aug, n, r);
    ridge_gauss_jordan(aug, r, C, lam, prow, pcol);
    for (int e = tid; e < r * n; e += nt) {
      const int a = e / n, j = e - a * n;
      Bt[e] = aug[a * C + r + j];
    }
    __syncthreads();

    // A^T = solve([B^T B + lam I | B^T X^T])
    normal_block(Bt, Xs, aug, n, r);
    ridge_gauss_jordan(aug, r, C, lam, prow, pcol);
    for (int e = tid; e < r * n; e += nt) {
      const int a = e / n, i = e - a * n;
      At[e] = aug[a * C + r + i];
    }
    __syncthreads();

    // X = A B^T, the Z projection, the Y update and the residual sums
    double s_pz = 0.0, s_dx = 0.0, s_flip = 0.0;
    for (int e = tid; e < nn; e += nt) {
      const int i = e / n, j = e - i * n;
      float x = __fmul_rn(At[i], Bt[j]);
      for (int a = 1; a < r; ++a) x = __fadd_rn(x, __fmul_rn(At[a * n + i], Bt[a * n + j]));
      const float y0 = Y[e];
      const float zc = (i == j) ? 1.f
                                : (dmask[e] ? 0.f : __fadd_rn(x, __fdiv_rn(y0, mu)));
      const float z = fminf(fmaxf(zc, 0.f), 1.f);
      const float x0 = X[e];
      const float dz = __fsub_rn(x, z);
      const float dx = __fsub_rn(x, x0);
      Y[e] = __fadd_rn(y0, __fmul_rn(mu, dz));
      Z[e] = z;
      Xn[e] = x;
      s_pz += static_cast<double>(__fmul_rn(dz, dz));
      s_dx += static_cast<double>(__fmul_rn(dx, dx));
      s_flip += ((x > 0.5f) != (x0 > 0.5f)) ? 1.0 : 0.0;
    }
    block_sum3(s_pz, s_dx, s_flip, red);
    const double p_res = sqrt(s_pz) / n;
    const double d_res = static_cast<double>(mu) * sqrt(s_dx) / n;
    done = (p_res < tol_d) && (d_res < tol_d);
    stable = (s_flip == 0.0) ? stable + 1 : 0;
    if (stable_iters > 0 && stable >= stable_iters) done = true;
    mu = (p_res > 10.0 * d_res) ? 2.f * mu : ((d_res > 10.0 * p_res) ? 0.5f * mu : mu);
    ++it;
    float* tmp = X;
    X = Xn;
    Xn = tmp;
  }

  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, j = e - i * n;
    x_bin[e] = (__fmul_rn(0.5f, __fadd_rn(X[i * n + j], X[j * n + i])) > 0.5f) ? 1 : 0;
  }
  if (tid == 0) iters_out[0] = it;
}

}  // namespace

// Floats of device scratch ONE problem needs at this (n, rank): 0 when its
// state fits one block's shared memory.  The caller passes C times as many.
extern "C" int als_scratch_floats(int n, int r) {
  if (n <= 0 || r <= 0) return 0;
  return smem_bytes(n, r) <= kSmemLimit ? 0 : static_cast<int>(state_floats(n, r));
}

// Solve `problems` problems, one block each: W and x_bin (problems, n, n),
// iters (problems,); scratch holds problems * als_scratch_floats(n, r)
// floats (or is null when that is 0).  Returns the launch's cudaError_t.
extern "C" int als_solve_f32(const void* W, const void* dmask, const void* init_A,
                             int problems, int n, int r, float alpha, float beta,
                             float mu0, float tol, int max_iter, int stable_iters,
                             void* x_bin, void* iters, void* scratch,
                             void* stream) {
  if (problems <= 0 || n <= 0 || r <= 0 || r > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = smem_bytes(n, r) <= kSmemLimit;
  if (!in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn = in_smem ? smem_bytes(n, r) : 0;
  if (dyn > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        als_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n <= 64 ? 256 : 1024;
  als_kernel<<<problems, threads, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const uint8_t*>(dmask),
      static_cast<const float*>(init_A), n, r, alpha, beta, mu0, tol,
      max_iter, stable_iters, static_cast<uint8_t*>(x_bin),
      static_cast<int*>(iters),
      in_smem ? nullptr : static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
