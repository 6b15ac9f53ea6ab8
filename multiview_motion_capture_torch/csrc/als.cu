// ALS multi-way matching solves for Hopper: one thread-block cluster per
// problem, its state in the cluster's distributed shared memory.
//
// Replaces: multiview_motion_capture_tpu/ops/als_pallas.py:_als_kernel
// (entry `match_als_pallas`, called once per frame by tracker._run_als: one
// problem) and _als_kernel_batched (entry `match_als_pallas_batched`, called
// once per frame by tracker._clustered_association when cfg.assoc_clusters >
// 1: the C camera clusters' [T track slots | Vc views] problems, which share
// one layout and differ in W).  Both are this launch, with C = 1 or C
// clusters.  Cluster c solves problem c: its own W, x_bin and iteration
// count; the same-group mask and the initial factor are shared.  Each
// problem freezes at its own stop test, so its x_bin and iteration count do
// not depend on which cluster or launch solves it.
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
//   x_bin = (X + X^T) / 2 > 0.5, and (X + X^T) / 2 itself where asked
//
// What bounds it on this card: at the wide rig's shape (n = 336, rank 32)
// one iteration is ~20 MFLOP per problem (0.3 us at 67 TFLOP/s f32) and the
// inputs ~0.5 MB, so neither the FP32 units nor memory are the limit: each
// iteration is a chain of dependent phases (two products, two ridge solves,
// the projection, a reduction), and the kernel is bound by the latency of
// that chain and by how many SMs share each phase.
//
// Design.
// - Cluster shape, from (n, rank) alone (als_launch_shape): a cluster of one
//   block where the whole state fits one SM's shared memory (n <= 103 at
//   rank 32; SHELF_BENCH's n = 38), else a cluster of 16 blocks on 16 SMs
//   (the wide rig's n = 336, up to MAX_N = 384 at rank 32).  A cluster of 8
//   would need twice the strip space, which does not fit.  A launch that
//   the card refuses raises in the wrapper; nothing retries another way.
// - Block q owns the column strip [q w, q w + w), w = ceil(n / S), of X, the
//   next X (which first holds the X step), Z and Y, and the same rows of A
//   (its output of the A^T solve).  Each block keeps a full copy F (rank x
//   n) of the factor it reads, gathered from its peers' strips.
// - Per iteration: the X step on the own strip; [A^T A | A^T Xs(:, strip)]
//   and its ridge solve give the B^T strip; cluster barrier; each block
//   gathers B^T and the X step's rows of its own row strip (transposed,
//   into Z's space, which is dead until the projection) from its peers;
//   [B^T B | B^T Xs(strip, :)^T] and its ridge solve give the A^T strip;
//   barrier; each block gathers A^T; X = A B^T on the own strip, fused with
//   the projection, the Y update and the residual partials; barrier; every
//   block sums the S partials in block order, so all take the same loop
//   exit.  Three cluster barriers per iteration.
// - The ridge solves are a no-pivot Gauss-Jordan (SPD plus a ridge needs
//   none) run by warps without block barriers: a lane holds one column of
//   [G + lam I | R] in registers, every warp carries its own copy of the
//   rank x rank left block and 32 right-hand columns, and each pivot column
//   is broadcast with __shfl_sync.  A column's update reads only itself and
//   the pivot column, and every copy of the left block evolves identically,
//   so the result equals the whole-block elimination bit for bit.  Rank <=
//   32 (a lane per left column); the wrapper raises above that.
// - W and the mask stay in device memory (read once per iteration per
//   strip, through L1/L2); all other state is in shared memory.
//
// Rounding: the iteration often does not converge within max_iter, and then
// its result depends on every rounding.  So outputs are partitioned and no
// sum is: each entry of each product is summed by one thread in index
// order, every product, sum and quotient is one round-to-nearest intrinsic
// (no multiply-add is contracted), and the residual sums are taken in f64
// and combined in a fixed order.  The plain torch version
// (ops/association.py:match_als, _ordered_matmul, _ridge_gauss_jordan)
// performs the same f32 operations in the same order, so the two return
// the same x_bin and iteration count.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRank = 32;
constexpr int kBigCluster = 16;
constexpr size_t kSmemLimit = 230000;  // of the 232448 B a block may opt into

struct Shape {
  int S;          // blocks per cluster
  int w;          // columns per block
  int ldS;        // row stride of a strip (odd: column walks hit distinct banks)
  int ldF;        // row stride of the full factor copy (odd)
  int threads;
  size_t floats;  // dynamic shared memory per block
};

__host__ __device__ inline Shape make_shape(int n, int r, int S) {
  Shape s;
  s.S = S;
  s.w = (n + S - 1) / S;
  s.ldS = s.w | 1;
  s.ldF = n | 1;
  s.threads = S == 1 ? 256 : 512;
  // X, next X, Z, Y strips; F; the B^T and A^T strips; the augmented block
  s.floats = 4 * static_cast<size_t>(n) * s.ldS + static_cast<size_t>(r) * s.ldF +
             2 * static_cast<size_t>(r) * s.w + static_cast<size_t>(r) * (r + s.w);
  return s;
}

inline Shape choose_shape(int n, int r) {
  const Shape one = make_shape(n, r, 1);
  return one.floats * sizeof(float) <= kSmemLimit ? one : make_shape(n, r, kBigCluster);
}

// (e / cols, e % cols) for e = start, start + step, ..., advanced without a
// division per step (cols > 0).
struct Walk2 {
  int i, j, di, dj, cols;
  __device__ Walk2(int cols_, int start, int step) : cols(cols_) {
    i = start / cols;
    j = start - i * cols;
    di = step / cols;
    dj = step - di * cols;
  }
  __device__ void next() {
    i += di;
    j += dj;
    if (j >= cols) {
      j -= cols;
      ++i;
    }
  }
};

// An operand vector in shared memory: its k-th value is p[k * step].
struct Vec {
  const float* p;
  int step;
};

// out(a, j) = sum over k = 0..K-1 in index order of lv(a)[k] * rv(j)[k],
// one rounding per product and one per sum, for a < ma, j < mj; epi(a, j,
// value) receives each.  A thread owns a tile of TA consecutive a by TJ
// j's spaced mj / TJ apart, so a warp reads neighbouring words of rv.
template <int TA, int TJ, class LOp, class ROp, class Epi>
__device__ void ordered_product(int K, int ma, int mj, LOp lv, ROp rv, Epi epi) {
  const int na = (ma + TA - 1) / TA, nj = (mj + TJ - 1) / TJ;
  if (na == 0 || nj == 0) return;
  for (Walk2 t(nj, threadIdx.x, blockDim.x); t.i < na; t.next()) {
    Vec l[TA], rr[TJ];
#pragma unroll
    for (int u = 0; u < TA; ++u) l[u] = lv(min(t.i * TA + u, ma - 1));
#pragma unroll
    for (int v = 0; v < TJ; ++v) rr[v] = rv(min(t.j + v * nj, mj - 1));
    float s[TA][TJ];
#pragma unroll
    for (int u = 0; u < TA; ++u)
#pragma unroll
      for (int v = 0; v < TJ; ++v) s[u][v] = __fmul_rn(l[u].p[0], rr[v].p[0]);
    for (int k = 1; k < K; ++k) {
      float a[TA], b[TJ];
#pragma unroll
      for (int u = 0; u < TA; ++u) a[u] = l[u].p[k * l[u].step];
#pragma unroll
      for (int v = 0; v < TJ; ++v) b[v] = rr[v].p[k * rr[v].step];
#pragma unroll
      for (int u = 0; u < TA; ++u)
#pragma unroll
        for (int v = 0; v < TJ; ++v) s[u][v] = __fadd_rn(s[u][v], __fmul_rn(a[u], b[v]));
    }
#pragma unroll
    for (int u = 0; u < TA; ++u)
#pragma unroll
      for (int v = 0; v < TJ; ++v) {
        const int a = t.i * TA + u, j = t.j + v * nj;
        if (a < ma && j < mj) epi(a, j, s[u][v]);
      }
  }
}

// aug (r x (r + m), row stride lda) = [F F^T | F M] for the factor F (r x
// n, row stride ldF) and the n x m strip M (row stride ldM).
__device__ void normal_block(const float* F, int ldF, const float* M, int ldM, int n,
                             int r, int m, float* aug, int lda) {
  ordered_product<2, 2>(
      n, r, r + m, [=](int a) { return Vec{F + a * ldF, 1}; },
      [=](int c) { return c < r ? Vec{F + c * ldF, 1} : Vec{M + (c - r), ldM}; },
      [=](int a, int c, float v) { aug[a * lda + c] = v; });
}

// aug[a][a] += lam, then no-pivot Gauss-Jordan on [G + lam I | R] (rows r,
// R's m columns): out (r x m, row stride ldo) = (G + lam I)^-1 R, by warps
// without a block barrier.  Each warp carries its own copy of the left
// block (lane c holds column c) and a group of right-hand columns: with
// kDual (r > 16), every lane also holds one (32 per warp); else lanes
// r..31 hold one each (32 - r per warp, half the work per lane).  The
// registers rotate by one row per pivot, so the pivot row is always at
// index 0 and the pivot loop need not be unrolled (a short loop body stays
// in the instruction cache): after step k, index j holds row (j + k + 1)
// mod R.  Rows r..R-1 are zero and never pivot.
template <int R, bool kDual>
__device__ void warp_ridge_gj(const float* aug, int lda, int r, int m, float lam,
                              float* out, int ldo) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int per = kDual ? 32 : 32 - r;
  const int groups = (m + per - 1) / per;
  for (int g = threadIdx.x >> 5; g < groups; g += nw) {
    const int col = g * per + (kDual ? lane : lane - r);
    const bool has_left = lane < r;
    const bool has_right = (kDual || !has_left) && col < m;
    float L[R], X[R];  // X: the right-hand column (kDual only)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v = 0.f;
      if (i < r && has_left)
        v = i == lane ? __fadd_rn(aug[i * lda + lane], lam) : aug[i * lda + lane];
      else if (i < r && has_right && !kDual)
        v = aug[i * lda + r + col];
      L[i] = v;
      X[i] = (kDual && has_right && i < r) ? aug[i * lda + r + col] : 0.f;
    }
#pragma unroll 1
    for (int k = 0; k < r; ++k) {
      const float piv = __shfl_sync(full, L[0], k);
      const float pl = __fdiv_rn(L[0], piv);
      const float px = kDual ? __fdiv_rn(X[0], piv) : 0.f;
#pragma unroll
      for (int i = 1; i < R; ++i) {
        const float pc = __shfl_sync(full, L[i], k);  // aug[.][k], before its update
        L[i - 1] = __fsub_rn(L[i], __fmul_rn(pc, pl));
        if (kDual) X[i - 1] = __fsub_rn(X[i], __fmul_rn(pc, px));
      }
      L[R - 1] = pl;
      if (kDual) X[R - 1] = px;
    }
    if (has_right) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int row = j + r < R ? j + r : j + r - R;
        if (row < r) out[row * ldo + col] = kDual ? X[j] : L[j];
      }
    }
  }
}

__device__ void ridge_solve(const float* aug, int lda, int r, int m, float lam,
                            float* out, int ldo) {
  if (r > 16)
    warp_ridge_gj<kMaxRank, true>(aug, lda, r, m, lam, out, ldo);
  else
    warp_ridge_gj<16, false>(aug, lda, r, m, lam, out, ldo);
}

// F[a][k] = strip_p[a][k - p w] for every column k, from the block p of the
// cluster that owns it (strips r x w, row stride w).
__device__ void gather_factor(cg::cluster_group& cluster, float* F, int ldF,
                              float* strip, int n, int r, int w) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int p = k / w, kl = k - p * w;
    const float* src = cluster.map_shared_rank(strip, p);
#pragma unroll 8
    for (int a = 0; a < r; ++a) F[a * ldF + k] = src[a * w + kl];
  }
}

__global__ void __launch_bounds__(512, 1)
als_kernel(const float* __restrict__ W, const uint8_t* __restrict__ dmask,
           const float* __restrict__ A_in, int n, int r, float alpha, float beta,
           float mu0, float tol, int max_iter, int stable_iters,
           uint8_t* __restrict__ x_bin, float* __restrict__ x_out,
           int* __restrict__ iters_out) {
  extern __shared__ float4 smem_f4[];
  __shared__ double red[96];
  __shared__ double part[3];
  cg::cluster_group cluster = cg::this_cluster();
  const Shape sh = make_shape(n, r, static_cast<int>(cluster.num_blocks()));
  const int S = sh.S, w = sh.w, ldS = sh.ldS, ldF = sh.ldF, lda = r + w;
  const int q = static_cast<int>(cluster.block_rank());
  const int c0 = q * w, wq = max(0, min(n, c0 + w) - c0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int problem = blockIdx.x / S;
  W += static_cast<size_t>(problem) * n * n;
  x_bin += static_cast<size_t>(problem) * n * n;
  if (x_out != nullptr) x_out += static_cast<size_t>(problem) * n * n;

  float* X = reinterpret_cast<float*>(smem_f4);  // current X, own strip
  float* Xn = X + n * ldS;   // the X step (read by peers), then the next X
  float* Zb = Xn + n * ldS;  // Z; between the gathers, X step rows transposed
  float* Y = Zb + n * ldS;
  float* F = Y + n * ldS;    // full A^T or B^T (r x n)
  float* Bq = F + r * ldF;   // own B^T strip (r x w)
  float* Aq = Bq + r * w;    // own A^T strip (r x w)
  float* aug = Aq + r * w;   // r x (r + w)

  if (wq > 0)
    for (Walk2 t(wq, tid, nt); t.i < n; t.next()) {
      const int i = t.i, j = c0 + t.j, e = i * ldS + t.j;
      const float v = __fmul_rn(0.5f, __fadd_rn(W[i * n + j], W[j * n + i]));
      X[e] = v;
      Zb[e] = v;
      Y[e] = 0.f;
    }
  for (Walk2 t(r, tid, nt); t.i < n; t.next()) F[t.j * ldF + t.i] = A_in[t.i * r + t.j];
  cluster.sync();  // every block of the cluster runs before any reads a peer

  const double tol_d = static_cast<double>(tol);
  float mu = mu0;
  int it = 0, stable = 0;
  bool done = false;
  while (it < max_iter && !done) {
    const float lam = __fdiv_rn(alpha, mu);

    // ADMM X step on the own strip: Xn = Z - (Y - W + beta) / mu
    if (wq > 0)
      for (Walk2 t(wq, tid, nt); t.i < n; t.next()) {
        const int i = t.i, j = c0 + t.j, e = i * ldS + t.j;
        const float wv = __fmul_rn(0.5f, __fadd_rn(W[i * n + j], W[j * n + i]));
        Xn[e] = __fsub_rn(Zb[e], __fdiv_rn(__fadd_rn(__fsub_rn(Y[e], wv), beta), mu));
      }
    __syncthreads();

    // B^T strip = solve([A^T A + lam I | A^T X(:, strip)])
    normal_block(F, ldF, Xn, ldS, n, r, wq, aug, lda);
    __syncthreads();
    ridge_solve(aug, lda, r, wq, lam, Bq, w);
    cluster.sync();

    // gather B^T, and the X step's rows of the own row strip, transposed
    gather_factor(cluster, F, ldF, Bq, n, r, w);
    for (int k = tid; k < n; k += nt) {
      const int p = k / w, kl = k - p * w;
      const float* src = cluster.map_shared_rank(Xn, p);
#pragma unroll 8
      for (int il = 0; il < wq; ++il) Zb[k * ldS + il] = src[(c0 + il) * ldS + kl];
    }
    __syncthreads();

    // A^T strip = solve([B^T B + lam I | B^T X(strip, :)^T])
    normal_block(F, ldF, Zb, ldS, n, r, wq, aug, lda);
    __syncthreads();
    ridge_solve(aug, lda, r, wq, lam, Aq, w);
    cluster.sync();

    // gather A^T
    gather_factor(cluster, F, ldF, Aq, n, r, w);
    __syncthreads();

    // X = A B^T on the own strip, the Z projection, the Y update and the
    // residual partials
    double s_pz = 0.0, s_dx = 0.0, s_flip = 0.0;
    ordered_product<4, 2>(
        r, wq, n, [=](int jl) { return Vec{Bq + jl, w}; },
        [=](int i) { return Vec{F + i, ldF}; },
        [&](int jl, int i, float x) {
          const int j = c0 + jl, e = i * ldS + jl;
          const float y0 = Y[e];
          const float zc =
              (i == j) ? 1.f : (dmask[i * n + j] ? 0.f : __fadd_rn(x, __fdiv_rn(y0, mu)));
          const float z = fminf(fmaxf(zc, 0.f), 1.f);
          const float x0 = X[e];
          const float dz = __fsub_rn(x, z);
          const float dx = __fsub_rn(x, x0);
          Y[e] = __fadd_rn(y0, __fmul_rn(mu, dz));
          Zb[e] = z;
          Xn[e] = x;
          s_pz += static_cast<double>(__fmul_rn(dz, dz));
          s_dx += static_cast<double>(__fmul_rn(dx, dx));
          s_flip += ((x > 0.5f) != (x0 > 0.5f)) ? 1.0 : 0.0;
        });
    const unsigned full = 0xffffffffu;
    for (int o = 16; o > 0; o >>= 1) {
      s_pz += __shfl_xor_sync(full, s_pz, o);
      s_dx += __shfl_xor_sync(full, s_dx, o);
      s_flip += __shfl_xor_sync(full, s_flip, o);
    }
    if ((tid & 31) == 0) {
      red[tid >> 5] = s_pz;
      red[32 + (tid >> 5)] = s_dx;
      red[64 + (tid >> 5)] = s_flip;
    }
    __syncthreads();
    if (tid == 0) {
      double a = 0.0, b = 0.0, c = 0.0;
      for (int v = 0; v < (nt >> 5); ++v) {
        a += red[v];
        b += red[32 + v];
        c += red[64 + v];
      }
      part[0] = a;
      part[1] = b;
      part[2] = c;
    }
    cluster.sync();
    // the cluster's totals, summed in block order by every thread
    double t_pz = 0.0, t_dx = 0.0, t_flip = 0.0;
    for (int p = 0; p < S; ++p) {
      const double* pp = cluster.map_shared_rank(part, p);
      t_pz += pp[0];
      t_dx += pp[1];
      t_flip += pp[2];
    }
    const double p_res = sqrt(t_pz) / n;
    const double d_res = static_cast<double>(mu) * sqrt(t_dx) / n;
    done = (p_res < tol_d) && (d_res < tol_d);
    stable = (t_flip == 0.0) ? stable + 1 : 0;
    if (stable_iters > 0 && stable >= stable_iters) done = true;
    mu = (p_res > 10.0 * d_res) ? 2.f * mu : ((d_res > 10.0 * p_res) ? 0.5f * mu : mu);
    ++it;
    float* tmp = X;
    X = Xn;
    Xn = tmp;
  }

  // x_bin = (X + X^T) / 2 > 0.5 on the own columns, and (X + X^T) / 2 into
  // x_out where the caller passed one (the TPU kernel's X output); X^T from
  // the peers' strips (every block swapped X the same number of times)
  for (int i = tid; i < n; i += nt) {
    const int p = i / w, il = i - p * w;
    const float* Xp = cluster.map_shared_rank(X, p);
    for (int jl = 0; jl < wq; ++jl) {
      const int j = c0 + jl;
      const float v = __fmul_rn(0.5f, __fadd_rn(X[i * ldS + jl], Xp[j * ldS + il]));
      x_bin[static_cast<size_t>(i) * n + j] = v > 0.5f ? 1 : 0;
      if (x_out != nullptr) x_out[static_cast<size_t>(i) * n + j] = v;
    }
  }
  if (q == 0 && tid == 0) iters_out[problem] = it;
  cluster.sync();  // no block leaves while a peer reads its shared memory
}

bool valid_shape(int n, int r) {
  return n > 0 && r > 0 && r <= kMaxRank && r <= n &&
         choose_shape(n, r).floats * sizeof(float) <= kSmemLimit;
}

cudaError_t configure(const Shape& s, int problems, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t bytes = s.floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      als_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (s.S > 8) {
    err = cudaFuncSetAttribute(als_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(problems * s.S));
  cfg->blockDim = dim3(static_cast<unsigned>(s.threads));
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(s.S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// The launch shape at (n, rank), into out[0..3]: blocks per cluster,
// threads per block, dynamic shared memory bytes per block, and how many
// such clusters the card holds at once.  Returns a cudaError_t.
extern "C" int als_launch_shape(int n, int r, void* out) {
  if (!valid_shape(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = choose_shape(n, r);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(s, 1, nullptr, &cfg, attr);
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, als_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = s.S;
  o[1] = s.threads;
  o[2] = static_cast<int>(s.floats * sizeof(float));
  o[3] = clusters;
  return 0;
}

// Solve `problems` problems, one cluster each: W and x_bin (problems, n,
// n), iters (problems,); x_out (problems, n, n) f32 receives the
// symmetrized continuous X, or is null (the tracker's launches).  Returns
// the launch's cudaError_t.
extern "C" int als_solve_f32(const void* W, const void* dmask, const void* init_A,
                             int problems, int n, int r, float alpha, float beta,
                             float mu0, float tol, int max_iter, int stable_iters,
                             void* x_bin, void* x_out, void* iters, void* stream) {
  if (problems <= 0 || !valid_shape(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      configure(choose_shape(n, r), problems, static_cast<cudaStream_t>(stream), &cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, als_kernel, static_cast<const float*>(W),
                           static_cast<const uint8_t*>(dmask),
                           static_cast<const float*>(init_A), n, r, alpha, beta, mu0, tol,
                           max_iter, stable_iters, static_cast<uint8_t*>(x_bin),
                           static_cast<float*>(x_out), static_cast<int*>(iters));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
