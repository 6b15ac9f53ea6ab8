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
//   block where the whole state fits one SM's shared memory (n <= 106 at
//   rank 32; SHELF_BENCH's n = 38), else a cluster of 16 blocks on 16 SMs
//   (the wide rig's n = 336, up to MAX_N = 384 at rank 32).  A cluster of 8
//   would need twice the strip space, which does not fit.  A launch that
//   the card refuses raises in the wrapper; nothing retries another way.
// - Block q owns the column strip [q w, q w + w), w = ceil(n / S), of X, the
//   next X (which first holds the X step), Z and Y, and the same rows of A
//   (its output of the A^T solve).  Each block keeps a full copy F (rank x
//   n) of the factor it reads, gathered from its peers' strips.
// - Each half of an iteration solves [F F^T + lam I | F M] for one factor
//   strip (F = A^T with M the X step's own columns, then F = B^T with M the
//   X step's own rows, transposed).  The Gram F F^T is symmetric bit for bit
//   (fmul commutes), so only its upper triangle is formed, and it is dealt
//   over the cluster: block q sums entries q, q + S, q + 2 S, ... of the
//   triangle, and every block reads the whole triangle from its peers after
//   a split cluster barrier (arrive, other work, wait).
// - The ridge solve is a no-pivot Gauss-Jordan (SPD plus a ridge needs none)
//   split in two.  Warp 0 eliminates the rank x rank left block alone (lane
//   c holds column c in registers) and records every pivot column as it
//   stood before its step, with the pivot's double reciprocal, in shared
//   memory, publishing each step by a release store of a step count.  The
//   warps of the other three sub-partitions (the product side; warp w
//   issues from sub-partition w mod 4, so the elimination's serial chain
//   shares its issue slots with no one) form the right-hand products F M
//   in registers, a lane a row, and apply each recorded step as soon as it
//   is published: a column's update reads only itself and the pivot
//   column, so this equals the whole elimination bit for bit.  Quotients
//   are gj_elim.cuh's `quotient` (the double product with the correctly
//   rounded reciprocal, rounded once: __fdiv_rn's result without its slow
//   path).  Rank <= 32 (a lane per left column); the wrapper raises above
//   that.
// - Per iteration: [the eliminating side sums its Gram share of A^T A,
//   arrives at a split cluster barrier, gathers the Gram, warp 0
//   eliminates | the product side arrives, takes the X step and solves its
//   columns of the B^T strip]; cluster barrier; each block gathers B^T and
//   the X step's rows of its own row strip (transposed, into Z's space,
//   which is dead until the projection) from its peers; the same for the
//   A^T strip with B^T B and the transposed rows; barrier; each block
//   gathers A^T; X = A B^T on the own strip, fused with the projection, the
//   Y update and the residual partials; barrier; warp 0 sums the S
//   partials in block order and hands the totals to the block, so all
//   blocks take the same loop exit.  Three cluster barriers and two split
//   ones per iteration.
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

#include "gj_elim.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRank = 32;
constexpr int kBigCluster = 16;
constexpr int kThreads = 512;  // 16 warps: 4 on the eliminating side, 12 on the product side
constexpr size_t kSmemLimit = 230000;  // of the 232448 B a block may opt into

struct Shape {
  int S;          // blocks per cluster
  int w;          // columns per block
  int ldS;        // row stride of a strip (odd: column walks hit distinct banks)
  int ldF;        // row stride of the full factor copy (odd)
  int R;          // lanes per right-hand column: 16 for rank <= 16, else 32
  int E;          // Gram entries summed per block
  size_t floats;  // dynamic shared memory per block
};

__host__ __device__ inline Shape make_shape(int n, int r, int S) {
  Shape s;
  s.S = S;
  s.w = (n + S - 1) / S;
  s.ldS = s.w | 1;
  s.ldF = n | 1;
  s.R = r > 16 ? 32 : 16;
  s.E = (r * (r + 1) / 2 + S - 1) / S;
  // the pivots' reciprocals (doubles) and pivot columns; X, next X, Z, Y
  // strips; F; the B^T and A^T strips; the Gram share
  s.floats = 2 * static_cast<size_t>(s.R) + static_cast<size_t>(s.R) * s.R +
             4 * static_cast<size_t>(n) * s.ldS + static_cast<size_t>(r) * s.ldF +
             2 * static_cast<size_t>(r) * s.w + s.E;
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

// Entry t of the Gram's upper triangle is (a, b), a <= b, t = b (b + 1) / 2 + a.
__device__ __forceinline__ int tri_index(int a, int b) { return b * (b + 1) / 2 + a; }

// The row b of the Gram's upper-triangle entry t (tri_index(0, b) <= t <
// tri_index(0, b + 1)).
__device__ __forceinline__ int tri_row(int t) {
  int b = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  if (tri_index(0, b + 1) <= t) ++b;
  else if (tri_index(0, b) > t) --b;
  return b;
}

// While a ridge solve's left block is formed and eliminated, the block's
// warps work on two sides.  Warp w issues from the SM's sub-partition w mod
// 4; warps 0, 4, 8, ... (the first sub-partition's) sum the block's share of
// the Gram, then warp 0 eliminates alone there, and the other warps form the
// right-hand products on the other three sub-partitions, so that the
// elimination's serial chain shares its issue slots with no one.
__device__ __forceinline__ bool eliminating_side(int warp) { return (warp & 3) == 0; }

// Index of a product-side warp among the product side's np warps.
__device__ __forceinline__ int product_warp(int warp) { return warp - (warp >> 2) - 1; }

__device__ __forceinline__ int product_warps(int nw) { return nw - (nw >> 2); }

// This block's share of the Gram F F^T (F: r x n, row stride ldF): gram[u]
// = entry q + S u of the upper triangle, each summed by one thread of the
// eliminating side in index order.
__device__ void gram_share(const float* F, int ldF, int n, int r, int q, int S, int E,
                           float* gram) {
  const int count = r * (r + 1) / 2;
  const int first = (threadIdx.x >> 7) * 32 + (threadIdx.x & 31);
  for (int u = first; u < E; u += blockDim.x >> 2) {
    const int t = q + S * u;
    if (t >= count) break;
    const int b = tri_row(t);
    const float* fa = F + (t - tri_index(0, b)) * ldF;
    const float* fb = F + b * ldF;
    float s = __fmul_rn(fa[0], fb[0]);
#pragma unroll 16
    for (int k = 1; k < n; ++k) s = __fadd_rn(s, __fmul_rn(fa[k], fb[k]));
    gram[u] = s;
  }
}

// The float at the shared-memory address `local` of this block, in the
// cluster's block `peer`.  A 32-bit address kept out of loop-invariant code
// motion: the compiler would keep every such address of the Gram's
// gather live in registers across the whole iteration.
__device__ __forceinline__ float load_peer(uint32_t local, int peer) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(peer));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote));
  return v;
}

// The eliminating side: G (r x r, row stride R) = the Gram, mirrored, from
// the cluster's shares, eight loads in flight a thread.
__device__ void gather_gram(const float* gram, int S, int r, int R, float* G) {
  const int first = (threadIdx.x >> 7) * 32 + (threadIdx.x & 31), step = blockDim.x >> 2;
  const int shift = __ffs(S) - 1, count = r * (r + 1) / 2;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(gram));
  for (int t0 = first; t0 < count; t0 += 8 * step) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + j * step;
      v[j] = t < count ? load_peer(base + 4u * static_cast<uint32_t>(t >> shift), t & (S - 1))
                       : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + j * step;
      if (t < count) {
        const int b = tri_row(t), a = t - tri_index(0, b);
        G[a * R + b] = v[j];
        G[b * R + a] = v[j];
      }
    }
  }
  asm volatile("bar.sync 2, %0;\n" ::"r"(static_cast<int>(blockDim.x) >> 2) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Barrier 1 over the product side's warps.
__device__ __forceinline__ void product_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(product_warps(blockDim.x >> 5) * 32) : "memory");
}

// The elimination's progress: warp 0's lane 0 publishes the count of steps
// whose pivot columns and reciprocals are stored by a release store, and
// the product side reads it with acquire loads.
__device__ __forceinline__ void publish_steps(unsigned* progress, unsigned count) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(progress))),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ unsigned published_steps(const unsigned* progress) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(progress)))
               : "memory");
  return v;
}

// Warp 0: no-pivot Gauss-Jordan on the left block G + lam I (G in pcol, row
// stride R, from gather_gram), recording for each step k its pivot column
// as it stood before the step (pcol[k R + j] = row (j + k) mod R) and the
// pivot's double reciprocal (rcps[k]).  Lane c holds column c.  The
// registers rotate by one row per pivot, so the pivot row is always at
// index 0 and the pivot loop need not be unrolled (a short loop body stays
// in the instruction cache): after step k, index j holds row (j + k + 1)
// mod R.  Lane k writes its column to pcol and the warp reads it back,
// broadcast, four rows a load: cheaper on this card than a shuffle a row.
// Each step forms the next pivot first and takes its reciprocal while the
// rest of the column updates; it publishes the steps before it (their
// stores passed a __syncwarp since), so the release never waits on its own
// step's stores.  Rows and columns r..R-1 are zero and never pivot.
template <int R>
__device__ void eliminate_left(int r, float lam, float* pcol, double* rcps, unsigned* progress,
                               unsigned base) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float L[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float g = (i < r && lane < r) ? pcol[i * R + lane] : 0.f;
    L[i] = (i == lane && lane < r) ? __fadd_rn(g, lam) : g;
  }
  __syncwarp();
  double rcp = __drcp_rn(static_cast<double>(__shfl_sync(full, L[0], 0)));
#pragma unroll 1
  for (int k = 0; k < r; ++k) {
    float4* col = reinterpret_cast<float4*>(pcol + k * R);
    if (lane == k) {
#pragma unroll
      for (int j = 0; j < R; j += 4) col[j / 4] = make_float4(L[j], L[j + 1], L[j + 2], L[j + 3]);
      rcps[k] = rcp;
    }
    __syncwarp();
    if (lane == 0 && k > 0) publish_steps(progress, base + k);
    float pc[R];  // aug[.][k], before its update
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      const float4 v = col[j / 4];
      pc[j] = v.x;
      pc[j + 1] = v.y;
      pc[j + 2] = v.z;
      pc[j + 3] = v.w;
    }
    const float pl = gj::quotient(L[0], rcp);
    L[0] = __fsub_rn(L[1], __fmul_rn(pc[1], pl));
    // the next pivot (past the last step: unused)
    rcp = __drcp_rn(static_cast<double>(__shfl_sync(full, L[0], (k + 1) & 31)));
#pragma unroll
    for (int i = 2; i < R; ++i) L[i - 1] = __fsub_rn(L[i], __fmul_rn(pc[i], pl));
    L[R - 1] = pl;
  }
  __syncwarp();
  if (lane == 0) publish_steps(progress, base + r);
}

// The product side's part of a ridge solve: for its groups of TJ columns,
// out(a, j) = ((G + lam I)^-1 F M)(a, j) (F: r x n, row stride ldF; M: n x
// m, row stride ldM; out row stride ldo).  A segment of R lanes holds the
// rows of a group (a lane a row): first the products F M, each summed in
// index order, in registers; then the elimination's recorded steps, each
// as soon as warp 0 has published it (steps base + 1 .. base + r of the
// progress count).  A column's update at step k reads only itself and the
// pivot column, so this equals the whole elimination bit for bit.
template <int R, int TJ>
__device__ void solve_columns(const float* F, int ldF, const float* M, int ldM, int n, int r,
                              int m, const float* pcol, const double* rcps,
                              const unsigned* progress, unsigned base, float* out, int ldo) {
  constexpr int spw = 32 / R;  // segments per warp
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, seg = lane / R, a = lane % R;
  const int np = product_warps(blockDim.x >> 5), pw = product_warp(threadIdx.x >> 5);
  const int groups = (m + TJ - 1) / TJ;
  const float* f = F + min(a, r - 1) * ldF;
  int ready = 0;  // steps known to be published
  for (int g = pw * spw + seg; g - seg < groups; g += np * spw) {  // warp-uniform
    const float* mc[TJ];
#pragma unroll
    for (int v = 0; v < TJ; ++v) mc[v] = M + min(g * TJ + v, m - 1);
    float s[TJ];
#pragma unroll
    for (int v = 0; v < TJ; ++v) s[v] = __fmul_rn(f[0], mc[v][0]);
    // deep enough that the loads run ahead of the sums' chains
    constexpr int kUnroll = TJ <= 2 ? 16 : (TJ <= 4 ? 8 : 4);
#pragma unroll kUnroll
    for (int k = 1; k < n; ++k) {
      const float fk = f[k];
#pragma unroll
      for (int v = 0; v < TJ; ++v) s[v] = __fadd_rn(s[v], __fmul_rn(fk, mc[v][k * ldM]));
    }
#pragma unroll 1
    for (int k = 0; k < r; ++k) {
      while (k >= ready) {
        ready = static_cast<int>(published_steps(progress) - base);
        if (k >= ready) __nanosleep(32);
      }
      const float pc = pcol[k * R + ((a - k) & (R - 1))];  // aug[a][k] before step k
      const double rcp = rcps[k];
      // lane v of the segment takes column v's quotient (one pair of
      // conversions a step for all TJ columns) and hands it out
      float mine = 0.f;
#pragma unroll
      for (int v = 0; v < TJ; ++v) {
        const float t = __shfl_sync(full, s[v], k, R);
        if (a == v) mine = t;
      }
      const float qm = gj::quotient(mine, rcp);
#pragma unroll
      for (int v = 0; v < TJ; ++v) {
        const float q = __shfl_sync(full, qm, v, R);
        s[v] = a == k ? q : __fsub_rn(s[v], __fmul_rn(pc, q));
      }
    }
#pragma unroll
    for (int v = 0; v < TJ; ++v) {
      const int j = g * TJ + v;
      if (a < r && j < m) out[a * ldo + j] = s[v];
    }
  }
}

// TJ: the fewest columns a group that still give every product-side
// segment at most one group, up to 16.
template <int R>
__device__ void solve_columns_by_width(const float* F, int ldF, const float* M, int ldM, int n,
                                       int r, int m, const float* pcol, const double* rcps,
                                       const unsigned* progress, unsigned base, float* out,
                                       int ldo) {
  const int slots = product_warps(blockDim.x >> 5) * (32 / R);
  const int per = (m + slots - 1) / slots;
  if (per <= 2)
    solve_columns<R, 2>(F, ldF, M, ldM, n, r, m, pcol, rcps, progress, base, out, ldo);
  else if (per <= 4)
    solve_columns<R, 4>(F, ldF, M, ldM, n, r, m, pcol, rcps, progress, base, out, ldo);
  else if (per <= 8)
    solve_columns<R, 8>(F, ldF, M, ldM, n, r, m, pcol, rcps, progress, base, out, ldo);
  else
    solve_columns<R, 16>(F, ldF, M, ldM, n, r, m, pcol, rcps, progress, base, out, ldo);
}

// The two parts of a ridge solve, at the rank's lane count.
__device__ void eliminate(int R, int r, float lam, float* pcol, double* rcps, unsigned* progress,
                          unsigned base) {
  if (R == 32)
    eliminate_left<32>(r, lam, pcol, rcps, progress, base);
  else
    eliminate_left<16>(r, lam, pcol, rcps, progress, base);
}

__device__ void solve_right(int R, const float* F, int ldF, const float* M, int ldM, int n, int r,
                            int m, const float* pcol, const double* rcps,
                            const unsigned* progress, unsigned base, float* out, int ldo) {
  if (R == 32)
    solve_columns_by_width<32>(F, ldF, M, ldM, n, r, m, pcol, rcps, progress, base, out, ldo);
  else
    solve_columns_by_width<16>(F, ldF, M, ldM, n, r, m, pcol, rcps, progress, base, out, ldo);
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

__global__ void __launch_bounds__(kThreads, 1)
als_kernel(const float* __restrict__ W, const uint8_t* __restrict__ dmask,
           const float* __restrict__ A_in, int n, int r, float alpha, float beta,
           float mu0, float tol, int max_iter, int stable_iters,
           uint8_t* __restrict__ x_bin, float* __restrict__ x_out,
           int* __restrict__ iters_out) {
  extern __shared__ float4 smem_f4[];
  __shared__ double red[96];
  __shared__ double part[3];
  __shared__ double tot[3];
  __shared__ unsigned progress;  // elimination steps recorded, over all solves
  cg::cluster_group cluster = cg::this_cluster();
  const Shape sh = make_shape(n, r, static_cast<int>(cluster.num_blocks()));
  const int S = sh.S, w = sh.w, ldS = sh.ldS, ldF = sh.ldF, R = sh.R;
  const int q = static_cast<int>(cluster.block_rank());
  const int c0 = q * w, wq = max(0, min(n, c0 + w) - c0);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const int problem = blockIdx.x / S;
  W += static_cast<size_t>(problem) * n * n;
  x_bin += static_cast<size_t>(problem) * n * n;
  if (x_out != nullptr) x_out += static_cast<size_t>(problem) * n * n;

  double* rcps = reinterpret_cast<double*>(smem_f4);  // R pivot reciprocals
  float* pcol = reinterpret_cast<float*>(smem_f4) + 2 * R;  // R x R pivot columns
  float* X = pcol + R * R;   // current X, own strip
  float* Xn = X + n * ldS;   // the X step (read by peers), then the next X
  float* Zb = Xn + n * ldS;  // Z; between the gathers, X step rows transposed
  float* Y = Zb + n * ldS;
  float* F = Y + n * ldS;    // full A^T or B^T (r x n)
  float* Bq = F + r * ldF;   // own B^T strip (r x w)
  float* Aq = Bq + r * w;    // own A^T strip (r x w)
  float* gram = Aq + r * w;  // this block's share of the Gram (E)

  if (wq > 0)
    for (Walk2 t(wq, tid, nt); t.i < n; t.next()) {
      const int i = t.i, j = c0 + t.j, e = i * ldS + t.j;
      const float v = __fmul_rn(0.5f, __fadd_rn(W[i * n + j], W[j * n + i]));
      X[e] = v;
      Zb[e] = v;
      Y[e] = 0.f;
    }
  for (Walk2 t(r, tid, nt); t.i < n; t.next()) F[t.j * ldF + t.i] = A_in[t.i * r + t.j];
  if (tid == 0) progress = 0;
  cluster.sync();  // every block of the cluster runs before any reads a peer

  const double tol_d = static_cast<double>(tol);
  float mu = mu0;
  int it = 0, stable = 0;
  unsigned base = 0;  // the progress count at the start of the current solve
  bool done = false;
  while (it < max_iter && !done) {
    const float lam = __fdiv_rn(alpha, mu);
    const double rmu = __drcp_rn(static_cast<double>(mu));

    // B^T strip = solve([A^T A + lam I | A^T Xs(:, strip)]); meanwhile the
    // product side takes the ADMM X step on the own strip, Xs = Z - (Y - W +
    // beta) / mu, forms the right-hand products and applies the steps
    const bool elim_side = eliminating_side(warp);
    if (elim_side) gram_share(F, ldF, n, r, q, S, sh.E, gram);
    cluster_arrive();
    if (!elim_side) {
      const int np = product_warps(nt >> 5) * 32;
      if (wq > 0)
        for (Walk2 t(wq, product_warp(warp) * 32 + (tid & 31), np); t.i < n;) {
          // four entries a pass, their eight loads of W in flight together
          int e[4];
          float wa[4], wb[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = min(t.i, n - 1), j = c0 + t.j;
            e[u] = t.i < n ? i * ldS + t.j : -1;
            wa[u] = W[i * n + j];
            wb[u] = W[j * n + i];
            t.next();
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (e[u] < 0) continue;
            const float wv = __fmul_rn(0.5f, __fadd_rn(wa[u], wb[u]));
            Xn[e[u]] = __fsub_rn(Zb[e[u]],
                                 gj::quotient(__fadd_rn(__fsub_rn(Y[e[u]], wv), beta), rmu));
          }
        }
      product_warps_sync();
      solve_right(R, F, ldF, Xn, ldS, n, r, wq, pcol, rcps, &progress, base, Bq, w);
    }
    cluster_wait();
    if (elim_side) gather_gram(gram, S, r, R, pcol);
    if (warp == 0) eliminate(R, r, lam, pcol, rcps, &progress, base);
    base += r;
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

    // A^T strip = solve([B^T B + lam I | B^T Xs(strip, :)^T])
    if (elim_side) gram_share(F, ldF, n, r, q, S, sh.E, gram);
    cluster_arrive();
    if (!elim_side) solve_right(R, F, ldF, Zb, ldS, n, r, wq, pcol, rcps, &progress, base, Aq, w);
    cluster_wait();
    if (elim_side) gather_gram(gram, S, r, R, pcol);
    if (warp == 0) eliminate(R, r, lam, pcol, rcps, &progress, base);
    base += r;
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
              (i == j) ? 1.f : (dmask[i * n + j] ? 0.f : __fadd_rn(x, gj::quotient(y0, rmu)));
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
    // the cluster's totals, summed in block order by warp 0 (lane p reads
    // block p's partials) and handed to the block
    if (warp == 0) {
      double v[3] = {0.0, 0.0, 0.0};
      if ((tid & 31) < S) {
        const double* pp = cluster.map_shared_rank(part, tid & 31);
        v[0] = pp[0];
        v[1] = pp[1];
        v[2] = pp[2];
      }
      double t3[3] = {0.0, 0.0, 0.0};
      for (int p = 0; p < S; ++p)
#pragma unroll
        for (int c = 0; c < 3; ++c) t3[c] += __shfl_sync(full, v[c], p);
      if (tid == 0)
#pragma unroll
        for (int c = 0; c < 3; ++c) tot[c] = t3[c];
    }
    __syncthreads();
    const double t_pz = tot[0], t_dx = tot[1], t_flip = tot[2];
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
  cfg->blockDim = dim3(static_cast<unsigned>(kThreads));
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
  o[1] = kThreads;
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
