// No-pivot Gauss-Jordan on one block's augmented matrix [A | g], held in
// registers: the elimination that gj_solve.cu (B2, B5) and
// fused_normal_gj.cu (B4) share.
//
// Layout: the block's S x S threads form a grid; thread (tr, tc), with
// threadIdx.x = tr * S + tc, owns rows tr + S i and columns tc + S j
// (i, j < P) of [A | g] padded to S P x S P, a P x P tile in registers.
// Padding entries start at 0 and feed only padding entries.  Pivot k lies
// in register row and column I = k / S of the threads with tr == k % S and
// tc == k % S: the pivot loop is P blocks of S pivots, one template
// instance per block I (pivot_block), so every register index is known at
// compile time, and register columns j < I, whose columns are unit vectors
// by then and never feed the solution column again, are skipped.
//
// One block barrier per pivot, by look-ahead.  Step k first forms row and
// column k+1 as step k leaves them, in the threads that own them: the S
// threads of row k+1 (S lanes of one warp) take the pivot a[k+1][k+1] from
// the lane that holds it with a shuffle and write the row's quotients
// a[k+1][j] / a[k+1][k+1] for its live columns j > k+1 into a shared-memory
// slot, and the threads of column k+1 write it into the same slot; then
// every thread applies step k to its tile.  Two slots alternate: step k+1
// reads its slot after one barrier, and a slot is written again only after
// the next barrier, when no thread still reads it.
//
// Rounding: step k sets row k to the quotients and every other entry to
// __fsub_rn(a[i][j], __fmul_rn(a[i][k], q[j])) (no contracted multiply-add).
// Within a step each entry is updated from values fixed before the step, so
// any partition of the entries among threads gives the same bits: those of
// ops/solve_kernel.py:gauss_jordan_plain, which performs the same operations
// on every entry.  A quotient is the double product of a[k][j] and the
// correctly rounded double reciprocal of the pivot, rounded once to float
// (`quotient`): that is the true quotient rounded to float, bit for bit, as
// __fdiv_rn gives it (see there), without __fdiv_rn's slow path, which the
// zero entries of frozen parameters take at every step.
#pragma once

#include <cuda_runtime.h>

namespace gj {

template <int S, int P>
struct Tiling {
  static_assert(S <= 32 && 32 % S == 0, "the owners of a row share one warp");
  static_assert(S * S >= 32, "whole warps");
  static constexpr int kS = S, kP = P;
  static constexpr int kThreads = S * S;
  static constexpr int kPad = S * P;  // padded rows and columns
  // one slot: the pivot row's quotients (kPad), then the pivot column (kPad)
  static constexpr int kSlot = 2 * kPad;
  static constexpr int kSmemFloats = 2 * kSlot;
  static constexpr int kMaxD = kPad - 1;  // D rows and D + 1 columns
};

// a / b rounded to float, equal to __fdiv_rn(a, b) for all floats, given
// rcp = __drcp_rn(b) (b as a double).  The product a * rcp, rounded to
// double, is within a relative 2^-52 of a / b (two double roundings).  A
// rounding boundary of float (a midpoint m of 25 significant bits, or a
// boundary of the subnormal or overflow range) is never a / b itself, since
// m b has more significant bits than a, and a / b lies at least a relative
// 2^-48 from it: |a / b - m| = |a - m b| / |b|, and a - m b is a nonzero
// multiple of the unit of m b.  So rounding the product to float gives the
// rounding of a / b.  Zeros, infinities and NaN follow IEEE rules in both.
__device__ __forceinline__ float quotient(float a, double rcp) {
  return __double2float_rn(__dmul_rn(static_cast<double>(a), rcp));
}

// Writes row n's quotients into `slot` from its owners' register row R
// (values nr, live from register column R on).  The whole warp of row n
// calls it; the pivot comes from the lane of column n.
template <class Tl, int R>
__device__ __forceinline__ void publish_row(int n, const float (&nr)[Tl::kP], float* slot,
                                            int tr, int tc, int D) {
  constexpr int S = Tl::kS, P = Tl::kP;
  const int src = (n % S % (32 / S)) * S + n % S;
  const float piv = __shfl_sync(0xffffffffu, nr[R], src);
  if (tr == n % S) {
    const double rcp = __drcp_rn(static_cast<double>(piv));
#pragma unroll
    for (int j = R; j < P; ++j) {
      const int c = tc + S * j;
      if (c > n && c <= D) slot[c] = quotient(nr[j], rcp);
    }
  }
}

// Look-ahead of step k (pivot in register row and column I): row and column
// n = k + 1 as step k leaves them, from their owners' register row and
// column N, into the slot `next`.
template <class Tl, int I, int N>
__device__ __forceinline__ void look_ahead(int k, bool pivot_row, const float (&a)[Tl::kP][Tl::kP],
                                           const float (&q)[Tl::kP], const float (&c)[Tl::kP],
                                           float* next, int tr, int tc, int D) {
  constexpr int S = Tl::kS, P = Tl::kP;
  const int n = k + 1;
  if (tc == n % S) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float v = __fsub_rn(a[i][N], __fmul_rn(c[i], q[N]));
      next[Tl::kPad + tr + S * i] = (i == I && pivot_row) ? q[N] : v;
    }
  }
  if (static_cast<int>(threadIdx.x) / 32 == n % S / (32 / S)) {  // warp-uniform
    float nr[P];
#pragma unroll
    for (int j = N; j < P; ++j) nr[j] = __fsub_rn(a[N][j], __fmul_rn(c[N], q[j]));
    publish_row<Tl, N>(n, nr, next, tr, tc, D);
  }
}

// Pivots I S .. I S + S - 1 (register row and column I), then the next
// block.
template <class Tl, int I>
__device__ __forceinline__ void pivot_block(float (&a)[Tl::kP][Tl::kP], float* slots, int tr,
                                            int tc, int D) {
  constexpr int S = Tl::kS, P = Tl::kP;
  for (int kk = 0; kk < S; ++kk) {
    const int k = I * S + kk;
    if (k >= D) return;
    __syncthreads();
    const float* s = slots + (k & 1) * Tl::kSlot;
    float q[P], c[P];
#pragma unroll
    for (int j = I; j < P; ++j) q[j] = s[tc + S * j];
#pragma unroll
    for (int i = 0; i < P; ++i) c[i] = s[Tl::kPad + tr + S * i];
    const bool pivot_row = tr == kk;  // register row I holds row k

    if (k + 1 < D) {
      float* next = slots + ((k + 1) & 1) * Tl::kSlot;
      if (kk + 1 < S) {
        look_ahead<Tl, I, I>(k, pivot_row, a, q, c, next, tr, tc, D);
      } else {
        look_ahead<Tl, I, (I + 1 < P ? I + 1 : P - 1)>(k, pivot_row, a, q, c, next, tr, tc, D);
      }
    }

    // step k on the live columns of the tile
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int j = I; j < P; ++j) {
        const float v = __fsub_rn(a[i][j], __fmul_rn(c[i], q[j]));
        a[i][j] = (i == I && pivot_row) ? q[j] : v;
      }
    }
  }
  if constexpr (I + 1 < P) pivot_block<Tl, I + 1>(a, slots, tr, tc, D);
}

// Solve [A | g] of side D <= Tl::kMaxD with the block's Tl::kThreads
// threads.  load(r, c) gives entry (r, c) for r < D, c <= D (c == D: g[r]);
// `slots` holds Tl::kSmemFloats floats of shared memory; x[0..D) receives the
// solution.  Every thread of the block must call it; it ends with a block
// barrier.
template <class Tl, class Load>
__device__ __forceinline__ void eliminate(int D, Load load, float* slots, float* __restrict__ x) {
  constexpr int S = Tl::kS, P = Tl::kP;
  const int tr = static_cast<int>(threadIdx.x) / S;
  const int tc = static_cast<int>(threadIdx.x) % S;
  float a[P][P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int r = tr + S * i, c = tc + S * j;
      a[i][j] = (r < D && c <= D) ? load(r, c) : 0.0f;
    }
  }

  // pivot 0: row and column 0 as loaded
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < P; ++i) slots[Tl::kPad + tr + S * i] = a[i][0];
  }
  if (threadIdx.x < 32) publish_row<Tl, 0>(0, a[0], slots, tr, tc, D);

  pivot_block<Tl, 0>(a, slots, tr, tc, D);

  // The solution column goes out through the slot that step D - 1 did not
  // read (every thread passed that step's barrier after its last read of
  // it), whole, padding included, and from there to x by consecutive
  // threads.  Guarding each register row's store with its own r < D instead
  // kept P row predicates alive across the pivot loop, which ptxas moved to
  // local memory in B4.
  float* sol = slots + (D & 1) * Tl::kSlot;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (tc + S * j == D) {
#pragma unroll
      for (int i = 0; i < P; ++i) sol[tr + S * i] = a[i][j];
    }
  }
  __syncthreads();
  for (int i = static_cast<int>(threadIdx.x); i < D; i += Tl::kThreads) x[i] = sol[i];
}

}  // namespace gj
