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
// 3.35 TB/s) and the work ~41 MFLOP for the products of the symmetric G plus
// ~3 MFLOP for the solves (0.7 us at 67 TFLOP/s f32).  What the kernel waits
// on is two chains: the R-long dependent sum of every entry of G, and the D
// dependent pivot steps of the elimination.
//
// Design: one thread-block cluster of kCluster blocks (256 threads each) per
// slot.
// - Gram, symmetric and register-tiled: only the tiles of 2 rows x 4 columns
//   of G that reach its upper triangle or its last column are computed (340
//   tiles at D = 68, 2,516 entries instead of 4,692), a contiguous range
//   of them to each block of the cluster, one tile per thread (neighbouring
//   lanes read neighbouring columns: no bank conflicts).  A thread keeps its 8
//   running sums in registers and, per row of Jaug, reads 2 + 4 values from
//   shared memory for 8 products.  The rows stream through shared memory in
//   chunks of kRowsPerChunk, a ring of kStages buffers filled with
//   cp.async, so that the loads of the next three chunks overlap this
//   chunk's products; one barrier per chunk.  Each block writes its
//   tiles and their mirror images into the leader block's G through
//   distributed shared memory; the outputs are partitioned, never summed.
// - The leader then forms the trace (one thread, in index order) and the
//   shift, and runs gj_elim.cuh's elimination (B2's) on G, the other blocks
//   having left.
//
// Rounding: every product and sum is one round-to-nearest intrinsic, each
// entry summed by one thread over the rows in index order, the first row's
// product taken as it is; a mirrored entry equals the one computed for its
// place, since a * b == b * a in IEEE.  The plain torch version
// (ops/solve_kernel.py:fused_normal_plain) performs the same operations in
// the same order, so the two agree bit for bit.
//
// Limit: D <= 90 (kMaxD), as before; at D = 90 the 551 tiles fill 138 of
// each block's 256 threads.
#include <atomic>

#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "gj_elim.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 4;
constexpr int kRowsPerChunk = 32;
constexpr int kStages = 4;  // chunks in flight: 3 ahead of the one being summed
constexpr int kMaxD = 90;
constexpr int kTU = 2, kTV = 4;  // a Gram tile: kTU rows x kTV columns of G
constexpr int kMaxDevices = 64;  // devices a process may launch on

// Column tiles of G (D + 1 columns); kTV of them make the row stride of the
// chunks and of G in floats.
__host__ __device__ inline int col_tiles(int D) { return (D + kTV) / kTV; }
__host__ __device__ inline int row_tiles(int D) { return (D + kTU - 1) / kTU; }
// the first column tile that reaches row tile u's diagonal
__host__ __device__ inline int first_col_tile(int u) { return kTU * u / kTV; }

// Tiles that reach the upper triangle or the last column of G.
__host__ __device__ inline int n_tiles(int D) {
  int n = 0;
  for (int u = 0; u < row_tiles(D); ++u) n += col_tiles(D) - first_col_tile(u);
  return n;
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x, out[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// Copies nr rows of C floats from src (contiguous) into dst (row stride CS)
// with cp.async: warp w copies rows w, w + 8, ..., lane l columns l, l + 32, ...
__device__ __forceinline__ void copy_rows_async(float* dst, const float* src, int nr, int C,
                                                int CS) {
  for (int r = threadIdx.x / 32; r < nr; r += kThreads / 32)
    for (int c = threadIdx.x % 32; c < C; c += 32)
      __pipeline_memcpy_async(dst + r * CS + c, src + r * C + c, sizeof(float));
}

size_t smem_bytes(int D, int slot_floats) {
  const size_t CS = kTV * static_cast<size_t>(col_tiles(D));
  return (kStages * kRowsPerChunk * CS + D * CS + slot_floats) * sizeof(float);
}

template <class Tl>
__global__ void __launch_bounds__(kThreads)
fused_normal_gj_kernel(const float* __restrict__ Jaug, const float* __restrict__ lam,
                       const float* __restrict__ frozen, float* __restrict__ x, int R, int D) {
  extern __shared__ float4 smem_f4[];
  __shared__ float shift;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int slot = blockIdx.x / kCluster;
  const int C = D + 1, CS = kTV * col_tiles(D);
  float* rows = reinterpret_cast<float*>(smem_f4);   // kStages x kRowsPerChunk x CS
  float* G = rows + kStages * kRowsPerChunk * CS;    // D x CS, the leader's
  float* slots = G + D * CS;                         // Tl::kSmemFloats
  const int tid = threadIdx.x;
  const float* Jt = Jaug + static_cast<size_t>(slot) * R * C;

  // this block has started: peers may write into its shared memory after
  // the matching wait
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // this thread's tile: rows kTU u .. kTU u + kTU - 1 and columns kTV v ..
  // kTV v + kTV - 1 of G.  Block b takes a contiguous range of the tiles, so
  // that neighbouring lanes read neighbouring columns of a row
  int u = -1, v = 0;
  const int per_block = (n_tiles(D) + kCluster - 1) / kCluster;
  if (tid < per_block) {
    int t = rank * per_block + tid;
    for (int uu = 0; uu < row_tiles(D); ++uu) {
      const int n = col_tiles(D) - first_col_tile(uu);
      if (t < n) {
        u = uu;
        v = first_col_tile(uu) + t;
        break;
      }
      t -= n;
    }
  }

  // chunk ch of kRowsPerChunk rows into ring buffer ch % kStages, one
  // cp.async group per chunk (empty past the last chunk)
  const int n_chunks = (R + kRowsPerChunk - 1) / kRowsPerChunk;
  const int chunk_floats = kRowsPerChunk * CS;
  for (int ch = 0; ch + 1 < kStages; ++ch) {
    if (ch < n_chunks)
      copy_rows_async(rows + (ch % kStages) * chunk_floats,
                      Jt + static_cast<size_t>(ch) * kRowsPerChunk * C,
                      min(kRowsPerChunk, R - ch * kRowsPerChunk), C, CS);
    __pipeline_commit();
  }
  float s[kTU][kTV];
  for (int ch = 0; ch < n_chunks; ++ch) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of chunk ch have landed
    __syncthreads();  // everyone's have, and everyone is done with chunk ch - 1
    const int ahead = ch + kStages - 1;  // into chunk ch - 1's buffer
    if (ahead < n_chunks)
      copy_rows_async(rows + (ahead % kStages) * chunk_floats,
                      Jt + static_cast<size_t>(ahead) * kRowsPerChunk * C,
                      min(kRowsPerChunk, R - ahead * kRowsPerChunk), C, CS);
    __pipeline_commit();
    if (u >= 0) {
      const float* pa = rows + (ch % kStages) * chunk_floats + kTU * u;
      const float* pb = rows + (ch % kStages) * chunk_floats + kTV * v;
      const int nr = min(kRowsPerChunk, R - ch * kRowsPerChunk);
      int r = 0;
      if (ch == 0) {  // the first row's products start the sums
        float a[kTU], b[kTV];
        load_vec(pa, a);
        load_vec(pb, b);
#pragma unroll
        for (int p = 0; p < kTU; ++p)
#pragma unroll
          for (int q = 0; q < kTV; ++q) s[p][q] = __fmul_rn(a[p], b[q]);
        r = 1;
      }
#pragma unroll 4
      for (; r < nr; ++r) {
        float a[kTU], b[kTV];
        load_vec(pa + r * CS, a);
        load_vec(pb + r * CS, b);
#pragma unroll
        for (int p = 0; p < kTU; ++p)
#pragma unroll
          for (int q = 0; q < kTV; ++q) s[p][q] = __fadd_rn(s[p][q], __fmul_rn(a[p], b[q]));
      }
    }
  }

  // the tiles and their mirror images into the leader's G
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (u >= 0) {
    float* Gl = cluster.map_shared_rank(G, 0);
#pragma unroll
    for (int p = 0; p < kTU; ++p) {
#pragma unroll
      for (int q = 0; q < kTV; ++q) {
        const int i = kTU * u + p, j = kTV * v + q;
        if (i < D && j <= D) {
          Gl[i * CS + j] = s[p][q];
          if (j < D) Gl[j * CS + i] = s[p][q];
        }
      }
    }
  }
  cluster.sync();
  if (rank != 0) return;  // the leader reads no peer's shared memory from here on

  // (lam + ridge) I + diag(frozen) on the first D columns
  if (tid == 0) {
    float tr = G[0];
    for (int i = 1; i < D; ++i) tr = __fadd_rn(tr, G[i * CS + i]);
    const float ridge = __fadd_rn(__fmul_rn(1e-6f, __fdiv_rn(tr, static_cast<float>(D))), 1e-6f);
    shift = __fadd_rn(lam[slot], ridge);
  }
  __syncthreads();
  for (int i = tid; i < D; i += kThreads)
    G[i * CS + i] = __fadd_rn(__fadd_rn(G[i * CS + i], shift), frozen[i]);
  __syncthreads();

  gj::eliminate<Tl>(
      D, [=](int r, int c) { return G[r * CS + c]; }, slots, x + static_cast<size_t>(slot) * D);
}

// Calls f(Tiling) for the elimination's tiling of side D;
// cudaErrorInvalidValue where there is none.
template <class F>
cudaError_t with_tiling(int D, F&& f) {
  auto fits = [&](auto tl) {
    return (D >= 1 && D <= kMaxD && D <= decltype(tl)::kMaxD &&
            n_tiles(D) <= kCluster * kThreads)
               ? f(tl)
               : cudaErrorInvalidValue;
  };
  switch ((D + 16) / 16) {  // the elimination's P = ceil((D + 1) / 16)
    case 1: return fits(gj::Tiling<16, 1>{});
    case 2: return fits(gj::Tiling<16, 2>{});
    case 3: return fits(gj::Tiling<16, 3>{});
    case 4: return fits(gj::Tiling<16, 4>{});
    case 5: return fits(gj::Tiling<16, 5>{});
    case 6: return fits(gj::Tiling<16, 6>{});
    default: return cudaErrorInvalidValue;
  }
}

template <class Tl>
cudaError_t configure(int D, int T, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const size_t bytes = smem_bytes(D, Tl::kSmemFloats);
  // the largest size set so far for this instantiation, per device: the
  // attribute belongs to the current device, and launches for several
  // devices may come from several host threads
  static std::atomic<size_t> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > allowed[dev].load()) {
    err = cudaFuncSetAttribute(fused_normal_gj_kernel<Tl>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    size_t seen = allowed[dev].load();
    while (seen < bytes && !allowed[dev].compare_exchange_weak(seen, bytes)) {
    }
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(T * kCluster));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Largest D the kernel takes.
extern "C" int fused_normal_max_d() { return kMaxD; }

// Jaug (T, R, D+1), lam (T,), frozen (D,), x (T, D).  Returns the launch's
// cudaError_t.
extern "C" int fused_normal_gj_f32(const void* Jaug, const void* lam, const void* frozen,
                                   void* x, int T, int R, int D, void* stream) {
  if (T <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_tiling(D, [&](auto tl) {
    using Tl = decltype(tl);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = configure<Tl>(D, T, static_cast<cudaStream_t>(stream), &cfg, attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, fused_normal_gj_kernel<Tl>,
                             static_cast<const float*>(Jaug), static_cast<const float*>(lam),
                             static_cast<const float*>(frozen), static_cast<float*>(x), R, D);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }));
}

// The launch shape at D, into out[0..5]: blocks per cluster (one slot),
// threads per block, dynamic shared memory bytes per block, registers per
// thread and local (spill) bytes per thread as ptxas assigned them, and how
// many such clusters the card holds at once.  Returns a cudaError_t.
extern "C" int fused_launch_shape(int D, void* out) {
  return static_cast<int>(with_tiling(D, [&](auto tl) {
    using Tl = decltype(tl);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = configure<Tl>(D, 1, nullptr, &cfg, attr);
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fused_normal_gj_kernel<Tl>);
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, fused_normal_gj_kernel<Tl>, &cfg);
    if (err != cudaSuccess) return err;
    int* o = static_cast<int*>(out);
    o[0] = kCluster;
    o[1] = kThreads;
    o[2] = static_cast<int>(cfg.dynamicSmemBytes);
    o[3] = fa.numRegs;
    o[4] = static_cast<int>(fa.localSizeBytes);
    o[5] = clusters;
    return cudaSuccess;
  }));
}
