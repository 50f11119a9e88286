// Device code shared by the LSTM and GRU scans' recompute backwards
// (lstm_scan_bwd.cu, gru_scan_bwd.cu; rows 16 and 12) for Hopper
// (sm_90a): the chain's geometry on a thread block cluster, its
// shared-memory budget, the per-step product of a few batch rows with a
// weight slice, and the cluster launch.  The host picks a launch's
// cluster, rows and form (ops/rnn_scan.py::scan_form).
//
// A chain carries up to kMaxRows batch rows (a kernel may take fewer, RM,
// to fit a wide W) through T steps on a cluster
// of NC blocks.  Block r owns hidden units [r*U, r*U + ucnt), U =
// ceil(W / NC), and the gate columns of each (four LSTM, three GRU); a step's per-unit
// values (the new h forward, the gate gradients backward) are written into
// every block's shared memory through distributed shared memory, and one
// cluster barrier a step publishes them.  Every block has the same shared
// memory layout (sized by U, not ucnt), so a peer's buffer sits at the
// same offset.
//
// Where the per-unit values cross the cluster past the shared memory (W
// wide enough that even one row's double-buffered values do not fit), a
// kernel may keep them in device memory instead (GX): each block writes its
// units' values there once, a fence and the cluster barrier publish them,
// and the product reads them back through L2 (ld.global.cg, which skips the
// SM's own L1, where an earlier step's line could stand).
//
// The per-step product out[b][c] = sum_j in[b][j] * Wt(j, c) over a block's
// C columns is SIMT f32: thread (s, c) takes column c over depth slice s,
// keeps a running sum for each of the RM rows (kMaxRows unless the kernel
// says fewer) in registers, reads in[b][j..j+3] as one float4
// broadcast and Wt(j, c) with neighbouring threads on neighbouring columns.
// The first `rs` rows of the block's weight slice sit in shared memory in
// the weights' dtype, loaded once; rows past it (a slice larger than the
// budget) are read from device memory, through L2, every step.  The
// slices' sums are added in slice order: no atomics, reruns are
// bit-identical.

#pragma once

#include <cooperative_groups.h>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kScanThreads = 256;
constexpr int kMaxRows = 8;       // batch rows a cluster carries
constexpr int kMaxCluster = 16;   // blocks of a cluster (16: non-portable)
constexpr int kMaxPairs = 2;      // (row, unit) pairs a thread owns
constexpr int kWidePairs = 8;     // the same, in the one-row forms
constexpr size_t kScanSmem = 225 * 1024;  // dynamic shared memory budget

struct ScanArgs {
  int Tn, B, W;
  int NC;    // blocks per cluster
  int U;     // units per block, ceil(W / NC)
  int rows;  // batch rows per cluster
  int rs;    // weight rows (depth) resident in shared memory, product 1
  int rs2;   // the same, product 2 (recompute backward only)
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Row stride of a [kMaxRows][depth] f32 operand: a multiple of 4, so a
// row's float4 loads stay aligned; the padding stays 0.
__host__ __device__ inline int row_ld(int depth) { return round4(depth); }

// Columns C and depth slices: S slices of L rows (L a multiple of 4) cover
// `depth`, S * C <= max(C, kScanThreads).
struct Slices {
  int S, L;
};

__host__ __device__ inline Slices slices(int C, int depth) {
  int s = C >= kScanThreads ? 1 : kScanThreads / (C > 0 ? C : 1);
  int L = round4((depth + s - 1) / s);
  if (L < 4) L = 4;
  s = (depth + L - 1) / L;
  return Slices{s < 1 ? 1 : s, L};
}

// f32 floats of the partial-sum buffer of a product of `rm` rows over
// Cmax columns.
__host__ __device__ inline size_t part_floats(int Cmax, int rm = kMaxRows) {
  return (size_t)rm * (Cmax > kScanThreads ? Cmax : kScanThreads);
}

// Where a block's weight column c lies in a row-major global matrix:
// row j, column (c / ucnt) * gstride + base + c % ucnt.
struct ColMap {
  int ucnt, gstride, base, ldg;
  __device__ __forceinline__ size_t col(int c) const {
    return (size_t)(c / ucnt) * gstride + base + c % ucnt;
  }
};

// Load rows [0, rs) of the block's C weight columns into w_s [rs][C].
template <typename T>
__device__ __forceinline__ void load_weights(T* w_s,
                                             const T* __restrict__ w_g,
                                             const ColMap& cm, int rs,
                                             int C) {
  for (int i = threadIdx.x; i < rs * C; i += kScanThreads) {
    const int j = i / C;
    const int c = i % C;
    w_s[i] = w_g[(size_t)j * cm.ldg + cm.col(c)];
  }
}

// An f32 input value or four: a plain load, or with CG one that skips L1
// (the input in device memory, written by other blocks of the cluster).
template <bool CG>
__device__ __forceinline__ float ld_in(const float* p) {
  if constexpr (CG) return __ldcg(p);
  return *p;
}
template <bool CG>
__device__ __forceinline__ float4 ld_in4(const float* p) {
  if constexpr (CG) return __ldcg(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}

// part_s[(s * RM + b) * C + c] = sum over j in slice s of
// in_s[b * ld + j] * Wt(j, c) for all RM rows b (rows past the chain's
// are 0 in in_s: summing them costs less than branching on them); Wt from
// w_s [rs][C] for j < rs, else from w_g through the column map.  With CG
// the input is in device memory (GX).
template <typename T, int RM = kMaxRows, bool CG = false>
__device__ __forceinline__ void product(const float* in_s, int ld,
                                        const T* w_s, int rs,
                                        const T* __restrict__ w_g,
                                        const ColMap& cm, int C, int depth,
                                        float* part_s) {
  const Slices sl = slices(C, depth);
  for (int item = threadIdx.x; item < sl.S * C; item += kScanThreads) {
    const int s = item / C;
    const int c = item % C;
    const int j0 = s * sl.L;
    const int j1 = min(j0 + sl.L, depth);
    const int jr = max(j0, min(j1, rs));
    float acc[RM];
#pragma unroll
    for (int b = 0; b < RM; ++b) acc[b] = 0.0f;
    int j = j0;
    for (; j + 4 <= jr; j += 4) {
      const T* wp = w_s + j * C + c;
      const float w0 = to_f(wp[0]);
      const float w1 = to_f(wp[C]);
      const float w2 = to_f(wp[2 * C]);
      const float w3 = to_f(wp[3 * C]);
#pragma unroll
      for (int b = 0; b < RM; ++b) {
        const float4 h = ld_in4<CG>(&in_s[b * ld + j]);
        acc[b] = fmaf(h.x, w0, acc[b]);
        acc[b] = fmaf(h.y, w1, acc[b]);
        acc[b] = fmaf(h.z, w2, acc[b]);
        acc[b] = fmaf(h.w, w3, acc[b]);
      }
    }
    for (; j < jr; ++j) {
      const float w0 = to_f(w_s[j * C + c]);
#pragma unroll
      for (int b = 0; b < RM; ++b)
        acc[b] = fmaf(ld_in<CG>(&in_s[b * ld + j]), w0, acc[b]);
    }
    // rows past the resident ones, through L2: eight loads in flight
    // before their products, so their latency overlaps
    const T* __restrict__ wg = w_g + cm.col(c);
    for (; j + 8 <= j1; j += 8) {
      float w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) w[q] = to_f(wg[(size_t)(j + q) * cm.ldg]);
#pragma unroll
      for (int b = 0; b < RM; ++b)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          acc[b] = fmaf(ld_in<CG>(&in_s[b * ld + j + q]), w[q], acc[b]);
    }
    for (; j < j1; ++j) {
      const float w0 = to_f(wg[(size_t)j * cm.ldg]);
#pragma unroll
      for (int b = 0; b < RM; ++b)
        acc[b] = fmaf(ld_in<CG>(&in_s[b * ld + j]), w0, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < RM; ++b)
      part_s[((size_t)s * RM + b) * C + c] = acc[b];
  }
}

// The product's output (b, c): its slices' sums in slice order.
template <int RM = kMaxRows>
__device__ __forceinline__ float reduce_slices(const float* part_s, int b,
                                               int c, int C, int depth) {
  const Slices sl = slices(C, depth);
  float sum = 0.0f;
  for (int s = 0; s < sl.S; ++s) sum += part_s[((size_t)s * RM + b) * C + c];
  return sum;
}

// The cluster barrier in its two halves: arrive (release: this thread's
// stores to the cluster's shared memory are visible to every block once
// the barrier completes) and wait (acquire).  Work between them -- stores
// to device memory, loads for the next step -- overlaps the wait for the
// slowest block, and the arrive does not wait for it.  Every thread of
// every block calls both, in the same order.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The block's geometry in the chain: rank, rows and units.
struct Chain {
  int r, b0, nb, u0, ucnt;
};

__device__ __forceinline__ Chain chain(const cg::cluster_group& cluster,
                                       const ScanArgs& a) {
  Chain ch;
  ch.r = (int)cluster.block_rank();
  ch.b0 = (int)(blockIdx.x / a.NC) * a.rows;
  ch.nb = min(a.rows, a.B - ch.b0);
  ch.u0 = ch.r * a.U;
  ch.ucnt = max(0, min(a.U, a.W - ch.u0));
  return ch;
}

// How many weight rows of `row_bytes` each fit in the budget after the
// `fixed` bytes of the other buffers (a multiple of 4, or all `depth`).
inline int resident_rows(size_t fixed, size_t row_bytes, int depth) {
  if (fixed >= kScanSmem || row_bytes == 0) return 0;
  size_t n = (kScanSmem - fixed) / row_bytes;
  if (n >= (size_t)depth) return depth;
  return (int)(n & ~(size_t)3);
}

// Where a kernel's per-unit values cross the cluster (the caller's pick,
// ops/rnn_scan.py::scan_form): up to kMaxRows rows a chain with the values
// in shared memory (Full), one row in shared memory (One) or one row in
// device memory (Gx), the first whose buffers fit.
enum Form { kFull = 0, kOne = 1, kGx = 2 };

// Whether a launch of RM rows and P (row, unit) pairs a thread takes the
// chain's rows and units, and its fixed buffers the budget.
template <int RM, int P>
bool form_fits(const ScanArgs& a, size_t fixed) {
  return a.rows <= RM && a.rows * a.U <= P * kScanThreads &&
         fixed <= kScanSmem;
}

// Launch `kernel` on clusters of a.NC blocks, one cluster per group of
// a.rows batch rows, with `smem` bytes of dynamic shared memory.
template <typename... KArgs, typename... Args>
cudaError_t launch_chain(void (*kernel)(KArgs...), const ScanArgs& a,
                         size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.NC > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  const int groups = (a.B + a.rows - 1) / a.rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * a.NC);
  cfg.blockDim = dim3(kScanThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Shared checks and geometry of an entry point from the caller's cluster
// and rows a chain; false on a bad argument.
inline bool scan_geometry(int Tn, int B, int W, int cluster, int rows,
                          ScanArgs* a) {
  if (Tn <= 0 || B <= 0 || W <= 0 || cluster < 1 || cluster > kMaxCluster ||
      cluster > W || rows < 1 || rows > kMaxRows)
    return false;
  a->Tn = Tn;
  a->B = B;
  a->W = W;
  a->NC = cluster;
  a->U = (W + cluster - 1) / cluster;
  a->rows = rows;
  a->rs = a->rs2 = 0;
  return true;
}

}  // namespace
