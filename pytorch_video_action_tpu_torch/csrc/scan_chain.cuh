// The register-resident chain shared by the scan kernels that carry a
// recurrence through T dependent steps on a thread block cluster (sm_90a):
// the LSTM scan's forwards (lstm_scan_fwd.cu), the GRU scan's forwards
// (gru_scan_fwd.cu) and both scans' saved-gates backwards (lstm_scan_bwd.cu,
// row 15; gru_scan_bwd.cu, row 11).  Each kernel writes its own step; this header holds
// what they share, from lstm_scan_fwd.cu's design (its source note has the
// measurements behind it):
//  * the geometry: NC blocks a chain, U = ceil(W / NC) units a block, a
//    unit's four lane groups (gates, or the backward's column chunks of
//    wh's row; the GRU's three and an idle fourth) of S depth slices each,
//    neighbouring lanes of one warp;
//    past 64 units a block each thread takes R units in turn (rounds);
//  * the weights: a thread's slice of L values of one weight vector (a
//    column of wh forward, a row chunk backward) in registers as f32, then
//    shared memory in the weights' dtype, then L2 (with rounds all L2);
//  * the product of RM rows of the step's input (h forward, the rounded
//    gate gradients backward) with that slice, broadcast float4 reads;
//  * the exchange: st.async of one f32 to a peer block's shared memory,
//    completing its bytes on that block's mbarrier, and the wait on one's
//    own mbarrier (expect, wait, parity), instead of a cluster barrier;
//  * the L2 prefetch of the next steps' rows, the occupancy query that
//    gives the clusters the card runs at once, and the cluster launch.
// Everything here is in namespace rc, so a source may include it beside
// scan_common.cuh or rnn_wgmma.cuh.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {
namespace rc {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;       // threads a block, at most
constexpr int kRegWords = 128;      // weights a thread keeps in registers, f32
constexpr int kMaxNC = 16;          // blocks a chain (16: non-portable)
constexpr int kAhead = 4;           // steps of input prefetched into L2
constexpr size_t kSmem = 225 * 1024;  // dynamic shared memory budget

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

struct ChainArgs {
  int Tn, B, W, G;
  int NC;    // blocks a chain
  int S;     // depth slices a lane group
  int U;     // units a block
  int R;     // rounds: units a thread takes in turn each step
  int UT;    // units a round, ceil(U / R)
  int L;     // depth a slice, a multiple of 8
  int LP;    // its stride in the input's rows, max(L, kRegWords) + 4: the
             // product reads kRegWords of the input a slice (zeros past L),
             // and the 4 put the slices on distinct banks
  int ldh;   // the input's row stride, NI * S * LP (NI input vectors of W a
             // row: 1 forward, 4 backward)
  int rows;  // batch rows a chain
  int ls;    // depth a slice reads from shared memory after kRegWords
  int nthr;  // threads a block
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory location in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_u32(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// One arrival that also expects `bytes` of remote stores this phase.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` completes; traps after 2^26
// polls (seconds), so a broken exchange fails the launch, not the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) asm volatile("trap;");
  }
}

// v into the cluster's shared memory at `addr`, completing 4 bytes on the
// mbarrier at `bar` (both in the same block).
__device__ __forceinline__ void send_h(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Weight words of the vector at wg (its depth d at wg[d * stride]): f32
// bits (registers hold bf16 weights as f32 too: the product then needs no
// unpacking), or in shared memory two bf16 (the even depth in the low
// half).
template <typename T>
__device__ __forceinline__ uint32_t load_word(const T* __restrict__ wg,
                                              int d, int W, int stride,
                                              bool on);
template <>
__device__ __forceinline__ uint32_t load_word<float>(
    const float* __restrict__ wg, int d, int W, int stride, bool on) {
  return on && d < W ? __float_as_uint(wg[(size_t)d * stride]) : 0u;
}
template <>
__device__ __forceinline__ uint32_t load_word<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ wg, int d, int W, int stride,
    bool on) {
  const uint32_t lo =
      on && d < W ? __bfloat16_as_ushort(wg[(size_t)d * stride]) : 0u;
  const uint32_t hi =
      on && d + 1 < W ? __bfloat16_as_ushort(wg[(size_t)(d + 1) * stride])
                      : 0u;
  return lo | (hi << 16);
}

template <typename T>
__device__ __forceinline__ uint32_t f32_word(const T* __restrict__ wg, int d,
                                             int W, int stride, bool on) {
  return on && d < W ? __float_as_uint(to_f(wg[(size_t)d * stride])) : 0u;
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// An f32 input value: a plain load, or with CG one that skips L1 (the
// input in device memory, written there by other blocks of the cluster).
template <bool CG>
__device__ __forceinline__ float ld_h(const float* p) {
  if constexpr (CG) return __ldcg(p);
  return *p;
}

// Four f32 input values: as ld_h.
template <bool CG>
__device__ __forceinline__ float4 ld_h4(const float* p) {
  if constexpr (CG) return __ldcg(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}

// acc += dot(h[0..3], w[0..3]), in that order.
__device__ __forceinline__ float dot4(float acc, float4 h, float w0,
                                      float w1, float w2, float w3) {
  acc = fmaf(h.x, w0, acc);
  acc = fmaf(h.y, w1, acc);
  acc = fmaf(h.z, w2, acc);
  return fmaf(h.w, w3, acc);
}

// The thread's resident weights, depth [d0, d0 + L) of the vector at wg
// (0 past W, or everywhere when !on): registers for [0, kRegWords), then
// its chunks of shared memory (w_s[q * nthr + tid], 16 bytes each).
template <typename T>
__device__ __forceinline__ void load_resident(uint32_t (&wr)[kRegWords],
                                              uint4* w_s,
                                              const T* __restrict__ wg,
                                              int stride, const ChainArgs& a,
                                              int d0, bool on, int tid) {
#pragma unroll
  for (int w = 0; w < kRegWords; ++w)
    wr[w] = w < a.L ? f32_word(wg, d0 + w, a.W, stride, on) : 0u;
  constexpr int VPW = 4 / (int)sizeof(T);
  constexpr int V = 16 / (int)sizeof(T);
  for (int q = 0; q < a.ls / V; ++q) {
    const int d = d0 + kRegWords + q * V;
    uint4 c;
    c.x = load_word<T>(wg, d, a.W, stride, on);
    c.y = load_word<T>(wg, d + VPW, a.W, stride, on);
    c.z = load_word<T>(wg, d + 2 * VPW, a.W, stride, on);
    c.w = load_word<T>(wg, d + 3 * VPW, a.W, stride, on);
    w_s[(size_t)q * a.nthr + tid] = c;
  }
}

// The thread's part of the step's product for RM rows: its slice of its
// weight vector (depth d at wg[d * stride]) against the input (rows of
// stride ldh from hs): registers for depth [0, kRegWords) (weights past the
// slice's L are 0, so the loop needs no bound and its loads of the input
// go out ahead of the FMAs), shared memory for [kRegWords, kRegWords + ls),
// L2 for the rest; with WIDE (rounds) all of it through L2.  NA sums a
// row, added in a fixed order.  With CG (only with WIDE) the input is in
// device memory and read past L1.  VEC > 0 (a weight vector contiguous in
// depth, stride 1, as the GRU scan's saved-gates backward's rows of wh
// are) reads the L2 tier 16 bytes a load, VEC loads in flight, where the
// thread's weights are 16-byte aligned: a warp's lanes read 32 different
// rows, so each load costs the SM's L1 a pass for every lane, and four
// or eight weights a load take that many times fewer.
template <typename T, int RM, bool WIDE, bool CG = false, int VEC = 0>
__device__ __forceinline__ void product(const uint32_t (&wr)[kRegWords],
                                        const uint4* __restrict__ ws,
                                        const T* __restrict__ wg, int stride,
                                        const float* hs, const ChainArgs& a,
                                        int d0, float (&out)[RM]) {
  constexpr int NA = RM >= 4 ? 1 : 4 / RM;
  float acc[RM][NA];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int k = 0; k < NA; ++k) acc[r][k] = 0.0f;
  if constexpr (!WIDE) {
    // registers
#pragma unroll
    for (int j = 0; j < kRegWords; j += 4) {
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 h = *reinterpret_cast<const float4*>(hs + r * a.ldh + j);
        acc[r][(j / 4) % NA] =
            dot4(acc[r][(j / 4) % NA], h, __uint_as_float(wr[j]),
                 __uint_as_float(wr[j + 1]), __uint_as_float(wr[j + 2]),
                 __uint_as_float(wr[j + 3]));
      }
    }
    // shared memory: 16-byte chunks, the thread's own at stride nthr
    constexpr int V = 16 / (int)sizeof(T);
    const int nq = a.ls / V;
#pragma unroll 2
    for (int q = 0; q < nq; ++q) {
      const uint4 c = ws[(size_t)q * a.nthr];
      const int j = kRegWords + q * V;
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float4 h =
              *reinterpret_cast<const float4*>(hs + r * a.ldh + j);
          acc[r][0] = dot4(acc[r][0], h, __uint_as_float(c.x),
                           __uint_as_float(c.y), __uint_as_float(c.z),
                           __uint_as_float(c.w));
        }
      } else {
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float4 h0 =
              *reinterpret_cast<const float4*>(hs + r * a.ldh + j);
          const float4 h1 =
              *reinterpret_cast<const float4*>(hs + r * a.ldh + j + 4);
          acc[r][0] = dot4(acc[r][0], h0, bf_lo(c.x), bf_hi(c.x), bf_lo(c.y),
                           bf_hi(c.y));
          acc[r][0] = dot4(acc[r][0], h1, bf_lo(c.z), bf_hi(c.z), bf_lo(c.w),
                           bf_hi(c.w));
        }
      }
    }
  }
  // L2: the depth past registers and shared memory, 8 loads in flight
  // (with WIDE all of it, 32 in flight and NA sums a row)
  int j = WIDE ? 0 : kRegWords + a.ls;
  const int j1 = min(a.L, a.W - d0);
  if constexpr (VEC > 0) {
    constexpr int E = 16 / (int)sizeof(T);  // weights a load
    const T* __restrict__ wv = wg + d0;
    if ((reinterpret_cast<uintptr_t>(wv + j) & 15) == 0) {
      for (; j + VEC * E <= j1; j += VEC * E) {
        uint4 v[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          v[q] = *reinterpret_cast<const uint4*>(wv + j + q * E);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const uint32_t u[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
          float w[E];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (sizeof(T) == 4) {
              w[e] = __uint_as_float(u[e]);
            } else {
              w[2 * e] = bf_lo(u[e]);
              w[2 * e + 1] = bf_hi(u[e]);
            }
          }
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int i = 0; i < E; i += 4) {
              const int n = (q * E + i) / 4 % NA;
              acc[r][n] = dot4(acc[r][n],
                               ld_h4<CG>(hs + r * a.ldh + j + q * E + i),
                               w[i], w[i + 1], w[i + 2], w[i + 3]);
            }
        }
      }
    }
  }
  if constexpr (WIDE) {
    for (; j + 32 <= j1; j += 32) {
      float w[32];
#pragma unroll
      for (int k = 0; k < 32; ++k)
        w[k] = to_f(wg[(size_t)(d0 + j + k) * stride]);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int k = 0; k < 32; ++k)
          acc[r][k % NA] =
              fmaf(ld_h<CG>(hs + r * a.ldh + j + k), w[k], acc[r][k % NA]);
    }
  }
  for (; j + 8 <= j1; j += 8) {
    float w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      w[k] = to_f(wg[(size_t)(d0 + j + k) * stride]);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[r][0] = fmaf(ld_h<CG>(hs + r * a.ldh + j + k), w[k], acc[r][0]);
  }
  for (; j < j1; ++j) {
    const float w0 = to_f(wg[(size_t)(d0 + j) * stride]);
#pragma unroll
    for (int r = 0; r < RM; ++r)
      acc[r][0] = fmaf(ld_h<CG>(hs + r * a.ldh + j), w0, acc[r][0]);
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    float sum = acc[r][0];
#pragma unroll
    for (int k = 1; k < NA; ++k) sum += acc[r][k];
    out[r] = sum;
  }
}

// Shared-memory bytes of a launch: the input's two buffers (unless gx:
// they are in device memory), the mbarriers and the weights read from
// shared memory or, with rounds, each thread's `carries` carries (R values
// a row each).
template <typename T>
size_t chain_smem(const ChainArgs& a, int rm, bool gx = false,
                  int carries = 1) {
  return (gx ? 0 : sizeof(float) * 2 * rm * a.ldh) + 16 +
         (a.R > 1 ? sizeof(float) * carries * a.R * rm * a.nthr
                  : (size_t)a.nthr * a.ls * sizeof(T));
}

// Launch `kernel` (a chain kernel of a.nthr threads) on clusters of a.NC
// blocks, one cluster a chain of a.rows batch rows, with `smem` bytes of
// dynamic shared memory; refuses more than kSmem.
template <typename... KArgs, typename... Args>
cudaError_t launch_chain(void (*kernel)(KArgs...), const ChainArgs& a,
                         size_t smem, cudaStream_t stream, Args... args) {
  if (smem > kSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.NC > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  const int chains = (a.B + a.rows - 1) / a.rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chains * a.NC);
  cfg.blockDim = dim3(a.nthr);
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

// Clusters of nc blocks of kThreads threads of `kernel`, one an SM, that
// the card holds at once, or -1 when it refuses the query.
template <typename... KArgs>
int max_clusters(void (*kernel)(KArgs...), int nc) {
  if (nc > 8 &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess
             ? n
             : -1;
}

// The launch's arguments from the caller's geometry (ops/rnn_scan.py::
// chain_geometry) for G = gates * W weight columns and an input of `ni`
// vectors of W a row; false when it is not one the kernels take.
inline bool chain_args(int Tn, int B, int W, int gates, int ni, int nc, int s,
                       int rows, int ls, int rounds, int chunk,
                       ChainArgs* a) {
  if (Tn <= 0 || B <= 0 || W <= 0 || nc < 1 || nc > kMaxNC ||
      (s != 1 && s != 2 && s != 4 && s != 8) || ls < 0 || ls % chunk ||
      rounds < 1 || (rounds > 1 && ls != 0))
    return false;
  a->Tn = Tn;
  a->B = B;
  a->W = W;
  a->G = gates * W;
  a->NC = nc;
  a->S = s;
  a->U = (W + nc - 1) / nc;
  a->R = rounds;
  a->UT = (a->U + rounds - 1) / rounds;
  a->L = ((W + s - 1) / s + 7) & ~7;
  a->LP = (a->L > kRegWords ? a->L : kRegWords) + 4;
  a->ldh = ni * s * a->LP;
  a->rows = rows;
  a->ls = ls;
  a->nthr = (4 * a->UT * s + 31) & ~31;
  // every block owns a unit, every round too; a unit's 4S threads share a
  // warp
  return (nc - 1) * a->U < W && (rounds - 1) * a->UT < a->U &&
         a->nthr <= kThreads && (ls == 0 || kRegWords + ls <= a->L);
}

}  // namespace rc
}  // namespace
