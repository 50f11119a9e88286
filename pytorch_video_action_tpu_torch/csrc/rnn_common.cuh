// Device code shared by the bidirectional GRU and LSTM layer kernels, split
// (gru_bidir_fwd.cu, gru_bidir_bwd.cu, lstm_bidir_fwd.cu, lstm_bidir_bwd.cu)
// and merged-body (gru_merged_bwd.cu, lstm_merged_{fwd,bwd}.cu; the merged
// GRU forward is in gru_bidir_fwd.cu), for Hopper (sm_90a):
// the input projection; the backward's bias reduction, the operands and
// stores of its products (rnn_wgmma.cuh's tensor-core products read them)
// and the merged LSTM backward's deterministic tiled SIMT GEMMs; and the
// GRU stack's layer boundary, built on load as an operand of the
// projection and of the products (the fused-boundary form).  Each .cu
// includes it and builds into its own library.

#pragma once

#include "dtype.cuh"
#include "hash.cuh"

#include <stddef.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ---------------------------------------------------------- layer input

// x[m, k] of a row-major [M, ld] layer input, as a float
template <typename T>
struct DenseRows {
  const T* p;
  int ld;
  __device__ float operator()(int m, int k) const {
    return to_f(p[(size_t)m * ld + k]);
  }
};

// The GRU stack's layer boundary (ops/rnn.py's glue between layers), built
// in registers from the previous layer's direction halves xa, xb [T, B, H]
// wherever a product reads the layer input; no [T, B, 2H] tensor exists.
// Row r = t*B + b, column c < 2H:
//   x = concat(xa, xb)[t, b, c] * (t < lengths[b])
//   with dropout: x = kept(t, b, c) ? rnd(x * scale) : 0
// kept: fmix32(idx ^ key) < thresh with idx = ((b*T + t)*2H + c) mod 2^32,
// the stream of ops/hashmask.py::keep_mask at strides (2H, T*2H, 1); scale
// is 1/keep rounded to T, as the glue's hash_dropout rounds it.  The same
// rounding steps as the glue's, so the products read the same values.
template <typename T>
struct Boundary {
  const T* xa;
  const T* xb;
  const int* lengths;
  int B, H, Tn;
  uint32_t key, thresh;
  float scale;
  int drop;
  __device__ bool valid(int t, int b) const { return t < lengths[b]; }
  __device__ bool kept(int t, int b, int c) const {
    const uint32_t idx =
        ((uint32_t)b * (uint32_t)Tn + (uint32_t)t) * (uint32_t)(2 * H) +
        (uint32_t)c;
    return fmix32(idx ^ key) < thresh;
  }
  __device__ float operator()(int r, int c) const {
    const int t = r / B;
    const int b = r - t * B;
    const size_t o = (size_t)r * H;
    float v = to_f(c < H ? xa[o + c] : xb[o + c - H]);
    v *= valid(t, b) ? 1.0f : 0.0f;
    if (drop) v = kept(t, b, c) ? rnd<T>(v * scale) : 0.0f;
    return v;
  }
};

// ------------------------------------------------------------- projection

constexpr int kPM = 128;  // rows (t*B + b) per block
constexpr int kPN = 128;  // gate columns per block
constexpr int kPK = 8;    // depth per shared-memory stage
constexpr int kPThreads = 256;

// xg[dir, m, n] = sum_k x(m, k) * wi_dir[k, n] + bi_dir[n]   (f32), x read
// through the operand XA (DenseRows, or Boundary for the fused-boundary
// form); with null bias pointers (the merged layers add theirs on the
// chain) no bias
template <typename T, typename XA>
__global__ void __launch_bounds__(kPThreads)
proj_kernel(const XA x, const T* __restrict__ wi_f,
            const T* __restrict__ wi_b, const T* __restrict__ bi_f,
            const T* __restrict__ bi_b, float* __restrict__ xg, int M, int K,
            int N) {
  const int dir = blockIdx.z;
  const T* __restrict__ w = dir ? wi_b : wi_f;
  const T* __restrict__ bias = dir ? bi_b : bi_f;
  // +4: the transposed A store is conflict-free and rows stay 16-byte aligned
  __shared__ __align__(16) float As[kPK][kPM + 4];
  __shared__ __align__(16) float Bs[kPK][kPN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kPM;
  const int n0 = blockIdx.y * kPN;
  const int tr = tid / 16;
  const int tc = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kPK) {
#pragma unroll
    for (int i = 0; i < (kPM * kPK) / kPThreads; ++i) {
      const int e = tid + i * kPThreads;
      const int m = e / kPK;
      const int kk = e % kPK;
      const int gm = m0 + m;
      const int gk = k0 + kk;
      As[kk][m] = (gm < M && gk < K) ? x(gm, gk) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (kPN * kPK) / kPThreads; ++i) {
      const int e = tid + i * kPThreads;
      const int kk = e / kPN;
      const int n = e % kPN;
      const int gk = k0 + kk;
      const int gn = n0 + n;
      Bs[kk][n] = (gk < K && gn < N) ? to_f(w[(size_t)gk * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tc * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? tr * 4 + i : 64 + tr * 4 + (i - 4));
    if (gm >= M) continue;
    float* __restrict__ row = xg + ((size_t)dir * M + gm) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tc * 4 + j : 64 + tc * 4 + (j - 4));
      if (gn < N) row[gn] = bias ? acc[i][j] + to_f(bias[gn]) : acc[i][j];
    }
  }
}

// xg [2, M, N] f32 for both directions of the layer input x [M, K], read
// through the operand x: one launch.
template <typename T, typename XA>
cudaError_t launch_proj_of(const XA& x, const void* wif, const void* wib,
                           const void* bif, const void* bib, float* xg, int M,
                           int K, int N, cudaStream_t stream) {
  const dim3 grid((M + kPM - 1) / kPM, (N + kPN - 1) / kPN, 2);
  proj_kernel<T, XA><<<grid, kPThreads, 0, stream>>>(
      x, static_cast<const T*>(wif), static_cast<const T*>(wib),
      static_cast<const T*>(bif), static_cast<const T*>(bib), xg, M, K, N);
  return cudaGetLastError();
}

// launch_proj_of for a dense x [M, K].
template <typename T>
cudaError_t launch_proj(const void* x, const void* wif, const void* wib,
                        const void* bif, const void* bib, float* xg, int M,
                        int K, int N, cudaStream_t stream) {
  return launch_proj_of<T>(DenseRows<T>{static_cast<const T*>(x), K}, wif,
                           wib, bif, bib, xg, M, K, N, stream);
}

// ---------------------------------------------------------- bias sums

constexpr int kMaxBiasOuts = 4;

template <typename T>
struct BiasOuts {
  T* p[kMaxBiasOuts];
};

// out.p[q][c] = sum over b, in order, of part[q][b][c], q < n_out: the
// chain's per-row bias sums added in a fixed order (no atomics)
template <typename T>
__global__ void bias_reduce_kernel(const float* __restrict__ part,
                                   const BiasOuts<T> out, int n_out, int B,
                                   int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out * G) return;
  const int q = i / G;
  const int c = i % G;
  const float* p = part + (size_t)q * B * G + c;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b) sum += p[(size_t)b * G];
  out.p[q][c] = from_f<T>(sum);
}

template <typename T>
cudaError_t launch_bias_reduce(const float* part, const BiasOuts<T>& out,
                               int n_out, int B, int G, cudaStream_t stream) {
  bias_reduce_kernel<T><<<(n_out * G + 255) / 256, 256, 0, stream>>>(
      part, out, n_out, B, G);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ GEMMs

constexpr int kBK = 8;  // depth per shared-memory stage
constexpr int kThreads = 256;

// C[m, n] = sum_k A(m, k) * B(k, n) for one BM x BN tile, f32 accumulation,
// each of the 256 threads a (BM/16) x (BN/16) sub-tile.  A and B are
// functors that return the operand, already rounded, as a float; their
// kContigK says whether neighbouring k are neighbours in memory, and the
// tile loads give neighbouring threads neighbouring addresses accordingly.
template <int BM, int BN, typename LA, typename LB, typename ST>
__device__ __forceinline__ void gemm_tile(const LA& a, const LB& bop,
                                          const ST& st, int M, int N, int K,
                                          int m0, int n0) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  // +4: transposed stores are conflict-free and rows stay 16-byte aligned
  __shared__ __align__(16) float As[kBK][BM + 4];
  __shared__ __align__(16) float Bs[kBK][BN + 4];
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (BM * kBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int m = LA::kContigK ? e / kBK : e % BM;
      const int kk = LA::kContigK ? e % kBK : e / BM;
      const int gm = m0 + m;
      const int gk = k0 + kk;
      As[kk][m] = (gm < M && gk < K) ? a(gm, gk) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (BN * kBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int n = LB::kContigK ? e / kBK : e % BN;
      const int kk = LB::kContigK ? e % kBK : e / BN;
      const int gk = k0 + kk;
      const int gn = n0 + n;
      Bs[kk][n] = (gk < K && gn < N) ? bop(gk, gn) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[kk][q * 64 + tr * 4]);
        av[q * 4] = v.x;
        av[q * 4 + 1] = v.y;
        av[q * 4 + 2] = v.z;
        av[q * 4 + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[kk][q * 64 + tc * 4]);
        bv[q * 4] = v.x;
        bv[q * 4 + 1] = v.y;
        bv[q * 4 + 2] = v.z;
        bv[q * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + (i / 4) * 64 + tr * 4 + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + (j / 4) * 64 + tc * 4 + j % 4;
      if (gn < N) st(gm, gn, acc[i][j]);
    }
  }
}

// A(m, k) = p[(k + shift) * ld + m], 0 where row k + shift is outside
// [0, rows): a row-major [rows, ld] matrix read transposed, with rows
// shifted (hp is ys shifted by one time step, B rows).
template <typename T>
struct ShiftedRowsT {
  static constexpr bool kContigK = false;
  const T* p;
  int ld, shift, rows;
  __device__ float operator()(int m, int k) const {
    const int r = k + shift;
    return (r >= 0 && r < rows) ? to_f(p[(size_t)r * ld + m]) : 0.0f;
  }
};

// B(k, n) = p[k * ld + n] rounded to T: f32 gate gradients as an operand
template <typename T>
struct RoundedRows {
  static constexpr bool kContigK = false;
  const float* p;
  int ld;
  __device__ float operator()(int k, int n) const {
    return rnd<T>(p[(size_t)k * ld + n]);
  }
};

// dx's A(m, k) = dxg[d][m][k - d*G] rounded to T, d = (k >= G)
template <typename T>
struct DxgRows {
  static constexpr bool kContigK = true;
  const float* p;
  size_t dir_stride;
  int G;
  __device__ float operator()(int m, int k) const {
    const int d = k >= G;
    return rnd<T>(p[d * dir_stride + (size_t)m * G + (k - d * G)]);
  }
};

// dx's B(k, n) = wi_d[n][k - d*G], d = (k >= G): both wi transposed
template <typename T>
struct WiT {
  static constexpr bool kContigK = true;
  const T* wf;
  const T* wb;
  int G;
  __device__ float operator()(int k, int n) const {
    const int d = k >= G;
    return to_f((d ? wb : wf)[(size_t)n * G + (k - d * G)]);
  }
};

template <typename T>
struct Store {
  T* p;
  int ld;
  __device__ void operator()(int m, int n, float v) const {
    p[(size_t)m * ld + n] = from_f<T>(v);
  }
};

// dx of the fused-boundary backward, through the boundary's VJP: the sum
// over both directions rounded to T (the glue's dx), then as the glue's
// autograd carries it back, kept(t, b, c) ? rnd(v * scale) : 0 with
// dropout, times the length mask; columns c < H go to dxa, the rest to dxb
// ([T, B, H] each).
template <typename T>
struct BoundaryStore {
  T* dxa;
  T* dxb;
  Boundary<T> bnd;
  __device__ void operator()(int m, int n, float v) const {
    const int t = m / bnd.B;
    const int b = m - t * bnd.B;
    v = rnd<T>(v);
    if (bnd.drop) v = bnd.kept(t, b, n) ? rnd<T>(v * bnd.scale) : 0.0f;
    v *= bnd.valid(t, b) ? 1.0f : 0.0f;
    const size_t o = (size_t)m * bnd.H;
    if (n < bnd.H)
      dxa[o + n] = from_f<T>(v);
    else
      dxb[o + n - bnd.H] = from_f<T>(v);
  }
};

template <typename T>
struct WgradProblem {
  ShiftedRowsT<T> a;
  RoundedRows<T> b;
  Store<T> c;
  int M;
};

// four weight gradients in one launch: blockIdx.z picks the problem, [rows,
// G] = A^T B over K = T*B rows.
template <typename T>
struct WgradProblems {
  WgradProblem<T> p[4];
};

constexpr int kWT = 64;   // weight-gradient tile
constexpr int kDxT = 128; // dx tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const WgradProblems<T> probs, int N, int K) {
  const WgradProblem<T>& p = probs.p[blockIdx.z];
  const int m0 = blockIdx.x * kWT;
  if (m0 >= p.M) return;  // the smaller (dwh) problems use fewer row tiles
  gemm_tile<kWT, kWT>(p.a, p.b, p.c, p.M, N, K, m0, blockIdx.y * kWT);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const DxgRows<T> a, const WiT<T> b, const Store<T> c, int M, int N,
          int K) {
  gemm_tile<kDxT, kDxT>(a, b, c, M, N, K, blockIdx.x * kDxT,
                        blockIdx.y * kDxT);
}

// The merged-body LSTM backward's products (lstm_merged_bwd.cu, row 8), for
// G = gH a direction and G2 = 2G, on the CUDA cores:
//   dwi_d = x^T rnd(dxg_d)                      [W, G]
//   dwh2  = hp2^T rnd(dhg2)                     [2H, G2], off-diagonal
//                                               blocks included
//   dx_d  = rnd(dxg_d) wi_d^T, apart            [T*B, W] each
// dxg is the chain's [2, T*B, G] f32, each direction dense and in original
// time order (the split layers' layout); dhg2 its [T*B, G2] f32 in kernel
// order, gate-grouped, the rows of hp2 [T*B, 2H] (in T).  dwif, dwib and
// dwh2's two column halves are the four problems of one wgrad_kernel
// launch, so their long-K tiles run as one wave.
template <typename T>
cudaError_t launch_merged_products(const void* x, const void* wif,
                                   const void* wib, const void* hp2,
                                   const float* dxg, const float* dhg2,
                                   void* dxf, void* dxb, void* dwif,
                                   void* dwib, void* dwh2, int Tn, int B,
                                   int W, int H, int G, cudaStream_t stream) {
  const int M = Tn * B;
  const int G2 = 2 * G;
  const size_t dstride = (size_t)M * G;
  const T* xt = static_cast<const T*>(x);
  const T* hp = static_cast<const T*>(hp2);
  T* dwh = static_cast<T*>(dwh2);
  WgradProblems<T> probs;
  probs.p[0] = {{xt, W, 0, M}, {dxg, G}, {static_cast<T*>(dwif), G}, W};
  probs.p[1] = {{xt, W, 0, M}, {dxg + dstride, G},
                {static_cast<T*>(dwib), G}, W};
  probs.p[2] = {{hp, 2 * H, 0, M}, {dhg2, G2}, {dwh, G2}, 2 * H};
  probs.p[3] = {{hp, 2 * H, 0, M}, {dhg2 + G, G2}, {dwh + G, G2}, 2 * H};
  const int rows = W > 2 * H ? W : 2 * H;
  wgrad_kernel<T><<<dim3((rows + kWT - 1) / kWT, (G + kWT - 1) / kWT, 4),
                    kThreads, 0, stream>>>(probs, G, M);
  cudaError_t err = cudaGetLastError();

  // dx_d over K = G: DxgRows and WiT then read direction d alone
  const dim3 xgrid((M + kDxT - 1) / kDxT, (W + kDxT - 1) / kDxT);
  for (int d = 0; d < 2 && err == cudaSuccess; ++d) {
    const T* wi = static_cast<const T*>(d ? wib : wif);
    const DxgRows<T> xa = {dxg + d * dstride, dstride, G};
    const WiT<T> xb = {wi, wi, G};
    const Store<T> xc = {static_cast<T*>(d ? dxb : dxf), W};
    dx_kernel<T><<<xgrid, kThreads, 0, stream>>>(xa, xb, xc, M, W, G);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
