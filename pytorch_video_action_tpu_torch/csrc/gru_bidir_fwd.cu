// One bidirectional GRU layer forward (inference form) for Hopper (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _fwd_kernel_split (train=False), reached through gru_bidir_fused_split.
//
// Computes, for x [T, B, W] time-major and per direction d in {fwd, bwd}
// wi_d [W, 3H], wh_d [H, 3H], bi_d [3H], bh_d [3H], lengths [B]:
//   gx = x_t @ wi_d + bi_d;  hg = h @ wh_d + bh_d
//   r = sigmoid(gx_r + hg_r); z = sigmoid(gx_z + hg_z)
//   n = tanh(gx_n + r * hg_n); h' = (1 - z) * n + z * h
// ys_f, ys_b [T, B, H] in original time order, unmasked.  The forward chain
// runs through padding; the backward chain walks t = T-1 .. 0 and keeps its
// carry (0 at the start) while t >= lengths[b], so ys_b is 0 on padding.
// Matmul inputs are the input dtype (f32 or bf16) with f32 accumulation; the
// carry and gate math are f32; h is rounded to the weight dtype before the
// hidden product; ys is stored in the input dtype.
//
// What bounds it on an H100: at the bench shape (B=64, T=1024, H=128) the
// work is 53 GFLOP for layer 0, which at f32 without TF32 (67 TFLOP/s) is
// about 0.8 ms, and about 0.17 GB of traffic.  A design that is right but
// simple is bound by neither: it is bound by the chain of T dependent
// hidden-state steps, each a [B, H] x [H, 3H] product plus the gates.
//
// What the design does about it:
//  * The input projection is off the chain: one tiled SIMT GEMM
//    (128x128 tile, 8x8 per thread, f32 accumulation) computes
//    xg [2, T*B, 3H] f32 for both directions before the recurrence.
//  * The recurrence runs one block per (direction, batch row) and loops
//    over T, so the 2B chains run side by side on the SMs.  Each of the 3H
//    threads owns one gate column of the hidden product and keeps that
//    column of wh in registers for the whole layer (128 floats a thread
//    at H=128).  A step then reads from shared memory only the carry, as
//    a broadcast.  With wh in shared memory instead, the 128 loads a
//    thread makes each step, not the arithmetic, set the step time.
//  * A step's input gates are loaded into registers before the hidden
//    product, so their global-memory latency hides behind it.
//  * The backward direction reads xg at T-1-s; no flipped copy of x exists.
//  * At H=128 one block fills an SM's registers, so for B > 66 the blocks
//    run in more than one wave.
// wgmma, TMA and spreading H across SMs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ------------------------------------------------------------- projection

constexpr int kPM = 128;  // rows (t*B + b) per block
constexpr int kPN = 128;  // gate columns per block
constexpr int kPK = 8;    // depth per shared-memory stage
constexpr int kPThreads = 256;

// xg[dir, m, n] = sum_k x[m, k] * wi_dir[k, n] + bi_dir[n]   (f32)
template <typename T>
__global__ void __launch_bounds__(kPThreads)
proj_kernel(const T* __restrict__ x, const T* __restrict__ wi_f,
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
      As[kk][m] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.0f;
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
      if (gn < N) row[gn] = acc[i][j] + to_f(bias[gn]);
    }
  }
}

// ------------------------------------------------------------- recurrence

// One block per (batch row, direction); blockDim.x == 3H.  Thread c owns
// gate column c of the hidden product and keeps that column of wh in
// registers for the whole layer, so a step reads only the carry (one
// broadcast) from shared memory.
template <typename T, int H>
__global__ void __launch_bounds__(3 * H, 1)
recur_kernel(const float* __restrict__ xg, const T* __restrict__ wh_f,
             const T* __restrict__ wh_b, const T* __restrict__ bh_f,
             const T* __restrict__ bh_b, const int* __restrict__ lengths,
             T* __restrict__ ys_f, T* __restrict__ ys_b, int Tn, int B) {
  constexpr int G = 3 * H;
  __shared__ __align__(16) float h_s[H];   // f32 carry
  __shared__ __align__(16) float hq_s[H];  // carry rounded to T
  __shared__ float hg_s[G];                // hidden gates
  const int dir = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const T* __restrict__ wh = dir ? wh_b : wh_f;
  T* __restrict__ ys = dir ? ys_b : ys_f;

  float w[H];
#pragma unroll
  for (int k = 0; k < H; ++k) w[k] = to_f(wh[k * G + tid]);
  const float bh_c = to_f((dir ? bh_b : bh_f)[tid]);
  if (tid < H) {
    h_s[tid] = 0.0f;
    hq_s[tid] = 0.0f;
  }
  const int len = lengths[b];
  __syncthreads();

  const float* __restrict__ xg_dir = xg + (size_t)dir * Tn * B * G;
  for (int s = 0; s < Tn; ++s) {
    const int t = dir ? Tn - 1 - s : s;

    // this step's input gates, loaded before the hidden product so their
    // latency hides behind it
    float gr = 0.0f, gz = 0.0f, gn = 0.0f;
    if (tid < H) {
      const float* g = xg_dir + ((size_t)t * B + b) * G;
      gr = g[tid];
      gz = g[H + tid];
      gn = g[2 * H + tid];
    }

    // hidden product, column tid: two independent FMA chains
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int k = 0; k < H; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(&hq_s[k]);
      a0 = fmaf(hv.x, w[k], a0);
      a1 = fmaf(hv.y, w[k + 1], a1);
      a0 = fmaf(hv.z, w[k + 2], a0);
      a1 = fmaf(hv.w, w[k + 3], a1);
    }
    hg_s[tid] = a0 + a1 + bh_c;
    __syncthreads();

    // gates and carry update
    if (tid < H) {
      const float r = sigmoid_f(gr + hg_s[tid]);
      const float z = sigmoid_f(gz + hg_s[H + tid]);
      const float n = tanhf(gn + r * hg_s[2 * H + tid]);
      const float hp = h_s[tid];
      float hn = (1.0f - z) * n + z * hp;
      if (dir && t >= len) hn = hp;  // backward chain: frozen on padding
      const T hq = from_f<T>(hn);
      h_s[tid] = hn;
      hq_s[tid] = to_f(hq);
      ys[((size_t)t * B + b) * H + tid] = hq;
    }
    __syncthreads();
  }
}

template <typename T, int H>
cudaError_t launch_recur(const float* xg, const void* whf, const void* whb,
                         const void* bhf, const void* bhb, const int* lengths,
                         void* ysf, void* ysb, int Tn, int B,
                         cudaStream_t stream) {
  recur_kernel<T, H><<<dim3(B, 2), 3 * H, 0, stream>>>(
      xg, static_cast<const T*>(whf), static_cast<const T*>(whb),
      static_cast<const T*>(bhf), static_cast<const T*>(bhb), lengths,
      static_cast<T*>(ysf), static_cast<T*>(ysb), Tn, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_layer(const void* x, const void* wif, const void* wib,
                      const void* bif, const void* bib, const void* whf,
                      const void* whb, const void* bhf, const void* bhb,
                      const int* lengths, void* ysf, void* ysb, float* xg,
                      int Tn, int B, int W, int H, cudaStream_t stream) {
  const int M = Tn * B;
  const int N = 3 * H;
  const dim3 pgrid((M + kPM - 1) / kPM, (N + kPN - 1) / kPN, 2);
  proj_kernel<T><<<pgrid, kPThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wif),
      static_cast<const T*>(wib), static_cast<const T*>(bif),
      static_cast<const T*>(bib), xg, M, W, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (H) {
    case 16:
      return launch_recur<T, 16>(xg, whf, whb, bhf, bhb, lengths, ysf, ysb,
                                 Tn, B, stream);
    case 32:
      return launch_recur<T, 32>(xg, whf, whb, bhf, bhb, lengths, ysf, ysb,
                                 Tn, B, stream);
    case 64:
      return launch_recur<T, 64>(xg, whf, whb, bhf, bhb, lengths, ysf, ysb,
                                 Tn, B, stream);
    case 128:
      return launch_recur<T, 128>(xg, whf, whb, bhf, bhb, lengths, ysf, ysb,
                                  Tn, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors; xg is f32 scratch of
// 2*T*B*3H elements.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int gru_bidir_fwd(int dtype, const void* x, const void* wif, const void* wib,
                  const void* bif, const void* bib, const void* whf,
                  const void* whb, const void* bhf, const void* bhb,
                  const int* lengths, void* ysf, void* ysb, float* xg, int Tn,
                  int B, int W, int H, void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_layer<float>(x, wif, wib, bif, bib, whf, whb, bhf, bhb,
                                 lengths, ysf, ysb, xg, Tn, B, W, H, s);
  if (dtype == 1)
    return (int)run_layer<__nv_bfloat16>(x, wif, wib, bif, bib, whf, whb, bhf,
                                         bhb, lengths, ysf, ysb, xg, Tn, B, W,
                                         H, s);
  return (int)cudaErrorInvalidValue;
}

const char* gru_bidir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
