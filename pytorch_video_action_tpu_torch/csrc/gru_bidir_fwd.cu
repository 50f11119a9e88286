// One bidirectional GRU layer forward, eval and train forms, for Hopper
// (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _fwd_kernel_split, reached through gru_bidir_fused_split: train=False
//   (eval form) and train=True (train form, from its custom_vjp forward);
//   and its halves=/boundary form, reached through
//   gru_bidir_fused_split_bnd (eval form and its custom_vjp forward).
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
// The train form also writes each step's residuals for the backward
// (csrc/gru_bidir_bwd.cu), res_f, res_b [T, B, 4H] = [r, z, n, hg_n] with
// hg_n = (h @ wh_d + bh_d)[2H:] (bh_n included), in the input dtype.  Both
// directions are stored in original time order: res_b[t] is the backward
// chain's step at time t, not its s-th step.
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
//  * The train form is a template flag: the H threads that update the
//    carry also store their column's four residuals, off the chain (stores
//    are not waited on).  The eval form compiles without them.
//  * The fused-boundary form (gru_bidir_bnd_fwd, the layers after the
//    first under PVA_RNN_FUSED_BOUNDARY=1) builds its layer input in the
//    projection's tile loads (rnn_common.cuh::Boundary): the previous
//    layer's halves, the length mask and the hash dropout in registers, so
//    the stack writes no [T, B, 2H] boundary tensor.  Each element is
//    hashed once a product; the TPU form hashed it once a direction.  The
//    recurrence does not read x and is the same kernel.
// wgmma, TMA and spreading H across SMs are later work.

#include "rnn_common.cuh"

namespace {

// ------------------------------------------------------------- recurrence

// One block per (batch row, direction); blockDim.x == 3H.  Thread c owns
// gate column c of the hidden product and keeps that column of wh in
// registers for the whole layer, so a step reads only the carry (one
// broadcast) from shared memory.  TRAIN also stores the residuals.
template <typename T, int H, bool TRAIN>
__global__ void __launch_bounds__(3 * H, 1)
recur_kernel(const float* __restrict__ xg, const T* __restrict__ wh_f,
             const T* __restrict__ wh_b, const T* __restrict__ bh_f,
             const T* __restrict__ bh_b, const int* __restrict__ lengths,
             T* __restrict__ ys_f, T* __restrict__ ys_b,
             T* __restrict__ res_f, T* __restrict__ res_b, int Tn, int B) {
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
      if (TRAIN) {
        T* res = (dir ? res_b : res_f) + ((size_t)t * B + b) * 4 * H;
        res[tid] = from_f<T>(r);
        res[H + tid] = from_f<T>(z);
        res[2 * H + tid] = from_f<T>(n);
        res[3 * H + tid] = from_f<T>(hg_s[2 * H + tid]);
      }
    }
    __syncthreads();
  }
}

template <typename T, int H>
cudaError_t launch_recur(const float* xg, const void* whf, const void* whb,
                         const void* bhf, const void* bhb, const int* lengths,
                         void* ysf, void* ysb, void* resf, void* resb,
                         bool train, int Tn, int B, cudaStream_t stream) {
  const dim3 grid(B, 2);
  const T* wf = static_cast<const T*>(whf);
  const T* wb = static_cast<const T*>(whb);
  const T* bf = static_cast<const T*>(bhf);
  const T* bb = static_cast<const T*>(bhb);
  T* yf = static_cast<T*>(ysf);
  T* yb = static_cast<T*>(ysb);
  if (train)
    recur_kernel<T, H, true><<<grid, 3 * H, 0, stream>>>(
        xg, wf, wb, bf, bb, lengths, yf, yb, static_cast<T*>(resf),
        static_cast<T*>(resb), Tn, B);
  else
    recur_kernel<T, H, false><<<grid, 3 * H, 0, stream>>>(
        xg, wf, wb, bf, bb, lengths, yf, yb, nullptr, nullptr, Tn, B);
  return cudaGetLastError();
}

// The recurrence on the projected gates xg, for the H of the layer.
template <typename T>
cudaError_t run_recur(const float* xg, const void* whf, const void* whb,
                      const void* bhf, const void* bhb, const int* lengths,
                      void* ysf, void* ysb, void* resf, void* resb,
                      bool train, int Tn, int B, int H, cudaStream_t stream) {
  switch (H) {
    case 16:
      return launch_recur<T, 16>(xg, whf, whb, bhf, bhb, lengths, ysf, ysb,
                                 resf, resb, train, Tn, B, stream);
    case 32:
      return launch_recur<T, 32>(xg, whf, whb, bhf, bhb, lengths, ysf, ysb,
                                 resf, resb, train, Tn, B, stream);
    case 64:
      return launch_recur<T, 64>(xg, whf, whb, bhf, bhb, lengths, ysf, ysb,
                                 resf, resb, train, Tn, B, stream);
    case 128:
      return launch_recur<T, 128>(xg, whf, whb, bhf, bhb, lengths, ysf, ysb,
                                  resf, resb, train, Tn, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The layer on a dense x [T, B, W] (launch_proj_of with x's DenseRows) or,
// the fused-boundary form, on the boundary the operand XA builds.
template <typename T, typename XA>
cudaError_t run_layer(const XA& x, const void* wif, const void* wib,
                      const void* bif, const void* bib, const void* whf,
                      const void* whb, const void* bhf, const void* bhb,
                      const int* lengths, void* ysf, void* ysb, void* resf,
                      void* resb, float* xg, int Tn, int B, int W, int H,
                      bool train, cudaStream_t stream) {
  const cudaError_t err =
      launch_proj_of<T>(x, wif, wib, bif, bib, xg, Tn * B, W, 3 * H, stream);
  if (err != cudaSuccess) return err;
  return run_recur<T>(xg, whf, whb, bhf, bhb, lengths, ysf, ysb, resf, resb,
                      train, Tn, B, H, stream);
}

template <typename T>
cudaError_t run_dense(const void* x, const void* wif, const void* wib,
                      const void* bif, const void* bib, const void* whf,
                      const void* whb, const void* bhf, const void* bhb,
                      const int* lengths, void* ysf, void* ysb, void* resf,
                      void* resb, float* xg, int Tn, int B, int W, int H,
                      bool train, cudaStream_t stream) {
  return run_layer<T>(DenseRows<T>{static_cast<const T*>(x), W}, wif, wib,
                      bif, bib, whf, whb, bhf, bhb, lengths, ysf, ysb, resf,
                      resb, xg, Tn, B, W, H, train, stream);
}

template <typename T>
cudaError_t run_boundary(const void* xa, const void* xb, const void* wif,
                         const void* wib, const void* bif, const void* bib,
                         const void* whf, const void* whb, const void* bhf,
                         const void* bhb, const int* lengths, void* ysf,
                         void* ysb, void* resf, void* resb, float* xg, int Tn,
                         int B, int Hx, int H, bool train, uint32_t seed,
                         uint32_t thresh, float scale, bool drop,
                         cudaStream_t stream) {
  const Boundary<T> bnd = {static_cast<const T*>(xa),
                           static_cast<const T*>(xb),
                           lengths,
                           B,
                           Hx,
                           Tn,
                           stream_key(seed),
                           thresh,
                           scale,
                           drop};
  return run_layer<T>(bnd, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths,
                      ysf, ysb, resf, resb, xg, Tn, B, 2 * Hx, H, train,
                      stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors; xg is f32 scratch of
// 2*T*B*3H elements.  train != 0 selects the train form, which also writes
// resf and resb ([T, B, 4H] each); the eval form ignores them.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int gru_bidir_fwd(int dtype, const void* x, const void* wif, const void* wib,
                  const void* bif, const void* bib, const void* whf,
                  const void* whb, const void* bhf, const void* bhb,
                  const int* lengths, void* ysf, void* ysb, void* resf,
                  void* resb, float* xg, int Tn, int B, int W, int H,
                  int train, void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (train && (resf == nullptr || resb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_dense<float>(x, wif, wib, bif, bib, whf, whb, bhf, bhb,
                                 lengths, ysf, ysb, resf, resb, xg, Tn, B, W,
                                 H, train != 0, s);
  if (dtype == 1)
    return (int)run_dense<__nv_bfloat16>(x, wif, wib, bif, bib, whf, whb, bhf,
                                         bhb, lengths, ysf, ysb, resf, resb,
                                         xg, Tn, B, W, H, train != 0, s);
  return (int)cudaErrorInvalidValue;
}

// The fused-boundary form (rnn_fused_pallas.py gru_bidir_fused_split_bnd):
// gru_bidir_fwd on the GRU stack's layer boundary built from the previous
// layer's halves xa, xb [T, B, Hx] (W = 2 Hx) inside the projection, with
// the hash dropout of seed `seed` (keep threshold `thresh`, `scale` = 1/keep
// rounded to the dtype) when drop != 0.  Other arguments as gru_bidir_fwd's.
int gru_bidir_bnd_fwd(int dtype, const void* xa, const void* xb,
                      const void* wif, const void* wib, const void* bif,
                      const void* bib, const void* whf, const void* whb,
                      const void* bhf, const void* bhb, const int* lengths,
                      void* ysf, void* ysb, void* resf, void* resb, float* xg,
                      int Tn, int B, int Hx, int H, int train,
                      unsigned int seed, unsigned int thresh, float scale,
                      int drop, void* stream) {
  if (Tn <= 0 || B <= 0 || Hx <= 0) return (int)cudaErrorInvalidValue;
  if (train && (resf == nullptr || resb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_boundary<float>(xa, xb, wif, wib, bif, bib, whf, whb, bhf,
                                    bhb, lengths, ysf, ysb, resf, resb, xg,
                                    Tn, B, Hx, H, train != 0, seed, thresh,
                                    scale, drop != 0, s);
  if (dtype == 1)
    return (int)run_boundary<__nv_bfloat16>(
        xa, xb, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths, ysf, ysb,
        resf, resb, xg, Tn, B, Hx, H, train != 0, seed, thresh, scale,
        drop != 0, s);
  return (int)cudaErrorInvalidValue;
}

const char* gru_bidir_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
