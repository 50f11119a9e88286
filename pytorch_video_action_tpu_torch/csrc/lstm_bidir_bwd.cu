// One bidirectional LSTM layer backward (the VJP of the train-form forward
// in csrc/lstm_bidir_fwd.cu) for Hopper (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _lstm_bwd_kernel_split, reached through lstm_bidir_fused_split's
//   custom_vjp.
//
// Inputs, for x [T, B, W] time-major and per direction d in {fwd, bwd}:
// wi_d [W, 4H], wh_d [H, 4H], lengths [B], the forward's ys_d [T, B, H],
// cell states cs_d [T, B, H] f32 and residuals res_d [T, B, 5H] =
// [i, f, g, o, tanh c] (original time order for both directions), and the
// output gradients dy_d [T, B, H].  Per chain step, in f32, with c_prev read
// from cs (cs_f[t-1] and cs_b[t+1], 0 past the ends):
//   dh = dy[t] + carry_h;  dc = dh * o * (1 - tanh_c^2) + carry_c
//   dpre_i = dc * g * i (1 - i);  dpre_f = dc * c_prev * f (1 - f)
//   dpre_g = dc * i * (1 - g^2);  dpre_o = dh * tanh_c * o (1 - o)
//   dgates = [dpre_i, dpre_f, dpre_g, dpre_o]
//   carry_h' = dgates @ wh_d^T;  carry_c' = dc * f
// On the backward chain's frozen steps (t >= lengths[b]) the forward kept h
// and c, so the gate gradients are 0 and dh and dc pass through.  Then, with
// hp the previous state read from ys (ys_f[t-1], ys_b[t+1], 0 past the
// ends): dwh_d = hp^T dgates_d, dwi_d = x^T dgates_d, db_d = sum dgates_d
// (the folded bias) and dx = dgates_f @ wi_f^T + dgates_b @ wi_b^T (one f32
// sum, cast to x's dtype).  bf16: dgates is rounded to the weight dtype
// before the carry product and dwh, to the wi dtype for dx and to the x
// dtype for dwi; every sum is f32 and the gradients are written in the
// weight dtype.
//
// What bounds it on an H100: at the bench shape (B=64, T=1024, H=128,
// W=400) the work is 4*T*B*4H*(2W + 2H) = 141.7 GFLOP, about 2.1 ms at f32
// without TF32 (67 TFLOP/s), and about 0.7 GB of traffic (0.2 ms).  Most of
// it, the weight and input gradients, is large products off the chain; the
// chain of T dependent steps holds only the [B, 4H] x [4H, H] carry
// product.  A design that is right but simple is bound by that chain and by
// SIMT throughput of the products.
//
// What the design does about it:
//  * The chain's contraction dgates @ wh^T is 4H = 512 deep per output: one
//    direction's wh is 256 KiB at f32 and H=128, more than one SM holds.  As
//    in the forward, each (batch row, direction) chain runs on a cluster of
//    two blocks.  Block r owns hidden units [r*H/2, (r+1)*H/2): the cell
//    threads compute those units' gate gradients and write them, rounded,
//    into their own and the peer block's shared memory (distributed shared
//    memory); after one cluster barrier, thread (p, u) of block r holds
//    wh[r*H/2 + u, pH .. pH+H) in registers (128 floats a thread at H=128)
//    and forms gate block p's part of carry_h'[r*H/2 + u]; the four parts
//    meet in shared memory.  The gate gradients are double-buffered, so a
//    step waits on one cluster barrier and one block barrier.  A step's
//    inputs (residuals, c_prev, dy) are loaded one step ahead.
//  * The chain writes dgates ([2, T*B, 4H] f32 scratch) and per-row bias
//    sums; everything else runs off the chain as the tiled SIMT GEMMs of
//    rnn_common.cuh over K = T*B (one launch for dwi and dwh of both
//    directions) and over K = 8H for dx.
//  * No atomics: each output tile owns its whole K loop and the bias sums
//    add the per-row partials in a fixed order, so two runs give
//    bit-identical gradients.
// wgmma, TMA and split-K with a fixed-order reduction are later work.

#include <cooperative_groups.h>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace {

// One chain step's inputs for unit k: the residuals, c_prev and dy.
struct StepIn {
  float i, f, g, o, tc, cp, dy;
};

template <typename T, int H>
__device__ __forceinline__ StepIn load_step(const T* __restrict__ res,
                                            const float* __restrict__ cs,
                                            const T* __restrict__ dy, int t,
                                            int Tn, int B, int b, int dir,
                                            int k) {
  const size_t row = (size_t)t * B + b;
  const T* rs = res + row * 5 * H;
  StepIn in;
  in.i = to_f(rs[k]);
  in.f = to_f(rs[H + k]);
  in.g = to_f(rs[2 * H + k]);
  in.o = to_f(rs[3 * H + k]);
  in.tc = to_f(rs[4 * H + k]);
  in.dy = to_f(dy[row * H + k]);
  // previous cell state of the chain: t-1 forward, t+1 backward, 0 past it
  const int tp = dir ? t + 1 : t - 1;
  in.cp = (tp >= 0 && tp < Tn) ? cs[((size_t)tp * B + b) * H + k] : 0.0f;
  return in;
}

// One cluster of two blocks per (batch row, direction): grid (2B, 2),
// blockDim.x == 2H.  Thread tid = p*H/2 + u of block r holds wh[k, pH ..
// pH+H) for k = r*H/2 + u and forms gate block p's part of carry_h'[k];
// threads p == 0 also own unit k's carries, gate gradients and bias sums.
template <typename T, int H>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(2 * H, 1)
lstm_bwd_recur_kernel(const T* __restrict__ wh_f, const T* __restrict__ wh_b,
                      const int* __restrict__ lengths,
                      const float* __restrict__ cs_f,
                      const float* __restrict__ cs_b,
                      const T* __restrict__ res_f, const T* __restrict__ res_b,
                      const T* __restrict__ dy_f, const T* __restrict__ dy_b,
                      float* __restrict__ dg, float* __restrict__ bias_part,
                      int Tn, int B) {
  constexpr int G = 4 * H;
  constexpr int HH = H / 2;
  __shared__ __align__(16) float dg_s[2][G];  // dgates rounded to T
  __shared__ float part_s[3][HH];             // gate blocks f, g, o
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / 2;
  const int dir = blockIdx.y;
  const int tid = threadIdx.x;
  const int p = tid / HH;
  const int u = tid % HH;
  const int k = r * HH + u;
  const T* __restrict__ wh = dir ? wh_b : wh_f;
  const float* __restrict__ cs = dir ? cs_b : cs_f;
  const T* __restrict__ res = dir ? res_b : res_f;
  const T* __restrict__ dy = dir ? dy_b : dy_f;
  float* __restrict__ dg_d = dg + (size_t)dir * Tn * B * G;
  float* peer_dg = cluster.map_shared_rank(&dg_s[0][0], r ^ 1);

  float w[H];
#pragma unroll
  for (int j = 0; j < H; ++j) w[j] = to_f(wh[(size_t)k * G + p * H + j]);
  const int len = lengths[b];

  // the chain's VJP walks t = T-1 .. 0 forward, t = 0 .. T-1 backward
  float carry_h = 0.0f, carry_c = 0.0f;
  float sum_i = 0.0f, sum_f = 0.0f, sum_g = 0.0f, sum_o = 0.0f;
  StepIn cur = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tid < HH)
    cur = load_step<T, H>(res, cs, dy, dir ? 0 : Tn - 1, Tn, B, b, dir, k);
  cluster.sync();  // both blocks have started

  for (int s = 0; s < Tn; ++s) {
    const int t = dir ? s : Tn - 1 - s;
    const int buf = s & 1;
    StepIn nxt = cur;
    float dh = 0.0f, dc = 0.0f;
    bool valid = true;
    if (tid < HH) {
      if (s + 1 < Tn)
        nxt = load_step<T, H>(res, cs, dy, dir ? s + 1 : Tn - 2 - s, Tn, B,
                              b, dir, k);
      dh = cur.dy + carry_h;
      dc = dh * cur.o * (1.0f - cur.tc * cur.tc) + carry_c;
      float dgates[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      valid = !(dir && t >= len);
      if (valid) {  // a frozen step has no gate gradient
        dgates[0] = dc * cur.g * cur.i * (1.0f - cur.i);
        dgates[1] = dc * cur.cp * cur.f * (1.0f - cur.f);
        dgates[2] = dc * cur.i * (1.0f - cur.g * cur.g);
        dgates[3] = dh * cur.tc * cur.o * (1.0f - cur.o);
      }
      const size_t o = ((size_t)t * B + b) * G;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dg_d[o + q * H + k] = dgates[q];
        const float v = rnd<T>(dgates[q]);
        dg_s[buf][q * H + k] = v;
        peer_dg[buf * G + q * H + k] = v;
      }
      sum_i += dgates[0];
      sum_f += dgates[1];
      sum_g += dgates[2];
      sum_o += dgates[3];
    }
    cluster.sync();

    // gate block p's part of (dgates @ wh^T)[k]: four independent FMA chains
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int j = 0; j < H; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&dg_s[buf][p * H + j]);
      a0 = fmaf(v.x, w[j], a0);
      a1 = fmaf(v.y, w[j + 1], a1);
      a2 = fmaf(v.z, w[j + 2], a2);
      a3 = fmaf(v.w, w[j + 3], a3);
    }
    const float part = (a0 + a1) + (a2 + a3);
    if (p > 0) part_s[p - 1][u] = part;
    __syncthreads();

    if (tid < HH) {
      const float next = ((part + part_s[0][u]) + part_s[1][u]) + part_s[2][u];
      carry_h = valid ? next : dh;
      carry_c = valid ? dc * cur.f : dc;
      cur = nxt;
    }
  }

  if (tid < HH) {
    // bias_part [2 (dir)][B][G]
    float* pb = bias_part + ((size_t)dir * B + b) * G;
    pb[k] = sum_i;
    pb[H + k] = sum_f;
    pb[2 * H + k] = sum_g;
    pb[3 * H + k] = sum_o;
  }
}

template <typename T, int H>
cudaError_t launch_recur(const void* whf, const void* whb, const int* lengths,
                         const float* csf, const float* csb, const void* resf,
                         const void* resb, const void* dyf, const void* dyb,
                         float* dg, float* bias_part, int Tn, int B,
                         cudaStream_t stream) {
  lstm_bwd_recur_kernel<T, H><<<dim3(2 * B, 2), 2 * H, 0, stream>>>(
      static_cast<const T*>(whf), static_cast<const T*>(whb), lengths, csf,
      csb, static_cast<const T*>(resf), static_cast<const T*>(resb),
      static_cast<const T*>(dyf), static_cast<const T*>(dyb), dg, bias_part,
      Tn, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd(const void* x, const void* wif, const void* wib,
                    const void* whf, const void* whb, const int* lengths,
                    const void* ysf, const void* ysb, const float* csf,
                    const float* csb, const void* resf, const void* resb,
                    const void* dyf, const void* dyb, void* dx, void* dwif,
                    void* dwib, void* dbf, void* dbb, void* dwhf, void* dwhb,
                    float* dg, float* bias_part, int Tn, int B, int W, int H,
                    cudaStream_t stream) {
  cudaError_t err;
  switch (H) {
    case 16:
      err = launch_recur<T, 16>(whf, whb, lengths, csf, csb, resf, resb, dyf,
                                dyb, dg, bias_part, Tn, B, stream);
      break;
    case 32:
      err = launch_recur<T, 32>(whf, whb, lengths, csf, csb, resf, resb, dyf,
                                dyb, dg, bias_part, Tn, B, stream);
      break;
    case 64:
      err = launch_recur<T, 64>(whf, whb, lengths, csf, csb, resf, resb, dyf,
                                dyb, dg, bias_part, Tn, B, stream);
      break;
    case 128:
      err = launch_recur<T, 128>(whf, whb, lengths, csf, csb, resf, resb, dyf,
                                 dyb, dg, bias_part, Tn, B, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  const int G = 4 * H;
  const BiasOuts<T> bias = {{static_cast<T*>(dbf), static_cast<T*>(dbb),
                             nullptr, nullptr}};
  err = launch_bias_reduce<T>(bias_part, bias, 2, B, G, stream);
  if (err != cudaSuccess) return err;
  // the LSTM's input and hidden gate gradients are both dgates
  return launch_products<T>(x, wif, wib, ysf, ysb, dg, dg, dx, dwif, dwib,
                            dwhf, dwhb, Tn, B, W, H, G, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors: the inputs x, wif, wib, whf,
// whb, lengths, ysf, ysb, csf and csb (f32), resf, resb, dyf, dyb; the
// outputs dx [T, B, W], dwif, dwib [W, 4H], dbf, dbb [4H] (the folded
// biases), dwhf, dwhb [H, 4H], in the dtype; f32 scratch dg of 2*T*B*4H
// elements and bias_part of 2*B*4H.  Launches on `stream` and returns the
// first non-zero cudaGetLastError() (0 on success).
int lstm_bidir_bwd(int dtype, const void* x, const void* wif, const void* wib,
                   const void* whf, const void* whb, const int* lengths,
                   const void* ysf, const void* ysb, const float* csf,
                   const float* csb, const void* resf, const void* resb,
                   const void* dyf, const void* dyb, void* dx, void* dwif,
                   void* dwib, void* dbf, void* dbb, void* dwhf, void* dwhb,
                   float* dg, float* bias_part, int Tn, int B, int W, int H,
                   void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bwd<float>(x, wif, wib, whf, whb, lengths, ysf, ysb, csf,
                               csb, resf, resb, dyf, dyb, dx, dwif, dwib, dbf,
                               dbb, dwhf, dwhb, dg, bias_part, Tn, B, W, H, s);
  if (dtype == 1)
    return (int)run_bwd<__nv_bfloat16>(
        x, wif, wib, whf, whb, lengths, ysf, ysb, csf, csb, resf, resb, dyf,
        dyb, dx, dwif, dwib, dbf, dbb, dwhf, dwhb, dg, bias_part, Tn, B, W, H,
        s);
  return (int)cudaErrorInvalidValue;
}

const char* lstm_bidir_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
