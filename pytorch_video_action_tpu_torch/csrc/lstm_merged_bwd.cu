// One bidirectional LSTM layer backward on the merged body (the VJP of the
// train-form forward, lstm_merged_fwd in csrc/lstm_bidir_fwd.cu) for
// Hopper (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _lstm_bwd_kernel, reached through lstm_bidir_fused's custom_vjp
//   (PVA_RNN_SPLIT=0).
//
// Inputs, for x [T, B, W] time-major: the forward's kernel-order residuals
// res [T, B, 10H] = [i f g o tanh_c] (each 2H wide, gate-grouped), the
// kernel-order previous state hp2 and cell state cp2 [T, B, 2H] (row s:
// the state before kernel step s, 0 at s = 0; built by the caller from ys
// and cs), the output gradients dyf, dyb [T, B, H] in original time
// order, the dense wif2, wib2 [W, 4H], the gate-grouped block-diagonal wh2
// [2H, 8H] and lengths [B].  Per kernel step s = T-1 .. 0, in f32, as
// JAX's _lstm_bwd_kernel:
//   dh = [dyf[s], dyb[T-1-s]] + carry_h
//   dc = dh * o * (1 - tanh_c^2) + carry_c
//   dpre_i = dc * g * i (1 - i);  dpre_f = dc * cp * f (1 - f)
//   dpre_g = dc * i * (1 - g^2);  dpre_o = dh * tanh_c * o (1 - o)
//   carry_h' = dg2 @ wh2^T;  carry_c' = dc * f
// On the backward half's frozen steps (s < T - lengths[b]) the gate
// gradients are 0 and dh and dc pass through.  Then dwh2 = hp2^T dg2 (the
// whole [2H, 8H], off-diagonal blocks included), dbi2 = sum dg2 (the folded
// bias), dwi_d = x^T dg_d and dx_f, dx_b = dg_d @ wi_d^T apart, each cast
// to x's dtype.  bf16: dg2 is rounded to the weight dtype before the carry
// product and dwh2, to the wi dtype for dx and to the x dtype for dwi;
// every sum is f32; the gradients are written in the weight dtype.
//
// Design: wh2 is block-diagonal, so the carry product is two direction
// chains, each against wh2's diagonal block (the TPU kernel relies on the
// zeros for its frozen lanes too).  The chain is row 4's
// (csrc/lstm_bidir_bwd.cu) with the merged layouts' addressing: each
// (batch row, direction) chain on a cluster of two blocks, block r owning
// hidden units [r*H/2, (r+1)*H/2), whose cell threads write the units'
// rounded gate gradients into both blocks' shared memory; after one
// cluster barrier thread (p, u) forms gate block p's part of carry_h' of
// unit r*H/2 + u from wh2's diagonal block, H floats in registers.  Both
// chains walk the kernel rows from T-1 down; a step's inputs are loaded
// one step ahead.  The chain writes each gate gradient twice, where each
// product reads it: dg [2, T*B, 4H] f32, dense per direction in original
// time order (row 4's layout, for dwi and dx), and dg2 [T*B, 8H] f32 in
// kernel order, gate-grouped (the rows of hp2, for dwh2), plus per-row
// bias sums; the products run off the chain as rnn_common.cuh's tiled
// SIMT GEMMs, dwif, dwib and dwh2's two column halves in one launch.  No
// atomics: two runs give bit-identical gradients.  What bounds it is row
// 4's: the chain and the products' SIMT throughput (dwh2 twice row 4's two
// dwh products).

#include <cooperative_groups.h>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace {

// One chain step's inputs for unit k: the residuals, c_prev and dy.
struct StepIn {
  float i, f, g, o, tc, cp, dy;
};

// the inputs of kernel row ks (time t of direction dir)
template <typename T, int H>
__device__ __forceinline__ StepIn load_step(const T* __restrict__ res,
                                            const T* __restrict__ cp2,
                                            const T* __restrict__ dy, int ks,
                                            int t, int B, int b, int dir,
                                            int k) {
  const size_t row = (size_t)ks * B + b;
  const T* rs = res + row * 10 * H + dir * H;
  StepIn in;
  in.i = to_f(rs[k]);
  in.f = to_f(rs[2 * H + k]);
  in.g = to_f(rs[4 * H + k]);
  in.o = to_f(rs[6 * H + k]);
  in.tc = to_f(rs[8 * H + k]);
  in.cp = to_f(cp2[row * 2 * H + dir * H + k]);
  in.dy = to_f(dy[((size_t)t * B + b) * H + k]);
  return in;
}

// One cluster of two blocks per (batch row, direction): grid (2B, 2),
// blockDim.x == 2H.  Thread tid = p*H/2 + u of block r holds row k =
// r*H/2 + u of gate block p of wh2's diagonal block and forms gate block
// p's part of carry_h'[k]; threads p == 0 also own unit k's carries, gate
// gradients and bias sums.
template <typename T, int H>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(2 * H, 1)
lstm_merged_bwd_recur_kernel(const T* __restrict__ wh2,
                             const int* __restrict__ lengths,
                             const T* __restrict__ res,
                             const T* __restrict__ cp2,
                             const T* __restrict__ dy_f,
                             const T* __restrict__ dy_b,
                             float* __restrict__ dg, float* __restrict__ dg2,
                             float* __restrict__ bias_part, int Tn, int B) {
  constexpr int G = 4 * H;
  constexpr int G2 = 2 * G;
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
  const T* __restrict__ dy = dir ? dy_b : dy_f;
  float* __restrict__ dg_d = dg + (size_t)dir * Tn * B * G;
  float* peer_dg = cluster.map_shared_rank(&dg_s[0][0], r ^ 1);

  float w[H];
#pragma unroll
  for (int j = 0; j < H; ++j)
    w[j] = to_f(wh2[(size_t)(dir * H + k) * G2 + p * 2 * H + dir * H + j]);
  const int len = lengths[b];

  // iteration i walks kernel row T-1-i: time T-1-i forward, i backward
  float carry_h = 0.0f, carry_c = 0.0f;
  float sum_i = 0.0f, sum_f = 0.0f, sum_g = 0.0f, sum_o = 0.0f;
  StepIn cur = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tid < HH)
    cur = load_step<T, H>(res, cp2, dy, Tn - 1, dir ? 0 : Tn - 1, B, b, dir,
                          k);
  cluster.sync();  // both blocks have started

  for (int i = 0; i < Tn; ++i) {
    const int ks = Tn - 1 - i;
    const int t = dir ? i : ks;
    const int buf = i & 1;
    StepIn nxt = cur;
    float dh = 0.0f, dc = 0.0f;
    bool valid = true;
    if (tid < HH) {
      if (i + 1 < Tn)
        nxt = load_step<T, H>(res, cp2, dy, ks - 1, dir ? i + 1 : ks - 1, B,
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
      const size_t ot = ((size_t)t * B + b) * G;  // time order, dense
      const size_t ok = ((size_t)ks * B + b) * G2 + dir * H;  // kernel order
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dg_d[ot + q * H + k] = dgates[q];
        dg2[ok + q * 2 * H + k] = dgates[q];
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

    // gate block p's part of (dgates @ wh_d^T)[k]: four independent chains
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
    // bias_part [B][8H], each block its direction's columns
    float* pb = bias_part + (size_t)b * G2 + dir * H;
    pb[k] = sum_i;
    pb[2 * H + k] = sum_f;
    pb[4 * H + k] = sum_g;
    pb[6 * H + k] = sum_o;
  }
}

template <typename T, int H>
cudaError_t launch_recur(const void* wh2, const int* lengths, const void* res,
                         const void* cp2, const void* dyf, const void* dyb,
                         float* dg, float* dg2, float* bias_part, int Tn,
                         int B, cudaStream_t stream) {
  lstm_merged_bwd_recur_kernel<T, H><<<dim3(2 * B, 2), 2 * H, 0, stream>>>(
      static_cast<const T*>(wh2), lengths, static_cast<const T*>(res),
      static_cast<const T*>(cp2), static_cast<const T*>(dyf),
      static_cast<const T*>(dyb), dg, dg2, bias_part, Tn, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd(const void* x, const void* res, const void* hp2,
                    const void* cp2, const void* dyf, const void* dyb,
                    const void* wif2, const void* wib2, const void* wh2,
                    const int* lengths, void* dxf, void* dxb, void* dwif,
                    void* dwib, void* dbi2, void* dwh2, float* dg,
                    float* dg2, float* bias_part, int Tn, int B, int W,
                    int H, cudaStream_t stream) {
  cudaError_t err;
  switch (H) {
    case 16:
      err = launch_recur<T, 16>(wh2, lengths, res, cp2, dyf, dyb, dg, dg2,
                                bias_part, Tn, B, stream);
      break;
    case 32:
      err = launch_recur<T, 32>(wh2, lengths, res, cp2, dyf, dyb, dg, dg2,
                                bias_part, Tn, B, stream);
      break;
    case 64:
      err = launch_recur<T, 64>(wh2, lengths, res, cp2, dyf, dyb, dg, dg2,
                                bias_part, Tn, B, stream);
      break;
    case 128:
      err = launch_recur<T, 128>(wh2, lengths, res, cp2, dyf, dyb, dg, dg2,
                                 bias_part, Tn, B, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  const BiasOuts<T> bias = {{static_cast<T*>(dbi2), nullptr, nullptr,
                             nullptr}};
  err = launch_bias_reduce<T>(bias_part, bias, 1, B, 8 * H, stream);
  if (err != cudaSuccess) return err;
  // the LSTM's input and hidden gate gradients are both dgates
  return launch_merged_products<T>(x, wif2, wib2, hp2, dg, dg2, dxf, dxb,
                                   dwif, dwib, dwh2, Tn, B, W, H, 4 * H,
                                   stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors: the inputs x, res, hp2, cp2,
// dyf, dyb, wif2, wib2, wh2, lengths; the outputs dxf, dxb [T, B, W],
// dwif, dwib [W, 4H], dbi2 [8H], dwh2 [2H, 8H], all in the dtype; f32
// scratch dg [2, T*B, 4H], dg2 [T*B, 8H] and bias_part [B, 8H].
// Launches on `stream` and returns the first non-zero cudaGetLastError()
// (0 on success).
int lstm_merged_bwd(int dtype, const void* x, const void* res,
                    const void* hp2, const void* cp2, const void* dyf,
                    const void* dyb, const void* wif2, const void* wib2,
                    const void* wh2, const int* lengths, void* dxf, void* dxb,
                    void* dwif, void* dwib, void* dbi2, void* dwh2,
                    float* dg, float* dg2, float* bias_part, int Tn, int B,
                    int W, int H, void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bwd<float>(x, res, hp2, cp2, dyf, dyb, wif2, wib2, wh2,
                               lengths, dxf, dxb, dwif, dwib, dbi2, dwh2, dg,
                               dg2, bias_part, Tn, B, W, H, s);
  if (dtype == 1)
    return (int)run_bwd<__nv_bfloat16>(
        x, res, hp2, cp2, dyf, dyb, wif2, wib2, wh2, lengths, dxf, dxb, dwif,
        dwib, dbi2, dwh2, dg, dg2, bias_part, Tn, B, W, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* lstm_merged_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
