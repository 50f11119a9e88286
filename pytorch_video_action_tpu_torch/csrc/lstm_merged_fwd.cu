// One bidirectional LSTM layer forward on the merged body, eval and train
// forms, for Hopper (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _lstm_fwd_kernel, reached through lstm_bidir_fused (PVA_RNN_SPLIT=0):
//   train=False (eval form) and train=True (train form, from its
//   custom_vjp forward).
//
// Computes, for x [T, B, W] time-major, dense per-direction input weights
// wif2, wib2 [W, 4H], the gate-grouped bi2 [8H] (both biases folded) and
// block-diagonal wh2 [2H, 8H] (columns [i_f i_b | f_f f_b | g_f g_b |
// o_f o_b]) and lengths [B], the TPU kernel's one [B, 2H] chain over
// kernel steps s:
//   a = ([x_s @ wif2 | x_{T-1-s} @ wib2] (gate-grouped) + bi2) + h2 @ wh2
//   i = sigmoid(a_i); f = sigmoid(a_f); g = tanh(a_g); o = sigmoid(a_o)
//   c2' = f * c2 + i * g;  h2' = o * tanh(c2')
// with the backward half's h and c frozen on its flipped-prefix padding
// (s < T - lengths[b]).  ys_f, ys_b [T, B, H] in original time order,
// unmasked.  Matmul inputs are the input dtype with f32 accumulation; c and
// the gate math are f32; h is rounded to the weight dtype before the
// hidden product.  The train form also writes, in KERNEL order (row s:
// forward time s, backward time T-1-s) and in the input dtype, for
// csrc/lstm_merged_bwd.cu: cs [T, B, 2H], the carried cell state after
// each step, and res [T, B, 10H] = [i f g o tanh_c], each 2H wide and
// gate-grouped (tanh of the step's own c', also on frozen steps).
//
// Design: wh2 is block-diagonal (ops/rnn.py:_pack_gate_grouped), so the
// chain is two direction chains, each against wh2's diagonal block; the
// kernel reads only those blocks, and so relies on the zeros.  The chains
// run on row 3's machinery (csrc/lstm_bidir_fwd.cu), only the addressing
// differs: the projection is rnn_common.cuh's GEMM into xg [2, T*B, 4H]
// f32 without bias (bi2 is added on the chain, as on the TPU); each (batch
// row, direction) chain runs on a cluster of two blocks, block r owning
// hidden units [r*H/2, (r+1)*H/2) and their four gate columns, each of its
// 2H threads one column of the diagonal block (H floats) in registers;
// the new h goes to both blocks through distributed shared memory, one
// cluster barrier a step.  What bounds it is row 3's: the chain of T
// dependent steps.

#include <cooperative_groups.h>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace {

// One cluster of two blocks per (batch row, direction): grid (2B, 2),
// blockDim.x == 2H.  Thread tid of block r owns gate q = tid / (H/2) of
// hidden unit k = r*H/2 + tid % (H/2): dense column q*H + k of xg,
// gate-grouped column q*2H + dir*H + k of wh2, bi2 and res.
template <typename T, int H, bool TRAIN>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(2 * H, 1)
lstm_merged_recur_kernel(const float* __restrict__ xg,
                         const T* __restrict__ bi2, const T* __restrict__ wh2,
                         const int* __restrict__ lengths,
                         T* __restrict__ ys_f, T* __restrict__ ys_b,
                         T* __restrict__ cs, T* __restrict__ res, int Tn,
                         int B) {
  constexpr int G = 4 * H;
  constexpr int G2 = 2 * G;
  constexpr int HH = H / 2;
  __shared__ __align__(16) float h_s[2][H];  // carry rounded to T, 2 buffers
  __shared__ float act_s[4 * HH];            // this block's gate activations
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / 2;
  const int dir = blockIdx.y;
  const int tid = threadIdx.x;
  const int q = tid / HH;
  const int u = tid % HH;
  const int k = r * HH + u;
  const int col = q * H + k;
  const int col2 = q * 2 * H + dir * H + k;
  T* __restrict__ ys = dir ? ys_b : ys_f;
  float* peer_h = cluster.map_shared_rank(&h_s[0][0], r ^ 1);

  float w[H];  // column col2 of wh2's diagonal block of direction dir
#pragma unroll
  for (int j = 0; j < H; ++j)
    w[j] = to_f(wh2[(size_t)(dir * H + j) * G2 + col2]);
  const float bias = to_f(bi2[col2]);
  (&h_s[0][0])[tid] = 0.0f;  // 2H threads, 2H floats
  const int len = lengths[b];
  const float* __restrict__ xg_d = xg + (size_t)dir * Tn * B * G;
  float xv_next = xg_d[((size_t)(dir ? Tn - 1 : 0) * B + b) * G + col];
  float c = 0.0f, hc = 0.0f;  // f32 carry of unit k (cell threads)
  cluster.sync();  // both blocks have started and zeroed h

  for (int s = 0; s < Tn; ++s) {
    const int t = dir ? Tn - 1 - s : s;
    const int cur = s & 1;
    const float xv = xv_next + bias;
    if (s + 1 < Tn)
      xv_next = xg_d[((size_t)(dir ? Tn - 2 - s : s + 1) * B + b) * G + col];

    // hidden product, column col2: four independent FMA chains
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int j = 0; j < H; j += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(&h_s[cur][j]);
      a0 = fmaf(hv.x, w[j], a0);
      a1 = fmaf(hv.y, w[j + 1], a1);
      a2 = fmaf(hv.z, w[j + 2], a2);
      a3 = fmaf(hv.w, w[j + 3], a3);
    }
    const float pre = xv + ((a0 + a1) + (a2 + a3));
    const float act = q == 2 ? tanhf(pre) : sigmoid_f(pre);
    act_s[tid] = act;
    const size_t krow = (size_t)s * B + b;  // kernel-order row
    if (TRAIN) res[krow * 10 * H + col2] = from_f<T>(act);
    __syncthreads();

    // cell update of unit k, and the new h to both blocks
    if (tid < HH) {
      const float ig = act_s[u], fg = act_s[HH + u];
      const float gg = act_s[2 * HH + u], og = act_s[3 * HH + u];
      float cn = fg * c + ig * gg;
      const float tc = tanhf(cn);
      float hn = og * tc;
      if (dir && t >= len) {  // backward half: frozen on padding
        cn = c;
        hn = hc;
      }
      c = cn;
      hc = hn;
      const T hq = from_f<T>(hn);
      ys[((size_t)t * B + b) * H + k] = hq;
      if (TRAIN) {
        res[krow * 10 * H + 8 * H + dir * H + k] = from_f<T>(tc);
        cs[krow * 2 * H + dir * H + k] = from_f<T>(cn);
      }
      const float hv = to_f(hq);
      h_s[cur ^ 1][k] = hv;
      peer_h[(cur ^ 1) * H + k] = hv;
    }
    cluster.sync();
  }
}

template <typename T, int H>
cudaError_t launch_recur(const float* xg, const void* bi2, const void* wh2,
                         const int* lengths, void* ysf, void* ysb, void* cs,
                         void* res, bool train, int Tn, int B,
                         cudaStream_t stream) {
  const dim3 grid(2 * B, 2);
  const T* bi = static_cast<const T*>(bi2);
  const T* wh = static_cast<const T*>(wh2);
  T* yf = static_cast<T*>(ysf);
  T* yb = static_cast<T*>(ysb);
  if (train)
    lstm_merged_recur_kernel<T, H, true><<<grid, 2 * H, 0, stream>>>(
        xg, bi, wh, lengths, yf, yb, static_cast<T*>(cs),
        static_cast<T*>(res), Tn, B);
  else
    lstm_merged_recur_kernel<T, H, false><<<grid, 2 * H, 0, stream>>>(
        xg, bi, wh, lengths, yf, yb, nullptr, nullptr, Tn, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_layer(const void* x, const void* wif2, const void* wib2,
                      const void* bi2, const void* wh2, const int* lengths,
                      void* ysf, void* ysb, void* cs, void* res, float* xg,
                      int Tn, int B, int W, int H, bool train,
                      cudaStream_t stream) {
  const cudaError_t err = launch_proj<T>(x, wif2, wib2, nullptr, nullptr, xg,
                                         Tn * B, W, 4 * H, stream);
  if (err != cudaSuccess) return err;
  switch (H) {
    case 16:
      return launch_recur<T, 16>(xg, bi2, wh2, lengths, ysf, ysb, cs, res,
                                 train, Tn, B, stream);
    case 32:
      return launch_recur<T, 32>(xg, bi2, wh2, lengths, ysf, ysb, cs, res,
                                 train, Tn, B, stream);
    case 64:
      return launch_recur<T, 64>(xg, bi2, wh2, lengths, ysf, ysb, cs, res,
                                 train, Tn, B, stream);
    case 128:
      return launch_recur<T, 128>(xg, bi2, wh2, lengths, ysf, ysb, cs, res,
                                  train, Tn, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors: x [T, B, W], wif2, wib2
// [W, 4H], bi2 [8H], wh2 [2H, 8H], lengths [B] int32, the outputs ysf, ysb
// [T, B, H] and, for train != 0, cs [T, B, 2H] and res [T, B, 10H], in the
// dtype (ignored by the eval form); xg is f32 scratch of 2*T*B*4H
// elements.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int lstm_merged_fwd(int dtype, const void* x, const void* wif2,
                    const void* wib2, const void* bi2, const void* wh2,
                    const int* lengths, void* ysf, void* ysb, void* cs,
                    void* res, float* xg, int Tn, int B, int W, int H,
                    int train, void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (train && (cs == nullptr || res == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_layer<float>(x, wif2, wib2, bi2, wh2, lengths, ysf, ysb,
                                 cs, res, xg, Tn, B, W, H, train != 0, s);
  if (dtype == 1)
    return (int)run_layer<__nv_bfloat16>(x, wif2, wib2, bi2, wh2, lengths,
                                         ysf, ysb, cs, res, xg, Tn, B, W, H,
                                         train != 0, s);
  return (int)cudaErrorInvalidValue;
}

const char* lstm_merged_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
