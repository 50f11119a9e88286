// One bidirectional LSTM layer forward, eval and train forms, for Hopper
// (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _lstm_fwd_kernel_split, reached through lstm_bidir_fused_split:
//   train=False (eval form) and train=True (train form, from its custom_vjp
//   forward).
//
// Computes, for x [T, B, W] time-major and per direction d in {fwd, bwd}
// wi_d [W, 4H], wh_d [H, 4H], one folded bias b_d = bi_d + bh_d [4H] and
// lengths [B], gates in the order i, f, g, o:
//   a = x_t @ wi_d + b_d + h @ wh_d
//   i = sigmoid(a_i); f = sigmoid(a_f); g = tanh(a_g); o = sigmoid(a_o)
//   c' = f * c + i * g;  h' = o * tanh(c')
// ys_f, ys_b [T, B, H] in original time order, unmasked.  The forward chain
// runs through padding; the backward chain walks t = T-1 .. 0 and keeps h
// and c (0 at the start) while t >= lengths[b], so ys_b is 0 on padding.
// Matmul inputs are the input dtype (f32 or bf16) with f32 accumulation; c
// and the gate math are f32; h is rounded to the weight dtype before the
// hidden product; ys is stored in the input dtype.
// The train form also writes, for the backward (csrc/lstm_bidir_bwd.cu),
// cs_f, cs_b [T, B, H] f32, the carried cell state after each step, and the
// residuals res_f, res_b [T, B, 5H] = [i, f, g, o, tanh(c')] in the input
// dtype (tanh of the step's own c', also on the backward chain's frozen
// steps).  Both directions are stored in original time order.
//
// What bounds it on an H100: at the bench shape (B=64, T=1024, H=128,
// W=400) layer 0's work is 2*T*B*(W + H)*4H*2 = 70.9 GFLOP, about 1.06 ms at
// f32 without TF32 (67 TFLOP/s), and about 0.2 GB of traffic.  A design
// that is right but simple is bound by neither: it is bound by the chain of
// T dependent steps, each a [B, H] x [H, 4H] product plus the gates.
//
// What the design does about it:
//  * The input projection is off the chain: one tiled SIMT GEMM
//    (rnn_common.cuh) computes xg [2, T*B, 4H] f32, bias included, for both
//    directions before the recurrence.
//  * The chain is where the GRU kernel's design does not carry over: the
//    GRU gives each of 3H threads one column of wh in registers, but one
//    direction's wh here is H x 4H = 128 x 512 f32 = 256 KiB at H=128, the
//    whole register file of an SM and more than the 227 KiB of shared
//    memory a block may have.  So each (batch row, direction) chain runs on
//    a thread-block cluster of two blocks on two SMs.  Block r owns hidden
//    units [r*H/2, (r+1)*H/2) and their four gate columns; each of its 2H
//    threads keeps one column of wh, all H rows, in registers (128 floats a
//    thread at H=128, as in the GRU kernel).  A step reads the full h from
//    shared memory as a broadcast; the H/2 threads that update c write their
//    new h into their own block's and, through distributed shared memory,
//    the peer block's buffer, and one cluster barrier a step publishes it.
//    h is double-buffered, so that barrier is the step's only cross-block
//    wait.  Splitting each column between registers and shared memory in
//    one block instead would make each step 64 shared-memory loads a
//    thread, the kind of load that set the step time of the GRU kernel's
//    first design.
//  * A step's input gates are loaded one step ahead, so their global-memory
//    latency hides behind the current step.  The cluster barrier's arrive
//    has release semantics and so also waits for the step's stores and
//    that load; splitting it into arrive and wait with the stores between
//    gained nothing measurable on the H100, and moving the load there too
//    exposed its latency at the next step (PERF.md).
//  * The backward direction reads xg at T-1-s; no flipped copy of x exists.
//  * The train form is a template flag: each thread stores its gate's
//    activation, the H/2 cell threads tanh(c') and c', off the chain.
// wgmma, TMA and more than two blocks per chain are later work.

#include <cooperative_groups.h>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;

namespace {

// One cluster of two blocks per (batch row, direction): grid (2B, 2),
// blockDim.x == 2H.  Thread tid of block r owns gate q = tid / (H/2) of
// hidden unit k = r*H/2 + tid % (H/2), i.e. gate column q*H + k, and keeps
// that column of wh in registers.  TRAIN also stores cs and the residuals.
template <typename T, int H, bool TRAIN>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(2 * H, 1)
lstm_recur_kernel(const float* __restrict__ xg, const T* __restrict__ wh_f,
                  const T* __restrict__ wh_b, const int* __restrict__ lengths,
                  T* __restrict__ ys_f, T* __restrict__ ys_b,
                  float* __restrict__ cs_f, float* __restrict__ cs_b,
                  T* __restrict__ res_f, T* __restrict__ res_b, int Tn,
                  int B) {
  constexpr int G = 4 * H;
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
  const T* __restrict__ wh = dir ? wh_b : wh_f;
  T* __restrict__ ys = dir ? ys_b : ys_f;
  float* __restrict__ cs = dir ? cs_b : cs_f;
  T* __restrict__ res = dir ? res_b : res_f;
  float* peer_h = cluster.map_shared_rank(&h_s[0][0], r ^ 1);

  float w[H];
#pragma unroll
  for (int j = 0; j < H; ++j) w[j] = to_f(wh[(size_t)j * G + col]);
  (&h_s[0][0])[tid] = 0.0f;  // 2H threads, 2H floats
  const int len = lengths[b];
  const float* __restrict__ xg_d = xg + (size_t)dir * Tn * B * G;
  float xv_next = xg_d[((size_t)(dir ? Tn - 1 : 0) * B + b) * G + col];
  float c = 0.0f, hc = 0.0f;  // f32 carry of unit k (cell threads)
  cluster.sync();  // both blocks have started and zeroed h

  for (int s = 0; s < Tn; ++s) {
    const int t = dir ? Tn - 1 - s : s;
    const int cur = s & 1;
    const float xv = xv_next;
    if (s + 1 < Tn)
      xv_next = xg_d[((size_t)(dir ? Tn - 2 - s : s + 1) * B + b) * G + col];

    // hidden product, column col: four independent FMA chains
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
    const size_t row = (size_t)t * B + b;
    if (TRAIN) res[row * 5 * H + col] = from_f<T>(act);
    __syncthreads();

    // cell update of unit k, and the new h to both blocks
    if (tid < HH) {
      const float ig = act_s[u], fg = act_s[HH + u];
      const float gg = act_s[2 * HH + u], og = act_s[3 * HH + u];
      float cn = fg * c + ig * gg;
      const float tc = tanhf(cn);
      float hn = og * tc;
      if (dir && t >= len) {  // backward chain: frozen on padding
        cn = c;
        hn = hc;
      }
      c = cn;
      hc = hn;
      const T hq = from_f<T>(hn);
      ys[row * H + k] = hq;
      if (TRAIN) {
        res[row * 5 * H + 4 * H + k] = from_f<T>(tc);
        cs[row * H + k] = cn;
      }
      const float hv = to_f(hq);
      h_s[cur ^ 1][k] = hv;
      peer_h[(cur ^ 1) * H + k] = hv;
    }
    cluster.sync();
  }
}

template <typename T, int H>
cudaError_t launch_recur(const float* xg, const void* whf, const void* whb,
                         const int* lengths, void* ysf, void* ysb, float* csf,
                         float* csb, void* resf, void* resb, bool train,
                         int Tn, int B, cudaStream_t stream) {
  const dim3 grid(2 * B, 2);
  const T* wf = static_cast<const T*>(whf);
  const T* wb = static_cast<const T*>(whb);
  T* yf = static_cast<T*>(ysf);
  T* yb = static_cast<T*>(ysb);
  if (train)
    lstm_recur_kernel<T, H, true><<<grid, 2 * H, 0, stream>>>(
        xg, wf, wb, lengths, yf, yb, csf, csb, static_cast<T*>(resf),
        static_cast<T*>(resb), Tn, B);
  else
    lstm_recur_kernel<T, H, false><<<grid, 2 * H, 0, stream>>>(
        xg, wf, wb, lengths, yf, yb, nullptr, nullptr, nullptr, nullptr, Tn,
        B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_layer(const void* x, const void* wif, const void* wib,
                      const void* bf, const void* bb, const void* whf,
                      const void* whb, const int* lengths, void* ysf,
                      void* ysb, float* csf, float* csb, void* resf,
                      void* resb, float* xg, int Tn, int B, int W, int H,
                      bool train, cudaStream_t stream) {
  const cudaError_t err =
      launch_proj<T>(x, wif, wib, bf, bb, xg, Tn * B, W, 4 * H, stream);
  if (err != cudaSuccess) return err;
  switch (H) {
    case 16:
      return launch_recur<T, 16>(xg, whf, whb, lengths, ysf, ysb, csf, csb,
                                 resf, resb, train, Tn, B, stream);
    case 32:
      return launch_recur<T, 32>(xg, whf, whb, lengths, ysf, ysb, csf, csb,
                                 resf, resb, train, Tn, B, stream);
    case 64:
      return launch_recur<T, 64>(xg, whf, whb, lengths, ysf, ysb, csf, csb,
                                 resf, resb, train, Tn, B, stream);
    case 128:
      return launch_recur<T, 128>(xg, whf, whb, lengths, ysf, ysb, csf, csb,
                                  resf, resb, train, Tn, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors; bf and bb are the folded biases
// [4H]; xg is f32 scratch of 2*T*B*4H elements.  train != 0 selects the
// train form, which also writes csf, csb ([T, B, H] f32) and resf, resb
// ([T, B, 5H]); the eval form ignores them.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int lstm_bidir_fwd(int dtype, const void* x, const void* wif, const void* wib,
                   const void* bf, const void* bb, const void* whf,
                   const void* whb, const int* lengths, void* ysf, void* ysb,
                   float* csf, float* csb, void* resf, void* resb, float* xg,
                   int Tn, int B, int W, int H, int train, void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (train && (csf == nullptr || csb == nullptr || resf == nullptr ||
                resb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_layer<float>(x, wif, wib, bf, bb, whf, whb, lengths, ysf,
                                 ysb, csf, csb, resf, resb, xg, Tn, B, W, H,
                                 train != 0, s);
  if (dtype == 1)
    return (int)run_layer<__nv_bfloat16>(x, wif, wib, bf, bb, whf, whb,
                                         lengths, ysf, ysb, csf, csb, resf,
                                         resb, xg, Tn, B, W, H, train != 0, s);
  return (int)cudaErrorInvalidValue;
}

const char* lstm_bidir_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
