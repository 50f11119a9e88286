// One bidirectional GRU layer forward on the merged body, eval and train
// forms, for Hopper (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _fwd_kernel, reached through gru_bidir_fused (PVA_RNN_SPLIT=0):
//   train=False (eval form) and train=True (train form, from its
//   custom_vjp forward).
//
// Computes, for x [T, B, W] time-major, dense per-direction input weights
// wif2, wib2 [W, 3H], the gate-grouped bi2, bh2 [6H] and block-diagonal
// wh2 [2H, 6H] (columns [r_f r_b | z_f z_b | n_f n_b]) and lengths [B],
// the TPU kernel's one [B, 2H] chain over kernel steps s:
//   gx = [x_s @ wif2 | x_{T-1-s} @ wib2] (gate-grouped) + bi2
//   hg = h2 @ wh2 + bh2
//   r = sigmoid(gx_r + hg_r); z = sigmoid(gx_z + hg_z)
//   n = tanh(gx_n + r * hg_n); h2' = (1 - z) * n + z * h2
// with the backward half's carry frozen on its flipped-prefix padding
// (s < T - lengths[b]).  ys_f, ys_b [T, B, H] in original time order,
// unmasked.  Matmul inputs are the input dtype (f32 or bf16) with f32
// accumulation; the carry and gate math are f32; h is rounded to the
// weight dtype before the hidden product; ys is stored in the input dtype.
// The train form also writes res [T, B, 8H] = [r z n hg_n], each 2H wide
// and gate-grouped, in KERNEL order (row s: forward time s, backward time
// T-1-s), in the input dtype, for csrc/gru_merged_bwd.cu.
//
// Design: wh2 is block-diagonal (ops/rnn.py:_pack_gate_grouped), so the
// [B, 2H] x [2H, 6H] product is two independent direction chains, each a
// [B, H] x [H, 3H] product against wh2's diagonal block; the kernel reads
// only those blocks, and so relies on the zeros, where the TPU kernel
// multiplies them.  The two chains run on row 1's machinery
// (csrc/gru_bidir_fwd.cu), only the addressing differs:
//  * the input projection is the same tiled SIMT GEMM (rnn_common.cuh)
//    into xg [2, T*B, 3H] f32, run before the chain and without bias: as
//    on the TPU, bi2 is added on the chain, g_x = xg + bi2;
//  * one block per (batch row, direction), 3H threads; thread tid owns
//    direction dir's gate column tid, gate-grouped column q*2H + dir*H + j
//    (q = tid / H, j = tid % H), and keeps that column of wh2's diagonal
//    block, H floats, in registers for the whole layer;
//  * the H threads that update the carry store their unit's residuals at
//    kernel step s (the backward direction's step s is time T-1-s) and ys
//    at the step's original time.
// What bounds it on an H100 is what bounds row 1: the chain of T dependent
// steps, each a [B, H] x [H, 3H] product plus the gates, not the 53 GFLOP
// (bench shape) of work or its traffic.

#include "rnn_common.cuh"

namespace {

// One block per (batch row, direction); blockDim.x == 3H.  TRAIN also
// stores the kernel-order residuals.
template <typename T, int H, bool TRAIN>
__global__ void __launch_bounds__(3 * H, 1)
merged_recur_kernel(const float* __restrict__ xg, const T* __restrict__ bi2,
                    const T* __restrict__ wh2, const T* __restrict__ bh2,
                    const int* __restrict__ lengths, T* __restrict__ ys_f,
                    T* __restrict__ ys_b, T* __restrict__ res, int Tn,
                    int B) {
  constexpr int G = 3 * H;   // one direction's gate columns
  constexpr int G2 = 2 * G;  // gate-grouped width of wh2, bi2, bh2
  __shared__ __align__(16) float h_s[H];   // f32 carry
  __shared__ __align__(16) float hq_s[H];  // carry rounded to T
  __shared__ float hg_s[G];                // hidden gates
  const int dir = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int col2 = (tid / H) * 2 * H + dir * H + tid % H;
  T* __restrict__ ys = dir ? ys_b : ys_f;

  float w[H];  // column col2 of wh2's diagonal block of direction dir
#pragma unroll
  for (int k = 0; k < H; ++k)
    w[k] = to_f(wh2[(size_t)(dir * H + k) * G2 + col2]);
  const float bh_c = to_f(bh2[col2]);
  float bi_r = 0.0f, bi_z = 0.0f, bi_n = 0.0f;
  if (tid < H) {
    bi_r = to_f(bi2[dir * H + tid]);
    bi_z = to_f(bi2[2 * H + dir * H + tid]);
    bi_n = to_f(bi2[4 * H + dir * H + tid]);
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
      gr = g[tid] + bi_r;
      gz = g[H + tid] + bi_z;
      gn = g[2 * H + tid] + bi_n;
    }

    // hidden product, column col2: two independent FMA chains
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
      const float hgn = hg_s[2 * H + tid];
      const float n = tanhf(gn + r * hgn);
      const float hp = h_s[tid];
      float hn = (1.0f - z) * n + z * hp;
      if (dir && t >= len) hn = hp;  // backward half: frozen on padding
      const T hq = from_f<T>(hn);
      h_s[tid] = hn;
      hq_s[tid] = to_f(hq);
      ys[((size_t)t * B + b) * H + tid] = hq;
      if (TRAIN) {
        T* rs = res + ((size_t)s * B + b) * 8 * H + dir * H;
        rs[tid] = from_f<T>(r);
        rs[2 * H + tid] = from_f<T>(z);
        rs[4 * H + tid] = from_f<T>(n);
        rs[6 * H + tid] = from_f<T>(hgn);
      }
    }
    __syncthreads();
  }
}

template <typename T, int H>
cudaError_t launch_recur(const float* xg, const void* bi2, const void* wh2,
                         const void* bh2, const int* lengths, void* ysf,
                         void* ysb, void* res, bool train, int Tn, int B,
                         cudaStream_t stream) {
  const dim3 grid(B, 2);
  const T* bi = static_cast<const T*>(bi2);
  const T* wh = static_cast<const T*>(wh2);
  const T* bh = static_cast<const T*>(bh2);
  T* yf = static_cast<T*>(ysf);
  T* yb = static_cast<T*>(ysb);
  if (train)
    merged_recur_kernel<T, H, true><<<grid, 3 * H, 0, stream>>>(
        xg, bi, wh, bh, lengths, yf, yb, static_cast<T*>(res), Tn, B);
  else
    merged_recur_kernel<T, H, false><<<grid, 3 * H, 0, stream>>>(
        xg, bi, wh, bh, lengths, yf, yb, nullptr, Tn, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_layer(const void* x, const void* wif2, const void* wib2,
                      const void* bi2, const void* wh2, const void* bh2,
                      const int* lengths, void* ysf, void* ysb, void* res,
                      float* xg, int Tn, int B, int W, int H, bool train,
                      cudaStream_t stream) {
  const cudaError_t err = launch_proj<T>(x, wif2, wib2, nullptr, nullptr, xg,
                                         Tn * B, W, 3 * H, stream);
  if (err != cudaSuccess) return err;
  switch (H) {
    case 16:
      return launch_recur<T, 16>(xg, bi2, wh2, bh2, lengths, ysf, ysb, res,
                                 train, Tn, B, stream);
    case 32:
      return launch_recur<T, 32>(xg, bi2, wh2, bh2, lengths, ysf, ysb, res,
                                 train, Tn, B, stream);
    case 64:
      return launch_recur<T, 64>(xg, bi2, wh2, bh2, lengths, ysf, ysb, res,
                                 train, Tn, B, stream);
    case 128:
      return launch_recur<T, 128>(xg, bi2, wh2, bh2, lengths, ysf, ysb, res,
                                  train, Tn, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors: x [T, B, W], wif2, wib2
// [W, 3H], bi2 [6H], wh2 [2H, 6H], bh2 [6H], lengths [B] int32, the
// outputs ysf, ysb [T, B, H] and, for train != 0, res [T, B, 8H] (ignored
// by the eval form); xg is f32 scratch of 2*T*B*3H elements.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int gru_merged_fwd(int dtype, const void* x, const void* wif2,
                   const void* wib2, const void* bi2, const void* wh2,
                   const void* bh2, const int* lengths, void* ysf, void* ysb,
                   void* res, float* xg, int Tn, int B, int W, int H,
                   int train, void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (train && res == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_layer<float>(x, wif2, wib2, bi2, wh2, bh2, lengths, ysf,
                                 ysb, res, xg, Tn, B, W, H, train != 0, s);
  if (dtype == 1)
    return (int)run_layer<__nv_bfloat16>(x, wif2, wib2, bi2, wh2, bh2,
                                         lengths, ysf, ysb, res, xg, Tn, B, W,
                                         H, train != 0, s);
  return (int)cudaErrorInvalidValue;
}

const char* gru_merged_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
