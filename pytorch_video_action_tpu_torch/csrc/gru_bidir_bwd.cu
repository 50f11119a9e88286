// One bidirectional GRU layer backward (the VJP of the train-form forward in
// csrc/gru_bidir_fwd.cu) for Hopper (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _bwd_kernel_split, reached through gru_bidir_fused_split's custom_vjp,
//   and its boundary form, reached through gru_bidir_fused_split_bnd's.
//
// Inputs, for x [T, B, W] time-major and per direction d in {fwd, bwd}:
// wi_d [W, 3H], wh_d [H, 3H], lengths [B], the forward's ys_d [T, B, H] and
// residuals res_d [T, B, 4H] = [r, z, n, hg_n] (original time order for both
// directions), and the output gradients dy_d [T, B, H].  Per chain step, in
// f32, with hp the previous state read from ys (ys_f[t-1] and ys_b[t+1],
// 0 past the ends):
//   dh = dy[t] + carry;  dz = dh * (hp - n)
//   dpre_n = dh * (1 - z) * (1 - n^2);  dpre_r = dpre_n * hg_n * r * (1 - r)
//   dpre_z = dz * z * (1 - z)
//   dxg = [dpre_r, dpre_z, dpre_n];  dhg = [dpre_r, dpre_z, dpre_n * r]
//   carry' = dh * z + dhg @ wh_d^T
// On the backward chain's padded steps (t >= lengths[b]) the forward froze
// the carry, so the gate gradients are 0 and the carry passes through.
// Then dwh_d = hp^T dhg, dbh_d = sum dhg, dwi_d = x^T dxg_d, dbi_d = sum dxg_d
// and dx = dxg_f @ wi_f^T + dxg_b @ wi_b^T (one f32 sum, cast to x's dtype).
// bf16: dhg and hp are rounded to the weight dtype before their products,
// dxg to the wi dtype for dx and to the x dtype for dwi; every sum is f32
// and the gradients are written in the weight dtype.
//
// What bounds it on an H100: at the bench shape (B=64, T=1024, H=128,
// W=400) the work is 4*T*B*3H*(2W + 2H) = 106 GFLOP and about 0.6 GB of
// traffic (0.2 ms).  Most of it, the weight and input gradients, is large
// products off the chain: 93 GFLOP, about 0.56 ms as 3xTF32 on the tensor
// cores and 0.09 ms in bf16.  The chain of T dependent steps holds only
// the [B, 3H] x [3H, H] carry product (13 GFLOP, 0.2 ms at the f32 SIMT
// peak of 67 TFLOP/s).
//
// What the design does about it:
//  * The chain runs one block per (batch row, direction), 3H threads,
//    walking t backwards.  Thread (g, k) keeps the H weights wh[k, gH ..
//    gH+H) of gate block g in registers for the whole layer (as the
//    forward keeps one column), so the 3H-deep contraction of output k is
//    split over three threads of H each, whose partials meet in shared
//    memory.  wh in shared memory instead (192 KB f32) would make a step
//    3H shared-memory loads a thread, the limit the forward's first,
//    shared-memory design ran into.  A step's inputs (residuals, dy, hp)
//    are loaded one step ahead, so their latency hides behind the current
//    step.
//  * The chain writes dxg and dhg ([2, T*B, 3H] f32 scratch) and per-row
//    bias sums; everything else runs off the chain on the tensor cores
//    (rnn_wgmma.cuh): dwi and dwh of both directions over K = T*B split
//    into slices whose f32 partials a second pass adds in order, and dx
//    over K = 6H.
//  * No atomics: each partial tile owns its slice, the slices and the bias
//    sums' per-row partials are added in a fixed order, so two runs give
//    bit-identical gradients.
//  * The fused-boundary form (gru_bidir_bnd_bwd) runs the same chain and
//    the same product kernels; their producer builds dwi's x operand from
//    the previous layer's halves as the forward did, and dx's store
//    applies the boundary's VJP (mask, and dropout's keep bit and scale)
//    and writes the two halves' gradients dxa and dxb directly
//    (rnn_common.cuh's Boundary and BoundaryStore).

#include "rnn_wgmma.cuh"

namespace {

// ------------------------------------------------------------- recurrence

// One chain step's inputs for thread k: the residuals, dy and hp.
struct StepIn {
  float r, z, n, hgn, dy, hp;
};

template <typename T, int H>
__device__ __forceinline__ StepIn load_step(const T* __restrict__ res,
                                            const T* __restrict__ dy,
                                            const T* __restrict__ ys, int t,
                                            int Tn, int B, int b, int dir,
                                            int k) {
  const size_t row = (size_t)t * B + b;
  const T* rs = res + row * 4 * H;
  StepIn in;
  in.r = to_f(rs[k]);
  in.z = to_f(rs[H + k]);
  in.n = to_f(rs[2 * H + k]);
  in.hgn = to_f(rs[3 * H + k]);
  in.dy = to_f(dy[row * H + k]);
  // previous state of the chain: t-1 forward, t+1 backward, 0 past the end
  const int tp = dir ? t + 1 : t - 1;
  in.hp =
      (tp >= 0 && tp < Tn) ? to_f(ys[((size_t)tp * B + b) * H + k]) : 0.0f;
  return in;
}

// One block per (batch row, direction); blockDim.x == 3H.  Thread tid =
// g*H + k holds wh[k, gH .. gH+H) in registers and forms gate block g's
// part of carry output k; threads k < H also own output k's carry, its
// gate math and its bias sums.
template <typename T, int H>
__global__ void __launch_bounds__(3 * H, 1)
bwd_recur_kernel(const T* __restrict__ wh_f, const T* __restrict__ wh_b,
                 const int* __restrict__ lengths, const T* __restrict__ ys_f,
                 const T* __restrict__ ys_b, const T* __restrict__ res_f,
                 const T* __restrict__ res_b, const T* __restrict__ dy_f,
                 const T* __restrict__ dy_b, float* __restrict__ dxg,
                 float* __restrict__ dhg, float* __restrict__ bias_part,
                 int Tn, int B) {
  constexpr int G = 3 * H;
  __shared__ __align__(16) float dhg_s[G];  // this step's dhg, rounded to T
  __shared__ float part_s[2][H];            // gate blocks z, n of the carry
  const int dir = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid / H;
  const int k = tid % H;
  const T* __restrict__ wh = dir ? wh_b : wh_f;
  const T* __restrict__ ys = dir ? ys_b : ys_f;
  const T* __restrict__ res = dir ? res_b : res_f;
  const T* __restrict__ dy = dir ? dy_b : dy_f;
  const size_t M = (size_t)Tn * B;
  float* __restrict__ dxg_d = dxg + dir * M * G;
  float* __restrict__ dhg_d = dhg + dir * M * G;

  float w[H];
#pragma unroll
  for (int j = 0; j < H; ++j) w[j] = to_f(wh[(size_t)k * G + g * H + j]);
  const int len = lengths[b];

  // the chain's VJP walks t = T-1 .. 0 forward, t = 0 .. T-1 backward
  float carry = 0.0f, sum_r = 0.0f, sum_z = 0.0f, sum_n = 0.0f,
        sum_hn = 0.0f;
  StepIn cur = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tid < H)
    cur = load_step<T, H>(res, dy, ys, dir ? 0 : Tn - 1, Tn, B, b, dir, k);
  for (int s = 0; s < Tn; ++s) {
    const int t = dir ? s : Tn - 1 - s;
    StepIn nxt = cur;
    float dh = 0.0f, z = 0.0f;
    bool valid = true;
    if (tid < H) {
      if (s + 1 < Tn)
        nxt = load_step<T, H>(res, dy, ys, dir ? s + 1 : Tn - 2 - s, Tn, B,
                              b, dir, k);
      z = cur.z;
      dh = cur.dy + carry;
      const float dz = dh * (cur.hp - cur.n);
      float dpn = dh * (1.0f - z) * (1.0f - cur.n * cur.n);
      float dpr = dpn * cur.hgn * cur.r * (1.0f - cur.r);
      float dpz = dz * z * (1.0f - z);
      valid = !(dir && t >= len);
      if (!valid) dpn = dpr = dpz = 0.0f;  // frozen step: no gate gradient
      const float dhn = dpn * cur.r;
      const size_t o = ((size_t)t * B + b) * G;
      dxg_d[o + k] = dpr;
      dxg_d[o + H + k] = dpz;
      dxg_d[o + 2 * H + k] = dpn;
      dhg_d[o + k] = dpr;
      dhg_d[o + H + k] = dpz;
      dhg_d[o + 2 * H + k] = dhn;
      sum_r += dpr;
      sum_z += dpz;
      sum_n += dpn;
      sum_hn += dhn;
      dhg_s[k] = rnd<T>(dpr);
      dhg_s[H + k] = rnd<T>(dpz);
      dhg_s[2 * H + k] = rnd<T>(dhn);
    }
    __syncthreads();

    // gate block g's part of (dhg @ wh^T)[k]: two independent FMA chains
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int j = 0; j < H; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&dhg_s[g * H + j]);
      a0 = fmaf(v.x, w[j], a0);
      a1 = fmaf(v.y, w[j + 1], a1);
      a0 = fmaf(v.z, w[j + 2], a0);
      a1 = fmaf(v.w, w[j + 3], a1);
    }
    if (g > 0) part_s[g - 1][k] = a0 + a1;
    __syncthreads();

    if (tid < H) {
      const float next = dh * z + ((a0 + a1) + part_s[0][k] + part_s[1][k]);
      carry = valid ? next : dh;
      cur = nxt;
    }
  }

  if (tid < H) {
    // bias_part [2 (bi, bh)][2 (dir)][B][G]
    float* pi = bias_part + ((size_t)dir * B + b) * G;
    float* ph = bias_part + ((size_t)(2 + dir) * B + b) * G;
    pi[k] = sum_r;
    pi[H + k] = sum_z;
    pi[2 * H + k] = sum_n;
    ph[k] = sum_r;
    ph[H + k] = sum_z;
    ph[2 * H + k] = sum_hn;
  }
}

template <typename T, int H>
cudaError_t launch_recur(const void* whf, const void* whb, const int* lengths,
                         const void* ysf, const void* ysb, const void* resf,
                         const void* resb, const void* dyf, const void* dyb,
                         float* dxg, float* dhg, float* bias_part, int Tn,
                         int B, cudaStream_t stream) {
  bwd_recur_kernel<T, H><<<dim3(B, 2), 3 * H, 0, stream>>>(
      static_cast<const T*>(whf), static_cast<const T*>(whb), lengths,
      static_cast<const T*>(ysf), static_cast<const T*>(ysb),
      static_cast<const T*>(resf), static_cast<const T*>(resb),
      static_cast<const T*>(dyf), static_cast<const T*>(dyb), dxg, dhg,
      bias_part, Tn, B);
  return cudaGetLastError();
}

// The chain (dxg, dhg and the bias sums) and the bias reduction.
template <typename T>
cudaError_t run_chain(const void* whf, const void* whb, const int* lengths,
                      const void* ysf, const void* ysb, const void* resf,
                      const void* resb, const void* dyf, const void* dyb,
                      void* dbif, void* dbib, void* dbhf, void* dbhb,
                      float* dxg, float* dhg, float* bias_part, int Tn, int B,
                      int H, cudaStream_t stream) {
  cudaError_t err;
  switch (H) {
    case 16:
      err = launch_recur<T, 16>(whf, whb, lengths, ysf, ysb, resf, resb, dyf,
                                dyb, dxg, dhg, bias_part, Tn, B, stream);
      break;
    case 32:
      err = launch_recur<T, 32>(whf, whb, lengths, ysf, ysb, resf, resb, dyf,
                                dyb, dxg, dhg, bias_part, Tn, B, stream);
      break;
    case 64:
      err = launch_recur<T, 64>(whf, whb, lengths, ysf, ysb, resf, resb, dyf,
                                dyb, dxg, dhg, bias_part, Tn, B, stream);
      break;
    case 128:
      err = launch_recur<T, 128>(whf, whb, lengths, ysf, ysb, resf, resb,
                                 dyf, dyb, dxg, dhg, bias_part, Tn, B,
                                 stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  const int G = 3 * H;
  // bias_part [2 (bi, bh)][2 (dir)][B][G]
  const BiasOuts<T> bias = {{static_cast<T*>(dbif), static_cast<T*>(dbib),
                             static_cast<T*>(dbhf), static_cast<T*>(dbhb)}};
  return launch_bias_reduce<T>(bias_part, bias, 4, B, G, stream);
}

template <typename T>
cudaError_t run_bwd(const void* x, const void* wif, const void* wib,
                    const void* whf, const void* whb, const int* lengths,
                    const void* ysf, const void* ysb, const void* resf,
                    const void* resb, const void* dyf, const void* dyb,
                    void* dx, void* dwif, void* dwib, void* dbif, void* dbib,
                    void* dwhf, void* dwhb, void* dbhf, void* dbhb,
                    float* dxg, float* dhg, float* bias_part,
                    float* wgrad_part, int slice_chunks, int Tn, int B,
                    int W, int H, cudaStream_t stream) {
  const cudaError_t err =
      run_chain<T>(whf, whb, lengths, ysf, ysb, resf, resb, dyf, dyb, dbif,
                   dbib, dbhf, dbhb, dxg, dhg, bias_part, Tn, B, H, stream);
  if (err != cudaSuccess) return err;
  return launch_wgmma_dense<T>(x, wif, wib, ysf, ysb, dxg, dhg, dx, dwif,
                               dwib, dwhf, dwhb, wgrad_part, slice_chunks,
                               false, Tn, B, W, H, 3 * H, stream);
}

// The fused-boundary form: the same chain, then the products with dwi read
// from the boundary the forward built and dx carried through its VJP into
// dxa and dxb.
template <typename T>
cudaError_t run_bwd_boundary(
    const void* xa, const void* xb, const void* wif, const void* wib,
    const void* whf, const void* whb, const int* lengths, const void* ysf,
    const void* ysb, const void* resf, const void* resb, const void* dyf,
    const void* dyb, void* dxa, void* dxb, void* dwif, void* dwib,
    void* dbif, void* dbib, void* dwhf, void* dwhb, void* dbhf, void* dbhb,
    float* dxg, float* dhg, float* bias_part, float* wgrad_part,
    int slice_chunks, int Tn, int B, int Hx, int H, uint32_t seed,
    uint32_t thresh, float scale, bool drop, cudaStream_t stream) {
  const cudaError_t err =
      run_chain<T>(whf, whb, lengths, ysf, ysb, resf, resb, dyf, dyb, dbif,
                   dbib, dbhf, dbhb, dxg, dhg, bias_part, Tn, B, H, stream);
  if (err != cudaSuccess) return err;
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
  return launch_wgmma_boundary<T>(bnd, wif, wib, ysf, ysb, dxg, dhg, dxa,
                                  dxb, dwif, dwib, dwhf, dwhb, wgrad_part,
                                  slice_chunks, Tn, B, H, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors: the inputs x, wif, wib, whf,
// whb, lengths, ysf, ysb, resf, resb, dyf, dyb; the outputs dx [T, B, W],
// dwif, dwib [W, 3H], dbif, dbib [3H], dwhf, dwhb [H, 3H], dbhf, dbhb [3H],
// all in the dtype; f32 scratch dxg and dhg of 2*T*B*3H elements each,
// bias_part of 4*B*3H and wgrad_part of ceil(ceil(T*B / 64) /
// slice_chunks) * 2*(W + H)*3H (the weight gradients' K slices of
// slice_chunks 64-row chunks).  Launches on `stream` and returns the first
// non-zero cudaGetLastError() (0 on success).
int gru_bidir_bwd(int dtype, const void* x, const void* wif, const void* wib,
                  const void* whf, const void* whb, const int* lengths,
                  const void* ysf, const void* ysb, const void* resf,
                  const void* resb, const void* dyf, const void* dyb,
                  void* dx, void* dwif, void* dwib, void* dbif, void* dbib,
                  void* dwhf, void* dwhb, void* dbhf, void* dbhb, float* dxg,
                  float* dhg, float* bias_part, float* wgrad_part,
                  int slice_chunks, int Tn, int B, int W, int H,
                  void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bwd<float>(x, wif, wib, whf, whb, lengths, ysf, ysb, resf,
                               resb, dyf, dyb, dx, dwif, dwib, dbif, dbib,
                               dwhf, dwhb, dbhf, dbhb, dxg, dhg, bias_part,
                               wgrad_part, slice_chunks, Tn, B, W, H, s);
  if (dtype == 1)
    return (int)run_bwd<__nv_bfloat16>(
        x, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb, dyf, dyb, dx,
        dwif, dwib, dbif, dbib, dwhf, dwhb, dbhf, dbhb, dxg, dhg, bias_part,
        wgrad_part, slice_chunks, Tn, B, W, H, s);
  return (int)cudaErrorInvalidValue;
}

// The fused-boundary form's backward (the VJP of gru_bidir_bnd_fwd's train
// form): xa, xb [T, B, Hx] in place of x and, in place of dx, dxa and dxb
// [T, B, Hx] through the boundary's VJP; seed, thresh, scale and drop as
// gru_bidir_bnd_fwd's.  Other arguments as gru_bidir_bwd's.
int gru_bidir_bnd_bwd(int dtype, const void* xa, const void* xb,
                      const void* wif, const void* wib, const void* whf,
                      const void* whb, const int* lengths, const void* ysf,
                      const void* ysb, const void* resf, const void* resb,
                      const void* dyf, const void* dyb, void* dxa, void* dxb,
                      void* dwif, void* dwib, void* dbif, void* dbib,
                      void* dwhf, void* dwhb, void* dbhf, void* dbhb,
                      float* dxg, float* dhg, float* bias_part,
                      float* wgrad_part, int slice_chunks, int Tn, int B,
                      int Hx, int H, unsigned int seed, unsigned int thresh,
                      float scale, int drop, void* stream) {
  if (Tn <= 0 || B <= 0 || Hx <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bwd_boundary<float>(
        xa, xb, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb, dyf, dyb,
        dxa, dxb, dwif, dwib, dbif, dbib, dwhf, dwhb, dbhf, dbhb, dxg, dhg,
        bias_part, wgrad_part, slice_chunks, Tn, B, Hx, H, seed, thresh,
        scale, drop != 0, s);
  if (dtype == 1)
    return (int)run_bwd_boundary<__nv_bfloat16>(
        xa, xb, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb, dyf, dyb,
        dxa, dxb, dwif, dwib, dbif, dbib, dwhf, dwhb, dbhf, dbhb, dxg, dhg,
        bias_part, wgrad_part, slice_chunks, Tn, B, Hx, H, seed, thresh,
        scale, drop != 0, s);
  return (int)cudaErrorInvalidValue;
}

const char* gru_bidir_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
