// One bidirectional GRU layer backward on the merged body (the VJP of the
// train-form forward gru_merged_fwd in csrc/gru_bidir_fwd.cu) for Hopper
// (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _bwd_kernel, reached through gru_bidir_fused's custom_vjp
//   (PVA_RNN_SPLIT=0).
//
// Inputs, for x [T, B, W] time-major: the forward's kernel-order residuals
// res [T, B, 8H] = [r z n hg_n] (each 2H wide, gate-grouped), the
// kernel-order previous state hp2 [T, B, 2H] (row s: [ys_f[s-1],
// ys_b[T-s]], 0 at s = 0; built by the caller), the output gradients
// dyf, dyb [T, B, H] in original time order, the dense wif2, wib2
// [W, 3H], the gate-grouped block-diagonal wh2 [2H, 6H] and lengths [B].
// Per kernel step s = T-1 .. 0, in f32, as JAX's _bwd_kernel:
//   dh = [dyf[s], dyb[T-1-s]] + carry;  dz = dh * (hp - n)
//   dpre_n = dh * (1 - z) * (1 - n^2);  dpre_r = dpre_n * hg_n * r (1 - r)
//   dpre_z = dz * z * (1 - z)
//   dxg = [dpre_r, dpre_z, dpre_n];  dhg2 = [dpre_r, dpre_z, dpre_n * r]
//   carry' = dh * z + dhg2 @ wh2^T
// On the backward half's frozen steps (s < T - lengths[b]) the gate
// gradients are 0 and the carry passes dh through.  Then dwh2 = hp2^T
// dhg2 (the whole [2H, 6H], off-diagonal blocks included, as the TPU
// kernel accumulates it), dbh2 = sum dhg2, dbi2 = sum dxg, dwi_d = x^T
// dxg_d, and dx_f, dx_b = dxg_d @ wi_d^T apart, each cast to x's dtype
// (the caller sums them).  bf16: dhg2 and hp2 are rounded to the weight
// dtype before their products, dxg to the wi dtype for dx and to the x
// dtype for dwi; every sum is f32; the gradients are written in the
// weight dtype.
//
// Design: wh2 is block-diagonal, so the carry product is two direction
// chains, each against wh2's diagonal block (the TPU kernel relies on the
// zeros too: its frozen lanes' dh passes through because the off-diagonal
// blocks give them nothing).  The chain is row 2's
// (csrc/gru_bidir_bwd.cu) with the merged layouts' addressing: one block
// per (batch row, direction), 3H threads; thread (g, k) keeps wh2[dir*H +
// k, g*2H + dir*H .. +H) in registers; both chains walk the kernel steps
// from T-1 down, so at iteration i each reads and writes kernel row
// T-1-i; a step's inputs are loaded one step ahead.  The chain writes
// each gate gradient where its product reads it: dxg [2, T*B, 3H] f32,
// dense per direction in original time order (row 2's layout, for dwi and
// dx), and dhg2 [T*B, 6H] f32 in kernel order, gate-grouped (the rows of
// hp2, for dwh2), plus per-row bias sums.  The products then run off the
// chain on the tensor cores (rnn_wgmma.cuh's launch_wgmma_merged, row 2's
// producer ring and wgmma products): dwif, dwib and dwh2's two column
// halves as the four problems of one launch over K = T*B, in slices whose
// f32 partials a second pass adds in order (the depth from
// ops/rnn_fused.py::wgrad_slice_chunks), the accumulators restarted every
// 8 chunks; then dx_f and dx_b apart, one launch.  Before, the products
// ran on rnn_common.cuh's SIMT GEMMs, about 2.6 of 3.92 ms at B=8,
// T=1920, W=400 (PERF.md section 6).  No atomics: two runs give
// bit-identical gradients.  What bounds it is row 2's: the chain of T
// dependent steps, then the products (dwh2 is twice row 2's two dwh
// products: the off-diagonal half is computed too).

#include "rnn_wgmma.cuh"

namespace {

// One chain step's inputs for thread k: the residuals, dy and hp.
struct StepIn {
  float r, z, n, hgn, dy, hp;
};

// the inputs of kernel row ks (time t of direction dir)
template <typename T, int H>
__device__ __forceinline__ StepIn load_step(const T* __restrict__ res,
                                            const T* __restrict__ hp2,
                                            const T* __restrict__ dy, int ks,
                                            int t, int B, int b, int dir,
                                            int k) {
  const size_t row = (size_t)ks * B + b;
  const T* rs = res + row * 8 * H + dir * H;
  StepIn in;
  in.r = to_f(rs[k]);
  in.z = to_f(rs[2 * H + k]);
  in.n = to_f(rs[4 * H + k]);
  in.hgn = to_f(rs[6 * H + k]);
  in.dy = to_f(dy[((size_t)t * B + b) * H + k]);
  in.hp = to_f(hp2[row * 2 * H + dir * H + k]);
  return in;
}

// One block per (batch row, direction); blockDim.x == 3H.  Thread tid =
// g*H + k holds row k of gate block g of wh2's diagonal block and forms
// gate block g's part of carry output k; threads k < H also own output
// k's carry, its gate math and its bias sums.
template <typename T, int H>
__global__ void __launch_bounds__(3 * H, 1)
merged_bwd_recur_kernel(const T* __restrict__ wh2,
                        const int* __restrict__ lengths,
                        const T* __restrict__ res, const T* __restrict__ hp2,
                        const T* __restrict__ dy_f,
                        const T* __restrict__ dy_b, float* __restrict__ dxg,
                        float* __restrict__ dhg2,
                        float* __restrict__ bias_part, int Tn, int B) {
  constexpr int G2 = 6 * H;
  __shared__ __align__(16) float dhg_s[3 * H];  // this step's dhg, rounded
  __shared__ float part_s[2][H];                // gate blocks z, n
  const int dir = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid / H;
  const int k = tid % H;
  const T* __restrict__ dy = dir ? dy_b : dy_f;
  float* __restrict__ dxg_d = dxg + (size_t)dir * Tn * B * 3 * H;

  float w[H];
#pragma unroll
  for (int j = 0; j < H; ++j)
    w[j] = to_f(wh2[(size_t)(dir * H + k) * G2 + g * 2 * H + dir * H + j]);
  const int len = lengths[b];

  // iteration i walks kernel row T-1-i: time T-1-i forward, i backward
  float carry = 0.0f, sum_r = 0.0f, sum_z = 0.0f, sum_n = 0.0f,
        sum_hn = 0.0f;
  StepIn cur = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tid < H)
    cur = load_step<T, H>(res, hp2, dy, Tn - 1, dir ? 0 : Tn - 1, B, b, dir,
                          k);
  for (int i = 0; i < Tn; ++i) {
    const int ks = Tn - 1 - i;
    const int t = dir ? i : ks;
    StepIn nxt = cur;
    float dh = 0.0f, z = 0.0f;
    bool valid = true;
    if (tid < H) {
      if (i + 1 < Tn)
        nxt = load_step<T, H>(res, hp2, dy, ks - 1, dir ? i + 1 : ks - 1, B,
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
      const size_t ot = ((size_t)t * B + b) * 3 * H;  // time order, dense
      dxg_d[ot + k] = dpr;
      dxg_d[ot + H + k] = dpz;
      dxg_d[ot + 2 * H + k] = dpn;
      const size_t ok = ((size_t)ks * B + b) * G2 + dir * H;  // kernel order
      dhg2[ok + k] = dpr;
      dhg2[ok + 2 * H + k] = dpz;
      dhg2[ok + 4 * H + k] = dhn;
      sum_r += dpr;
      sum_z += dpz;
      sum_n += dpn;
      sum_hn += dhn;
      dhg_s[k] = rnd<T>(dpr);
      dhg_s[H + k] = rnd<T>(dpz);
      dhg_s[2 * H + k] = rnd<T>(dhn);
    }
    __syncthreads();

    // gate block g's part of (dhg @ wh_d^T)[k]: two independent FMA chains
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
    // bias_part [2 (bi2, bh2)][B][6H], each block its direction's columns
    float* pi = bias_part + (size_t)b * G2 + dir * H;
    float* ph = bias_part + ((size_t)B + b) * G2 + dir * H;
    pi[k] = sum_r;
    pi[2 * H + k] = sum_z;
    pi[4 * H + k] = sum_n;
    ph[k] = sum_r;
    ph[2 * H + k] = sum_z;
    ph[4 * H + k] = sum_hn;
  }
}

template <typename T, int H>
cudaError_t launch_recur(const void* wh2, const int* lengths, const void* res,
                         const void* hp2, const void* dyf, const void* dyb,
                         float* dxg, float* dhg2, float* bias_part, int Tn,
                         int B, cudaStream_t stream) {
  merged_bwd_recur_kernel<T, H><<<dim3(B, 2), 3 * H, 0, stream>>>(
      static_cast<const T*>(wh2), lengths, static_cast<const T*>(res),
      static_cast<const T*>(hp2), static_cast<const T*>(dyf),
      static_cast<const T*>(dyb), dxg, dhg2, bias_part, Tn, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd(const void* x, const void* res, const void* hp2,
                    const void* dyf, const void* dyb, const void* wif2,
                    const void* wib2, const void* wh2, const int* lengths,
                    void* dxf, void* dxb, void* dwif, void* dwib, void* dbi2,
                    void* dwh2, void* dbh2, float* dxg, float* dhg2,
                    float* bias_part, float* wgrad_part, int slice_chunks,
                    int Tn, int B, int W, int H, cudaStream_t stream) {
  cudaError_t err;
  switch (H) {
    case 16:
      err = launch_recur<T, 16>(wh2, lengths, res, hp2, dyf, dyb, dxg, dhg2,
                                bias_part, Tn, B, stream);
      break;
    case 32:
      err = launch_recur<T, 32>(wh2, lengths, res, hp2, dyf, dyb, dxg, dhg2,
                                bias_part, Tn, B, stream);
      break;
    case 64:
      err = launch_recur<T, 64>(wh2, lengths, res, hp2, dyf, dyb, dxg, dhg2,
                                bias_part, Tn, B, stream);
      break;
    case 128:
      err = launch_recur<T, 128>(wh2, lengths, res, hp2, dyf, dyb, dxg,
                                 dhg2, bias_part, Tn, B, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  const BiasOuts<T> bias = {{static_cast<T*>(dbi2), static_cast<T*>(dbh2),
                             nullptr, nullptr}};
  err = launch_bias_reduce<T>(bias_part, bias, 2, B, 6 * H, stream);
  if (err != cudaSuccess) return err;
  return launch_wgmma_merged<T>(x, wif2, wib2, hp2, dxg, dhg2, dxf, dxb,
                                dwif, dwib, dwh2, wgrad_part, slice_chunks,
                                true, Tn, B, W, H, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors: the inputs x, res, hp2, dyf,
// dyb, wif2, wib2, wh2, lengths; the outputs dxf, dxb [T, B, W], dwif,
// dwib [W, 3H], dbi2 [6H], dwh2 [2H, 6H], dbh2 [6H], all in the dtype; f32
// scratch dxg [2, T*B, 3H] and dhg2 [T*B, 6H], bias_part of 2*B*6H and
// wgrad_part of ceil(ceil(T*B / 64) / slice_chunks) * 2*(W + 2H)*3H (the
// weight gradients' K slices of slice_chunks 64-row chunks).  Launches on
// `stream` and returns the first non-zero cudaGetLastError() (0 on
// success).
int gru_merged_bwd(int dtype, const void* x, const void* res,
                   const void* hp2, const void* dyf, const void* dyb,
                   const void* wif2, const void* wib2, const void* wh2,
                   const int* lengths, void* dxf, void* dxb, void* dwif,
                   void* dwib, void* dbi2, void* dwh2, void* dbh2,
                   float* dxg, float* dhg2, float* bias_part,
                   float* wgrad_part, int slice_chunks, int Tn, int B, int W,
                   int H, void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bwd<float>(x, res, hp2, dyf, dyb, wif2, wib2, wh2,
                               lengths, dxf, dxb, dwif, dwib, dbi2, dwh2,
                               dbh2, dxg, dhg2, bias_part, wgrad_part,
                               slice_chunks, Tn, B, W, H, s);
  if (dtype == 1)
    return (int)run_bwd<__nv_bfloat16>(
        x, res, hp2, dyf, dyb, wif2, wib2, wh2, lengths, dxf, dxb, dwif,
        dwib, dbi2, dwh2, dbh2, dxg, dhg2, bias_part, wgrad_part,
        slice_chunks, Tn, B, W, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* gru_merged_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
