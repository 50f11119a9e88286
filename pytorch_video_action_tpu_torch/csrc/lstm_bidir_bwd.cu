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
// What bounds it on an H100: at bilstm's training shape (B=8, T=1920,
// H=128, W=400) the work is 4*T*B*4H*(2W + 2H) = 33.2 GFLOP; the products
// off the chain (dwi, dx, dwh: 4*T*B*4H*(2W + H)) are 29.2 of it, about
// 0.18 ms as 3xTF32 on the tensor cores (0.03 ms in bf16), and the chain's
// carry product, the [B, 4H] x [4H, H] of each of T dependent steps, 4.0
// GFLOP, 0.06 ms at the f32 SIMT peak; about 0.2 GB of traffic (0.06 ms).
// The chain of T dependent steps binds.
//
// What the design does about it:
//  * The chain's contraction dgates @ wh^T is 4H = 512 deep per output: one
//    direction's wh is 256 KiB at f32 and H=128, more than one SM holds.  As
//    in the forward, each (batch row, direction) chain runs on a cluster of
//    two blocks.  Block r owns hidden units [r*H/2, (r+1)*H/2); a unit's
//    four lanes of one warp are its gate blocks g: lane g holds wh[k, gH ..
//    gH+H) in registers (128 floats at H=128), forms gate block g's part of
//    carry_h'[k] from the step's rounded gate gradients in shared memory,
//    and the four parts meet by shuffles, so every lane of the unit holds
//    carry_h.  Each lane then forms the unit's cell (dh, dc, the carry of
//    c: the same in its four lanes) and the gradient of its gate g.
//  * The exchange, as the LSTM scan's chains (scan_chain.cuh): each lane
//    sends its rounded gradient by st.async into its own block's and the
//    peer block's buffer for the next step, the stores completing their
//    bytes on that block's mbarrier, one a buffer; a block waits on its own
//    mbarrier (4H floats a step) and nothing else: no cluster barrier and
//    no block barrier a step.  The buffers are double, and a block writes
//    a buffer only after it has waited for the other one, which every lane
//    of both blocks sends to only after reading this one: safe one step
//    ahead.  The design before waited on one cluster barrier and one
//    block barrier a step, the parts meeting in shared memory (PERF.md
//    section 6 gives both designs' step split,
//    tools/torch_lstm_scan_steps.py --kernel 4).
//  * A step's inputs (residuals, c_prev, dy) are loaded into registers one
//    step ahead.  They are 2- or 4-byte values of a (row, unit) that its
//    four lanes share, which cp.async would copy only in groups across
//    units, into a ring read after a barrier; a prefetch into L2 some steps
//    ahead, as the scan chains do, made the step slower (PERF.md section 6).
//  * Each lane forms its gate's factors that do not wait on the carry
//    (o (1 - tanh_c^2) and, say, g i (1 - i)) before the step's wait, so
//    after the product only dh, dc and one product each remain: dc = dh *
//    f_o + carry_c, dgate = dc * f_g (dh * f_g for o).
//  * The chain writes dgates ([2, T*B, 4H] f32 scratch) and per-row bias
//    sums; everything else runs off the chain on the tensor cores
//    (rnn_wgmma.cuh, row 2's products at G = 4H): dwi and dwh of both
//    directions over K = T*B split into slices whose f32 partials a second
//    pass adds in order, and dx over K = 8H.  The accumulators do not
//    restart within a slice: at the bench shape (94 chunks a slice) the f32
//    gradients stand 4.75e-5 of the largest element from the plain
//    version's without it (PERF.md section 6), as row 2's do.
//  * No atomics: the slices and the bias sums' per-row partials are added
//    in a fixed order, so two runs give bit-identical gradients.

#include "rnn_wgmma.cuh"
#include "scan_chain.cuh"

namespace cg = cooperative_groups;

namespace {

// One chain step's inputs for unit k: the residuals, c_prev and dy.
struct StepIn {
  float i, f, g, o, tc, cp, dy;
};

// the chain's VJP walks t = T-1 .. 0 forward, t = 0 .. T-1 backward: the
// time of its step s
__device__ __forceinline__ int step_t(int s, int dir, int Tn) {
  return dir ? s : Tn - 1 - s;
}

// the previous cell state's time of the chain at t: t-1 forward, t+1
// backward
__device__ __forceinline__ int prev_t(int t, int dir) {
  return dir ? t + 1 : t - 1;
}

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
  // 0 past the ends
  const int tp = prev_t(t, dir);
  in.cp = (tp >= 0 && tp < Tn) ? cs[((size_t)tp * B + b) * H + k] : 0.0f;
  return in;
}

// One cluster of two blocks per (batch row, direction): grid (2B, 2),
// blockDim.x == 2H.  Lane l of warp v of block r is gate block g = l / 8
// of unit k = r*H/2 + 8v + l % 8: it holds wh[k, gH .. gH+H) and forms
// gate block g's part of carry_h'[k]; the unit's four lanes (l % 8, + 8,
// + 16, + 24) add their parts, each forms the unit's cell, and lane g the
// gradient of gate g and its bias sum.  A quarter warp's lanes share g, so
// each of the product's loads of dg_s is a broadcast in every quarter warp
// (PERF.md section 6 times a unit's four lanes side by side too).  dg_s
// [2][4][H + 4]: a step's 4H rounded gradients, gate g's in row g (padded:
// the quarters' rows fall on distinct banks).
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
  constexpr int LD = H + 4;
  constexpr uint32_t kBytes = 4u * G;  // a buffer's stores a step
  __shared__ __align__(16) float dg_s[2][4][LD];
  __shared__ __align__(8) uint64_t bars[2];
  const int r = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / 2;
  const int dir = blockIdx.y;
  const int tid = threadIdx.x;
  const int g = (tid % 32) / 8;
  const int k = r * HH + (tid / 32) * 8 + tid % 8;
  const T* __restrict__ wh = dir ? wh_b : wh_f;
  const float* __restrict__ cs = dir ? cs_b : cs_f;
  const T* __restrict__ res = dir ? res_b : res_f;
  const T* __restrict__ dy = dir ? dy_b : dy_f;
  float* __restrict__ dg_d = dg + (size_t)dir * Tn * B * G;

  float w[H];
#pragma unroll
  for (int j = 0; j < H; ++j) w[j] = to_f(wh[(size_t)k * G + g * H + j]);
  const int len = lengths[b];

  // buffer 0 holds the gradients before step 0: none
  for (int i = tid; i < 4 * LD; i += blockDim.x) (&dg_s[0][0][0])[i] = 0.0f;
  const uint32_t bar0 = rc::smem_u32(bars);
  const uint32_t slot0 = rc::smem_u32(&dg_s[0][0][0]);
  if (tid == 0) {
    rc::bar_init(bar0);
    rc::bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // buffer 1 receives the gradients of step 0, buffer 0 those of step 1
    if (Tn > 1) rc::bar_expect(bar0 + 8, kBytes);
    if (Tn > 2) rc::bar_expect(bar0, kBytes);
  }
  cg::this_cluster().sync();  // both blocks set up before any store

  StepIn cur =
      load_step<T, H>(res, cs, dy, step_t(0, dir, Tn), Tn, B, b, dir, k);
  float carry_c = 0.0f, dh_prev = 0.0f, sum = 0.0f;
  bool valid_prev = true;

  for (int s = 0; s < Tn; ++s) {
    const int t = step_t(s, dir, Tn);
    const int cb = s & 1;
    StepIn nxt = cur;
    if (s + 1 < Tn)
      nxt = load_step<T, H>(res, cs, dy, step_t(s + 1, dir, Tn), Tn, B, b,
                            dir, k);
    // the step's gate factors, which do not wait on the carry
    const float fo = cur.o * (1.0f - cur.tc * cur.tc);
    const float fg = g == 0   ? cur.g * cur.i * (1.0f - cur.i)
                     : g == 1 ? cur.cp * cur.f * (1.0f - cur.f)
                     : g == 2 ? cur.i * (1.0f - cur.g * cur.g)
                              : cur.tc * cur.o * (1.0f - cur.o);
    if (s > 0) {
      rc::bar_wait(bar0 + 8 * cb, ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 2 < Tn) rc::bar_expect(bar0 + 8 * cb, kBytes);
    }

    // gate block g's part of (dgates of the step before @ wh^T)[k]: four
    // independent FMA chains; the unit's four parts added by shuffles
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int j = 0; j < H; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&dg_s[cb][g][j]);
      a0 = fmaf(v.x, w[j], a0);
      a1 = fmaf(v.y, w[j + 1], a1);
      a2 = fmaf(v.z, w[j + 2], a2);
      a3 = fmaf(v.w, w[j + 3], a3);
    }
    float part = (a0 + a1) + (a2 + a3);
    part += __shfl_xor_sync(0xffffffffu, part, 8);
    part += __shfl_xor_sync(0xffffffffu, part, 16);

    // a frozen step (the backward chain's t >= lengths[b]) has no gate
    // gradient, and the carries pass dh and dc through
    const float dh = cur.dy + (valid_prev ? part : dh_prev);
    const float dc = fmaf(dh, fo, carry_c);
    const bool valid = !(dir && t >= len);
    const float d = valid ? (g == 3 ? dh : dc) * fg : 0.0f;
    carry_c = valid ? dc * cur.f : dc;
    dh_prev = dh;
    valid_prev = valid;

    // the rounded gradient into both blocks' next buffer, then dgates
    if (s + 1 < Tn) {
      const int nb = cb ^ 1;
      const uint32_t slot = slot0 + 4u * (uint32_t)((nb * 4 + g) * LD + k);
      const float v = rnd<T>(d);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        rc::send_h(rc::peer_u32(slot, q), v, rc::peer_u32(bar0 + 8 * nb, q));
    }
    dg_d[((size_t)t * B + b) * G + g * H + k] = d;
    sum += d;
    cur = nxt;
  }

  // bias_part [2 (dir)][B][G]
  bias_part[((size_t)dir * B + b) * G + g * H + k] = sum;
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
                    float* dg, float* bias_part, float* wgrad_part,
                    int slice_chunks, int Tn, int B, int W, int H,
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
  return launch_wgmma_dense<T>(x, wif, wib, ysf, ysb, dg, dg, dx, dwif, dwib,
                               dwhf, dwhb, wgrad_part, slice_chunks, false, Tn,
                               B, W, H, G, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; H one of 16, 32, 64, 128.  All pointers
// are device pointers of contiguous tensors: the inputs x, wif, wib, whf,
// whb, lengths, ysf, ysb, csf and csb (f32), resf, resb, dyf, dyb; the
// outputs dx [T, B, W], dwif, dwib [W, 4H], dbf, dbb [4H] (the folded
// biases), dwhf, dwhb [H, 4H], in the dtype; f32 scratch dg of 2*T*B*4H
// elements, bias_part of 2*B*4H and wgrad_part of ceil(ceil(T*B / 64) /
// slice_chunks) * 2*(W + H)*4H (the weight gradients' K slices of
// slice_chunks 64-row chunks).  Launches on `stream` and returns the first
// non-zero cudaGetLastError() (0 on success).
int lstm_bidir_bwd(int dtype, const void* x, const void* wif, const void* wib,
                   const void* whf, const void* whb, const int* lengths,
                   const void* ysf, const void* ysb, const float* csf,
                   const float* csb, const void* resf, const void* resb,
                   const void* dyf, const void* dyb, void* dx, void* dwif,
                   void* dwib, void* dbf, void* dbb, void* dwhf, void* dwhb,
                   float* dg, float* bias_part, float* wgrad_part,
                   int slice_chunks, int Tn, int B, int W, int H,
                   void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bwd<float>(x, wif, wib, whf, whb, lengths, ysf, ysb, csf,
                               csb, resf, resb, dyf, dyb, dx, dwif, dwib, dbf,
                               dbb, dwhf, dwhb, dg, bias_part, wgrad_part,
                               slice_chunks, Tn, B, W, H, s);
  if (dtype == 1)
    return (int)run_bwd<__nv_bfloat16>(
        x, wif, wib, whf, whb, lengths, ysf, ysb, csf, csb, resf, resb, dyf,
        dyb, dx, dwif, dwib, dbf, dbb, dwhf, dwhb, dg, bias_part, wgrad_part,
        slice_chunks, Tn, B, W, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* lstm_bidir_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
