// One bidirectional LSTM layer forward, eval and train forms, for Hopper
// (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _lstm_fwd_kernel_split, reached through lstm_bidir_fused_split:
//   train=False (eval form) and train=True (train form, from its custom_vjp
//   forward); and _lstm_fwd_kernel, the merged body's forward, reached
//   through lstm_bidir_fused (PVA_RNN_SPLIT=0; eval and train forms):
//   lstm_merged_fwd, below.
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
//  * One direction's wh is H x 4H = 128 x 512 f32 = 256 KiB at H=128, the
//    whole register file of an SM and more than the 227 KiB of shared
//    memory a block may have.  So each (batch row, direction) chain runs on
//    a thread-block cluster of two blocks on two SMs, as the layer's
//    backward (csrc/lstm_bidir_bwd.cu) does.  Block r owns hidden units
//    [r*H/2, (r+1)*H/2); a unit's four gate lanes sit in one warp, a
//    quarter warp apart, in two pairs (i and f, g and o).  A lane keeps
//    half the depth of its pair's two columns of wh in registers (128
//    floats at H=128), so each broadcast load of h from shared memory
//    feeds eight FMAs, as in the GRU layer's forward (csrc/gru_bidir_fwd.cu);
//    one shuffle adds the halves, and lane g then holds gate g's
//    pre-activation and forms its activation (sigmoid, or tanh for g).
//    The four activations meet by shuffles, and every lane of the unit
//    forms the cell, c' = f c + i g and h' = o tanh c', the same in its
//    four lanes.
//  * The exchange, as the backward's (scan_chain.cuh): lane 0 of a unit
//    sends its rounded h' by st.async into block 0's buffer of the next
//    step, lane 1 into block 1's, each store completing its bytes on that
//    block's mbarrier, one a buffer; a block waits on its own mbarrier (H
//    floats a step) and nothing else: no cluster barrier and no block
//    barrier a step.  The buffers are double, so a block writes one a step
//    ahead: at step s into the buffer step s - 1 read.  Before that it has
//    waited, at step s, for the h' that every warp of both blocks sent at
//    step s - 1 (every warp holds sending lanes), and a warp sends only
//    after the shuffles that need all its lanes' products of step s - 1:
//    no lane still reads the buffer it overwrites.  The first cluster
//    barrier starts the exchange after both blocks set up their
//    mbarriers; the last keeps a block from exiting while its peer still
//    sends into it.
//  * Each lane loads its column's xg one step ahead into a register.  On
//    an H100 that was faster than cp.async into shared memory three steps
//    ahead (0.72 against 0.75 us a step at B=3, T=1280; 0.92 against 0.96
//    at B=8, T=1920, where xg, 63 MB, is more than the L2 holds); a load
//    two steps ahead gained 1-2 %, within the spread between runs.
//  * The step, taken apart (tools/torch_lstm_scan_steps.py --kernel 3, us
//    a step in f32, as is / without the product / the gate math / the
//    exchange / all three): 0.72 / 0.50 / 0.55 / 0.59 / 0.30 at B=3,
//    T=1280 and 0.92 / 0.71 / 0.77 / 0.83 / 0.63 at B=8, T=1920.  The
//    design before, one column of wh a lane, the four gates meeting in
//    shared memory after a block barrier and h published through
//    distributed shared memory with a cluster barrier a step, took 1.19 and
//    1.35, of which the barriers 0.65 and 0.64 (PERF.md section 6).
//  * The backward direction reads xg at T-1-s; no flipped copy of x exists.
//  * The train form is a template flag: each lane stores its gate's
//    activation, lane 2 of a unit ys, lane 3 tanh(c') and c', off the chain;
//    the eval form compiles without them.
//  * The merged body (lstm_merged_fwd, row 7) is the TPU kernel's one
//    [B, 2H] chain over kernel steps s with dense per-direction input
//    weights wif2, wib2 [W, 4H], the gate-grouped bi2 [8H] (both biases
//    folded) and the block-diagonal wh2 [2H, 8H] (columns [i_f i_b | f_f
//    f_b | g_f g_b | o_f o_b]): a = ([x_s @ wif2 | x_{T-1-s} @ wib2] + bi2)
//    + h2 @ wh2, the backward half frozen on its flipped-prefix padding (s
//    < T - lengths[b], t >= lengths[b] above).  wh2 is block-diagonal
//    (ops/rnn.py:_pack_gate_grouped), so the product is the two direction
//    chains above, each against its diagonal block; the recurrence reads
//    only those blocks (it relies on the zeros, which the TPU kernel
//    multiplies).  It is the same recurrence with another addressing
//    (MergedAddr, as row 5 runs row 1's in gru_bidir_fwd.cu): wh2's column
//    q*2H + dir*H + k, bi2 added on the chain (the projection runs without
//    bias, as on the TPU), and, in the train form, in kernel order (row s:
//    forward time s, backward time T-1-s) and in the input dtype, res
//    [T, B, 10H] = [i f g o tanh c'], each 2H wide and gate-grouped, and
//    cs [T, B, 2H], for csrc/lstm_merged_bwd.cu.  xg + bi2 is the sum the
//    projection forms with the folded bias, so on the same weights its ys
//    equal the split layer's bit for bit.  The split form (SplitAddr) keeps
//    the recurrence's own offsets under if constexpr and compiles to the
//    instructions it had before (tools/torch_sass.py --other).  The merged
//    body's first design, one column of wh2's diagonal block a thread, the
//    gates meeting in shared memory after a block barrier and h published
//    through distributed shared memory with a cluster barrier a step, took
//    1.20 and 1.34 us a step at the serving and training shapes in f32
//    (1.5377 and 2.5636 ms a call), of which the exchange and barriers
//    0.66 and 0.62 (tools/torch_lstm_scan_steps.py --kernel 7, PERF.md
//    section 6).  On this recurrence it takes 0.71 / 0.49 / 0.55 / 0.60 /
//    0.30 us a step (as is / without the product / the gate math / the
//    exchange / all three) at the serving shape and 0.97 / 0.71 / 0.77 /
//    0.85 / 0.63 at the training shape, f32: 0.9086 and 1.8545 ms a call.
// wgmma, TMA and more than two blocks per chain are later work.

#include <type_traits>

#include "rnn_common.cuh"
#include "scan_chain.cuh"

namespace cg = cooperative_groups;

namespace {

// Where the recurrence finds a direction's weights, bias and outputs.  The
// split layer (row 3): per-direction wh_d [H, 4H], the folded bias already
// in xg, cs_d [T, B, H] f32 and res_d [T, B, 5H] at time t (the
// recurrence's own offsets, so that this form compiles to the instructions
// it had before it took an addressing).
template <int H>
struct SplitAddr {
  static constexpr bool kMerged = false;
  __device__ static int vec(int dir, int col) { return col; }
};

// The merged body (row 7, PVA_RNN_SPLIT=0): the gate-grouped wh2 [2H, 8H],
// of which the recurrence reads direction dir's diagonal block (rows dir*H
// + d, columns q*2H + dir*H + k), bi2 [8H] added on the chain, and res
// [T, B, 10H] and cs [T, B, 2H] in the input dtype in kernel order (row s:
// forward time s, backward time T-1-s); a column col of the split layout
// (q = 4: tanh c') is at vec(dir, col) in a row of res.
template <int H>
struct MergedAddr {
  static constexpr bool kMerged = true;
  __device__ static int vec(int dir, int col) {
    return (col / H) * 2 * H + dir * H + col % H;
  }
  __device__ static int wh(int dir, int d, int col) {
    return (dir * H + d) * 8 * H + vec(dir, col);
  }
};

// The cell states' dtype: f32 for the split layer's backward, the input
// dtype for the merged body's.
template <typename T, typename A>
using CsT = std::conditional_t<A::kMerged, T, float>;

// One cluster of two blocks per (batch row, direction): grid (2B, 2),
// blockDim.x == 2H.  Lane l of warp v of block r is gate g = l / 8 of unit
// k = r*H/2 + 8v + l % 8, gate column g*H + k.  The unit's lanes g and g ^ 1
// are a pair: gates i and f, or g and o.  Lane g keeps half hf = g % 2 of
// the depth, H/2 deep, of both of its pair's columns in registers, so a
// broadcast load of h feeds eight FMAs; one shuffle adds the halves, and
// lane g then owns column g.  h_s [2][2 (H/2 + 4)]: a step's rounded h,
// double-buffered, its second half 16 bytes further on in banks than the
// first, so a warp's two halves' loads do not conflict.  TRAIN also stores
// cs and the residuals.  A (SplitAddr or MergedAddr) places the weights,
// the bias (bi only with the merged body's) and the train form's outputs;
// the arithmetic is the same.
template <typename T, int H, bool TRAIN, typename A>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(2 * H, 1)
lstm_recur_kernel(const float* __restrict__ xg, const T* __restrict__ wh_f,
                  const T* __restrict__ wh_b, const T* __restrict__ bi,
                  const int* __restrict__ lengths, T* __restrict__ ys_f,
                  T* __restrict__ ys_b, CsT<T, A>* __restrict__ cs_f,
                  CsT<T, A>* __restrict__ cs_b, T* __restrict__ res_f,
                  T* __restrict__ res_b, int Tn, int B) {
  constexpr int G = 4 * H;
  constexpr int HH = H / 2;  // units a block
  constexpr int D = H / 2;   // depth of a lane's half
  constexpr uint32_t kBytes = 4u * H;  // a buffer's stores a step
  __shared__ __align__(16) float h_s[2][2 * (D + 4)];
  __shared__ __align__(8) uint64_t bars[2];
  const int r = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / 2;
  const int dir = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 8;
  const int k = r * HH + (tid / 32) * 8 + lane % 8;
  const int col = g * H + k;
  const T* __restrict__ wh = dir ? wh_b : wh_f;
  T* __restrict__ ys = dir ? ys_b : ys_f;
  CsT<T, A>* __restrict__ cs = dir ? cs_b : cs_f;
  T* __restrict__ res = dir ? res_b : res_f;

  const int hf = g % 2;
  const int pcol = (g - hf) * H + k;  // the pair's first column
  float w[2][D];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if constexpr (A::kMerged)
        w[j][d] = to_f(wh[A::wh(dir, hf * D + d, pcol + j * H)]);
      else
        w[j][d] = to_f(wh[(size_t)(hf * D + d) * G + pcol + j * H]);
    }
  // the merged body's bias, and its train form's outputs of row b at step
  // 0 (this lane's column of res; lane 3's tanh c' and c'), a step B rows
  // on
  const float bias = A::kMerged ? to_f(bi[A::vec(dir, col)]) : 0.0f;
  T* const mres =
      A::kMerged && TRAIN ? res + (size_t)b * 10 * H + A::vec(dir, col)
                          : nullptr;
  T* const mtc = A::kMerged && TRAIN
                     ? res + (size_t)b * 10 * H + 8 * H + dir * H + k
                     : nullptr;
  CsT<T, A>* const mcs =
      A::kMerged && TRAIN ? cs + (size_t)b * 2 * H + dir * H + k : nullptr;
  const int hslot = (k / D) * (D + 4) + k % D;  // the unit's place in h_s
  const int len = lengths[b];

  // buffer 0 holds h before step 0: 0
  if (tid < 2 * (D + 4)) h_s[0][tid] = 0.0f;
  const uint32_t bar0 = rc::smem_u32(bars);
  const uint32_t slot0 = rc::smem_u32(&h_s[0][0]);
  if (tid == 0) {
    rc::bar_init(bar0);
    rc::bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // buffer 1 receives the h of step 0, buffer 0 that of step 1
    if (Tn > 1) rc::bar_expect(bar0 + 8, kBytes);
    if (Tn > 2) rc::bar_expect(bar0, kBytes);
  }

  // this lane's column of xg, loaded one step ahead (the backward chain
  // walks t = T-1 .. 0)
  const ptrdiff_t step = dir ? -(ptrdiff_t)B * G : (ptrdiff_t)B * G;
  const float* xnext = xg + (size_t)dir * Tn * B * G + (size_t)b * G + col +
                       (dir ? (size_t)(Tn - 1) * B * G : 0);
  float xv_next = *xnext;
  xnext += step;
  float c = 0.0f, hc = 0.0f;  // the unit's f32 carry, in its four lanes
  cg::this_cluster().sync();  // both blocks set up before any store

  for (int s = 0; s < Tn; ++s) {
    const int t = dir ? Tn - 1 - s : s;
    const int cur = s & 1;
    float xv = xv_next;
    if constexpr (A::kMerged) xv += bias;
    if (s + 1 < Tn) xv_next = *xnext;
    xnext += step;
    if (s > 0) {
      rc::bar_wait(bar0 + 8 * cur, ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 2 < Tn) rc::bar_expect(bar0 + 8 * cur, kBytes);
    }

    // the pair's two columns over this lane's half, then the halves' sum
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int j = 0; j < D; j += 4) {
      const float4 hv =
          *reinterpret_cast<const float4*>(&h_s[cur][hf * (D + 4) + j]);
      a0 = fmaf(hv.x, w[0][j], a0);
      a0 = fmaf(hv.y, w[0][j + 1], a0);
      a0 = fmaf(hv.z, w[0][j + 2], a0);
      a0 = fmaf(hv.w, w[0][j + 3], a0);
      a1 = fmaf(hv.x, w[1][j], a1);
      a1 = fmaf(hv.y, w[1][j + 1], a1);
      a1 = fmaf(hv.z, w[1][j + 2], a1);
      a1 = fmaf(hv.w, w[1][j + 3], a1);
    }
    a0 += __shfl_xor_sync(0xffffffffu, a0, 8);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 8);
    const float pre = xv + (hf ? a1 : a0);
    const float act = g == 2 ? tanhf(pre) : sigmoid_f(pre);

    // the unit's four gates by shuffles; its cell in each of its lanes
    const int u0 = lane % 8;
    const float ig = __shfl_sync(0xffffffffu, act, u0);
    const float fg = __shfl_sync(0xffffffffu, act, u0 + 8);
    const float gg = __shfl_sync(0xffffffffu, act, u0 + 16);
    const float og = __shfl_sync(0xffffffffu, act, u0 + 24);
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

    // the rounded h into block g's next buffer (lanes 0 and 1 of the unit)
    if (g < 2 && s + 1 < Tn) {
      const int nb = cur ^ 1;
      const uint32_t slot =
          slot0 + 4u * (uint32_t)(nb * 2 * (D + 4) + hslot);
      rc::send_h(rc::peer_u32(slot, g), to_f(hq),
                 rc::peer_u32(bar0 + 8 * nb, g));
    }
    const size_t row = (size_t)t * B + b;
    if constexpr (A::kMerged) {
      const size_t step_off = (size_t)s * B * 10 * H;
      if (TRAIN) mres[step_off] = from_f<T>(act);
      if (g == 2) ys[row * H + k] = hq;
      if (TRAIN && g == 3) {
        mtc[step_off] = from_f<T>(tc);
        mcs[(size_t)s * B * 2 * H] = from_f<T>(cn);
      }
    } else {
      if (TRAIN) res[row * 5 * H + col] = from_f<T>(act);
      if (g == 2) ys[row * H + k] = hq;
      if (TRAIN && g == 3) {
        res[row * 5 * H + 4 * H + k] = from_f<T>(tc);
        cs[row * H + k] = cn;
      }
    }
  }
  cg::this_cluster().sync();  // no block exits while its peer sends to it
}

// The recurrence on the projected gates xg with the addressing A; the
// merged body passes wh2, cs and res for both directions' pointers.
template <typename T, int H, typename A>
cudaError_t launch_recur(const float* xg, const void* whf, const void* whb,
                         const void* bi, const int* lengths, void* ysf,
                         void* ysb, void* csf, void* csb, void* resf,
                         void* resb, bool train, int Tn, int B,
                         cudaStream_t stream) {
  const dim3 grid(2 * B, 2);
  const T* wf = static_cast<const T*>(whf);
  const T* wb = static_cast<const T*>(whb);
  const T* bx = static_cast<const T*>(bi);
  T* yf = static_cast<T*>(ysf);
  T* yb = static_cast<T*>(ysb);
  if (train)
    lstm_recur_kernel<T, H, true, A><<<grid, 2 * H, 0, stream>>>(
        xg, wf, wb, bx, lengths, yf, yb, static_cast<CsT<T, A>*>(csf),
        static_cast<CsT<T, A>*>(csb), static_cast<T*>(resf),
        static_cast<T*>(resb), Tn, B);
  else
    lstm_recur_kernel<T, H, false, A><<<grid, 2 * H, 0, stream>>>(
        xg, wf, wb, bx, lengths, yf, yb, nullptr, nullptr, nullptr, nullptr,
        Tn, B);
  return cudaGetLastError();
}

// The recurrence for the H of the layer, with the addressing A: the split
// layer's (bi null, as the projection added the bias) or the merged
// body's.
template <typename T, template <int> class A>
cudaError_t run_recur(const float* xg, const void* whf, const void* whb,
                      const void* bi, const int* lengths, void* ysf,
                      void* ysb, void* csf, void* csb, void* resf, void* resb,
                      bool train, int Tn, int B, int H, cudaStream_t stream) {
  switch (H) {
    case 16:
      return launch_recur<T, 16, A<16>>(xg, whf, whb, bi, lengths, ysf, ysb,
                                        csf, csb, resf, resb, train, Tn, B,
                                        stream);
    case 32:
      return launch_recur<T, 32, A<32>>(xg, whf, whb, bi, lengths, ysf, ysb,
                                        csf, csb, resf, resb, train, Tn, B,
                                        stream);
    case 64:
      return launch_recur<T, 64, A<64>>(xg, whf, whb, bi, lengths, ysf, ysb,
                                        csf, csb, resf, resb, train, Tn, B,
                                        stream);
    case 128:
      return launch_recur<T, 128, A<128>>(xg, whf, whb, bi, lengths, ysf,
                                          ysb, csf, csb, resf, resb, train,
                                          Tn, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  return run_recur<T, SplitAddr>(xg, whf, whb, nullptr, lengths, ysf, ysb,
                                 csf, csb, resf, resb, train, Tn, B, H,
                                 stream);
}

// The merged body's layer (row 7): the projection without bias, then the
// recurrence with the merged addressing.
template <typename T>
cudaError_t run_merged(const void* x, const void* wif2, const void* wib2,
                       const void* bi2, const void* wh2, const int* lengths,
                       void* ysf, void* ysb, void* cs, void* res, float* xg,
                       int Tn, int B, int W, int H, bool train,
                       cudaStream_t stream) {
  const cudaError_t err = launch_proj<T>(x, wif2, wib2, nullptr, nullptr, xg,
                                         Tn * B, W, 4 * H, stream);
  if (err != cudaSuccess) return err;
  return run_recur<T, MergedAddr>(xg, wh2, wh2, bi2, lengths, ysf, ysb, cs,
                                  cs, res, res, train, Tn, B, H, stream);
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

// Row 7, the merged body's layer (rnn_fused_pallas.py lstm_bidir_fused,
// PVA_RNN_SPLIT=0): x [T, B, W], wif2, wib2 [W, 4H], the gate-grouped bi2
// [8H] (both biases folded), the block-diagonal wh2 [2H, 8H] (only its
// diagonal blocks are read), lengths [B] int32; the outputs ysf, ysb
// [T, B, H] and, for train != 0, cs [T, B, 2H] and res [T, B, 10H] in the
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
    return (int)run_merged<float>(x, wif2, wib2, bi2, wh2, lengths, ysf, ysb,
                                  cs, res, xg, Tn, B, W, H, train != 0, s);
  if (dtype == 1)
    return (int)run_merged<__nv_bfloat16>(x, wif2, wib2, bi2, wh2, lengths,
                                          ysf, ysb, cs, res, xg, Tn, B, W, H,
                                          train != 0, s);
  return (int)cudaErrorInvalidValue;
}

const char* lstm_bidir_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
