// One bidirectional GRU layer forward, eval and train forms, for Hopper
// (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/rnn_fused_pallas.py
//   _fwd_kernel_split, reached through gru_bidir_fused_split: train=False
//   (eval form) and train=True (train form, from its custom_vjp forward);
//   its halves=/boundary form, reached through gru_bidir_fused_split_bnd
//   (eval form and its custom_vjp forward); and _fwd_kernel, the merged
//   body's forward, reached through gru_bidir_fused (PVA_RNN_SPLIT=0; eval
//   and train forms): gru_merged_fwd, below.
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
//    over T, so the 2B chains run side by side on the SMs.  The 3H
//    threads keep wh in registers for the whole layer (128 floats a thread
//    at H=128), so a step reads from shared memory only the carry, as a
//    broadcast.  With wh in shared memory instead, the 128 loads a thread
//    makes each step, not the arithmetic, set the step time.
//  * The step, taken apart (PERF.md section 6, tools/
//    torch_lstm_scan_steps.py --kernel 1): the first recurrence took 0.75
//    us a step at the serving shape (B=3, T=1280, f32), of it the product
//    0.29, the gate math 0.16, the rest with both barriers 0.30, and 0.94
//    at the training shape (B=8, T=1920), where the rest was 0.49: each
//    step's xg was loaded at the step's start and waited on after the
//    product, from a 47 MB xg that no longer sits whole in L2.  Spreading
//    the product over more SMs did not pay: the GRU scan's cluster chain
//    took 0.93 us a step at W=128, and a cluster of two blocks a (row,
//    direction), h through distributed shared memory and a cluster
//    barrier a step, was slower still.  So, on one SM:
//  * Every thread loads its own column's xg (3H threads, one value each),
//    kXgAhead - 1 steps ahead, by cp.async into its own slots of shared
//    memory, and waits on the step's group only after the product.
//  * r's and z's lanes form their gates, sigmoid(xg + hg), themselves,
//    before the step's first barrier, side by side; n's lane of a unit
//    then needs only tanh(xg_n + r hg_n) and the carry update, which it
//    keeps in its registers.
//  * The product was bound by its broadcast loads of h from shared memory
//    (one float4 for four FMAs) as much as by the FMAs: each lane now keeps
//    two columns over half the depth, so a load feeds eight FMAs, and one
//    shuffle adds the halves; the carry's two halves lie 16 bytes apart in
//    banks, so a pair's loads do not conflict.
//  * The backward direction reads xg at T-1-s; no flipped copy of x exists.
//  * At H=128 one block fills an SM's registers, so for B > 66 the blocks
//    run in more than one wave.
//  * The train form is a template flag: each lane stores its column's
//    residual (r, z; n's lane n and hg_n), off the chain (stores are not
//    waited on).  The eval form compiles without them.
//  * The fused-boundary form (gru_bidir_bnd_fwd, the layers after the
//    first under PVA_RNN_FUSED_BOUNDARY=1) builds its layer input in the
//    projection's tile loads (rnn_common.cuh::Boundary): the previous
//    layer's halves, the length mask and the hash dropout in registers, so
//    the stack writes no [T, B, 2H] boundary tensor.  Each element is
//    hashed once a product; the TPU form hashed it once a direction.  The
//    recurrence does not read x and is the same kernel.
//  * The merged body (gru_merged_fwd) is the TPU kernel's one [B, 2H] chain
//    over kernel steps s with dense per-direction input weights wif2, wib2
//    [W, 3H], the gate-grouped bi2, bh2 [6H] and the block-diagonal wh2
//    [2H, 6H] (columns [r_f r_b | z_f z_b | n_f n_b]): gx = [x_s @ wif2 |
//    x_{T-1-s} @ wib2] + bi2, hg = h2 @ wh2 + bh2, the backward half frozen
//    on its flipped-prefix padding.  wh2 is block-diagonal
//    (ops/rnn.py:_pack_gate_grouped), so the product is the two direction
//    chains above, each against its diagonal block; the recurrence reads
//    only those blocks (it relies on the zeros, which the TPU kernel
//    multiplies).  It is the same recurrence with another addressing
//    (MergedAddr): wh2's column q*2H + dir*H + u, bi2 added on the chain
//    (the projection runs without bias, as on the TPU), and the residuals
//    res [T, B, 8H] = [r z n hg_n], each 2H wide and gate-grouped, in
//    kernel order (row s: forward time s, backward time T-1-s), for
//    csrc/gru_merged_bwd.cu.  xg + bi2 is the sum the projection forms
//    with bi, so on the same weights its ys equal the split layer's bit for
//    bit.  The split form (SplitAddr) keeps the recurrence's own offsets
//    and compiles to the instructions it had before (cuobjdump -sass, each
//    instantiation); two other spellings of its residual stores cost its
//    train form 4 % on an H100.  The merged body's step, taken apart
//    (tools/torch_lstm_scan_steps.py --kernel 5, us a step, f32, B=3,
//    T=1280, as is / without the product / the gate math / the barriers /
//    all three): 0.63 / 0.33 / 0.53 / 0.57 / 0.18, row 1's.  Its first
//    design, one column of wh2 a thread, xg loaded at the step's start and
//    the gates formed after the barrier, took 0.87 (1.1249 and 2.2767 ms
//    a call at the serving and training shapes; PERF.md section 6).

#include "rnn_common.cuh"

namespace {

// ------------------------------------------------------------- recurrence

// Steps of xg a thread has in flight into shared memory (cp.async).
constexpr int kXgAhead = 4;

// 4 bytes of global memory into shared memory, asynchronously (cp.async),
// in the thread's current group.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N of the thread's most recent groups are in flight.
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where the recurrence finds a direction's weights and biases, as
// offsets: gate column col = q*H + u of direction dir (q: 0 r, 1 z, 2 n),
// depth d.  The split layer (rows 1 and 1 alt): per-direction wh_d [H, 3H]
// and bh_d [3H], the input bias already in xg, residuals res_d [T, B, 4H]
// at time t (the recurrence's own offsets, so that this form compiles to
// the instructions it had before it took an addressing).
template <int H>
struct SplitAddr {
  static constexpr bool kMerged = false;
  __device__ static int wh(int dir, int d, int col) { return d * 3 * H + col; }
  __device__ static int vec(int dir, int col) { return col; }
};

// The merged body (row 5, PVA_RNN_SPLIT=0): the gate-grouped wh2 [2H, 6H],
// of which the recurrence reads direction dir's diagonal block (rows dir*H
// + d, columns q*2H + dir*H + u), bi2 and bh2 [6H]; the projection ran
// without bias, so bi2 is added on the chain, as on the TPU; residuals res
// [T, B, 8H] = [r z n hg_n], each 2H wide and gate-grouped, in kernel
// order (row s: forward time s, backward time T-1-s); a lane's column col
// of the split layout (q = 3: hg_n) is at vec(dir, col) in a row.
template <int H>
struct MergedAddr {
  static constexpr bool kMerged = true;
  __device__ static int vec(int dir, int col) {
    return (col / H) * 2 * H + dir * H + col % H;
  }
  __device__ static int wh(int dir, int d, int col) {
    return (dir * H + d) * 6 * H + vec(dir, col);
  }
};

// One block per (batch row, direction); blockDim.x == 3H.  Threads [0, 2H)
// take the r and z columns, threads [2H, 3H) the n columns, in pairs of
// neighbouring lanes: pair p of r and z holds the r and z columns of unit
// p, pair p of n the n columns of units p and p + H/2.  Lane `half` of a
// pair keeps that half of the depth, H/2 deep, of both of the pair's
// columns in registers, so a broadcast load of h feeds eight FMAs (one
// column a lane over the whole depth, and four over a quarter, whose
// shuffles cost more than the loads they save, were both slower on an
// H100); one shuffle adds the halves, and lane
// `half` then owns column `half` of the pair.  Each thread also has its
// column's xg of the next kXgAhead - 1 steps in flight into its own slots
// of xg_s.  A step: the product; r's and z's lanes form sigmoid(xg + hg)
// into act_s; a barrier; n's lane of each unit forms n and the new carry
// (kept in its registers, rounded into hq_s), stores ys and, TRAIN, n and
// hg_n, while r's and z's lanes store their gates; a barrier.  A
// (SplitAddr or MergedAddr) places the weights, the biases (bi only with
// the merged body's) and the residuals; the arithmetic is the same.
template <typename T, int H, bool TRAIN, typename A>
__global__ void __launch_bounds__(3 * H, 1)
recur_kernel(const float* __restrict__ xg, const T* __restrict__ wh_f,
             const T* __restrict__ wh_b, const T* __restrict__ bh_f,
             const T* __restrict__ bh_b, const T* __restrict__ bi,
             const int* __restrict__ lengths, T* __restrict__ ys_f,
             T* __restrict__ ys_b, T* __restrict__ res_f,
             T* __restrict__ res_b, int Tn, int B) {
  constexpr int G = 3 * H;
  constexpr int D = H / 2;  // depth of a lane's half
  // the carry rounded to T, its second half at D + 4: the four floats
  // between the halves put a pair's broadcast loads on distinct banks
  __shared__ __align__(16) float hq_s[2 * (D + 4)];
  __shared__ float act_s[2 * H];       // the step's r and z
  __shared__ float xg_s[kXgAhead][G];  // each thread's xg, steps ahead
  const int dir = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const bool rz = tid < 2 * H;
  const int pair = (rz ? tid : tid - 2 * H) / 2;
  auto column = [&](int j) {  // column j of the pair
    return rz ? j * H + pair : 2 * H + pair + j * (H / 2);
  };
  const int col = column(half);
  const int gate = col / H;  // 0 r, 1 z, 2 n
  const int u = col % H;
  const T* __restrict__ wh = dir ? wh_b : wh_f;
  T* __restrict__ ys = dir ? ys_b : ys_f;
  T* __restrict__ res = dir ? res_b : res_f;

  float w[2][D];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int k = 0; k < D; ++k)
      w[j][k] = to_f(wh[A::wh(dir, half * D + k, column(j))]);
  const float bh_c = to_f((dir ? bh_b : bh_f)[A::vec(dir, col)]);
  const float bi_c = A::kMerged ? to_f(bi[A::vec(dir, col)]) : 0.0f;
  // the merged body's residuals: this lane's column of row b at step 0
  // (n's lane's hg_n 2H further on), a step B rows on
  T* const mres =
      A::kMerged && TRAIN ? res + (size_t)b * 8 * H + A::vec(dir, col)
                          : nullptr;
  float hc = 0.0f;  // the f32 carry, in n's lane of the unit
  const int hslot = (u / D) * (D + 4) + u % D;  // the unit's place in hq_s
  for (int i = tid; i < 2 * (D + 4); i += 3 * H) hq_s[i] = 0.0f;
  const int len = lengths[b];
  // the lanes of this thread's warp that exist: 3H need not fill the last
  // warp (H=16); where it does, the mask is a constant, as a mask held in
  // a register cost the step about 11 % at H=128 on an H100
  const unsigned lanes = G % 32 == 0 || G - (tid & ~31) >= 32
                             ? 0xffffffffu
                             : (1u << (G % 32)) - 1u;

  // the next step's xg of this lane's column to fetch (the backward chain
  // walks t = T-1 .. 0)
  const ptrdiff_t step = dir ? -(ptrdiff_t)B * G : (ptrdiff_t)B * G;
  const float* xnext = xg + (size_t)dir * Tn * B * G + (size_t)b * G + col +
                       (dir ? (size_t)(Tn - 1) * B * G : 0);
#pragma unroll
  for (int j = 0; j < kXgAhead - 1; ++j) {
    if (j < Tn) copy_async4(&xg_s[j][tid], xnext);
    commit_async();
    xnext += step;
  }
  __syncthreads();

  for (int s = 0; s < Tn; ++s) {
    const int t = dir ? Tn - 1 - s : s;
    if (s + kXgAhead - 1 < Tn)
      copy_async4(&xg_s[(s + kXgAhead - 1) % kXgAhead][tid], xnext);
    commit_async();
    xnext += step;

    // the pair's two columns over this lane's half, then the halves' sum
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int k = 0; k < D; k += 4) {
      const float4 hv =
          *reinterpret_cast<const float4*>(&hq_s[half * (D + 4) + k]);
      a0 = fmaf(hv.x, w[0][k], a0);
      a0 = fmaf(hv.y, w[0][k + 1], a0);
      a0 = fmaf(hv.z, w[0][k + 2], a0);
      a0 = fmaf(hv.w, w[0][k + 3], a0);
      a1 = fmaf(hv.x, w[1][k], a1);
      a1 = fmaf(hv.y, w[1][k + 1], a1);
      a1 = fmaf(hv.z, w[1][k + 2], a1);
      a1 = fmaf(hv.w, w[1][k + 3], a1);
    }
    a0 += __shfl_xor_sync(lanes, a0, 1);
    a1 += __shfl_xor_sync(lanes, a1, 1);
    const float hg = (half ? a1 : a0) + bh_c;
    wait_async<kXgAhead - 1>();  // this step's xg has landed
    float xv = xg_s[s % kXgAhead][tid];
    if constexpr (A::kMerged) xv += bi_c;
    float act = 0.0f;
    if (gate < 2) {
      act = sigmoid_f(xv + hg);
      act_s[col] = act;
    }
    __syncthreads();  // r and z in act_s; every product has read hq_s

    const size_t row = (size_t)t * B + b;
    if (gate == 2) {
      const float r = act_s[u];
      const float z = act_s[H + u];
      const float n = tanhf(xv + r * hg);
      float hn = (1.0f - z) * n + z * hc;
      if (dir && t >= len) hn = hc;  // backward chain: frozen on padding
      hc = hn;
      const T hq = from_f<T>(hn);
      hq_s[hslot] = to_f(hq);
      ys[row * H + u] = hq;
      if (TRAIN) {
        if constexpr (A::kMerged) {
          T* const rs = mres + (size_t)s * B * 8 * H;
          rs[0] = from_f<T>(n);
          rs[2 * H] = from_f<T>(hg);
        } else {
          res[row * 4 * H + 2 * H + u] = from_f<T>(n);
          res[row * 4 * H + 3 * H + u] = from_f<T>(hg);
        }
      }
    } else if (TRAIN) {  // r or z
      if constexpr (A::kMerged)
        mres[(size_t)s * B * 8 * H] = from_f<T>(act);
      else
        res[row * 4 * H + col] = from_f<T>(act);
    }
    __syncthreads();  // the new carry in hq_s
  }
}

// The recurrence on the projected gates xg with the addressing A; the
// merged body passes wh2, bh2 and res for both directions' pointers.
template <typename T, int H, typename A>
cudaError_t launch_recur(const float* xg, const void* whf, const void* whb,
                         const void* bhf, const void* bhb, const void* bi,
                         const int* lengths, void* ysf, void* ysb, void* resf,
                         void* resb, bool train, int Tn, int B,
                         cudaStream_t stream) {
  const dim3 grid(B, 2);
  const T* wf = static_cast<const T*>(whf);
  const T* wb = static_cast<const T*>(whb);
  const T* bf = static_cast<const T*>(bhf);
  const T* bb = static_cast<const T*>(bhb);
  const T* bx = static_cast<const T*>(bi);
  T* yf = static_cast<T*>(ysf);
  T* yb = static_cast<T*>(ysb);
  if (train)
    recur_kernel<T, H, true, A><<<grid, 3 * H, 0, stream>>>(
        xg, wf, wb, bf, bb, bx, lengths, yf, yb, static_cast<T*>(resf),
        static_cast<T*>(resb), Tn, B);
  else
    recur_kernel<T, H, false, A><<<grid, 3 * H, 0, stream>>>(
        xg, wf, wb, bf, bb, bx, lengths, yf, yb, nullptr, nullptr, Tn, B);
  return cudaGetLastError();
}

// The recurrence for the H of the layer, with the addressing A: the split
// layer's (bi null, as the projection added it) or the merged body's.
template <typename T, template <int> class A>
cudaError_t run_recur(const float* xg, const void* whf, const void* whb,
                      const void* bhf, const void* bhb, const void* bi,
                      const int* lengths, void* ysf, void* ysb, void* resf,
                      void* resb, bool train, int Tn, int B, int H,
                      cudaStream_t stream) {
  switch (H) {
    case 16:
      return launch_recur<T, 16, A<16>>(xg, whf, whb, bhf, bhb, bi, lengths,
                                        ysf, ysb, resf, resb, train, Tn, B,
                                        stream);
    case 32:
      return launch_recur<T, 32, A<32>>(xg, whf, whb, bhf, bhb, bi, lengths,
                                        ysf, ysb, resf, resb, train, Tn, B,
                                        stream);
    case 64:
      return launch_recur<T, 64, A<64>>(xg, whf, whb, bhf, bhb, bi, lengths,
                                        ysf, ysb, resf, resb, train, Tn, B,
                                        stream);
    case 128:
      return launch_recur<T, 128, A<128>>(xg, whf, whb, bhf, bhb, bi, lengths,
                                          ysf, ysb, resf, resb, train, Tn, B,
                                          stream);
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
  return run_recur<T, SplitAddr>(xg, whf, whb, bhf, bhb, nullptr, lengths,
                                 ysf, ysb, resf, resb, train, Tn, B, H,
                                 stream);
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

// The merged body's layer (row 5): the projection without bias, then the
// recurrence with the merged addressing.
template <typename T>
cudaError_t run_merged(const void* x, const void* wif2, const void* wib2,
                       const void* bi2, const void* wh2, const void* bh2,
                       const int* lengths, void* ysf, void* ysb, void* res,
                       float* xg, int Tn, int B, int W, int H, bool train,
                       cudaStream_t stream) {
  const cudaError_t err = launch_proj<T>(x, wif2, wib2, nullptr, nullptr, xg,
                                         Tn * B, W, 3 * H, stream);
  if (err != cudaSuccess) return err;
  return run_recur<T, MergedAddr>(xg, wh2, wh2, bh2, bh2, bi2, lengths, ysf,
                                  ysb, res, res, train, Tn, B, H, stream);
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

// Row 5, the merged body's layer (rnn_fused_pallas.py gru_bidir_fused,
// PVA_RNN_SPLIT=0): x [T, B, W], wif2, wib2 [W, 3H], the gate-grouped bi2
// [6H], the block-diagonal wh2 [2H, 6H] (only its diagonal blocks are
// read) and bh2 [6H], lengths [B] int32; the outputs ysf, ysb [T, B, H]
// and, for train != 0, res [T, B, 8H] (ignored by the eval form); xg is f32
// scratch of 2*T*B*3H elements.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int gru_merged_fwd(int dtype, const void* x, const void* wif2,
                   const void* wib2, const void* bi2, const void* wh2,
                   const void* bh2, const int* lengths, void* ysf, void* ysb,
                   void* res, float* xg, int Tn, int B, int W, int H,
                   int train, void* stream) {
  if (Tn <= 0 || B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (train && res == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_merged<float>(x, wif2, wib2, bi2, wh2, bh2, lengths, ysf,
                                  ysb, res, xg, Tn, B, W, H, train != 0, s);
  if (dtype == 1)
    return (int)run_merged<__nv_bfloat16>(x, wif2, wib2, bi2, wh2, bh2,
                                          lengths, ysf, ysb, res, xg, Tn, B,
                                          W, H, train != 0, s);
  return (int)cudaErrorInvalidValue;
}

const char* gru_bidir_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
