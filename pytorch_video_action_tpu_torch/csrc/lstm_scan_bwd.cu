// The LSTM scan backward for Hopper (sm_90a): from the saved gates, or
// recomputing them.
//
// Replaces: pytorch_video_action_tpu/ops/rnn_pallas.py
//   _lstm_bwd_saved_kernel (pallas_call in _lstm_bwd_saved_call, the
//   default backward of lstm_scan_pallas's custom_vjp) and _lstm_bwd_kernel
//   (pallas_call in _lstm_bwd_call, the backward under PVA_RNN_RECOMPUTE=1).
//
// Inputs [T, B, *] in one dtype: the residuals res [5W] = [i, f, g, o,
// tanh c] of the saving forward, or (recompute) xg [4W] and cs [W]; hp and
// cp [W], the forward's ys and cs one step earlier (0 at t = 0); dy [W];
// wh [W, 4W] and its transpose whT [4W, W].  Per step t = T-1 .. 0, in f32:
//   (recompute) a = xg[t] + hp[t] @ wh, i, f, g, o from a, tanh c from cs[t]
//   dh = dy[t] + dh_c;  dc = dh * o * (1 - tanh_c^2) + dc_c
//   dg = [dc g i (1-i), dc cp f (1-f), dc i (1-g^2), dh tanh_c o (1-o)]
//   dxg[t] = dg (in the input dtype);  dh_c = rnd(dg) @ wh^T;  dc_c = dc f
// and dwh = sum over t and b of hp^T rnd(dg) in f32, written in wh's dtype.
// rnd rounds to wh's dtype, the same as the inputs'.
//
// What bounds it on an H100: at vanilla_lstm's training shape (B=8,
// T=1920, W=256) the carry products and dwh are 2 * 2*T*B*W*4W = 16.1
// GFLOP, 0.24 ms at f32's 67 TFLOP/s (the recompute form a third more);
// the bytes about 0.2 GB, 0.06 ms.  The chain of T dependent steps binds.
//
// What the design does about it:
//  * The chain runs on a cluster of NC blocks (scan_common.cuh); block r
//    owns units [r*U, r*U + U).  A step: the cell threads form their units'
//    gate gradients (all four gates of a unit are the block's), write dxg
//    and put the rounded gradients into every block's shared memory
//    (distributed shared memory); one cluster barrier; then each block
//    forms dh_c of its own units, a product of all 4W gradients with its
//    rows of wh, held as the [4W, U] slice of whT in shared memory (rows
//    past the budget read through L2).  The gradients are double-buffered,
//    so that barrier is the step's only wait across blocks.
//  * The cluster barrier is split: the gate gradients go to every block,
//    the arrive, then the stores of dxg and the loads of the next step's
//    inputs into registers, then the wait; so the arrive waits for no
//    device-memory access and the loads' latency hides behind the wait and
//    the carry product.
//  * The recompute form first forms its units' gates from hp[t], a
//    product with its [W, 4U] slice of wh, as the forward does.
//  * dwh is off the chain: a tiled SIMT GEMM (rnn_common.cuh) over K =
//    T*B after it, each output tile summing its whole K in order.  No
//    atomics: reruns are bit-identical.
// wgmma, TMA and a split-K dwh with a fixed-order reduction are later work.

#include "scan_common.cuh"

namespace {

// One (row, unit) step's inputs: gates (saved form), tanh c or c, c_prev, dy.
struct StepIn {
  float i, f, g, o, tc, cp, dy;
};

template <typename T, bool RECOMPUTE>
__device__ __forceinline__ void load_step(StepIn& in, const T* __restrict__ first,
                                          const T* __restrict__ cp,
                                          const T* __restrict__ cs,
                                          const T* __restrict__ dy,
                                          size_t row, int W, int unit) {
  if (RECOMPUTE) {
    in.tc = to_f(cs[row * W + unit]);  // c; its tanh is taken when used
  } else {
    const T* r = first + row * 5 * W;
    in.i = to_f(r[unit]);
    in.f = to_f(r[W + unit]);
    in.g = to_f(r[2 * W + unit]);
    in.o = to_f(r[3 * W + unit]);
    in.tc = to_f(r[4 * W + unit]);
  }
  in.cp = to_f(cp[row * W + unit]);
  in.dy = to_f(dy[row * W + unit]);
}

template <typename T, bool RECOMPUTE>
__global__ void __launch_bounds__(kScanThreads, 1)
lstm_scan_bwd_kernel(const T* __restrict__ first, const T* __restrict__ hp,
                     const T* __restrict__ cp, const T* __restrict__ cs,
                     const T* __restrict__ dy, const T* __restrict__ wh,
                     const T* __restrict__ whT, T* __restrict__ dxg,
                     ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Chain ch = chain(cluster, a);
  const int W = a.W;
  const int G = 4 * W;
  const int ldh = row_ld(W);
  const int C = 4 * ch.ucnt;
  const int C4 = 4 * a.U;
  // the layout, the same in every block
  float* dg_s = reinterpret_cast<float*>(smem_raw);  // [2][kMaxRows][G]
  float* part_s = dg_s + 2 * kMaxRows * G;
  float* dh_s = part_s + part_floats(C4);   // [kMaxRows][U]
  float* dc_s = dh_s + kMaxRows * a.U;      // [kMaxRows][U]
  float* hp_s = dc_s + kMaxRows * a.U;      // recompute: [kMaxRows][ldh]
  float* act_s = hp_s + (RECOMPUTE ? kMaxRows * ldh : 0);  // [kMaxRows][C]
  T* wT_s = reinterpret_cast<T*>(act_s + (RECOMPUTE ? kMaxRows * C4 : 0));
  T* w_s = wT_s + (size_t)a.rs * a.U;  // recompute: [rs2][C]

  // whT rows are gate columns, its columns units: slice [4W, ucnt]
  const int uc = ch.ucnt > 0 ? ch.ucnt : 1;
  const ColMap cmT{uc, 0, ch.u0, W};
  const ColMap cm{uc, W, ch.u0, G};
  load_weights(wT_s, whT, cmT, a.rs, ch.ucnt);
  if (RECOMPUTE) load_weights(w_s, wh, cm, a.rs2, C);
  for (int i = threadIdx.x; i < kMaxRows * a.U; i += kScanThreads) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }
  // the rows past the chain's stay 0: the carry product sums them
  for (int i = threadIdx.x; i < 2 * kMaxRows * G; i += kScanThreads)
    dg_s[i] = 0.0f;
  if (RECOMPUTE)
    for (int i = threadIdx.x; i < kMaxRows * ldh; i += kScanThreads)
      hp_s[i] = 0.0f;
  float* peer[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < a.NC) peer[q] = cluster.map_shared_rank(dg_s, q);

  const int n_pairs = ch.nb * ch.ucnt;
  StepIn in[kMaxPairs];
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int e = threadIdx.x + k * kScanThreads;
    if (e < n_pairs)
      load_step<T, RECOMPUTE>(in[k], first, cp, cs, dy,
                              (size_t)(a.Tn - 1) * a.B + ch.b0 + e / ch.ucnt,
                              W, ch.u0 + e % ch.ucnt);
  }
  cluster.sync();  // every block has started

  for (int s = 0; s < a.Tn; ++s) {
    const int t = a.Tn - 1 - s;
    const int cur = s & 1;
    const size_t row0 = (size_t)t * a.B + ch.b0;
    if (RECOMPUTE) {  // this block's gates of step t from hp[t]
      for (int i = threadIdx.x; i < ch.nb * W; i += kScanThreads)
        hp_s[(i / W) * ldh + i % W] = to_f(hp[(row0 + i / W) * W + i % W]);
      __syncthreads();
      if (C > 0)
        product(hp_s, ldh, w_s, a.rs2, wh, cm, C, W, part_s);
      __syncthreads();
      for (int e = threadIdx.x; e < ch.nb * C; e += kScanThreads) {
        const int b = e / C;
        const int c = e % C;
        const float pre = to_f(first[(row0 + b) * G + cm.col(c)]) +
                          reduce_slices(part_s, b, c, C, W);
        act_s[b * C + c] = c / uc == 2 ? tanhf(pre) : sigmoid_f(pre);
      }
      __syncthreads();
    }

    // the cell threads' gate gradients to every block, the barrier's
    // arrive; then their stores to dxg and the next step's inputs
    float d[kMaxPairs][4];
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) {
      const int e = threadIdx.x + k * kScanThreads;
      if (e < n_pairs) {
        const int b = e / ch.ucnt;
        const int u = e % ch.ucnt;
        StepIn x = in[k];
        if (RECOMPUTE) {
          const float* g = act_s + b * C;
          x.i = g[u];
          x.f = g[ch.ucnt + u];
          x.g = g[2 * ch.ucnt + u];
          x.o = g[3 * ch.ucnt + u];
          x.tc = tanhf(x.tc);
        }
        const int p = b * a.U + u;
        const float dh = x.dy + dh_s[p];
        const float dc = dh * x.o * (1.0f - x.tc * x.tc) + dc_s[p];
        dc_s[p] = dc * x.f;
        d[k][0] = dc * x.g * x.i * (1.0f - x.i);
        d[k][1] = dc * x.cp * x.f * (1.0f - x.f);
        d[k][2] = dc * x.i * (1.0f - x.g * x.g);
        d[k][3] = dh * x.tc * x.o * (1.0f - x.o);
        const int slot = (cur * kMaxRows + b) * G + ch.u0 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d[k][q] = rnd<T>(d[k][q]);
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r)
            if (r < a.NC) peer[r][slot + q * W] = d[k][q];
        }
      }
    }
    cluster_arrive();
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) {
      const int e = threadIdx.x + k * kScanThreads;
      if (e < n_pairs) {
        T* out = dxg + (row0 + e / ch.ucnt) * G + ch.u0 + e % ch.ucnt;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * W] = from_f<T>(d[k][q]);
      }
    }
    if (t > 0) {
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        const int e = threadIdx.x + k * kScanThreads;
        if (e < n_pairs)
          load_step<T, RECOMPUTE>(in[k], first, cp, cs, dy,
                                  row0 - a.B + e / ch.ucnt, W,
                                  ch.u0 + e % ch.ucnt);
      }
    }
    cluster_wait();

    // dh_c of this block's units
    if (ch.ucnt > 0)
      product(dg_s + cur * kMaxRows * G, G, wT_s, a.rs, whT, cmT, ch.ucnt,
              G, part_s);
    __syncthreads();
    for (int e = threadIdx.x; e < n_pairs; e += kScanThreads) {
      const int b = e / ch.ucnt;
      const int u = e % ch.ucnt;
      dh_s[b * a.U + u] = reduce_slices(part_s, b, u, ch.ucnt, G);
    }
    __syncthreads();
  }
}

// dwh's B operand: B(k, n) = p[k * ld + n], the gate gradients as stored
template <typename T>
struct RowsT {
  static constexpr bool kContigK = false;
  const T* p;
  int ld;
  __device__ float operator()(int k, int n) const {
    return to_f(p[(size_t)k * ld + n]);
  }
};

// dwh [W, 4W] = hp^T dxg over K = T*B rows, one 64 x 64 tile a block
template <typename T>
__global__ void __launch_bounds__(kThreads)
dwh_kernel(const ShiftedRowsT<T> a, const RowsT<T> b, const Store<T> c,
           int M, int N, int K) {
  gemm_tile<kWT, kWT>(a, b, c, M, N, K, blockIdx.x * kWT, blockIdx.y * kWT);
}

size_t bwd_fixed_bytes(const ScanArgs& a, bool recompute) {
  const int C4 = 4 * a.U;
  size_t floats = 2 * kMaxRows * 4 * (size_t)a.W + part_floats(C4) +
                  2 * kMaxRows * a.U;
  if (recompute) floats += kMaxRows * row_ld(a.W) + kMaxRows * C4;
  return align16(sizeof(float) * floats);
}

template <typename T>
cudaError_t run_bwd(bool recompute, const void* first, const void* hp,
                    const void* cp, const void* cs, const void* dy,
                    const void* wh, const void* whT, void* dxg, void* dwh,
                    ScanArgs a, cudaStream_t stream) {
  const size_t fixed = bwd_fixed_bytes(a, recompute);
  // the carry product's slice [4W, U] first; recompute: then [W, 4U]
  const size_t rowT = sizeof(T) * a.U;
  a.rs = resident_rows(fixed, rowT, 4 * a.W);
  size_t smem = fixed + rowT * a.rs;
  if (recompute) {
    const size_t row = sizeof(T) * 4 * a.U;
    a.rs2 = resident_rows(smem, row, a.W);
    smem += row * a.rs2;
  }
  const T* f = static_cast<const T*>(first);
  const T* h = static_cast<const T*>(hp);
  const T* c = static_cast<const T*>(cp);
  const T* s = static_cast<const T*>(cs);
  const T* d = static_cast<const T*>(dy);
  const T* w = static_cast<const T*>(wh);
  const T* wt = static_cast<const T*>(whT);
  T* dx = static_cast<T*>(dxg);
  cudaError_t err =
      recompute ? launch_chain(lstm_scan_bwd_kernel<T, true>, a, smem, stream,
                               f, h, c, s, d, w, wt, dx, a)
                : launch_chain(lstm_scan_bwd_kernel<T, false>, a, smem,
                               stream, f, h, c, s, d, w, wt, dx, a);
  if (err != cudaSuccess) return err;
  const int M = a.Tn * a.B;
  const int G = 4 * a.W;
  const dim3 grid((a.W + kWT - 1) / kWT, (G + kWT - 1) / kWT);
  dwh_kernel<T><<<grid, kThreads, 0, stream>>>(
      ShiftedRowsT<T>{h, a.W, 0, M}, RowsT<T>{dx, G},
      Store<T>{static_cast<T*>(dwh), G}, a.W, G, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the dtype of every tensor.  Device
// pointers of contiguous tensors: first = res [T, B, 5W] (recompute == 0)
// or xg [T, B, 4W] (recompute != 0); hp, cp, dy [T, B, W]; cs [T, B, W]
// (recompute only, ignored otherwise); wh [W, 4W] and whT = wh^T [4W, W];
// outputs dxg [T, B, 4W] and dwh [W, 4W].  cluster as lstm_scan_fwd's.
// Launches on `stream` and returns the launches' error (0 on success).
int lstm_scan_bwd(int dtype, int recompute, const void* first,
                  const void* hp, const void* cp, const void* cs,
                  const void* dy, const void* wh, const void* whT, void* dxg,
                  void* dwh, int Tn, int B, int W, int cluster,
                  void* stream) {
  ScanArgs a;
  if (!scan_geometry(Tn, B, W, cluster, &a) || (recompute && cs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bwd<float>(recompute != 0, first, hp, cp, cs, dy, wh,
                               whT, dxg, dwh, a, s);
  if (dtype == 1)
    return (int)run_bwd<__nv_bfloat16>(recompute != 0, first, hp, cp, cs, dy,
                                       wh, whT, dxg, dwh, a, s);
  return (int)cudaErrorInvalidValue;
}

const char* lstm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
