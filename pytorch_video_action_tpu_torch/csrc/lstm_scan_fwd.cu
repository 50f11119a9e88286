// The LSTM scan forward for Hopper (sm_90a), eval and saving forms.
//
// Replaces: pytorch_video_action_tpu/ops/rnn_pallas.py
//   _lstm_fwd_kernel (pallas_call in _lstm_fwd, the eval form of
//   lstm_scan_pallas) and _lstm_fwd_save_kernel (pallas_call in
//   _lstm_fwd_save, the training forward of its custom_vjp).
//
// Computes, for xg [T, B, 4W] (the input projection with both biases
// folded in, gates i, f, g, o) and wh [W, 4W], from h = c = 0:
//   a = xg[t] + rnd(h) @ wh;  i, f, o = sigmoid, g = tanh of a's gates
//   c' = f * c + i * g;  h' = o * tanh(c')
// ys[t] = h', cs[t] = c' [T, B, W] and, in the saving form, res[t] =
// [i, f, g, o, tanh c'] [T, B, 5W], all stored in xg's dtype.  rnd rounds
// h to wh's dtype (the same as xg's); products accumulate in f32; c is
// carried in f32.  The raw recurrence: no mask, the caller masks ys.
//
// What bounds it on an H100: at vanilla_lstm's training shape (B=8,
// T=1920, W=256) the hidden products are 2*T*B*W*4W = 8.05 GFLOP, 0.12 ms
// at f32's 67 TFLOP/s, and the bytes (xg in, ys, cs, res out) about 0.14
// GB, 0.04 ms.  Neither binds: the chain of T dependent steps does, each a
// [B, W] x [W, 4W] product, the gates and an exchange of h between SMs.
//
// What the design does about it:
//  * One direction's wh is 1 MiB in f32 at W=256 (4 MiB at W=512): no SM
//    holds it.  The chain runs on a cluster of NC blocks
//    (scan_common.cuh): block r owns units [r*U, r*U + U) and all four gate
//    columns of each, so the cell update stays in the block; its [W, 4U]
//    slice of wh sits in shared memory, as far as the budget goes (at
//    W=512 in f32 the rows past it are read through L2 every step).
//  * A step: the block's product of the carried rows' h (all W, rounded,
//    from its own shared memory) with its slice; the slices' sums and xg
//    give the gates; the cell update writes ys, cs, res and the new h into
//    every block of the cluster (distributed shared memory); one cluster
//    barrier.  h is double-buffered, so that barrier is the step's only
//    wait across blocks.
//  * The cluster barrier is split: the new h goes to every block, the
//    arrive, then the step's stores of ys, cs and res and the loads of the
//    next step's xg into registers, then the wait.  So the arrive waits
//    for no device-memory access, and the loads' latency hides behind the
//    wait and the next step's product.
//  * Up to 8 batch rows share a cluster and each weight read; more rows
//    take more clusters.
// wgmma and TMA are later work.

#include "scan_common.cuh"

namespace {

template <typename T, bool SAVE>
__global__ void __launch_bounds__(kScanThreads, 1)
lstm_scan_fwd_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
                     T* __restrict__ ys, T* __restrict__ cs,
                     T* __restrict__ res, ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Chain ch = chain(cluster, a);
  const int W = a.W;
  const int G = 4 * W;
  const int ld = row_ld(W);
  const int C = 4 * ch.ucnt;
  const int C4 = 4 * a.U;
  // the layout, the same in every block
  float* h_s = reinterpret_cast<float*>(smem_raw);  // [2][kMaxRows][ld]
  float* part_s = h_s + 2 * kMaxRows * ld;
  float* act_s = part_s + part_floats(C4);  // [kMaxRows][C]
  float* c_s = act_s + kMaxRows * C4;       // [kMaxRows][U]
  T* w_s = reinterpret_cast<T*>(c_s + kMaxRows * a.U);  // [rs][C]

  const ColMap cm{ch.ucnt > 0 ? ch.ucnt : 1, W, ch.u0, G};
  load_weights(w_s, wh, cm, a.rs, C);
  for (int i = threadIdx.x; i < 2 * kMaxRows * ld; i += kScanThreads)
    h_s[i] = 0.0f;
  for (int i = threadIdx.x; i < kMaxRows * a.U; i += kScanThreads)
    c_s[i] = 0.0f;
  float* peer[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < a.NC) peer[q] = cluster.map_shared_rank(h_s, q);

  // this thread's (row, column) items of the gate step, and their xg; its
  // (row, unit) pairs of the cell update
  const int n_items = ch.nb * C;
  const int n_pairs = ch.nb * ch.ucnt;
  float xv[kMaxItems];
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int e = threadIdx.x + k * kScanThreads;
    if (e < n_items)
      xv[k] = to_f(xg[(size_t)(ch.b0 + e / C) * G + cm.col(e % C)]);
  }
  cluster.sync();  // every block has started and zeroed its h

  for (int t = 0; t < a.Tn; ++t) {
    const int cur = t & 1;
    if (C > 0)
      product(h_s + cur * kMaxRows * ld, ld, w_s, a.rs, wh, cm, C, W,
              part_s);
    __syncthreads();

    // gates: the slices' sums, xg and the activation
#pragma unroll
    for (int k = 0; k < kMaxItems; ++k) {
      const int e = threadIdx.x + k * kScanThreads;
      if (e < n_items) {
        const int b = e / C;
        const int c = e % C;
        const float pre = xv[k] + reduce_slices(part_s, b, c, C, W);
        const float act = c / ch.ucnt == 2 ? tanhf(pre) : sigmoid_f(pre);
        act_s[b * C + c] = act;
        if (SAVE)
          res[((size_t)t * a.B + ch.b0 + b) * 5 * W + cm.col(c)] =
              from_f<T>(act);
      }
    }
    __syncthreads();

    // the cell update of (row b, unit u), the new h to every block, and
    // the barrier's arrive; then the step's stores and the next step's xg
    T hq[kMaxPairs];
    float cn[kMaxPairs], tc[kMaxPairs];
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) {
      const int e = threadIdx.x + k * kScanThreads;
      if (e < n_pairs) {
        const int b = e / ch.ucnt;
        const int u = e % ch.ucnt;
        const float* g = act_s + b * C;
        const float ig = g[u], fg = g[ch.ucnt + u];
        const float gg = g[2 * ch.ucnt + u], og = g[3 * ch.ucnt + u];
        cn[k] = fg * c_s[b * a.U + u] + ig * gg;
        c_s[b * a.U + u] = cn[k];
        tc[k] = tanhf(cn[k]);
        hq[k] = from_f<T>(og * tc[k]);
        const float hv = to_f(hq[k]);
        const int slot = ((cur ^ 1) * kMaxRows + b) * ld + ch.u0 + u;
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < a.NC) peer[q][slot] = hv;
      }
    }
    cluster_arrive();
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) {
      const int e = threadIdx.x + k * kScanThreads;
      if (e < n_pairs) {
        const size_t row = (size_t)t * a.B + ch.b0 + e / ch.ucnt;
        const int unit = ch.u0 + e % ch.ucnt;
        ys[row * W + unit] = hq[k];
        cs[row * W + unit] = from_f<T>(cn[k]);
        if (SAVE) res[row * 5 * W + 4 * W + unit] = from_f<T>(tc[k]);
      }
    }
    if (t + 1 < a.Tn) {
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        const int e = threadIdx.x + k * kScanThreads;
        if (e < n_items)
          xv[k] = to_f(xg[((size_t)(t + 1) * a.B + ch.b0 + e / C) * G +
                          cm.col(e % C)]);
      }
    }
    cluster_wait();
  }
}

// Bytes of the shared-memory buffers other than the resident weights.
size_t fwd_fixed_bytes(const ScanArgs& a) {
  const int ld = row_ld(a.W);
  const int C4 = 4 * a.U;
  return align16(sizeof(float) *
                 (2 * kMaxRows * ld + part_floats(C4) + kMaxRows * C4 +
                  kMaxRows * a.U));
}

template <typename T>
cudaError_t run_fwd(const void* xg, const void* wh, void* ys, void* cs,
                    void* res, ScanArgs a, bool save, cudaStream_t stream) {
  const size_t fixed = fwd_fixed_bytes(a);
  const size_t row_bytes = sizeof(T) * 4 * a.U;
  a.rs = resident_rows(fixed, row_bytes, a.W);
  const size_t smem = fixed + row_bytes * a.rs;
  const T* x = static_cast<const T*>(xg);
  const T* w = static_cast<const T*>(wh);
  T* y = static_cast<T*>(ys);
  T* c = static_cast<T*>(cs);
  T* r = static_cast<T*>(res);
  if (save)
    return launch_chain(lstm_scan_fwd_kernel<T, true>, a, smem, stream, x, w,
                        y, c, r, a);
  return launch_chain(lstm_scan_fwd_kernel<T, false>, a, smem, stream, x, w,
                      y, c, r, a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the dtype of every tensor.  Device
// pointers of contiguous tensors: xg [T, B, 4W], wh [W, 4W], ys and cs
// [T, B, W] and, when save != 0, res [T, B, 5W] (ignored otherwise).
// cluster: blocks a chain spreads W over, 1..16 and at most W.  Launches
// on `stream` and returns the launch's error (0 on success).
int lstm_scan_fwd(int dtype, const void* xg, const void* wh, void* ys,
                  void* cs, void* res, int Tn, int B, int W, int save,
                  int cluster, void* stream) {
  ScanArgs a;
  if (!scan_geometry(Tn, B, W, cluster, &a) || (save && res == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_fwd<float>(xg, wh, ys, cs, res, a, save != 0, s);
  if (dtype == 1)
    return (int)run_fwd<__nv_bfloat16>(xg, wh, ys, cs, res, a, save != 0, s);
  return (int)cudaErrorInvalidValue;
}

const char* lstm_scan_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
