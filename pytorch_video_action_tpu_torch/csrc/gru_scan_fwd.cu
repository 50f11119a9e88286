// The GRU scan forward for Hopper (sm_90a), eval and saving forms.
//
// Replaces: pytorch_video_action_tpu/ops/rnn_pallas.py
//   _gru_fwd_kernel (pallas_call in _gru_fwd, the eval form of
//   gru_scan_pallas) and _gru_fwd_save_kernel (pallas_call in
//   _gru_fwd_save, the training forward of its custom_vjp).
//
// Computes, for xg [T, B, 3W] (the input projection with bi only, gates
// r, z, n), wh [W, 3W] and bh [3W], from h = 0:
//   hg = rnd(h) @ wh + bh;  r = sigmoid(xg_r + hg_r);  z = sigmoid(xg_z + hg_z)
//   n = tanh(xg_n + r * hg_n);  h' = (1 - z) * n + z * h
// ys[t] = h' [T, B, W] and, in the saving form, res[t] = [r, z, n, hg_n]
// [T, B, 4W] (hg_n includes bh_n), stored in xg's dtype.  rnd rounds h to
// wh's dtype (the same as xg's); products accumulate in f32; h is carried
// in f32.  The raw recurrence: no mask, the caller masks ys.
//
// What bounds it on an H100: at the BiGRU's training shape with
// hidden_dim_1 = 512 (B=8, T=1920, W=256) the hidden products are
// 2*T*B*W*3W = 6.04 GFLOP, 0.09 ms at f32's 67 TFLOP/s, and the bytes (xg
// in, ys and res out) about 0.12 GB, 0.04 ms.  Neither binds: the chain of
// T dependent steps does, each a [B, W] x [W, 3W] product, the gates and
// an exchange of h between SMs.
//
// What the design does about it (the LSTM scan's, scan_common.cuh):
//  * The chain runs on a cluster of NC blocks: block r owns units [r*U,
//    r*U + U) and the three gate columns of each, so the gate math and the
//    carry update stay in the block; its [W, 3U] slice of wh sits in
//    shared memory as far as the budget goes (at W=512 in f32 the rows past
//    it are read through L2 every step).
//  * A step: the block's product of the carried rows' rounded h (all W,
//    from its own shared memory) with its slice; each (row, unit) thread
//    adds bh and its three slice sums, forms r, z, n and h' from xg and its
//    f32 carry, and writes rnd(h') into every block of the cluster
//    (distributed shared memory); one cluster barrier.  h is
//    double-buffered, so that barrier is the step's only wait across
//    blocks.
//  * The cluster barrier is split: the new h goes to every block, the
//    arrive, then the step's stores of ys and res and the loads of the next
//    step's xg into registers, then the wait.
//  * Up to 8 batch rows share a cluster and each weight read; more rows
//    take more clusters.
// wgmma and TMA are later work.

#include "scan_common.cuh"

namespace {

template <typename T, bool SAVE>
__global__ void __launch_bounds__(kScanThreads, 1)
gru_scan_fwd_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
                    const T* __restrict__ bh, T* __restrict__ ys,
                    T* __restrict__ res, ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Chain ch = chain(cluster, a);
  const int W = a.W;
  const int G = 3 * W;
  const int ld = row_ld(W);
  const int C = 3 * ch.ucnt;
  // the layout, the same in every block
  float* h_s = reinterpret_cast<float*>(smem_raw);  // [2][kMaxRows][ld]
  float* part_s = h_s + 2 * kMaxRows * ld;
  float* hc_s = part_s + part_floats(3 * a.U);  // [kMaxRows][U], f32 carry
  T* w_s = reinterpret_cast<T*>(hc_s + kMaxRows * a.U);  // [rs][C]

  const int uc = ch.ucnt > 0 ? ch.ucnt : 1;
  const ColMap cm{uc, W, ch.u0, G};
  load_weights(w_s, wh, cm, a.rs, C);
  for (int i = threadIdx.x; i < 2 * kMaxRows * ld; i += kScanThreads)
    h_s[i] = 0.0f;
  for (int i = threadIdx.x; i < kMaxRows * a.U; i += kScanThreads)
    hc_s[i] = 0.0f;
  float* peer[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < a.NC) peer[q] = cluster.map_shared_rank(h_s, q);

  // this thread's (row, unit) pairs: their bh and xg of the first step
  const int n_pairs = ch.nb * ch.ucnt;
  float bv[kMaxPairs][3], xv[kMaxPairs][3];
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int e = threadIdx.x + k * kScanThreads;
    if (e < n_pairs) {
      const int unit = ch.u0 + e % uc;
      const T* x = xg + (size_t)(ch.b0 + e / uc) * G + unit;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        bv[k][q] = to_f(bh[q * W + unit]);
        xv[k][q] = to_f(x[q * W]);
      }
    }
  }
  cluster.sync();  // every block has started and zeroed its h

  for (int t = 0; t < a.Tn; ++t) {
    const int cur = t & 1;
    if (C > 0)
      product(h_s + cur * kMaxRows * ld, ld, w_s, a.rs, wh, cm, C, W,
              part_s);
    __syncthreads();

    // the gates and the carry update of (row b, unit u), the new h to
    // every block, and the barrier's arrive; then the step's stores and
    // the next step's xg
    T hq[kMaxPairs];
    float gv[kMaxPairs][4];
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) {
      const int e = threadIdx.x + k * kScanThreads;
      if (e < n_pairs) {
        const int b = e / uc;
        const int u = e % uc;
        const float hr = reduce_slices(part_s, b, u, C, W) + bv[k][0];
        const float hz = reduce_slices(part_s, b, uc + u, C, W) + bv[k][1];
        const float hn = reduce_slices(part_s, b, 2 * uc + u, C, W) +
                         bv[k][2];
        const float r = sigmoid_f(xv[k][0] + hr);
        const float z = sigmoid_f(xv[k][1] + hz);
        const float n = tanhf(xv[k][2] + r * hn);
        float* hc = hc_s + b * a.U + u;
        const float h = (1.0f - z) * n + z * *hc;
        *hc = h;
        hq[k] = from_f<T>(h);
        gv[k][0] = r;
        gv[k][1] = z;
        gv[k][2] = n;
        gv[k][3] = hn;
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
        const size_t row = (size_t)t * a.B + ch.b0 + e / uc;
        const int unit = ch.u0 + e % uc;
        ys[row * W + unit] = hq[k];
        if (SAVE) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            res[row * 4 * W + q * W + unit] = from_f<T>(gv[k][q]);
        }
      }
    }
    if (t + 1 < a.Tn) {
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        const int e = threadIdx.x + k * kScanThreads;
        if (e < n_pairs) {
          const T* x = xg + ((size_t)(t + 1) * a.B + ch.b0 + e / uc) * G +
                       ch.u0 + e % uc;
#pragma unroll
          for (int q = 0; q < 3; ++q) xv[k][q] = to_f(x[q * W]);
        }
      }
    }
    cluster_wait();
  }
}

// Bytes of the shared-memory buffers other than the resident weights.
size_t fwd_fixed_bytes(const ScanArgs& a) {
  return align16(sizeof(float) * (2 * kMaxRows * row_ld(a.W) +
                                  part_floats(3 * a.U) + kMaxRows * a.U));
}

template <typename T>
cudaError_t run_fwd(const void* xg, const void* wh, const void* bh, void* ys,
                    void* res, ScanArgs a, bool save, cudaStream_t stream) {
  const size_t fixed = fwd_fixed_bytes(a);
  if (fixed > kScanSmem) return cudaErrorInvalidValue;
  const size_t row_bytes = sizeof(T) * 3 * a.U;
  a.rs = resident_rows(fixed, row_bytes, a.W);
  const size_t smem = fixed + row_bytes * a.rs;
  const T* x = static_cast<const T*>(xg);
  const T* w = static_cast<const T*>(wh);
  const T* bb = static_cast<const T*>(bh);
  T* y = static_cast<T*>(ys);
  T* r = static_cast<T*>(res);
  if (save)
    return launch_chain(gru_scan_fwd_kernel<T, true>, a, smem, stream, x, w,
                        bb, y, r, a);
  return launch_chain(gru_scan_fwd_kernel<T, false>, a, smem, stream, x, w,
                      bb, y, r, a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the dtype of every tensor.  Device
// pointers of contiguous tensors: xg [T, B, 3W], wh [W, 3W], bh [3W], ys
// [T, B, W] and, when save != 0, res [T, B, 4W] (ignored otherwise).
// cluster: blocks a chain spreads W over, 1..16 and at most W.  Launches
// on `stream` and returns the launch's error (0 on success).
int gru_scan_fwd(int dtype, const void* xg, const void* wh, const void* bh,
                 void* ys, void* res, int Tn, int B, int W, int save,
                 int cluster, void* stream) {
  ScanArgs a;
  if (!scan_geometry(Tn, B, W, cluster, &a) || (save && res == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_fwd<float>(xg, wh, bh, ys, res, a, save != 0, s);
  if (dtype == 1)
    return (int)run_fwd<__nv_bfloat16>(xg, wh, bh, ys, res, a, save != 0, s);
  return (int)cudaErrorInvalidValue;
}

const char* gru_scan_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
