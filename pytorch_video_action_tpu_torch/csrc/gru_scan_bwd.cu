// The GRU scan backward for Hopper (sm_90a): from the saved gates, or
// recomputing them.
//
// Replaces: pytorch_video_action_tpu/ops/rnn_pallas.py
//   _gru_bwd_saved_kernel (pallas_call in _gru_bwd_saved_call, the default
//   backward of gru_scan_pallas's custom_vjp) and _gru_bwd_kernel
//   (pallas_call in _gru_bwd_call, the backward under PVA_RNN_RECOMPUTE=1).
//
// Inputs [T, B, *] in one dtype: the residuals res [4W] = [r, z, n, hg_n]
// of the saving forward, or (recompute) xg [3W] with bh [3W]; hp [W], the
// forward's ys one step earlier (0 at t = 0); dy [W]; wh [W, 3W] and its
// transpose whT [3W, W].  Per step t = T-1 .. 0, in f32:
//   (recompute) hg = hp[t] @ wh + bh; r, z, n from xg[t] and hg; hg_n
//   dh = dy[t] + dh_c;  dz = dh (hp - n);  dn = dh (1 - z) (1 - n^2)
//   dr = dn hg_n r (1 - r);  dzp = dz z (1 - z)
//   dxg[t] = [dr, dzp, dn] (in the input dtype);  dhg = [dr, dzp, dn r]
//   dh_c = dh z + rnd(dhg) @ wh^T
// dwh = sum over t and b of hp^T rnd(dhg) and dbh = sum of dhg, both in
// f32, written in wh's dtype.  rnd rounds to wh's dtype, the same as the
// inputs'.  Unlike the LSTM's, the hidden side's n-gate gradient is dn r,
// not dn: hg_n (which includes bh_n) enters n through r.
//
// What bounds it on an H100: at the BiGRU's training shape with
// hidden_dim_1 = 512 (B=8, T=1920, W=256) the carry products and dwh are
// 2 * 2*T*B*W*3W = 12.1 GFLOP, 0.18 ms at f32's 67 TFLOP/s (the recompute
// form a half more); the bytes about 0.16 GB, 0.05 ms.  The chain of T
// dependent steps binds.
//
// What the design does about it (the LSTM scan backward's, scan_common.cuh):
//  * The chain runs on a cluster of NC blocks; block r owns units [r*U,
//    r*U + U).  A step: each (row, unit) thread forms its unit's three gate
//    gradients (the gates of a unit are the block's), writes dxg, keeps
//    dh z for its own carry and a running f32 sum of dhg for dbh, and puts
//    rnd(dhg) into every block's shared memory (distributed shared memory);
//    one cluster barrier; then each block forms the product part of dh_c
//    for its own units, all 3W gradients against its rows of wh, held as
//    the [3W, U] slice of whT in shared memory (rows past the budget read
//    through L2).  The gradients are double-buffered, so that barrier is
//    the step's only wait across blocks.
//  * The cluster barrier is split: the gate gradients go to every block,
//    the arrive, then the stores of dxg and of rnd(dhg) (f32, for dwh) and
//    the loads of the next step's inputs into registers, then the wait.
//  * The recompute form first forms its units' gates from hp[t], a product
//    with its [W, 3U] slice of wh, as the forward does.
//  * dwh and dbh are off the chain: dwh a tiled SIMT GEMM (rnn_common.cuh)
//    over K = T*B after it, each output tile summing its whole K in order;
//    dbh each row's sum over t, then the rows' sums in order.  No atomics:
//    reruns are bit-identical.
// wgmma, TMA and a split-K dwh with a fixed-order reduction are later work.

#include "scan_common.cuh"

namespace {

// One (row, unit) step's inputs: the saved r, z, n, hg_n, or
// (recompute) xg's r, z and n parts in the first three; hp and dy.
struct StepIn {
  float g0, g1, g2, hn, hp, dy;
};

template <typename T, bool RECOMPUTE>
__device__ __forceinline__ void load_step(StepIn& in,
                                          const T* __restrict__ first,
                                          const T* __restrict__ hp,
                                          const T* __restrict__ dy,
                                          size_t row, int W, int unit) {
  const T* g = first + row * (RECOMPUTE ? 3 : 4) * W + unit;
  in.g0 = to_f(g[0]);
  in.g1 = to_f(g[W]);
  in.g2 = to_f(g[2 * W]);
  if (!RECOMPUTE) in.hn = to_f(g[3 * W]);
  in.hp = to_f(hp[row * W + unit]);
  in.dy = to_f(dy[row * W + unit]);
}

// RM rows a chain (kMaxRows, or 1 in the one-row forms), P (row, unit)
// pairs a thread, and with GX the gate gradients crossing the cluster in
// device memory (xbuf [chains][2][RM][ldg] f32) instead of shared memory.
template <typename T, bool RECOMPUTE, int RM, int P, bool GX>
__global__ void __launch_bounds__(kScanThreads, 1)
gru_scan_bwd_kernel(const T* __restrict__ first, const T* __restrict__ hp,
                    const T* __restrict__ dy, const T* __restrict__ wh,
                    const T* __restrict__ whT, const T* __restrict__ bh,
                    T* __restrict__ dxg, float* __restrict__ dhg,
                    float* __restrict__ bias_part, float* __restrict__ xbuf,
                    ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Chain ch = chain(cluster, a);
  const int W = a.W;
  const int G = 3 * W;
  const int ldg = row_ld(G);
  const int ldh = row_ld(W);
  const int C = 3 * ch.ucnt;
  // the layout, the same in every block
  float* dg_s = reinterpret_cast<float*>(smem_raw);  // [2][RM][ldg]
  float* part_s = dg_s + (GX ? 0 : 2 * RM * ldg);
  float* dh_s = part_s + part_floats(3 * a.U, RM);  // [RM][U]
  float* dz_s = dh_s + RM * a.U;                    // [RM][U]: dh z
  float* hp_s = dz_s + RM * a.U;                    // recompute: [RM][ldh]
  T* wT_s = reinterpret_cast<T*>(hp_s + (RECOMPUTE ? RM * ldh : 0));
  T* w_s = wT_s + (size_t)a.rs * a.U;  // recompute: [rs2][C]
  float* dg = GX ? xbuf + (size_t)(blockIdx.x / a.NC) * 2 * RM * ldg : dg_s;

  // whT rows are gate columns, its columns units: slice [3W, ucnt]
  const int uc = ch.ucnt > 0 ? ch.ucnt : 1;
  const ColMap cmT{uc, 0, ch.u0, W};
  const ColMap cm{uc, W, ch.u0, G};
  load_weights(wT_s, whT, cmT, a.rs, ch.ucnt);
  if (RECOMPUTE) load_weights(w_s, wh, cm, a.rs2, C);
  for (int i = threadIdx.x; i < RM * a.U; i += kScanThreads) {
    dh_s[i] = 0.0f;
    dz_s[i] = 0.0f;
  }
  // the rows past the chain's stay 0: the products sum them (GX: one row,
  // the chain's)
  if (!GX)
    for (int i = threadIdx.x; i < 2 * RM * ldg; i += kScanThreads)
      dg_s[i] = 0.0f;
  if (RECOMPUTE)
    for (int i = threadIdx.x; i < RM * ldh; i += kScanThreads)
      hp_s[i] = 0.0f;
  float* peer[kMaxCluster];
  if (!GX) {
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < a.NC) peer[q] = cluster.map_shared_rank(dg_s, q);
  }

  const int n_pairs = ch.nb * ch.ucnt;
  StepIn in[P];
  float bv[P][3], bsum[P][3];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int e = threadIdx.x + k * kScanThreads;
#pragma unroll
    for (int q = 0; q < 3; ++q) bsum[k][q] = 0.0f;
    if (e < n_pairs) {
      const int unit = ch.u0 + e % uc;
      if (RECOMPUTE)
#pragma unroll
        for (int q = 0; q < 3; ++q) bv[k][q] = to_f(bh[q * W + unit]);
      load_step<T, RECOMPUTE>(in[k], first, hp, dy,
                              (size_t)(a.Tn - 1) * a.B + ch.b0 + e / uc, W,
                              unit);
    }
  }
  cluster.sync();  // every block has started

  for (int s = 0; s < a.Tn; ++s) {
    const int t = a.Tn - 1 - s;
    const int cur = s & 1;
    const size_t row0 = (size_t)t * a.B + ch.b0;
    if (RECOMPUTE) {  // this block's hidden gates of step t from hp[t]
      for (int i = threadIdx.x; i < ch.nb * W; i += kScanThreads)
        hp_s[(i / W) * ldh + i % W] = to_f(hp[(row0 + i / W) * W + i % W]);
      __syncthreads();
      if (C > 0) product<T, RM>(hp_s, ldh, w_s, a.rs2, wh, cm, C, W, part_s);
      __syncthreads();
    }

    // each pair's gate gradients to every block, the barrier's arrive;
    // then their stores and the next step's inputs
    float dx[P][3], d[P][3];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int e = threadIdx.x + k * kScanThreads;
      if (e < n_pairs) {
        const int b = e / uc;
        const int u = e % uc;
        const StepIn& x = in[k];
        float r = x.g0, z = x.g1, n = x.g2, hn = x.hn;
        if (RECOMPUTE) {
          const float hr = reduce_slices<RM>(part_s, b, u, C, W) + bv[k][0];
          const float hz =
              reduce_slices<RM>(part_s, b, uc + u, C, W) + bv[k][1];
          hn = reduce_slices<RM>(part_s, b, 2 * uc + u, C, W) + bv[k][2];
          r = sigmoid_f(x.g0 + hr);
          z = sigmoid_f(x.g1 + hz);
          n = tanhf(x.g2 + r * hn);
        }
        const int p = b * a.U + u;
        const float dh = x.dy + dh_s[p];
        const float dz = dh * (x.hp - n);
        const float dn = dh * (1.0f - z) * (1.0f - n * n);
        dx[k][0] = dn * hn * r * (1.0f - r);
        dx[k][1] = dz * z * (1.0f - z);
        dx[k][2] = dn;
        dz_s[p] = dh * z;
        const float dhg_v[3] = {dx[k][0], dx[k][1], dn * r};
        const int slot = (cur * RM + b) * ldg + ch.u0 + u;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          bsum[k][q] += dhg_v[q];
          d[k][q] = rnd<T>(dhg_v[q]);
          if (GX) {
            dg[slot + q * W] = d[k][q];
          } else {
#pragma unroll
            for (int c = 0; c < kMaxCluster; ++c)
              if (c < a.NC) peer[c][slot + q * W] = d[k][q];
          }
        }
      }
    }
    if (GX) __threadfence();
    cluster_arrive();
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int e = threadIdx.x + k * kScanThreads;
      if (e < n_pairs) {
        const size_t off = (row0 + e / uc) * G + ch.u0 + e % uc;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          dxg[off + q * W] = from_f<T>(dx[k][q]);
          dhg[off + q * W] = d[k][q];
        }
      }
    }
    if (t > 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int e = threadIdx.x + k * kScanThreads;
        if (e < n_pairs)
          load_step<T, RECOMPUTE>(in[k], first, hp, dy, row0 - a.B + e / uc,
                                  W, ch.u0 + e % uc);
      }
    }
    cluster_wait();

    // dh_c of this block's units: dh z plus the carry product
    if (ch.ucnt > 0)
      product<T, RM, GX>(dg + cur * RM * ldg, ldg, wT_s, a.rs, whT, cmT,
                         ch.ucnt, G, part_s);
    __syncthreads();
    for (int e = threadIdx.x; e < n_pairs; e += kScanThreads) {
      const int p = (e / uc) * a.U + e % uc;
      dh_s[p] = dz_s[p] +
                reduce_slices<RM>(part_s, e / uc, e % uc, ch.ucnt, G);
    }
    __syncthreads();
  }

  // each row's dbh sums over t, for the fixed-order sum over the rows
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int e = threadIdx.x + k * kScanThreads;
    if (e < n_pairs) {
      float* out = bias_part + (size_t)(ch.b0 + e / uc) * G + ch.u0 + e % uc;
#pragma unroll
      for (int q = 0; q < 3; ++q) out[q * W] = bsum[k][q];
    }
  }
}

// dwh [W, 3W] = hp^T rnd(dhg) over K = T*B rows, one 64 x 64 tile a block
template <typename T>
__global__ void __launch_bounds__(kThreads)
dwh_kernel(const ShiftedRowsT<T> a, const RoundedRows<T> b, const Store<T> c,
           int M, int N, int K) {
  gemm_tile<kWT, kWT>(a, b, c, M, N, K, blockIdx.x * kWT, blockIdx.y * kWT);
}

// Bytes of a form's shared-memory buffers other than the resident
// weights: rm rows, the gradients' two buffers unless gx.
size_t bwd_fixed_bytes(const ScanArgs& a, bool recompute, int rm, bool gx) {
  size_t floats = (gx ? 0 : 2 * rm * (size_t)row_ld(3 * a.W)) +
                  part_floats(3 * a.U, rm) + 2 * rm * a.U;
  if (recompute) floats += rm * row_ld(a.W);
  return align16(sizeof(float) * floats);
}

template <typename T, int RM, int P, bool GX>
cudaError_t launch_bwd(bool recompute, const void* first, const void* hp,
                       const void* dy, const void* wh, const void* whT,
                       const void* bh, void* dxg, float* dhg,
                       float* bias_part, float* xbuf, ScanArgs a,
                       cudaStream_t stream) {
  const size_t fixed = bwd_fixed_bytes(a, recompute, RM, GX);
  if (!form_fits<RM, P>(a, fixed)) return cudaErrorInvalidValue;
  // the carry product's slice [3W, U] first; recompute: then [W, 3U]
  const size_t rowT = sizeof(T) * a.U;
  a.rs = resident_rows(fixed, rowT, 3 * a.W);
  size_t smem = fixed + rowT * a.rs;
  if (recompute) {
    const size_t row = sizeof(T) * 3 * a.U;
    a.rs2 = resident_rows(smem, row, a.W);
    smem += row * a.rs2;
  }
  const T* f = static_cast<const T*>(first);
  const T* h = static_cast<const T*>(hp);
  const T* d = static_cast<const T*>(dy);
  const T* w = static_cast<const T*>(wh);
  const T* wt = static_cast<const T*>(whT);
  const T* bb = static_cast<const T*>(bh);
  T* dx = static_cast<T*>(dxg);
  return recompute
             ? launch_chain(gru_scan_bwd_kernel<T, true, RM, P, GX>, a, smem,
                            stream, f, h, d, w, wt, bb, dx, dhg, bias_part,
                            xbuf, a)
             : launch_chain(gru_scan_bwd_kernel<T, false, RM, P, GX>, a,
                            smem, stream, f, h, d, w, wt, bb, dx, dhg,
                            bias_part, xbuf, a);
}

template <typename T>
cudaError_t run_bwd(bool recompute, int form, const void* first,
                    const void* hp, const void* dy, const void* wh,
                    const void* whT, const void* bh, void* dxg, float* dhg,
                    float* bias_part, float* xbuf, void* dwh, void* dbh,
                    ScanArgs a, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (form == kFull)
    err = launch_bwd<T, kMaxRows, kMaxPairs, false>(
        recompute, first, hp, dy, wh, whT, bh, dxg, dhg, bias_part, xbuf, a,
        stream);
  else if (form == kOne)
    err = launch_bwd<T, 1, kWidePairs, false>(recompute, first, hp, dy, wh,
                                              whT, bh, dxg, dhg, bias_part,
                                              xbuf, a, stream);
  else if (form == kGx && xbuf != nullptr)
    err = launch_bwd<T, 1, kWidePairs, true>(recompute, first, hp, dy, wh,
                                             whT, bh, dxg, dhg, bias_part,
                                             xbuf, a, stream);
  if (err != cudaSuccess) return err;
  const T* h = static_cast<const T*>(hp);
  const int M = a.Tn * a.B;
  const int G = 3 * a.W;
  const dim3 grid((a.W + kWT - 1) / kWT, (G + kWT - 1) / kWT);
  dwh_kernel<T><<<grid, kThreads, 0, stream>>>(
      ShiftedRowsT<T>{h, a.W, 0, M}, RoundedRows<T>{dhg, G},
      Store<T>{static_cast<T*>(dwh), G}, a.W, G, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const BiasOuts<T> out = {{static_cast<T*>(dbh)}};
  return launch_bias_reduce<T>(bias_part, out, 1, a.B, G, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the dtype of every tensor but the f32
// scratch.  Device pointers of contiguous tensors: first = res [T, B, 4W]
// (recompute == 0) or xg [T, B, 3W] (recompute != 0); hp, dy [T, B, W];
// wh [W, 3W] and whT = wh^T [3W, W]; bh [3W] (recompute only, ignored
// otherwise); outputs dxg [T, B, 3W], dwh [W, 3W] and dbh [3W]; f32
// scratch dhg [T, B, 3W], bias_part [B, 3W] and, the Gx form, xbuf
// [B][2][round4(3W)] (the gradients' exchange in device memory).  The
// launch (ops/rnn_scan.py::scan_form): cluster, the blocks a chain spreads
// W over, 1..16 and at most W; rows a chain; form, where the gradients
// cross the cluster (scan_common.cuh's Form: 0 Full, 1 One, 2 Gx).
// Launches on `stream` and returns the launches' error (0 on success).
int gru_scan_bwd(int dtype, int recompute, const void* first, const void* hp,
                 const void* dy, const void* wh, const void* whT,
                 const void* bh, void* dxg, float* dhg, float* bias_part,
                 float* xbuf, void* dwh, void* dbh, int Tn, int B, int W,
                 int cluster, int rows, int form, void* stream) {
  ScanArgs a;
  if (!scan_geometry(Tn, B, W, cluster, rows, &a) ||
      (recompute && bh == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bwd<float>(recompute != 0, form, first, hp, dy, wh, whT,
                               bh, dxg, dhg, bias_part, xbuf, dwh, dbh, a,
                               s);
  if (dtype == 1)
    return (int)run_bwd<__nv_bfloat16>(recompute != 0, form, first, hp, dy,
                                       wh, whT, bh, dxg, dhg, bias_part, xbuf,
                                       dwh, dbh, a, s);
  return (int)cudaErrorInvalidValue;
}

const char* gru_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
