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
// The eval form (row 9) runs on the register-resident chain of
// scan_chain.cuh, as the LSTM scan's forward does.  The first design (the
// saving form's below) took 4.1 us a step at B=8, W=256: its product from
// shared memory over all 8 rows 1.8, the peer stores and the cluster
// barrier 0.8, the gate math 0.2, the rest (block barriers, round trips
// through shared memory, xg's loads) 1.5 (PERF.md section 6, the step
// split of tools/torch_lstm_scan_steps.py --kernel 9).  So:
//  * Geometry from storage (ops/rnn_scan.py::chain_geometry): the
//    LSTM's, a unit's three gate columns on three of its four lane groups
//    of S depth slices; the fourth group holds no weights (it reads n's
//    column in the L2 tier, the same addresses as n's lanes) and its sums
//    go unused.  Three groups of S lanes do not divide a warp; packing 10
//    units a warp (30 lanes) would put a unit's lanes across a slice
//    boundary of the shuffles and change the geometry's block counts, for
//    no gain in a step: a warp's lanes run in lockstep, so an idle lane
//    costs registers, not time, and at W=256 in f32 the padded layout takes
//    the LSTM forward's 8 blocks of 128 weights a thread (the 768 KiB of
//    wh would fit 6 blocks only at a chain width that is not a power of
//    two).  The packed layout was not built.
//  * The n gate: n's lanes keep hg_n = their product + bh_n apart (it
//    enters n through r, tanh(xg_n + r * hg_n)); r's and z's lanes form
//    sigmoid(xg + hg + bh).  Every lane of a unit gathers r, z, hg_n and
//    xg_n by shuffles and carries h in f32 in registers.
//  * h goes to every block by st.async onto the receiver's mbarrier; xg
//    of the next step is loaded at the end of a step, its rows prefetched
//    into L2 four steps ahead.  W=768, 7 MiB of f32 weights, reads its
//    depth past registers and shared memory through L2 (or in rounds).
//
// The saving form (row 10) keeps the first design, on scan_common.cuh:
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

#include "scan_chain.cuh"
#include "scan_common.cuh"

namespace {
namespace rc {

// The eval form (row 9) on the chain of scan_chain.cuh.  Block rank q owns
// units [q*U, q*U + ucnt); thread tid is depth slice s = tid % S of lane
// group g = (tid / S) % 4 of local unit tid / (4S) + i*UT in round i (one
// round unless WIDE): groups 0, 1, 2 hold the r, z and n columns of wh,
// group 3 none (it reads n's column and its sums go unused).  h_s
// [2][RM][ldh] f32 (slice s of a row at s*LP), then two mbarriers (one an
// h buffer), then the shared-memory weights [ls*sizeof(T)/16][nthr]
// 16-byte chunks or, with WIDE, each thread's h carry [R][RM][nthr] f32.
template <typename T, int RM, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
gru_scan_eval_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
                     const T* __restrict__ bh, T* __restrict__ ys,
                     ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* h_s = reinterpret_cast<float*>(smem_raw);
  const int hfloats = 2 * RM * a.ldh;
  uint64_t* bars = reinterpret_cast<uint64_t*>(h_s + hfloats);
  uint4* w_s = reinterpret_cast<uint4*>(bars + 2);
  float* c_s = reinterpret_cast<float*>(bars + 2);

  const int tid = threadIdx.x;
  const int rank = a.NC > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int chain = blockIdx.x / a.NC;
  const int b0 = chain * a.rows;
  const int nb = min(a.rows, a.B - b0);
  const int u0 = rank * a.U;
  const int ucnt = min(a.U, a.W - u0);
  const int s = tid % a.S;
  const int g = (tid / a.S) % 4;
  const int gc = min(g, 2);  // the gate whose column the lane reads
  const int ul = tid / (4 * a.S);
  const int d0 = s * a.L;
  const int k = tid % (4 * a.S);                 // lane in the unit's group
  const int base = (tid & 31) - (tid & 31) % (4 * a.S);  // group's lane 0
  const int nr = WIDE ? a.R : 1;
  // round 0's unit (the only one unless WIDE; threads past a round's UT
  // units have none): whether the block has it, its column (a column to
  // read, always) and its place in h's rows.  Round i's is i*UT further.
  const bool on0 = ul < ucnt && (!WIDE || ul < a.UT);
  const int unit0 = u0 + ul;
  const int col0 = gc * a.W + (on0 ? unit0 : 0);
  const int uoff0 = on0 ? (unit0 / a.L) * a.LP + unit0 % a.L : 0;

  // the weights: registers, then shared memory (WIDE: L2 only)
  uint32_t wr[kRegWords];
  if constexpr (!WIDE) {
    load_resident(wr, w_s, wh + col0, a.G, a, d0, on0 && g < 3, tid);
  } else {
    for (int i = 0; i < a.R * RM; ++i) c_s[(size_t)i * a.nthr + tid] = 0.0f;
  }
  for (int i = tid; i < hfloats; i += blockDim.x) h_s[i] = 0.0f;
  const uint32_t bar0 = smem_u32(bars), h0 = smem_u32(h_s);
  const uint32_t bytes = 4u * (uint32_t)a.W * (uint32_t)nb;
  if (a.NC > 1) {
    if (tid == 0) {
      bar_init(bar0);
      bar_init(bar0 + 8);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      // buffer 1 receives h of step 1, buffer 0 that of step 2
      if (a.Tn > 1) bar_expect(bar0 + 8, bytes);
      if (a.Tn > 2) bar_expect(bar0, bytes);
    }
    cg::this_cluster().sync();  // every block set up before any store
    // a warp with no unit of this block has nothing to do (round 0 holds
    // a thread's lowest unit)
    if (!__any_sync(0xffffffffu, on0)) return;
  } else {
    __syncthreads();
  }

  const size_t ldx = (size_t)a.B * a.G;
  float xv[RM], hc[RM];
  float bv = to_f(bh[col0]);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    xv[r] = r < nb ? to_f(xg[(size_t)(b0 + r) * a.G + col0]) : 0.0f;
    hc[r] = 0.0f;
  }
  for (int i = 0; i < nr; ++i) {
    const int col = on0 && ul + i * a.UT < ucnt ? col0 + i * a.UT : col0;
    for (int t = 1; t < kAhead && t < a.Tn; ++t)
      for (int r = 0; r < nb; ++r)
        prefetch_l2(xg + t * ldx + (size_t)(b0 + r) * a.G + col);
  }

  for (int t = 0; t < a.Tn; ++t) {
    const int cur = t & 1;
    const int nxt = cur ^ 1;
    if (a.NC > 1 && t > 0) {
      bar_wait(bar0 + 8 * cur, ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 < a.Tn) bar_expect(bar0 + 8 * cur, bytes);
    }
    for (int i = 0; i < nr; ++i) {
      bool on = on0;
      int unit = unit0, col = col0, uoff = uoff0;
      if constexpr (WIDE) {  // this round's unit, xg, bh and h carry
        unit = unit0 + i * a.UT;
        on = on0 && ul + i * a.UT < ucnt;
        col = gc * a.W + (on ? unit : 0);
        uoff = on ? (unit / a.L) * a.LP + unit % a.L : 0;
        bv = to_f(bh[col]);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          xv[r] = r < nb ? to_f(xg[t * ldx + (size_t)(b0 + r) * a.G + col])
                         : 0.0f;
          hc[r] = c_s[(size_t)(i * RM + r) * a.nthr + tid];
        }
      }
      float pre[RM];
      product<T, RM, WIDE>(wr, w_s + tid, wh + col, a.G,
                           h_s + cur * RM * a.ldh + s * a.LP, a, d0, pre);
      // the slices' sums plus bh (the same in every slice's lane): r and z
      // in their lanes, hg_n kept apart in n's (it enters n through r);
      // each lane gathers r, z, hg_n and xg_n of its unit and updates h
      T hq[RM];
      float hv[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float sum = pre[r];
        for (int o = 1; o < a.S; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float hg = sum + bv;
        const float act = g < 2 ? sigmoid_f(xv[r] + hg) : hg;
        const int lane = base + s;
        const float rg = __shfl_sync(0xffffffffu, act, lane);
        const float zg = __shfl_sync(0xffffffffu, act, lane + a.S);
        const float hn = __shfl_sync(0xffffffffu, act, lane + 2 * a.S);
        const float xn = __shfl_sync(0xffffffffu, xv[r], lane + 2 * a.S);
        const float n = tanhf(xn + rg * hn);
        hc[r] = (1.0f - zg) * n + zg * hc[r];
        hq[r] = from_f<T>(hc[r]);
        hv[r] = to_f(hq[r]);
      }
      if constexpr (WIDE) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
          c_s[(size_t)(i * RM + r) * a.nthr + tid] = hc[r];
      }
      // the new h to every block (or to this one), then the step's stores
      // and the next step's xg
      if (t + 1 < a.Tn && on) {
        const uint32_t slot = h0 + 4u * (uint32_t)(nxt * RM * a.ldh + uoff);
        if (a.NC > 1) {
          for (int q = k; q < a.NC; q += 4 * a.S) {
            const uint32_t dst = peer_u32(slot, q);
            const uint32_t bar = peer_u32(bar0 + 8 * nxt, q);
#pragma unroll
            for (int r = 0; r < RM; ++r)
              if (r < nb) send_h(dst + 4u * r * a.ldh, hv[r], bar);
          }
        } else if (k == 3) {
#pragma unroll
          for (int r = 0; r < RM; ++r)
            if (r < nb) h_s[nxt * RM * a.ldh + r * a.ldh + uoff] = hv[r];
        }
      }
      if (on && k == 0) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
          if (r < nb) ys[((size_t)t * a.B + b0 + r) * a.W + unit] = hq[r];
      }
      if (t + 1 < a.Tn) {
        if constexpr (!WIDE) {
#pragma unroll
          for (int r = 0; r < RM; ++r)
            xv[r] = r < nb ? to_f(xg[(t + 1) * ldx + (size_t)(b0 + r) * a.G +
                                     col])
                           : 0.0f;
        }
        if (t + kAhead < a.Tn)
          for (int r = 0; r < nb; ++r)
            prefetch_l2(xg + (t + kAhead) * ldx + (size_t)(b0 + r) * a.G +
                        col);
      }
    }
    if (a.NC == 1) __syncthreads();
  }
}

template <typename T, int RM, bool WIDE>
cudaError_t launch_eval(const ChainArgs& a, cudaStream_t stream,
                        const void* xg, const void* wh, const void* bh,
                        void* ys) {
  return launch_chain(gru_scan_eval_kernel<T, RM, WIDE>, a,
                      chain_smem<T>(a, RM), stream, static_cast<const T*>(xg),
                      static_cast<const T*>(wh), static_cast<const T*>(bh),
                      static_cast<T*>(ys), a);
}

template <typename T, int RM>
cudaError_t eval_rows(const ChainArgs& a, cudaStream_t stream, const void* xg,
                      const void* wh, const void* bh, void* ys) {
  if (a.R > 1) {  // rounds: 1, 2 or 4 rows a chain
    if constexpr (RM == 1 || RM == 2 || RM == 4)
      return launch_eval<T, RM, true>(a, stream, xg, wh, bh, ys);
    return cudaErrorInvalidValue;
  }
  return launch_eval<T, RM, false>(a, stream, xg, wh, bh, ys);
}

template <typename T>
cudaError_t run_eval(const ChainArgs& a, cudaStream_t stream, const void* xg,
                     const void* wh, const void* bh, void* ys) {
  switch (a.rows) {
    case 1: return eval_rows<T, 1>(a, stream, xg, wh, bh, ys);
    case 2: return eval_rows<T, 2>(a, stream, xg, wh, bh, ys);
    case 3: return eval_rows<T, 3>(a, stream, xg, wh, bh, ys);
    case 4: return eval_rows<T, 4>(a, stream, xg, wh, bh, ys);
    case 6: return eval_rows<T, 6>(a, stream, xg, wh, bh, ys);
    case 8: return eval_rows<T, 8>(a, stream, xg, wh, bh, ys);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rc

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
                    void* res, ScanArgs a, cudaStream_t stream) {
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
  return launch_chain(gru_scan_fwd_kernel<T, true>, a, smem, stream, x, w,
                      bb, y, r, a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the dtype of every tensor.  Device
// pointers of contiguous tensors: xg [T, B, 3W], wh [W, 3W], bh [3W], ys
// [T, B, W] and res [T, B, 4W].  The saving form (row 10) on
// scan_common.cuh's chain; cluster: blocks a chain spreads W over, 1..16
// and at most W.  Launches on `stream` and returns the launch's error (0
// on success).
int gru_scan_fwd(int dtype, const void* xg, const void* wh, const void* bh,
                 void* ys, void* res, int Tn, int B, int W, int cluster,
                 void* stream) {
  ScanArgs a;
  if (!scan_geometry(Tn, B, W, cluster, &a) || res == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_fwd<float>(xg, wh, bh, ys, res, a, s);
  if (dtype == 1)
    return (int)run_fwd<__nv_bfloat16>(xg, wh, bh, ys, res, a, s);
  return (int)cudaErrorInvalidValue;
}

// The eval form (row 9) on scan_chain.cuh's chain: xg, wh, bh and ys as
// above; the geometry (ops/rnn_scan.py::chain_geometry) as
// lstm_scan_fwd's: nc blocks a chain, s depth slices a column, rows a
// chain, ls of shared-memory depth, rounds.
int gru_scan_eval(int dtype, const void* xg, const void* wh, const void* bh,
                  void* ys, int Tn, int B, int W, int nc, int s, int rows,
                  int ls, int rounds, void* stream) {
  rc::ChainArgs a;
  const int chunk = dtype == 0 ? 4 : 8;
  if (!rc::chain_args(Tn, B, W, 3, 1, nc, s, rows, ls, rounds, chunk, &a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)rc::run_eval<float>(a, st, xg, wh, bh, ys);
  if (dtype == 1)
    return (int)rc::run_eval<__nv_bfloat16>(a, st, xg, wh, bh, ys);
  return (int)cudaErrorInvalidValue;
}

const char* gru_scan_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
