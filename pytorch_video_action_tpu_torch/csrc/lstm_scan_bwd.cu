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
// wh [W, 4W] (and, recompute, its transpose whT [4W, W]).  Per step t =
// T-1 .. 0, in f32:
//   (recompute) a = xg[t] + hp[t] @ wh, i, f, g, o from a, tanh c from cs[t]
//   dh = dy[t] + dh_c;  dc = dh * o * (1 - tanh_c^2) + dc_c
//   dg = [dc g i (1-i), dc cp f (1-f), dc i (1-g^2), dh tanh_c o (1-o)]
//   dxg[t] = dg (in the input dtype);  dh_c = rnd(dg) @ wh^T;  dc_c = dc f
// and dwh = sum over t and b of hp^T rnd(dg) in f32, written in wh's dtype.
// rnd rounds to wh's dtype, the same as the inputs'.
//
// What bounds it on an H100: at vanilla_lstm's training shape (B=8,
// T=1920, W=256) the carry product is 2*T*B*W*4W = 8.05 GFLOP, 0.12 ms at
// f32's 67 TFLOP/s, and dwh as many, 0.05 ms as 3xTF32 on the tensor cores
// (the recompute form's gates a third more, SIMT); the bytes about 0.2 GB,
// 0.06 ms.  The chain of T dependent steps binds.
//
// The saved-gates form (row 15), on the register-resident chain of
// scan_chain.cuh.  The first design (scan_common.cuh's chain, as the
// recompute form below still runs) took 6.4 us a step at B=8, W=256, of it
// the carry product and the cluster barrier most (PERF.md section 6, the
// step split of tools/torch_lstm_scan_steps.py --kernel 15), and its
// [2][8][4W] f32 gradient buffers passed the shared memory past W = 870.
// Where the weights sit and what crosses the cluster:
//  * (a) a block keeps the rows of wh of its own units, [U, 4W], and
//    receives every block's rounded gate gradients, 4W values a row; or
//    (b) it keeps the forward's columns of its own gates, [W, 4U], forms a
//    partial dh_c of all W units from its own gradients and sends each peer
//    the U partials of its units, a quarter of the values, to be added in
//    rank order.  (a) is taken: its thread (unit u, column chunk g, depth
//    slice s) keeps wh[u, g*W + s*L ..] in registers, the forward's thread
//    layout with a row of wh for a column, so the forward's geometry,
//    product, weight tiers and exchange serve it unchanged, and a unit's 4S
//    lanes end the step's product with dh_c by shuffles, with no block
//    barrier.  (b) needs a second thread layout for its product (one lane
//    an output unit of all W) and a block barrier a step between the unit
//    lanes that form the gradients and the product lanes that read them,
//    the cost that the forward's redesign took out (the first design's
//    barriers and shared-memory round trips were 2.5 of 5.7 us a step),
//    to save stores that are a one-way latency each: in the forward the
//    exchange took about 0.1 of 1.0 us a step.
//  * A step: wait for the buffer of the previous step's gradients, the
//    carry product (dh_c of the unit in all its lanes), the cell in every
//    lane (dc_c carried in f32 in registers), then lane group g rounds its
//    gate's gradient, sends it to every block (st.async onto the
//    receiver's mbarrier, lanes s, s + S, .. of the peers), stores dxg, and
//    loads the next step's res, cp and dy, whose rows are prefetched into
//    L2 four steps ahead.
//  * dwh is off the chain: hp^T dxg (dxg is rnd(dg) as stored) on the
//    tensor cores, rnn_wgmma.cuh's dwh_wgmma_kernel on its producer ring
//    and wgmma products (row 2's dwh_d, ShiftedRowsT operands), K = T*B split into slices of whole
//    64-row chunks (ops/rnn_scan.py::dwh_slices), the slices' f32 partials
//    added in order after: no atomics, reruns are bit-identical.  Inside a
//    slice the accumulators restart every 8 chunks (run_products' sums):
//    the f32 sums inside the tensor cores lose precision with the chunks
//    they add (in f32 1.06e-4 of dwh's largest element at 240 chunks,
//    past the 1e-4 gate, against 3.6e-6 at 8), the CUDA cores' ordered sum
//    of the runs does not.
//
// The recompute form (row 16) keeps scan_common.cuh's chain: the cell
// threads form their units' gate gradients, write dxg and put the rounded
// gradients into every block's shared memory; one cluster barrier; each
// block forms dh_c of its own units from all 4W gradients with its [4W, U]
// slice of whT; first it forms its units' gates from hp[t], a product with
// its [W, 4U] slice of wh.  Its buffers hold RM rows: 8, or 1 where 8 would
// pass the shared memory (W past about 850); past about 5984, where one
// row's [2][4W] f32 gradients pass it too, they cross the cluster in
// device memory (scan_common.cuh's GX form, read back through L2).

#include "rnn_wgmma.cuh"
#include "scan_chain.cuh"
#include "scan_common.cuh"

namespace {
namespace rc {

// One (row, unit) step's inputs from the saved gates.
struct StepIn {
  float i, f, g, o, tc, cp, dy;
};

template <typename T>
__device__ __forceinline__ void load_in(StepIn& in, const T* __restrict__ res,
                                        const T* __restrict__ cp,
                                        const T* __restrict__ dy, size_t row,
                                        int W, int unit) {
  const T* r = res + row * 5 * W + unit;
  in.i = to_f(r[0]);
  in.f = to_f(r[W]);
  in.g = to_f(r[2 * W]);
  in.o = to_f(r[3 * W]);
  in.tc = to_f(r[4 * W]);
  in.cp = to_f(cp[row * W + unit]);
  in.dy = to_f(dy[row * W + unit]);
}

// The seven inputs of a (row, unit) into L2, lane k's share of them.
template <typename T>
__device__ __forceinline__ void prefetch_in(const T* res, const T* cp,
                                            const T* dy, size_t row, int W,
                                            int unit, int k, int lanes) {
  for (int q = k; q < 7; q += lanes)
    prefetch_l2(q < 5 ? res + row * 5 * W + q * W + unit
                      : (q == 5 ? cp : dy) + row * W + unit);
}

// One chain of a.rows batch rows on a cluster of a.NC blocks, steps in
// reverse.  Block rank q owns units [q*U, q*U + ucnt); thread tid is depth
// slice s = tid % S of column chunk g = (tid / S) % 4 (wh's columns
// [g*W, g*W + W), the gradients of gate g) of local unit tid / (4S) + i*UT
// in round i (one round unless WIDE).  dg_s [2][RM][ldh] f32, a row's
// 4W rounded gradients (column g*W + d of a row at (g*S + d / L)*LP +
// d % L), then two mbarriers (one a buffer), then the shared-memory
// weights [ls*sizeof(T)/16][nthr] 16-byte chunks or, with WIDE, each
// thread's dc carry [R][RM][nthr] f32.  With GX (only with WIDE, one row a
// chain: where even one row's two buffers pass the shared memory, W past
// 6968) the two buffers of dg_s are in device memory instead, xbuf
// [chains][2][RM][ldh]: a unit's lane group writes its gradient there once,
// a fence and a cluster barrier end the step, and the product reads them
// through L2.
template <typename T, int RM, bool WIDE, bool GX>
__global__ void __launch_bounds__(kThreads, 1)
lstm_scan_bwd_saved_kernel(const T* __restrict__ res,
                           const T* __restrict__ cp,
                           const T* __restrict__ dy,
                           const T* __restrict__ wh, T* __restrict__ dxg,
                           float* __restrict__ xbuf, ChainArgs a) {
  static_assert(WIDE || !GX, "the device-memory exchange is a rounds form");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dfloats = 2 * RM * a.ldh;
  float* dg_s = GX ? xbuf + (size_t)(blockIdx.x / a.NC) * dfloats
                   : reinterpret_cast<float*>(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      GX ? reinterpret_cast<float*>(smem_raw) : dg_s + dfloats);
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
  const int ul = tid / (4 * a.S);
  const int d0 = s * a.L;
  const int lanes = 4 * a.S;
  const int k = tid % lanes;  // lane in the unit's group
  const int nr = WIDE ? a.R : 1;
  // round 0's unit (the only one unless WIDE; threads past a round's UT
  // units have none): whether the block has it and its gradient's place
  // in the rows of dg_s.  Round i's unit is i*UT further.
  const bool on0 = ul < ucnt && (!WIDE || ul < a.UT);
  const int unit0 = u0 + (on0 ? ul : 0);
  const int goff = (g * a.S) * a.LP;  // chunk g's slices in a row

  // the weights wh[unit, g*W + d0 ..]: registers, then shared memory
  // (WIDE: L2 only)
  uint32_t wr[kRegWords];
  if constexpr (!WIDE) {
    load_resident(wr, w_s, wh + (size_t)unit0 * a.G + g * a.W, 1, a, d0,
                  on0, tid);
  } else {
    for (int i = 0; i < a.R * RM; ++i) c_s[(size_t)i * a.nthr + tid] = 0.0f;
  }
  if (!GX)  // (GX: the caller's buffers start at 0)
    for (int i = tid; i < dfloats; i += blockDim.x) dg_s[i] = 0.0f;
  const uint32_t bar0 = smem_u32(bars), d0s = GX ? 0u : smem_u32(dg_s);
  const uint32_t bytes = 16u * (uint32_t)a.W * (uint32_t)nb;
  if (GX) {
    cg::this_cluster().sync();  // every thread takes the steps' barriers
  } else if (a.NC > 1) {
    if (tid == 0) {
      bar_init(bar0);
      bar_init(bar0 + 8);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      // buffer 1 receives the gradients of step 1, buffer 0 those of 2
      if (a.Tn > 1) bar_expect(bar0 + 8, bytes);
      if (a.Tn > 2) bar_expect(bar0, bytes);
    }
    cg::this_cluster().sync();  // every block set up before any store
    if (!__any_sync(0xffffffffu, on0)) return;
  } else {
    __syncthreads();
  }

  StepIn in[RM];
  float dcc[RM];
  const size_t last = (size_t)(a.Tn - 1) * a.B + b0;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    in[r] = StepIn{};  // rows past the chain's stay 0
    if (!WIDE && r < nb) load_in(in[r], res, cp, dy, last + r, a.W, unit0);
    dcc[r] = 0.0f;
  }
  for (int i = 0; i < nr; ++i) {
    const int unit = on0 && ul + i * a.UT < ucnt ? unit0 + i * a.UT : unit0;
    for (int st = 1; st < kAhead && st < a.Tn; ++st)
      for (int r = 0; r < nb; ++r)
        prefetch_in(res, cp, dy, last - (size_t)st * a.B + r, a.W, unit, k,
                    lanes);
  }

  for (int st = 0; st < a.Tn; ++st) {
    const int t = a.Tn - 1 - st;
    const int cur = st & 1;
    const int nxt = cur ^ 1;
    const size_t row0 = (size_t)t * a.B + b0;
    if (!GX && a.NC > 1 && st > 0) {
      bar_wait(bar0 + 8 * cur, ((st - 1) >> 1) & 1);
      if (tid == 0 && st + 2 < a.Tn) bar_expect(bar0 + 8 * cur, bytes);
    }
    for (int i = 0; i < nr; ++i) {
      bool on = on0;
      int unit = unit0;
      if constexpr (WIDE) {  // this round's unit, inputs and dc carry
        unit = unit0 + i * a.UT;
        on = on0 && ul + i * a.UT < ucnt;
        if (!on) unit = unit0;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r < nb) load_in(in[r], res, cp, dy, row0 + r, a.W, unit);
          dcc[r] = c_s[(size_t)(i * RM + r) * a.nthr + tid];
        }
      }
      float pre[RM];
      product<T, RM, WIDE, GX>(wr, w_s + tid,
                               wh + (size_t)unit * a.G + g * a.W, 1,
                               dg_s + cur * RM * a.ldh + goff + s * a.LP, a,
                               d0, pre);
      // dh_c of the unit (the sum of its 4S lanes, the same in each), the
      // cell in every lane, and gate g's gradient in lane group g
      float dv[RM];
      T dq[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float dhc = pre[r];
        for (int o = 1; o < lanes; o <<= 1)
          dhc += __shfl_xor_sync(0xffffffffu, dhc, o);
        const StepIn x = in[r];
        const float dh = x.dy + dhc;
        const float dc = dh * x.o * (1.0f - x.tc * x.tc) + dcc[r];
        dcc[r] = dc * x.f;
        const float d = g == 0   ? dc * x.g * x.i * (1.0f - x.i)
                        : g == 1 ? dc * x.cp * x.f * (1.0f - x.f)
                        : g == 2 ? dc * x.i * (1.0f - x.g * x.g)
                                 : dh * x.tc * x.o * (1.0f - x.o);
        dq[r] = from_f<T>(d);
        dv[r] = to_f(dq[r]);
      }
      if constexpr (WIDE) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
          c_s[(size_t)(i * RM + r) * a.nthr + tid] = dcc[r];
      }
      // the rounded gradient to every block (or to this one), then dxg
      // and the next step's inputs
      if (st + 1 < a.Tn && on) {
        const int off =
            nxt * RM * a.ldh + goff + (unit / a.L) * a.LP + unit % a.L;
        const uint32_t slot = d0s + 4u * (uint32_t)off;
        if (GX) {
          if (s == 0) {
#pragma unroll
            for (int r = 0; r < RM; ++r)
              if (r < nb) dg_s[off + r * a.ldh] = dv[r];
          }
        } else if (a.NC > 1) {
          for (int q = s; q < a.NC; q += a.S) {
            const uint32_t dst = peer_u32(slot, q);
            const uint32_t bar = peer_u32(bar0 + 8 * nxt, q);
#pragma unroll
            for (int r = 0; r < RM; ++r)
              if (r < nb) send_h(dst + 4u * r * a.ldh, dv[r], bar);
          }
        } else if (s == 0) {
          float* dst = dg_s + (slot - d0s) / 4;
#pragma unroll
          for (int r = 0; r < RM; ++r)
            if (r < nb) dst[r * a.ldh] = dv[r];
        }
      }
      if (on && s == 0) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
          if (r < nb) dxg[(row0 + r) * a.G + g * a.W + unit] = dq[r];
      }
      if (t > 0) {
        if constexpr (!WIDE) {
#pragma unroll
          for (int r = 0; r < RM; ++r)
            if (r < nb) load_in(in[r], res, cp, dy, row0 - a.B + r, a.W, unit);
        }
        if (t >= kAhead)
          for (int r = 0; r < nb; ++r)
            prefetch_in(res, cp, dy, row0 - (size_t)kAhead * a.B + r, a.W,
                        unit, k, lanes);
      }
    }
    if (GX) {  // the step's gradients published in device memory
      __threadfence();
      cluster_arrive();
      cluster_wait();
    } else if (a.NC == 1) {
      __syncthreads();
    }
  }
}

template <typename T, int RM, bool WIDE, bool GX = false>
cudaError_t launch_saved(const ChainArgs& a, cudaStream_t stream,
                         const void* res, const void* cp, const void* dy,
                         const void* wh, void* dxg, float* xbuf) {
  return launch_chain(lstm_scan_bwd_saved_kernel<T, RM, WIDE, GX>, a,
                      chain_smem<T>(a, RM, GX), stream,
                      static_cast<const T*>(res), static_cast<const T*>(cp),
                      static_cast<const T*>(dy), static_cast<const T*>(wh),
                      static_cast<T*>(dxg), xbuf, a);
}

template <typename T, int RM>
cudaError_t saved_rows(const ChainArgs& a, cudaStream_t stream,
                       const void* res, const void* cp, const void* dy,
                       const void* wh, void* dxg, float* xbuf, bool gx) {
  if (gx) {  // one row, in rounds, the gradients in device memory
    if constexpr (RM == 1)
      return launch_saved<T, 1, true, true>(a, stream, res, cp, dy, wh, dxg,
                                            xbuf);
    return cudaErrorInvalidValue;
  }
  if (a.R > 1) {  // rounds: 1, 2 or 4 rows a chain
    if constexpr (RM == 1 || RM == 2 || RM == 4)
      return launch_saved<T, RM, true>(a, stream, res, cp, dy, wh, dxg,
                                       xbuf);
    return cudaErrorInvalidValue;
  }
  return launch_saved<T, RM, false>(a, stream, res, cp, dy, wh, dxg, xbuf);
}

template <typename T>
cudaError_t run_saved(const ChainArgs& a, cudaStream_t stream,
                      const void* res, const void* cp, const void* dy,
                      const void* wh, void* dxg, float* xbuf, bool gx) {
  switch (a.rows) {
    case 1: return saved_rows<T, 1>(a, stream, res, cp, dy, wh, dxg, xbuf, gx);
    case 2: return saved_rows<T, 2>(a, stream, res, cp, dy, wh, dxg, xbuf, gx);
    case 3: return saved_rows<T, 3>(a, stream, res, cp, dy, wh, dxg, xbuf, gx);
    case 4: return saved_rows<T, 4>(a, stream, res, cp, dy, wh, dxg, xbuf, gx);
    case 6: return saved_rows<T, 6>(a, stream, res, cp, dy, wh, dxg, xbuf, gx);
    case 8: return saved_rows<T, 8>(a, stream, res, cp, dy, wh, dxg, xbuf, gx);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rc

// One (row, unit) step's inputs of the recompute form: c, c_prev, dy.
template <typename T>
__device__ __forceinline__ void load_cell(float& c, float& cpv, float& dyv,
                                          const T* __restrict__ cs,
                                          const T* __restrict__ cp,
                                          const T* __restrict__ dy,
                                          size_t row, int W, int unit) {
  c = to_f(cs[row * W + unit]);
  cpv = to_f(cp[row * W + unit]);
  dyv = to_f(dy[row * W + unit]);
}

// The recompute form (row 16) on scan_common.cuh's chain, RM rows a chain,
// P (row, unit) pairs a thread, and with GX the gate gradients crossing the
// cluster in device memory (xbuf [chains][2][RM][4W] f32).
template <typename T, int RM, int P, bool GX>
__global__ void __launch_bounds__(kScanThreads, 1)
lstm_scan_bwd_kernel(const T* __restrict__ xg, const T* __restrict__ hp,
                     const T* __restrict__ cp, const T* __restrict__ cs,
                     const T* __restrict__ dy, const T* __restrict__ wh,
                     const T* __restrict__ whT, T* __restrict__ dxg,
                     float* __restrict__ xbuf, ScanArgs a) {
  // (rnn_wgmma.cuh's kernels name theirs smem_raw, as char)
  extern __shared__ __align__(16) unsigned char smem_scan[];
  cg::cluster_group cluster = cg::this_cluster();
  const Chain ch = chain(cluster, a);
  const int W = a.W;
  const int G = 4 * W;
  const int ldh = row_ld(W);
  const int C = 4 * ch.ucnt;
  const int C4 = 4 * a.U;
  // the layout, the same in every block
  float* dg_s = reinterpret_cast<float*>(smem_scan);  // [2][RM][G]
  float* part_s = dg_s + (GX ? 0 : 2 * RM * G);
  float* dh_s = part_s + part_floats(C4, RM);  // [RM][U]
  float* dc_s = dh_s + RM * a.U;               // [RM][U]
  float* hp_s = dc_s + RM * a.U;               // [RM][ldh]
  float* act_s = hp_s + RM * ldh;              // [RM][C]
  T* wT_s = reinterpret_cast<T*>(act_s + RM * C4);
  T* w_s = wT_s + (size_t)a.rs * a.U;  // [rs2][C]
  float* dg = GX ? xbuf + (size_t)(blockIdx.x / a.NC) * 2 * RM * G : dg_s;

  // whT rows are gate columns, its columns units: slice [4W, ucnt]
  const int uc = ch.ucnt > 0 ? ch.ucnt : 1;
  const ColMap cmT{uc, 0, ch.u0, W};
  const ColMap cm{uc, W, ch.u0, G};
  load_weights(wT_s, whT, cmT, a.rs, ch.ucnt);
  load_weights(w_s, wh, cm, a.rs2, C);
  for (int i = threadIdx.x; i < RM * a.U; i += kScanThreads) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }
  // the rows past the chain's stay 0: the carry product sums them (GX:
  // one row, the chain's)
  if (!GX)
    for (int i = threadIdx.x; i < 2 * RM * G; i += kScanThreads)
      dg_s[i] = 0.0f;
  for (int i = threadIdx.x; i < RM * ldh; i += kScanThreads) hp_s[i] = 0.0f;
  float* peer[kMaxCluster];
  if (!GX) {
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < a.NC) peer[q] = cluster.map_shared_rank(dg_s, q);
  }

  // one (row, unit) step's inputs: c (its tanh is taken when used),
  // c_prev, dy
  const int n_pairs = ch.nb * ch.ucnt;
  float cv[P], cpv[P], dyv[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int e = threadIdx.x + k * kScanThreads;
    if (e < n_pairs)
      load_cell(cv[k], cpv[k], dyv[k], cs, cp, dy,
                (size_t)(a.Tn - 1) * a.B + ch.b0 + e / ch.ucnt, W,
                ch.u0 + e % ch.ucnt);
  }
  cluster.sync();  // every block has started

  for (int s = 0; s < a.Tn; ++s) {
    const int t = a.Tn - 1 - s;
    const int cur = s & 1;
    const size_t row0 = (size_t)t * a.B + ch.b0;
    // this block's gates of step t from hp[t]
    for (int i = threadIdx.x; i < ch.nb * W; i += kScanThreads)
      hp_s[(i / W) * ldh + i % W] = to_f(hp[(row0 + i / W) * W + i % W]);
    __syncthreads();
    if (C > 0) product<T, RM>(hp_s, ldh, w_s, a.rs2, wh, cm, C, W, part_s);
    __syncthreads();
    for (int e = threadIdx.x; e < ch.nb * C; e += kScanThreads) {
      const int b = e / C;
      const int c = e % C;
      const float pre = to_f(xg[(row0 + b) * G + cm.col(c)]) +
                        reduce_slices<RM>(part_s, b, c, C, W);
      act_s[b * C + c] = c / uc == 2 ? tanhf(pre) : sigmoid_f(pre);
    }
    __syncthreads();

    // the cell threads' gate gradients to every block, the barrier's
    // arrive; then their stores to dxg and the next step's inputs
    float d[P][4];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int e = threadIdx.x + k * kScanThreads;
      if (e < n_pairs) {
        const int b = e / ch.ucnt;
        const int u = e % ch.ucnt;
        const float* gt = act_s + b * C;
        const float i = gt[u], f = gt[ch.ucnt + u], gg = gt[2 * ch.ucnt + u];
        const float o = gt[3 * ch.ucnt + u], tc = tanhf(cv[k]);
        const int p = b * a.U + u;
        const float dh = dyv[k] + dh_s[p];
        const float dc = dh * o * (1.0f - tc * tc) + dc_s[p];
        dc_s[p] = dc * f;
        d[k][0] = dc * gg * i * (1.0f - i);
        d[k][1] = dc * cpv[k] * f * (1.0f - f);
        d[k][2] = dc * i * (1.0f - gg * gg);
        d[k][3] = dh * tc * o * (1.0f - o);
        const int slot = (cur * RM + b) * G + ch.u0 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d[k][q] = rnd<T>(d[k][q]);
          if (GX) {
            dg[slot + q * W] = d[k][q];
          } else {
#pragma unroll
            for (int r = 0; r < kMaxCluster; ++r)
              if (r < a.NC) peer[r][slot + q * W] = d[k][q];
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
        T* out = dxg + (row0 + e / ch.ucnt) * G + ch.u0 + e % ch.ucnt;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * W] = from_f<T>(d[k][q]);
      }
    }
    if (t > 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int e = threadIdx.x + k * kScanThreads;
        if (e < n_pairs)
          load_cell(cv[k], cpv[k], dyv[k], cs, cp, dy,
                    row0 - a.B + e / ch.ucnt, W, ch.u0 + e % ch.ucnt);
      }
    }
    cluster_wait();

    // dh_c of this block's units
    if (ch.ucnt > 0)
      product<T, RM, GX>(dg + cur * RM * G, G, wT_s, a.rs, whT, cmT,
                         ch.ucnt, G, part_s);
    __syncthreads();
    for (int e = threadIdx.x; e < n_pairs; e += kScanThreads) {
      const int b = e / ch.ucnt;
      const int u = e % ch.ucnt;
      dh_s[b * a.U + u] = reduce_slices<RM>(part_s, b, u, ch.ucnt, G);
    }
    __syncthreads();
  }
}

// Bytes of a form's shared-memory buffers other than the resident
// weights: rm rows, the gradients' two buffers unless gx.
size_t bwd_fixed_bytes(const ScanArgs& a, int rm, bool gx) {
  const int C4 = 4 * a.U;
  const size_t floats = (gx ? 0 : 2 * rm * 4 * (size_t)a.W) +
                        part_floats(C4, rm) + 2 * rm * a.U +
                        rm * row_ld(a.W) + rm * C4;
  return align16(sizeof(float) * floats);
}

template <typename T, int RM, int P, bool GX>
cudaError_t launch_recompute(const void* xg, const void* hp, const void* cp,
                             const void* cs, const void* dy, const void* wh,
                             const void* whT, void* dxg, float* xbuf,
                             ScanArgs a, cudaStream_t stream) {
  const size_t fixed = bwd_fixed_bytes(a, RM, GX);
  if (!form_fits<RM, P>(a, fixed)) return cudaErrorInvalidValue;
  // the carry product's slice [4W, U] first, then [W, 4U]
  const size_t rowT = sizeof(T) * a.U;
  a.rs = resident_rows(fixed, rowT, 4 * a.W);
  size_t smem = fixed + rowT * a.rs;
  const size_t row = sizeof(T) * 4 * a.U;
  a.rs2 = resident_rows(smem, row, a.W);
  smem += row * a.rs2;
  return launch_chain(lstm_scan_bwd_kernel<T, RM, P, GX>, a, smem, stream,
                      static_cast<const T*>(xg), static_cast<const T*>(hp),
                      static_cast<const T*>(cp), static_cast<const T*>(cs),
                      static_cast<const T*>(dy), static_cast<const T*>(wh),
                      static_cast<const T*>(whT), static_cast<T*>(dxg), xbuf,
                      a);
}

// The recompute form in the caller's form (scan_common.cuh's Form).
template <typename T>
cudaError_t run_recompute(int form, const void* xg, const void* hp,
                          const void* cp, const void* cs, const void* dy,
                          const void* wh, const void* whT, void* dxg,
                          float* xbuf, const ScanArgs& a,
                          cudaStream_t stream) {
  switch (form) {
    case kFull:
      return launch_recompute<T, kMaxRows, kMaxPairs, false>(
          xg, hp, cp, cs, dy, wh, whT, dxg, xbuf, a, stream);
    case kOne:
      return launch_recompute<T, 1, kWidePairs, false>(
          xg, hp, cp, cs, dy, wh, whT, dxg, xbuf, a, stream);
    case kGx:
      if (xbuf == nullptr) return cudaErrorInvalidValue;
      return launch_recompute<T, 1, kWidePairs, true>(
          xg, hp, cp, cs, dy, wh, whT, dxg, xbuf, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the dtype of every tensor.  Device
// pointers of contiguous tensors: res [T, B, 5W]; hp, cp, dy [T, B, W];
// wh [W, 4W]; outputs dxg [T, B, 4W] and dwh [W, 4W]; part, dwh's f32
// partials, ceil(ceil(T*B / 64) / slice_chunks) slices of W * 4W.  The
// chain's geometry (ops/rnn_scan.py::chain_geometry) as lstm_scan_fwd's:
// nc blocks a chain, s depth slices a column chunk, rows a chain, ls of
// shared-memory depth, rounds, and gx: the gradients' exchange in xbuf
// (f32, zeros, [B][2][4 (L + 4)], L = W rounded up to 8; one row a chain,
// in rounds) instead of shared memory.  Launches on `stream` (the chain,
// dwh's partials, their sum) and returns the launches' error (0 on
// success).
int lstm_scan_bwd_saved(int dtype, const void* res, const void* hp,
                        const void* cp, const void* dy, const void* wh,
                        void* dxg, void* dwh, void* part, float* xbuf,
                        int Tn, int B, int W, int nc, int s, int rows, int ls,
                        int rounds, int gx, int slice_chunks, void* stream) {
  rc::ChainArgs a;
  const int chunk = dtype == 0 ? 4 : 8;
  if (!rc::chain_args(Tn, B, W, 4, 4, nc, s, rows, ls, rounds, chunk, &a) ||
      (gx && (rounds < 2 || rows != 1 || xbuf == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = rc::run_saved<float>(a, st, res, cp, dy, wh, dxg, xbuf, gx != 0);
    if (err == cudaSuccess)
      err = launch_scan_dwh<float>(hp, dxg, dwh, p, slice_chunks, Tn, B,
                                   W, 4 * W, st);
  } else if (dtype == 1) {
    err = rc::run_saved<__nv_bfloat16>(a, st, res, cp, dy, wh, dxg, xbuf,
                                       gx != 0);
    if (err == cudaSuccess)
      err = launch_scan_dwh<__nv_bfloat16>(hp, dxg, dwh, p, slice_chunks, Tn,
                                           B, W, 4 * W, st);
  }
  return (int)err;
}

// The recompute form: xg [T, B, 4W]; hp, cp, cs, dy [T, B, W]; wh [W, 4W]
// and whT = wh^T [4W, W]; dxg, dwh and part as above; the Gx form's f32
// scratch xbuf [B][2][4W] (the gradients' exchange in device memory).  The
// launch (ops/rnn_scan.py::scan_form): cluster, the blocks a chain spreads
// W over, 1..16; rows a chain; form (scan_common.cuh's Form).
int lstm_scan_bwd(int dtype, const void* xg, const void* hp, const void* cp,
                  const void* cs, const void* dy, const void* wh,
                  const void* whT, void* dxg, void* dwh, void* part,
                  float* xbuf, int Tn, int B, int W, int cluster, int rows,
                  int form, int slice_chunks, void* stream) {
  ScanArgs a;
  if (!scan_geometry(Tn, B, W, cluster, rows, &a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = run_recompute<float>(form, xg, hp, cp, cs, dy, wh, whT, dxg, xbuf,
                               a, st);
    if (err == cudaSuccess)
      err = launch_scan_dwh<float>(hp, dxg, dwh, p, slice_chunks, Tn, B,
                                   W, 4 * W, st);
  } else if (dtype == 1) {
    err = run_recompute<__nv_bfloat16>(form, xg, hp, cp, cs, dy, wh, whT, dxg,
                                       xbuf, a, st);
    if (err == cudaSuccess)
      err = launch_scan_dwh<__nv_bfloat16>(hp, dxg, dwh, p, slice_chunks, Tn,
                                           B, W, 4 * W, st);
  }
  return (int)err;
}

const char* lstm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
