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
// forward's ys one step earlier (0 at t = 0); dy [W]; wh [W, 3W] (and,
// recompute, its transpose whT [3W, W]).  Per step t = T-1 .. 0, in f32:
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
// hidden_dim_1 = 512 (B=8, T=1920, W=256) the carry product is 2*T*B*W*3W
// = 6.04 GFLOP, 0.09 ms at f32's 67 TFLOP/s, and dwh as many, 0.04 ms as
// 3xTF32 on the tensor cores (the recompute form's gates a half more,
// SIMT, and its dwh SIMT); the bytes about 0.16 GB, 0.05 ms.  The chain of
// T dependent steps binds.
//
// The saved-gates form (row 11), on the register-resident chain of
// scan_chain.cuh, by the LSTM scan's saved-gates backward's route (a)
// (lstm_scan_bwd.cu, row 15).  The first design (scan_common.cuh's chain,
// as the recompute form below still runs) took 5.46 us a step at B=8,
// W=256: every gate gradient into every peer's shared memory, a split
// cluster barrier and two block barriers a step, the carry product
// through a partial-sum buffer in shared memory, dwh a SIMT GEMM (PERF.md
// section 6, the step split of tools/torch_lstm_scan_steps.py --kernel
// 11).  So:
//  * A block keeps the rows of wh of its own units, [U, 3W]: thread (unit
//    u, lane group g, depth slice s) keeps wh[u, g*W + s*L ..] in
//    registers, then shared memory, then L2 (with rounds all L2), the
//    forward's geometry (ops/rnn_scan.py::chain_geometry) with an input
//    row of 3W gradients.  Three lane groups do not divide a warp, so a
//    fourth group holds no weights, as in the GRU scan's forward
//    (gru_scan_fwd.cu): its product is counted 0, and it takes the n
//    gate's hidden-side gradient dn r, which the group of n (dxg's dn)
//    does not.
//  * A step: wait on the block's own mbarrier for the previous step's
//    rounded dhg; the carry product, whose sum over the unit's 4S lanes
//    (shuffles) reaches every lane; dh = dy + (dh z of the previous step,
//    carried in f32 in registers, + the product) and the gate gradients in
//    every lane; groups 0, 1 and 3 round dhg's r, z and n parts and send
//    them to every block (st.async onto the receiver's mbarrier, lanes s,
//    s + S, .. of the peers), and keep each row's f32 sum of the unrounded
//    dhg for dbh; groups 0-2 store dxg, groups 0, 1 and 3 rnd(dhg); then
//    the next step's res (4 values), hp and dy, whose rows are prefetched
//    into L2 four steps ahead.  A chain of one block sends to itself the
//    same way, so no step of the shared-memory forms has a block or a
//    cluster barrier.
//  * Writing one step ahead is safe: a block's two buffers alternate, and
//    at step st a lane sends into the buffer that every block read at step
//    st - 1.  Before it sends it has waited, at step st, for the gradients
//    every warp of every block sent at step st - 1; a warp sends only after
//    the shuffles that sum all its lanes' products of step st - 1, so no
//    lane still reads that buffer.  A peer's stores of step st + 1 into
//    this block's buffer come after that peer's wait at step st + 1, which
//    this block's sends of step st complete: after this block's own wait
//    at step st ended the buffer's previous phase.  Warps that own no unit
//    neither read nor send, and leave after the set-up's cluster barrier.
//  * The n gate's trap: dxg's n third is dn, dhg's is dn r, and dwh needs
//    rnd(dhg).  The chain stores rnd(dhg) [T, B, 3W] in wh's dtype (half
//    the bytes of the f32 copy the first design kept, in bf16; the same in
//    f32), so dwh is one product over one operand on row 15's tensor-core
//    kernel unchanged.  Storing only the n third and reading r and z from
//    dxg would save 2TBW stores off the chain (31 MB at the shape above,
//    about 10 us at 3.35 TB/s, against a chain of milliseconds) at the cost
//    of a two-operand dwh kernel.
//  * Past W = 8824, where even one row's two buffers of 3W
//    gradients pass the shared memory, they cross the cluster in device
//    memory (gx, one row a chain, in rounds): a unit's lane groups write
//    them there once, a fence and a cluster barrier end the step, and the
//    product reads them through L2, as row 15's gx form does.
//  * dwh is off the chain: hp^T rnd(dhg) on the tensor cores
//    (rnn_wgmma.cuh's dwh_wgmma_kernel, row 15's), K = T*B in slices of
//    whole 64-row chunks (ops/rnn_scan.py::dwh_slices), the accumulators
//    restarted every 8 chunks, the slices' f32 partials added in order;
//    dbh each row's f32 sum over t, the rows' sums added in order
//    (launch_bias_reduce).  No atomics: reruns are bit-identical.
//  * Measured on an H100 (tools/torch_lstm_scan_steps.py --kernel 11, us
//    a step of the whole call in f32, as is / without the product / the
//    gate math / the exchange / dwh / all of them): 1.50 / 0.92 / 1.46 /
//    1.29 / 1.43 / 0.41 at B=8, T=1920, W=256 (2.87 ms a call; the first
//    design 5.59 / 3.84 / 5.48 / 4.14 / 4.32 / 1.51, 10.74 ms); bf16 1.77.
//    At W=1024 (two rows a chain of 16 blocks, most of wh through L2)
//    30.1 / 3.0 / 30.0 / 28.7 / 29.3 / 0.8 (first design 44.7): the L2
//    tier of the product is the step, so that tier reads 16 bytes a load
//    (scan_chain.cuh's VEC), which took it from 81 to 30 us a step.
//
// The recompute form (row 12) keeps scan_common.cuh's chain: the (row,
// unit) threads form their units' three gate gradients, write dxg, keep dh
// z for their carry and a running f32 sum of dhg for dbh, and put rnd(dhg)
// into every block's shared memory (distributed shared memory); one split
// cluster barrier (the arrive, then the stores of dxg and of rnd(dhg), f32,
// for dwh, and the next step's loads, then the wait); then each block
// forms the product part of dh_c for its own units, all 3W gradients
// against its [3W, U] slice of whT in shared memory (rows past the budget
// read through L2); first it forms its units' gates from hp[t], a product
// with its [W, 3U] slice of wh.  dwh is a tiled SIMT GEMM (rnn_common.cuh)
// after the chain; dbh as above.

#include "rnn_wgmma.cuh"
#include "scan_chain.cuh"
#include "scan_common.cuh"

namespace {
namespace rc {

// One (row, unit) step's inputs from the saved gates.
struct StepIn {
  float r, z, n, hn, hp, dy;
};

template <typename T>
__device__ __forceinline__ void load_in(StepIn& in, const T* __restrict__ res,
                                        const T* __restrict__ hp,
                                        const T* __restrict__ dy, size_t row,
                                        int W, int unit) {
  const T* g = res + row * 4 * W + unit;
  in.r = to_f(g[0]);
  in.z = to_f(g[W]);
  in.n = to_f(g[2 * W]);
  in.hn = to_f(g[3 * W]);
  in.hp = to_f(hp[row * W + unit]);
  in.dy = to_f(dy[row * W + unit]);
}

// The six inputs of a (row, unit) into L2, lane k's share of them.
template <typename T>
__device__ __forceinline__ void prefetch_in(const T* res, const T* hp,
                                            const T* dy, size_t row, int W,
                                            int unit, int k, int lanes) {
  for (int q = k; q < 6; q += lanes)
    prefetch_l2(q < 4 ? res + row * 4 * W + q * W + unit
                      : (q == 4 ? hp : dy) + row * W + unit);
}

// One chain of a.rows batch rows on a cluster of a.NC blocks, steps in
// reverse.  Block rank q owns units [q*U, q*U + ucnt); thread tid is depth
// slice s = tid % S of lane group g = (tid / S) % 4 of local unit tid /
// (4S) + i*UT in round i (one round unless WIDE).  Group g < 3 keeps wh's
// columns [g*W, g*W + W) of its unit's row; groups 2 and 3 read chunk 2 of
// the input (group 3's product is counted 0).  dg_s [2][RM][ldh] f32, a
// row's 3W rounded gradients (column c*W + d of a row at (c*S + d / L)*LP
// + d % L), then two mbarriers (one a buffer), then the shared-memory
// weights [ls*sizeof(T)/16][nthr] 16-byte chunks or, with WIDE, each
// thread's carries [2][R][RM][nthr] f32 (dh z, then dbh's sum).  With GX
// (only with WIDE, one row a chain) the two buffers of dg_s are in device
// memory instead, xbuf [chains][2][RM][ldh].
template <typename T, int RM, bool WIDE, bool GX>
__global__ void __launch_bounds__(kThreads, 1)
gru_scan_bwd_saved_kernel(const T* __restrict__ res, const T* __restrict__ hp,
                          const T* __restrict__ dy, const T* __restrict__ wh,
                          T* __restrict__ dxg, T* __restrict__ dhg,
                          float* __restrict__ bias_part,
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
  const int c = min(g, 2);  // the chunk of dhg the lane reads (and sends)
  const int ul = tid / (4 * a.S);
  const int d0 = s * a.L;
  const int lanes = 4 * a.S;
  const int k = tid % lanes;  // lane in the unit's group
  const int nr = WIDE ? a.R : 1;
  const int G = a.G;
  // round 0's unit (the only one unless WIDE; threads past a round's UT
  // units have none).  Round i's unit is i*UT further.
  const bool on0 = ul < ucnt && (!WIDE || ul < a.UT);
  const int unit0 = u0 + (on0 ? ul : 0);
  const int goff = (c * a.S) * a.LP;  // chunk c's slices in a row
  const size_t carry = (size_t)a.R * RM * a.nthr;  // WIDE: dbh's sums
  // the L2 tier's 16-byte loads in flight (scan_chain.cuh's product); not
  // with 6 or 8 rows, whose registers are full (they spill already)
  constexpr int kVec = RM > 4 ? 0 : WIDE ? 16 : 8;

  // the weights wh[unit, g*W + d0 ..] (group 3: none): registers, then
  // shared memory (WIDE: L2 only)
  uint32_t wr[kRegWords];
  if constexpr (!WIDE) {
    load_resident(wr, w_s, wh + (size_t)unit0 * G + c * a.W, 1, a, d0,
                  on0 && g < 3, tid);
  } else {
    for (size_t i = 0; i < 2 * carry; i += a.nthr) c_s[i + tid] = 0.0f;
  }
  if (!GX)  // (GX: the caller's buffers start at 0)
    for (int i = tid; i < dfloats; i += blockDim.x) dg_s[i] = 0.0f;
  const uint32_t bar0 = smem_u32(bars), d0s = GX ? 0u : smem_u32(dg_s);
  const uint32_t bytes = 12u * (uint32_t)a.W * (uint32_t)nb;
  if (GX) {
    cg::this_cluster().sync();  // every thread takes the steps' barriers
  } else {
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
  }

  StepIn in[RM];
  float dzc[RM], bs[RM];
  const size_t last = (size_t)(a.Tn - 1) * a.B + b0;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    in[r] = StepIn{};  // rows past the chain's stay 0
    if (!WIDE && r < nb) load_in(in[r], res, hp, dy, last + r, a.W, unit0);
    dzc[r] = bs[r] = 0.0f;
  }
  for (int i = 0; i < nr; ++i) {
    const int unit = on0 && ul + i * a.UT < ucnt ? unit0 + i * a.UT : unit0;
    for (int st = 1; st < kAhead && st < a.Tn; ++st)
      for (int r = 0; r < nb; ++r)
        prefetch_in(res, hp, dy, last - (size_t)st * a.B + r, a.W, unit, k,
                    lanes);
  }

  for (int st = 0; st < a.Tn; ++st) {
    const int t = a.Tn - 1 - st;
    const int cur = st & 1;
    const int nxt = cur ^ 1;
    const size_t row0 = (size_t)t * a.B + b0;
    if (!GX && st > 0) {
      bar_wait(bar0 + 8 * cur, ((st - 1) >> 1) & 1);
      if (tid == 0 && st + 2 < a.Tn) bar_expect(bar0 + 8 * cur, bytes);
    }
    for (int i = 0; i < nr; ++i) {
      bool on = on0;
      int unit = unit0;
      if constexpr (WIDE) {  // this round's unit, inputs and carries
        unit = unit0 + i * a.UT;
        on = on0 && ul + i * a.UT < ucnt;
        if (!on) unit = unit0;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r < nb) load_in(in[r], res, hp, dy, row0 + r, a.W, unit);
          dzc[r] = c_s[(size_t)(i * RM + r) * a.nthr + tid];
          bs[r] = c_s[carry + (size_t)(i * RM + r) * a.nthr + tid];
        }
      }
      float pre[RM];
      product<T, RM, WIDE, GX, kVec>(
          wr, w_s + tid, wh + (size_t)unit * G + c * a.W, 1,
          dg_s + cur * RM * a.ldh + goff + s * a.LP, a, d0, pre);
      // dh_c of the unit (the sum of its 4S lanes, the same in each), the
      // gates' gradients in every lane, and lane group g's one
      T dq[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float dhc = g < 3 ? pre[r] : 0.0f;
        for (int o = 1; o < lanes; o <<= 1)
          dhc += __shfl_xor_sync(0xffffffffu, dhc, o);
        const StepIn x = in[r];
        const float dh = x.dy + (dzc[r] + dhc);
        const float dz = dh * (x.hp - x.n);
        const float dn = dh * (1.0f - x.z) * (1.0f - x.n * x.n);
        dzc[r] = dh * x.z;
        const float d = g == 0   ? dn * x.hn * x.r * (1.0f - x.r)
                        : g == 1 ? dz * x.z * (1.0f - x.z)
                        : g == 2 ? dn
                                 : dn * x.r;
        bs[r] += d;  // dbh's (group 2's sum goes unused)
        dq[r] = from_f<T>(d);
      }
      if constexpr (WIDE) {
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          c_s[(size_t)(i * RM + r) * a.nthr + tid] = dzc[r];
          c_s[carry + (size_t)(i * RM + r) * a.nthr + tid] = bs[r];
        }
      }
      // the rounded dhg to every block, then dxg, rnd(dhg) and the next
      // step's inputs
      if (st + 1 < a.Tn && on && g != 2) {
        const int off =
            nxt * RM * a.ldh + goff + (unit / a.L) * a.LP + unit % a.L;
        if (GX) {
          if (s == 0) {
#pragma unroll
            for (int r = 0; r < RM; ++r)
              if (r < nb) dg_s[off + r * a.ldh] = to_f(dq[r]);
          }
        } else {
          const uint32_t slot = d0s + 4u * (uint32_t)off;
          for (int q = s; q < a.NC; q += a.S) {
            const uint32_t dst = peer_u32(slot, q);
            const uint32_t bar = peer_u32(bar0 + 8 * nxt, q);
#pragma unroll
            for (int r = 0; r < RM; ++r)
              if (r < nb) send_h(dst + 4u * r * a.ldh, to_f(dq[r]), bar);
          }
        }
      }
      if (on && s == 0) {
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r >= nb) continue;
          const size_t o = (row0 + r) * G + unit;
          if (g < 3) dxg[o + g * a.W] = dq[r];
          if (g != 2) dhg[o + c * a.W] = dq[r];
        }
      }
      if (t > 0) {
        if constexpr (!WIDE) {
#pragma unroll
          for (int r = 0; r < RM; ++r)
            if (r < nb) load_in(in[r], res, hp, dy, row0 - a.B + r, a.W, unit);
        }
        if (t >= kAhead)
          for (int r = 0; r < nb; ++r)
            prefetch_in(res, hp, dy, row0 - (size_t)kAhead * a.B + r, a.W,
                        unit, k, lanes);
      }
    }
    if (GX) {  // the step's gradients published in device memory
      __threadfence();
      cluster_arrive();
      cluster_wait();
    }
  }

  // each row's dbh sums over t, for the fixed-order sum over the rows
  for (int i = 0; i < nr; ++i) {
    const int unit = unit0 + i * a.UT;
    if (!(on0 && ul + i * a.UT < ucnt) || s != 0 || g == 2) continue;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= nb) continue;
      const float v =
          WIDE ? c_s[carry + (size_t)(i * RM + r) * a.nthr + tid] : bs[r];
      bias_part[(size_t)(b0 + r) * G + c * a.W + unit] = v;
    }
  }
}

template <typename T, int RM, bool WIDE, bool GX = false>
cudaError_t launch_saved(const ChainArgs& a, cudaStream_t stream,
                         const void* res, const void* hp, const void* dy,
                         const void* wh, void* dxg, void* dhg,
                         float* bias_part, float* xbuf) {
  return launch_chain(gru_scan_bwd_saved_kernel<T, RM, WIDE, GX>, a,
                      chain_smem<T>(a, RM, GX, 2), stream,
                      static_cast<const T*>(res), static_cast<const T*>(hp),
                      static_cast<const T*>(dy), static_cast<const T*>(wh),
                      static_cast<T*>(dxg), static_cast<T*>(dhg), bias_part,
                      xbuf, a);
}

template <typename T, int RM>
cudaError_t saved_rows(const ChainArgs& a, cudaStream_t stream,
                       const void* res, const void* hp, const void* dy,
                       const void* wh, void* dxg, void* dhg,
                       float* bias_part, float* xbuf, bool gx) {
  if (gx) {  // one row, in rounds, the gradients in device memory
    if constexpr (RM == 1)
      return launch_saved<T, 1, true, true>(a, stream, res, hp, dy, wh, dxg,
                                            dhg, bias_part, xbuf);
    return cudaErrorInvalidValue;
  }
  if (a.R > 1) {  // rounds: 1, 2 or 4 rows a chain
    if constexpr (RM == 1 || RM == 2 || RM == 4)
      return launch_saved<T, RM, true>(a, stream, res, hp, dy, wh, dxg, dhg,
                                       bias_part, xbuf);
    return cudaErrorInvalidValue;
  }
  return launch_saved<T, RM, false>(a, stream, res, hp, dy, wh, dxg, dhg,
                                    bias_part, xbuf);
}

// The chain, then dwh on the tensor cores and dbh's ordered sum.
template <typename T>
cudaError_t run_saved(const ChainArgs& a, cudaStream_t stream,
                      const void* res, const void* hp, const void* dy,
                      const void* wh, void* dxg, void* dhg, float* bias_part,
                      float* xbuf, bool gx, void* dwh, void* dbh, float* part,
                      int slice_chunks) {
  cudaError_t err;
  switch (a.rows) {
#define ROWS(n)                                                            \
  case n:                                                                  \
    err = saved_rows<T, n>(a, stream, res, hp, dy, wh, dxg, dhg, bias_part, \
                           xbuf, gx);                                      \
    break;
    ROWS(1) ROWS(2) ROWS(3) ROWS(4) ROWS(6) ROWS(8)
#undef ROWS
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  err = launch_scan_dwh<T>(hp, dhg, dwh, part, slice_chunks, a.Tn, a.B, a.W,
                           a.G, stream);
  if (err != cudaSuccess) return err;
  const BiasOuts<T> out = {{static_cast<T*>(dbh)}};
  return launch_bias_reduce<T>(bias_part, out, 1, a.B, a.G, stream);
}

}  // namespace rc

// One (row, unit) step's inputs of the recompute form: xg's r, z and n
// parts, hp and dy.
struct StepIn {
  float g0, g1, g2, hp, dy;
};

template <typename T>
__device__ __forceinline__ void load_step(StepIn& in,
                                          const T* __restrict__ xg,
                                          const T* __restrict__ hp,
                                          const T* __restrict__ dy,
                                          size_t row, int W, int unit) {
  const T* g = xg + row * 3 * W + unit;
  in.g0 = to_f(g[0]);
  in.g1 = to_f(g[W]);
  in.g2 = to_f(g[2 * W]);
  in.hp = to_f(hp[row * W + unit]);
  in.dy = to_f(dy[row * W + unit]);
}

// The recompute form (row 12) on scan_common.cuh's chain: RM rows a chain
// (kMaxRows, or 1 in the one-row forms), P (row, unit) pairs a thread, and
// with GX the gate gradients crossing the cluster in device memory (xbuf
// [chains][2][RM][ldg] f32) instead of shared memory.
template <typename T, int RM, int P, bool GX>
__global__ void __launch_bounds__(kScanThreads, 1)
gru_scan_bwd_kernel(const T* __restrict__ xg, const T* __restrict__ hp,
                    const T* __restrict__ dy, const T* __restrict__ wh,
                    const T* __restrict__ whT, const T* __restrict__ bh,
                    T* __restrict__ dxg, float* __restrict__ dhg,
                    float* __restrict__ bias_part, float* __restrict__ xbuf,
                    ScanArgs a) {
  // (rnn_wgmma.cuh's kernels name theirs smem_raw, as char)
  extern __shared__ __align__(16) unsigned char smem_scan[];
  cg::cluster_group cluster = cg::this_cluster();
  const Chain ch = chain(cluster, a);
  const int W = a.W;
  const int G = 3 * W;
  const int ldg = row_ld(G);
  const int ldh = row_ld(W);
  const int C = 3 * ch.ucnt;
  // the layout, the same in every block
  float* dg_s = reinterpret_cast<float*>(smem_scan);  // [2][RM][ldg]
  float* part_s = dg_s + (GX ? 0 : 2 * RM * ldg);
  float* dh_s = part_s + part_floats(3 * a.U, RM);  // [RM][U]
  float* dz_s = dh_s + RM * a.U;                    // [RM][U]: dh z
  float* hp_s = dz_s + RM * a.U;                    // [RM][ldh]
  T* wT_s = reinterpret_cast<T*>(hp_s + RM * ldh);
  T* w_s = wT_s + (size_t)a.rs * a.U;  // [rs2][C]
  float* dg = GX ? xbuf + (size_t)(blockIdx.x / a.NC) * 2 * RM * ldg : dg_s;

  // whT rows are gate columns, its columns units: slice [3W, ucnt]
  const int uc = ch.ucnt > 0 ? ch.ucnt : 1;
  const ColMap cmT{uc, 0, ch.u0, W};
  const ColMap cm{uc, W, ch.u0, G};
  load_weights(wT_s, whT, cmT, a.rs, ch.ucnt);
  load_weights(w_s, wh, cm, a.rs2, C);
  for (int i = threadIdx.x; i < RM * a.U; i += kScanThreads) {
    dh_s[i] = 0.0f;
    dz_s[i] = 0.0f;
  }
  // the rows past the chain's stay 0: the products sum them (GX: one row,
  // the chain's)
  if (!GX)
    for (int i = threadIdx.x; i < 2 * RM * ldg; i += kScanThreads)
      dg_s[i] = 0.0f;
  for (int i = threadIdx.x; i < RM * ldh; i += kScanThreads) hp_s[i] = 0.0f;
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
#pragma unroll
      for (int q = 0; q < 3; ++q) bv[k][q] = to_f(bh[q * W + unit]);
      load_step<T>(in[k], xg, hp, dy,
                   (size_t)(a.Tn - 1) * a.B + ch.b0 + e / uc, W, unit);
    }
  }
  cluster.sync();  // every block has started

  for (int s = 0; s < a.Tn; ++s) {
    const int t = a.Tn - 1 - s;
    const int cur = s & 1;
    const size_t row0 = (size_t)t * a.B + ch.b0;
    // this block's hidden gates of step t from hp[t]
    for (int i = threadIdx.x; i < ch.nb * W; i += kScanThreads)
      hp_s[(i / W) * ldh + i % W] = to_f(hp[(row0 + i / W) * W + i % W]);
    __syncthreads();
    if (C > 0) product<T, RM>(hp_s, ldh, w_s, a.rs2, wh, cm, C, W, part_s);
    __syncthreads();

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
        const float hr = reduce_slices<RM>(part_s, b, u, C, W) + bv[k][0];
        const float hz = reduce_slices<RM>(part_s, b, uc + u, C, W) + bv[k][1];
        const float hn =
            reduce_slices<RM>(part_s, b, 2 * uc + u, C, W) + bv[k][2];
        const float r = sigmoid_f(x.g0 + hr);
        const float z = sigmoid_f(x.g1 + hz);
        const float n = tanhf(x.g2 + r * hn);
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
          load_step<T>(in[k], xg, hp, dy, row0 - a.B + e / uc, W,
                       ch.u0 + e % uc);
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
size_t bwd_fixed_bytes(const ScanArgs& a, int rm, bool gx) {
  const size_t floats = (gx ? 0 : 2 * rm * (size_t)row_ld(3 * a.W)) +
                        part_floats(3 * a.U, rm) + 2 * rm * a.U +
                        rm * row_ld(a.W);
  return align16(sizeof(float) * floats);
}

template <typename T, int RM, int P, bool GX>
cudaError_t launch_bwd(const void* xg, const void* hp, const void* dy,
                       const void* wh, const void* whT, const void* bh,
                       void* dxg, float* dhg, float* bias_part, float* xbuf,
                       ScanArgs a, cudaStream_t stream) {
  const size_t fixed = bwd_fixed_bytes(a, RM, GX);
  if (!form_fits<RM, P>(a, fixed)) return cudaErrorInvalidValue;
  // the carry product's slice [3W, U] first, then [W, 3U]
  const size_t rowT = sizeof(T) * a.U;
  a.rs = resident_rows(fixed, rowT, 3 * a.W);
  size_t smem = fixed + rowT * a.rs;
  const size_t row = sizeof(T) * 3 * a.U;
  a.rs2 = resident_rows(smem, row, a.W);
  smem += row * a.rs2;
  return launch_chain(gru_scan_bwd_kernel<T, RM, P, GX>, a, smem, stream,
                      static_cast<const T*>(xg), static_cast<const T*>(hp),
                      static_cast<const T*>(dy), static_cast<const T*>(wh),
                      static_cast<const T*>(whT), static_cast<const T*>(bh),
                      static_cast<T*>(dxg), dhg, bias_part, xbuf, a);
}

template <typename T>
cudaError_t run_bwd(int form, const void* xg, const void* hp, const void* dy,
                    const void* wh, const void* whT, const void* bh,
                    void* dxg, float* dhg, float* bias_part, float* xbuf,
                    void* dwh, void* dbh, ScanArgs a, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (form == kFull)
    err = launch_bwd<T, kMaxRows, kMaxPairs, false>(
        xg, hp, dy, wh, whT, bh, dxg, dhg, bias_part, xbuf, a, stream);
  else if (form == kOne)
    err = launch_bwd<T, 1, kWidePairs, false>(xg, hp, dy, wh, whT, bh, dxg,
                                              dhg, bias_part, xbuf, a,
                                              stream);
  else if (form == kGx && xbuf != nullptr)
    err = launch_bwd<T, 1, kWidePairs, true>(xg, hp, dy, wh, whT, bh, dxg,
                                             dhg, bias_part, xbuf, a, stream);
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

// Row 11.  dtype: 0 = float32, 1 = bfloat16, the dtype of every tensor but
// the f32 scratch.  Device pointers of contiguous tensors: res [T, B, 4W];
// hp, dy [T, B, W]; wh [W, 3W]; outputs dxg [T, B, 3W], dwh [W, 3W] and
// dbh [3W]; scratch dhg [T, B, 3W] (rnd(dhg), in the dtype), f32
// bias_part [B, 3W] (each row's dbh) and part, dwh's partials,
// ceil(ceil(T*B / 64) / slice_chunks) slices of W * 3W.  The chain's
// geometry (ops/rnn_scan.py::chain_geometry, an input of 3W a row) as
// lstm_scan_bwd_saved's: nc blocks a chain, s depth slices a column chunk,
// rows a chain, ls of shared-memory depth, rounds, and gx: the gradients'
// exchange in xbuf (f32, zeros, [B][2][3 (L + 4)], L = W rounded up to 8;
// one row a chain, in rounds) instead of shared memory.  Launches on
// `stream` (the chain, dwh's partials and their sum, dbh's sum) and
// returns the launches' error (0 on success).
int gru_scan_bwd_saved(int dtype, const void* res, const void* hp,
                       const void* dy, const void* wh, void* dxg, void* dhg,
                       float* bias_part, float* xbuf, void* dwh, void* dbh,
                       void* part, int Tn, int B, int W, int nc, int s,
                       int rows, int ls, int rounds, int gx,
                       int slice_chunks, void* stream) {
  rc::ChainArgs a;
  const int chunk = dtype == 0 ? 4 : 8;
  if (!rc::chain_args(Tn, B, W, 3, 3, nc, s, rows, ls, rounds, chunk, &a) ||
      (gx && (rounds < 2 || rows != 1 || xbuf == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return (int)rc::run_saved<float>(a, st, res, hp, dy, wh, dxg, dhg,
                                     bias_part, xbuf, gx != 0, dwh, dbh, p,
                                     slice_chunks);
  if (dtype == 1)
    return (int)rc::run_saved<__nv_bfloat16>(a, st, res, hp, dy, wh, dxg, dhg,
                                             bias_part, xbuf, gx != 0, dwh,
                                             dbh, p, slice_chunks);
  return (int)cudaErrorInvalidValue;
}

// Row 12, the recompute form: recompute must be 1 (the saved-gates form
// is gru_scan_bwd_saved; the argument stays so that the entry keeps its
// earlier signature, under which tools/torch_bwd_bits.py runs an earlier
// checkout's library through this wrapper); first = xg [T, B, 3W]; hp, dy [T, B, W]; wh
// [W, 3W] and whT = wh^T [3W, W]; bh [3W]; outputs dxg [T, B, 3W], dwh
// [W, 3W] and dbh [3W]; f32 scratch dhg [T, B, 3W], bias_part [B, 3W] and,
// the Gx form, xbuf [B][2][round4(3W)] (the gradients' exchange in device
// memory).  The launch (ops/rnn_scan.py::scan_form): cluster, the blocks a
// chain spreads W over, 1..16 and at most W; rows a chain; form, where the
// gradients cross the cluster (scan_common.cuh's Form: 0 Full, 1 One, 2
// Gx).  Launches on `stream` and returns the launches' error (0 on
// success).
int gru_scan_bwd(int dtype, int recompute, const void* first, const void* hp,
                 const void* dy, const void* wh, const void* whT,
                 const void* bh, void* dxg, float* dhg, float* bias_part,
                 float* xbuf, void* dwh, void* dbh, int Tn, int B, int W,
                 int cluster, int rows, int form, void* stream) {
  ScanArgs a;
  if (!scan_geometry(Tn, B, W, cluster, rows, &a) || recompute != 1 ||
      bh == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bwd<float>(form, first, hp, dy, wh, whT, bh, dxg, dhg,
                               bias_part, xbuf, dwh, dbh, a, s);
  if (dtype == 1)
    return (int)run_bwd<__nv_bfloat16>(form, first, hp, dy, wh, whT, bh, dxg,
                                       dhg, bias_part, xbuf, dwh, dbh, a, s);
  return (int)cudaErrorInvalidValue;
}

const char* gru_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
