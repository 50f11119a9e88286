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
// Both forms run on the register-resident chain of scan_chain.cuh, as the
// LSTM scan's forwards do: one kernel, which with res given (the saving
// form, row 10) also stores four residuals a unit, one a lane group, off
// the chain (stores are not waited on), so the saving form's ys equals the
// eval form's (row 9) bit for bit and it takes every width the eval form
// takes.  The first design (on scan_common.cuh's chain, which the saving
// form kept longer) took 4.1 us a step at B=8, W=256: its product from
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

#include "scan_chain.cuh"

namespace {
namespace rc {

// Both forms on the chain of scan_chain.cuh (res given: the saving form,
// row 10, which also writes the residuals).  Block rank q owns
// units [q*U, q*U + ucnt); thread tid is depth slice s = tid % S of lane
// group g = (tid / S) % 4 of local unit tid / (4S) + i*UT in round i (one
// round unless WIDE): groups 0, 1, 2 hold the r, z and n columns of wh,
// group 3 none (it reads n's column and its sums go unused).  h_s
// [2][RM][ldh] f32 (slice s of a row at s*LP), then two mbarriers (one an
// h buffer), then the shared-memory weights [ls*sizeof(T)/16][nthr]
// 16-byte chunks or, with WIDE, each thread's h carry [R][RM][nthr] f32.
template <typename T, int RM, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
gru_scan_fwd_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
                     const T* __restrict__ bh, T* __restrict__ ys,
                     T* __restrict__ res, ChainArgs a) {
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
      float hv[RM], gates[RM];
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
        gates[r] = g == 0 ? rg : g == 1 ? zg : g == 2 ? n : hn;  // res
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
      if (res != nullptr && on && s == 0) {  // lane group g's residual
#pragma unroll
        for (int r = 0; r < RM; ++r)
          if (r < nb)
            res[((size_t)t * a.B + b0 + r) * 4 * a.W + g * a.W + unit] =
                from_f<T>(gates[r]);
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
cudaError_t launch_fwd(const ChainArgs& a, cudaStream_t stream,
                       const void* xg, const void* wh, const void* bh,
                       void* ys, void* res) {
  return launch_chain(gru_scan_fwd_kernel<T, RM, WIDE>, a,
                      chain_smem<T>(a, RM), stream, static_cast<const T*>(xg),
                      static_cast<const T*>(wh), static_cast<const T*>(bh),
                      static_cast<T*>(ys), static_cast<T*>(res), a);
}

template <typename T, int RM>
cudaError_t fwd_rows(const ChainArgs& a, cudaStream_t stream, const void* xg,
                     const void* wh, const void* bh, void* ys, void* res) {
  if (a.R > 1) {  // rounds: 1, 2 or 4 rows a chain
    if constexpr (RM == 1 || RM == 2 || RM == 4)
      return launch_fwd<T, RM, true>(a, stream, xg, wh, bh, ys, res);
    return cudaErrorInvalidValue;
  }
  return launch_fwd<T, RM, false>(a, stream, xg, wh, bh, ys, res);
}

// The saving form when res is given, else the eval form.
template <typename T>
cudaError_t run_fwd(const ChainArgs& a, cudaStream_t stream, const void* xg,
                    const void* wh, const void* bh, void* ys, void* res) {
  switch (a.rows) {
    case 1: return fwd_rows<T, 1>(a, stream, xg, wh, bh, ys, res);
    case 2: return fwd_rows<T, 2>(a, stream, xg, wh, bh, ys, res);
    case 3: return fwd_rows<T, 3>(a, stream, xg, wh, bh, ys, res);
    case 4: return fwd_rows<T, 4>(a, stream, xg, wh, bh, ys, res);
    case 6: return fwd_rows<T, 6>(a, stream, xg, wh, bh, ys, res);
    case 8: return fwd_rows<T, 8>(a, stream, xg, wh, bh, ys, res);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rc
}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the dtype of every tensor.  Device
// pointers of contiguous tensors: xg [T, B, 3W], wh [W, 3W], bh [3W], ys
// [T, B, W] and, the saving form (row 10), res [T, B, 4W]; res = 0 runs the
// eval form (row 9).  The chain's geometry (ops/rnn_scan.py::
// chain_geometry) as lstm_scan_fwd's: nc blocks a chain, s depth slices a
// column, rows a chain, ls of shared-memory depth, rounds.  Launches on
// `stream` and returns the launch's error (0 on success).
int gru_scan_fwd(int dtype, const void* xg, const void* wh, const void* bh,
                 void* ys, void* res, int Tn, int B, int W, int nc, int s,
                 int rows, int ls, int rounds, void* stream) {
  rc::ChainArgs a;
  const int chunk = dtype == 0 ? 4 : 8;
  if (!rc::chain_args(Tn, B, W, 3, 1, nc, s, rows, ls, rounds, chunk, &a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)rc::run_fwd<float>(a, st, xg, wh, bh, ys, res);
  if (dtype == 1)
    return (int)rc::run_fwd<__nv_bfloat16>(a, st, xg, wh, bh, ys, res);
  return (int)cudaErrorInvalidValue;
}

const char* gru_scan_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
