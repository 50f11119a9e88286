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
// What bounded the first design (a cluster of W/16 blocks carrying up
// to 8 rows, the weights read from shared memory every step by a
// depth-sliced product whose partial sums and gates went through shared
// memory, two block barriers, one scalar remote store a (row, unit) pair a
// peer and a full cluster barrier a step), taken apart with edited copies
// (tools/torch_lstm_scan_steps.py, PERF.md section 6; f32, us a step):
// 5.70 at B=8, W=256, of it the product 2.0 (all 8 rows' sums, from shared
// memory), the exchange 0.6, the gate math 0.5 and 2.5 in the rest (the
// block barriers, the round trips through shared memory, xg's loads);
// 3.11 at B=3, W=64 (the product 0.9 on a 4-block cluster whose whole wh
// fits one block); 11.4 at B=64 (the product 7.2, the scalar peer stores
// 4.7).  So this design:
//  * Geometry from storage (ops/rnn_scan.py::chain_geometry): the fewest
//    blocks NC (up to 8) whose registers hold wh's slices, 128 values a
//    thread, else the fewest (up to 16) whose registers and shared memory
//    hold them; a depth past both streams through L2 every step (W > 512
//    in f32).  W=64: one block, no cluster; W=256: 8 blocks.  Past 64
//    units a block (W > 1024, or a chain the card cannot run wider) each
//    thread takes R units a step in turn (rounds), every weight through L2
//    and c in shared memory: a width no model of the repo uses by default,
//    taken so that every width runs (vanilla_lstm's --lstm_hidden1, half of
//    it for the bidirectional LSTM's scan route).
//  * bf16 weights sit in registers as f32: packed two a register they
//    would halve the blocks at W=256, but unpacking them costs an
//    instruction a weight a step, and the first build of that measured 2.5
//    us a step against f32's 1.0 (shared memory keeps them packed).
//  * Rows a chain (1, 2, 3, 4, 6 or 8) from B and the clusters the card
//    runs at once (its occupancy query: 15 of 8 blocks on an H100, not
//    132 / 8): one row a chain at B <= 15, so a block's product is one
//    row's; more rows share a chain (and each weight read) only so that no
//    chain waits for another to finish.
//  * Thread (unit u, gate g, depth slice s) keeps its slice of wh's column
//    g*W + u in registers.  A unit's 4*S threads are neighbouring lanes of
//    one warp: the slices' sums meet by shuffles, and each lane gathers the
//    four gates by shuffles and updates c (carried in registers) itself.
//    No shared-memory round trip but h's, no block barrier in a step.
//  * h is exchanged by st.async: each new h value goes to every block of
//    the cluster as one remote store that also completes its bytes on the
//    receiver's mbarrier, so a block waits only for its own h buffer to
//    fill (a one-way latency), never for a cluster barrier.  h is double-
//    buffered: a block writes a peer's buffer for step t+2 only after the
//    peer sent its h of step t+1, which it does after reading the buffer at
//    step t.  With one block the h values go to its own shared memory and
//    one block barrier a step publishes them.  Wider writes (a block's
//    slice gathered, then one bulk copy a peer) would add a block barrier
//    a step to save an exchange that takes about 0.1 us of it (below).
//  * xg of step t+1 is loaded at the end of step t, its rows prefetched
//    into L2 four steps ahead; the stores of ys, cs and res follow the
//    remote stores, off the chain.
// Measured the same way, a step of this design at B=8, W=256 (f32) takes
// about 1.0 us: the product about 0.4, the gate math 0.2, the exchange
// 0.1 (PERF.md section 6).  The product stays SIMT: with one row a chain
// (B <= 15 on 8-block chains) an mma.sync m16n8k16 would use one of its 8
// columns and add a fragment shuffle a step, and 3xTF32 triples f32's
// work; the bench's 6-row chains, where the product takes 1.9 of 4.5 us,
// are where tensor cores could pay (ROADMAP section 2).
//
// The chain's pieces (geometry arguments, weight tiers and product,
// mbarrier exchange, L2 prefetch, occupancy query, cluster launch) live in
// scan_chain.cuh, shared with the GRU scan's eval forward and the LSTM
// scan's saved-gates backward; the step itself is this kernel's.

#include "scan_chain.cuh"

namespace {

using namespace rc;

// One chain of a.rows batch rows on a cluster of a.NC blocks.  Block rank
// q owns units [q*U, q*U + ucnt); thread tid is depth slice s = tid % S of
// gate g = (tid / S) % 4 of local unit tid / (4S) + i*UT in round i (one
// round unless WIDE).  h_s [2][RM][ldh] f32 (slice s of a row at s*LP),
// then two mbarriers (one an h buffer), then the shared-memory weights
// [ls*sizeof(T)/16][nthr] 16-byte chunks or, with WIDE, each thread's c
// [R][RM][nthr] f32.
template <typename T, int RM, bool SAVE, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
lstm_scan_fwd_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
                     T* __restrict__ ys, T* __restrict__ cs,
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
  const int col0 = g * a.W + (on0 ? unit0 : 0);
  const int uoff0 = on0 ? (unit0 / a.L) * a.LP + unit0 % a.L : 0;

  // the weights: registers, then shared memory (WIDE: L2 only)
  uint32_t wr[kRegWords];
  if constexpr (!WIDE) {
    load_resident(wr, w_s, wh + col0, a.G, a, d0, on0, tid);
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
  float xv[RM], c[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    xv[r] = r < nb ? to_f(xg[(size_t)(b0 + r) * a.G + col0]) : 0.0f;
    c[r] = 0.0f;
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
      if constexpr (WIDE) {  // this round's unit, xg and c
        unit = unit0 + i * a.UT;
        on = on0 && ul + i * a.UT < ucnt;
        col = g * a.W + (on ? unit : 0);
        uoff = on ? (unit / a.L) * a.LP + unit % a.L : 0;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          xv[r] = r < nb ? to_f(xg[t * ldx + (size_t)(b0 + r) * a.G + col])
                         : 0.0f;
          c[r] = c_s[(size_t)(i * RM + r) * a.nthr + tid];
        }
      }
      float pre[RM];
      product<T, RM, WIDE>(wr, w_s + tid, wh + col, a.G,
                           h_s + cur * RM * a.ldh + s * a.LP, a, d0, pre);
      // the slices' sums (the same in every slice's lane), the gate, the four
      // gates of the unit from its lanes, and the cell update in every lane
      float act[RM], tc[RM], hv[RM];
      T hq[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float sum = pre[r];
        for (int o = 1; o < a.S; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float p = xv[r] + sum;
        act[r] = g == 2 ? tanhf(p) : sigmoid_f(p);
        const int lane = base + s;
        const float ig = __shfl_sync(0xffffffffu, act[r], lane);
        const float fg = __shfl_sync(0xffffffffu, act[r], lane + a.S);
        const float gg = __shfl_sync(0xffffffffu, act[r], lane + 2 * a.S);
        const float og = __shfl_sync(0xffffffffu, act[r], lane + 3 * a.S);
        c[r] = fmaf(fg, c[r], ig * gg);
        tc[r] = tanhf(c[r]);
        hq[r] = from_f<T>(og * tc[r]);
        hv[r] = to_f(hq[r]);
      }
      if constexpr (WIDE) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
          c_s[(size_t)(i * RM + r) * a.nthr + tid] = c[r];
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
      if (on) {
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r < nb) {
            const size_t row = (size_t)t * a.B + b0 + r;
            if (k == 0) ys[row * a.W + unit] = hq[r];
            if (k == 1) cs[row * a.W + unit] = from_f<T>(c[r]);
            if (SAVE && k == 2)
              res[row * 5 * a.W + 4 * a.W + unit] = from_f<T>(tc[r]);
            if (SAVE && s == 0) res[row * 5 * a.W + col] = from_f<T>(act[r]);
          }
        }
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

template <typename T, int RM, bool SAVE, bool WIDE>
cudaError_t launch(const ChainArgs& a, cudaStream_t stream, const void* xg,
                   const void* wh, void* ys, void* cs, void* res) {
  return launch_chain(lstm_scan_fwd_kernel<T, RM, SAVE, WIDE>, a,
                      chain_smem<T>(a, RM), stream, static_cast<const T*>(xg),
                      static_cast<const T*>(wh), static_cast<T*>(ys),
                      static_cast<T*>(cs), static_cast<T*>(res), a);
}

template <typename T, int RM>
cudaError_t run_rows(const ChainArgs& a, bool save, cudaStream_t stream,
                     const void* xg, const void* wh, void* ys, void* cs,
                     void* res) {
  if (a.R > 1) {  // rounds: 1, 2 or 4 rows a chain
    if constexpr (RM == 1 || RM == 2 || RM == 4) {
      if (save)
        return launch<T, RM, true, true>(a, stream, xg, wh, ys, cs, res);
      return launch<T, RM, false, true>(a, stream, xg, wh, ys, cs, res);
    }
    return cudaErrorInvalidValue;
  }
  if (save) return launch<T, RM, true, false>(a, stream, xg, wh, ys, cs, res);
  return launch<T, RM, false, false>(a, stream, xg, wh, ys, cs, res);
}

template <typename T>
cudaError_t run_fwd(const ChainArgs& a, bool save, cudaStream_t stream,
                    const void* xg, const void* wh, void* ys, void* cs,
                    void* res) {
  switch (a.rows) {
    case 1: return run_rows<T, 1>(a, save, stream, xg, wh, ys, cs, res);
    case 2: return run_rows<T, 2>(a, save, stream, xg, wh, ys, cs, res);
    case 3: return run_rows<T, 3>(a, save, stream, xg, wh, ys, cs, res);
    case 4: return run_rows<T, 4>(a, save, stream, xg, wh, ys, cs, res);
    case 6: return run_rows<T, 6>(a, save, stream, xg, wh, ys, cs, res);
    case 8: return run_rows<T, 8>(a, save, stream, xg, wh, ys, cs, res);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the dtype of every tensor.  Device
// pointers of contiguous tensors: xg [T, B, 4W], wh [W, 4W], ys and cs
// [T, B, W] and, when save != 0, res [T, B, 5W] (ignored otherwise).
// The geometry (ops/rnn_scan.py::chain_geometry): nc blocks a chain
// (1..16, each owning a unit), s depth slices a gate column (1, 2, 4, 8),
// rounds, the units a thread takes in turn each step (4 * ceil(ceil(W /
// nc) / rounds) * s <= 256), rows batch rows a chain (1, 2, 3, 4, 6, 8;
// with rounds 1, 2, 4) and ls, the depth a slice reads from shared memory
// after its registers (a multiple of 16 bytes' values; 0 with rounds).
// Launches on `stream` and returns the launch's error (0 on success).
int lstm_scan_fwd(int dtype, const void* xg, const void* wh, void* ys,
                  void* cs, void* res, int Tn, int B, int W, int save,
                  int nc, int s, int rows, int ls, int rounds, void* stream) {
  ChainArgs a;
  const int chunk = dtype == 0 ? 4 : 8;
  if (!chain_args(Tn, B, W, 4, 1, nc, s, rows, ls, rounds, chunk, &a) ||
      (save && res == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_fwd<float>(a, save != 0, st, xg, wh, ys, cs, res);
  if (dtype == 1)
    return (int)run_fwd<__nv_bfloat16>(a, save != 0, st, xg, wh, ys, cs,
                                       res);
  return (int)cudaErrorInvalidValue;
}

// The clusters of nc blocks (1..16) that the card runs at once
// (cudaOccupancyMaxActiveClusters; a cluster lies in one GPC, so fewer
// than SMs / nc), or -1 for a size it refuses.
int lstm_scan_fwd_clusters(int nc) {
  return nc >= 1 && nc <= kMaxNC
             ? max_clusters(lstm_scan_fwd_kernel<float, 1, true, false>, nc)
             : -1;
}

const char* lstm_scan_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
