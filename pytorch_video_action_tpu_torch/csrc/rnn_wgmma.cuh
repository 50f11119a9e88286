// The bidirectional layer backwards' products off the chain on Hopper's
// tensor cores (sm_90a), for gate width G: the GRU layer's (gru_bidir_bwd.cu,
// rows 2 and 2 alt, G = 3H) and the LSTM layer's (lstm_bidir_bwd.cu, row 4,
// G = 4H)
//   dwi_d = x^T rnd(dxg_d), dwh_d = hp_d^T rnd(dhg_d)   [W or H, G]
//   dx    = rnd(dxg_f) wi_f^T + rnd(dxg_b) wi_b^T       [T*B, W]
// and the merged-body GRU's (gru_merged_bwd.cu, row 6)
//   dwi_d = x^T rnd(dxg_d)                    [W, G]
//   dwh2  = hp2^T rnd(dhg2)                   [2H, 2G]
//   dx_d  = rnd(dxg_d) wi_d^T, apart          [T*B, W] each
// with the operands, rounding points and store functors of rnn_common.cuh
// (ShiftedRowsT, RoundedRows, DxgRows, WiT, Store; for the fused-boundary
// form Boundary and BoundaryStore), read only, and the wgmma machinery of
// flash_wgmma.cuh (chunks, descriptors, put4, mma_ss, the Ring of
// mbarriers, the tf32 split), included unedited.  The LSTM scan's dwh
// and the GRU scan's (rows 15 and 11: dwh_wgmma_kernel, below) run on
// run_products too.
//
// What bounds it on an H100: at bigru's layer 0 in training (B=8, T=1920,
// W=400, H=128) the products are 4*T*B*G*(2W + H) = 21.9 GFLOP: about
// 0.13 ms as 3xTF32 (three TF32 products for each f32 one at 495 TFLOP/s)
// and 0.02 ms in bf16, against 0.33 ms at the f32 SIMT peak.  The weight
// gradients have a short output ([W or H] x G: 54 tiles of 64 x 128) and a
// long K (T*B = 15360 rows), so tiles alone leave most of the 132 SMs idle.
//
// What the design does about it:
//  * A block is four warpgroups: three producers that stage 64 x 64
//    K-major chunks into a ring of slots (flash_wgmma.cuh's Ring), one
//    chunk of each slot apiece, and a consumer that issues two m64n64
//    products, f32 accumulation: bf16 k16 wgmma with both operands in
//    shared memory, or 3xTF32 on tf32 k8 wgmma with the A operand raw in
//    shared memory and split in registers.  A slot holds one chunk X and
//    two chunks Y_0, Y_1, X shared by both products: a block's output is
//    64 x 128, X staged once for both halves.  The producers' reads and
//    conversions, not the tensor cores, set the pace, so they get three
//    warpgroups' issue slots and latency hiding, and the 128 registers a
//    thread of a 512-thread block.
//  * The producer reads every operand as its rnn_common.cuh functor
//    defines it and converts it into the chunk (the tf32 split, or bf16):
//    the same values the SIMT products read, so the fused-boundary form
//    builds each boundary element once per staged chunk, as the dense form
//    converts the glue's tensor, and the two stay equal bit for bit.  The
//    weight gradients' operands run along the chunk rows in memory (x and
//    hp read transposed, dxg and dhg along G), so a thread reads one chunk
//    row down K and writes it 4 elements a store; dx's (dxg rows, wi rows)
//    are read 4 along K a load.  A thread reads its 32 elements of a chunk
//    in two halves, the next half's loads in flight while it writes the
//    last one, and reads before it waits for a free slot, so the loads
//    overlap the consumer's products.
//  * dwi and dwh: K split into slices of whole chunks (the wrapper picks
//    the depth, ops/rnn_fused.py::wgrad_slice_chunks); each (tile, slice)
//    block writes its f32 partial to scratch, and wgrad_reduce_kernel adds
//    the slices in order and writes the gradients in the weight dtype: no
//    atomics, so two runs give bit-identical gradients.  Each of the four
//    problems has its own A operand, rows, gate-gradient operand and
//    partial stride, so the merged body's dwh2 is two problems (its column
//    halves) over hp2 unshifted, their partials one [2H, 2G] block.  Row 6
//    restarts the accumulators every kRestartChunks chunks (run_products'
//    sums), as row 15 does: its 512-chunk slices at the bench shape stand
//    2.69e-4 of the largest element from the plain version's without it;
//    rows 2, 2 alt and 4 do not.
//  * dx: K = 2G, both directions in one sum; a block is two 64-row tiles
//    of T*B sharing the chunk of wi, its epilogue the store functor (the
//    dense store, or the boundary's VJP).  The merged body's dx_f and dx_b
//    are apart: one launch, blockIdx.z the direction, K = G each.

#pragma once

#include "flash_wgmma.cuh"
#include "rnn_common.cuh"

namespace {

// three producer warpgroups (one a chunk of the slot) and a consumer
constexpr int kProducers = 3;
constexpr int kProdThreads = (kProducers + 1) * kWg;
constexpr int kProdStagesMax = 4;

template <typename T>
__host__ __device__ constexpr int slot_bytes() {
  return 3 * chunk_bytes<T>();  // X, Y_0, Y_1
}
template <typename T>
__host__ __device__ constexpr int prod_stages() {
  return ring_stages(kSmemAlign, slot_bytes<T>(), kProdStagesMax);
}
template <typename T>
constexpr int prod_smem() {
  return prod_stages<T>() * slot_bytes<T>() + kSmemAlign;
}

// ------------------------------------------------ the producer's reads
//
// Each of the slot's chunks is 4096 elements, 32 a thread of its producer
// warpgroup, read into registers in two halves (so one half's loads are in
// flight while the other half is written) and written as 4-element groups
// along K (put4: the tf32 split, or bf16), 16 bytes a store in f32.  Every
// load is unconditional: inside the operand by construction (an interior
// chunk) or with its indices clamped into range and what lies outside
// zeroed after, so the loads carry no branches.

// A load the compiler issues where it stands and never predicates: the
// reads of a chunk go out back to back, and only their uses wait.  The
// operands are written by earlier launches, so the read-only path (.nc)
// holds.
__device__ __forceinline__ float ldg(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  unsigned short u;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(u) : "l"(p));
  return __uint_as_float((uint32_t)u << 16);
}

// Element (R, C) of a transposed operand (R the row of T*B, C the chunk
// row): ShiftedRowsT's rows p[(R + shift) * ld + C], 0 outside [0, rows);
// RoundedRows' rnd(p[R * ld + C]); the boundary's element (R, C).
template <typename T>
__device__ __forceinline__ float at_t(const ShiftedRowsT<T>& s, int R,
                                      int C) {
  const int q = R + s.shift;
  const unsigned qc = (unsigned)min(max(q, 0), s.rows - 1);
  const float v = ldg(s.p + ((size_t)qc * (unsigned)s.ld + C));
  return (q >= 0 && q < s.rows) ? v : 0.0f;
}
template <typename T>
__device__ __forceinline__ float at_t(const RoundedRows<T>& b, int R,
                                      int C) {
  return rnd<T>(ldg(b.p + ((size_t)(unsigned)R * (unsigned)b.ld + C)));
}
template <typename T>
__device__ __forceinline__ float at_t(const Boundary<T>& bnd, int R, int C) {
  return bnd(R, C);
}

// The same reads where the whole chunk (rows [k0, k0 + 64) of K, columns
// [c0, c0 + 64)) lies inside the operand, as most chunks do: a pointer to
// source row R and the element at a pointer; the boundary's by gather_bnd
// (kRows false).
template <typename L>
constexpr bool kRows = true;
template <typename T>
constexpr bool kRows<Boundary<T>> = false;
template <typename T>
__device__ __forceinline__ bool inside(const ShiftedRowsT<T>& s, int k0,
                                       int kn, int c0, int cols) {
  return k0 + kTile <= kn && c0 + kTile <= cols && k0 + s.shift >= 0 &&
         k0 + kTile + s.shift <= s.rows;
}
template <typename T>
__device__ __forceinline__ const T* row_at(const ShiftedRowsT<T>& s, int R) {
  return s.p + (size_t)(unsigned)(R + s.shift) * (unsigned)s.ld;
}
template <typename T>
__device__ __forceinline__ float get_at(const ShiftedRowsT<T>&,
                                        const T* p) {
  return ldg(p);
}
template <typename T>
__device__ __forceinline__ bool inside(const RoundedRows<T>&, int k0, int kn,
                                       int c0, int cols) {
  return k0 + kTile <= kn && c0 + kTile <= cols;
}
template <typename T>
__device__ __forceinline__ const float* row_at(const RoundedRows<T>& b,
                                               int R) {
  return b.p + (size_t)(unsigned)R * (unsigned)b.ld;
}
template <typename T>
__device__ __forceinline__ float get_at(const RoundedRows<T>&,
                                        const float* p) {
  return rnd<T>(ldg(p));
}

// The boundary's 16 elements of an interior chunk at column C, rows R0 +
// 8 j + e (j < 4, e < 4): Boundary::operator()'s arithmetic, with each
// row's (t, b) stepped from one division a group and all 16 loads issued
// before the first use.
template <typename T>
__device__ __forceinline__ void gather_bnd(float v[16], const Boundary<T>& bnd,
                                           int C, int R0) {
  const int H = bnd.H;
  const T* col = C < H ? bnd.xa + C : bnd.xb + (C - H);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = ldg(col + (size_t)(unsigned)(R0 + 8 * (i >> 2) + (i & 3)) * H);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int R = R0 + 8 * j;
    int t = R / bnd.B;
    int b = R - t * bnd.B;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e > 0 && ++b == bnd.B) {
        b = 0;
        ++t;
      }
      float x = v[4 * j + e];
      x *= bnd.valid(t, b) ? 1.0f : 0.0f;
      if (bnd.drop) x = bnd.kept(t, b, C) ? rnd<T>(x * bnd.scale) : 0.0f;
      v[4 * j + e] = x;
    }
  }
}

// A transposed chunk: this thread's chunk row r = lane + 32 (warp & 1)
// (source column c0 + r, neighbouring lanes on neighbouring columns) and
// its groups g = (warp >> 1) + 2 j, j < 8 (source rows k0 + 4 g + e, e <
// 4); 0 past `cols` and `kn`.  The group's 16-byte stores of a quarter
// warp fall on 8 consecutive chunk rows: every bank once.
// Half h of them: groups j in [4h, 4h + 4).
template <typename L>
__device__ __forceinline__ void gather_t(float v[16], const L& src, int c0,
                                         int cols, int k0, int kn, int tid,
                                         int h) {
  const int r = (tid & 31) + 32 * ((tid >> 5) & 1);
  if constexpr (kRows<L>) {
    if (inside(src, k0, kn, c0, cols)) {
      const auto* base = row_at(src, k0 + 4 * (tid >> 6)) + c0 + r;
      const unsigned ld = src.ld;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[4 * j + e] =
              get_at(src, base + (size_t)((8 * (4 * h + j) + e) * ld));
      return;
    }
  } else {
    if (k0 + kTile <= kn && c0 + kTile <= cols) {
      gather_bnd(v, src, c0 + r, k0 + 4 * (tid >> 6) + 32 * h);
      return;
    }
  }
  const int C = min(c0 + r, cols - 1);
  const bool in = c0 + r < cols;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int R = k0 + 4 * ((tid >> 6) + 2 * (4 * h + j)) + e;
      const float x = at_t(src, min(R, kn - 1), C);
      v[4 * j + e] = (in && R < kn) ? x : 0.0f;
    }
}
template <typename T, bool kSplit>
__device__ __forceinline__ void scatter_t(char* chunk, const float v[16],
                                          int tid, int h) {
  const int r = (tid & 31) + 32 * ((tid >> 5) & 1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    put4<T, kSplit>(chunk, r, (tid >> 6) + 2 * (4 * h + j), &v[4 * j]);
}

// Four neighbours along K of a natural operand: dx's dxg rows (rnd(dxg_d[m]
// [k - d G]), DxgRows) and wi rows (wi_d[n][k - d G], WiT), d = (k >= G).
// k is a multiple of 4 and G too, so the four share a direction; a 16-byte
// (f32) or 8-byte (bf16) load where the address allows.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "l"(p));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = ldg(p + e);
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  if (reinterpret_cast<uintptr_t>(p) % 8 == 0) {
    uint32_t lo, hi;
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(lo), "=r"(hi)
                 : "l"(p));
    v[0] = __uint_as_float(lo << 16);
    v[1] = __uint_as_float(lo & 0xffff0000u);
    v[2] = __uint_as_float(hi << 16);
    v[3] = __uint_as_float(hi & 0xffff0000u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = ldg(p + e);
  }
}
template <typename T>
__device__ __forceinline__ void at4(const DxgRows<T>& a, int m, int k,
                                    float v[4]) {
  const int d = k >= a.G;
  load4(a.p + d * a.dir_stride + (size_t)(unsigned)m * a.G + (k - d * a.G),
        v);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = rnd<T>(v[e]);
}
template <typename T>
__device__ __forceinline__ void at4(const WiT<T>& b, int n, int k,
                                    float v[4]) {
  const int d = k >= b.G;
  load4((d ? b.wb : b.wf) + (size_t)(unsigned)n * b.G + (k - d * b.G), v);
}

// A natural chunk: this thread's units i = tid + 128 it, it < 8 (chunk row
// unit_row(i) = source row r0 + unit_row(i), group unit_group(i) = source
// columns k0 + 4 unit_group(i) ..), flash_wgmma.cuh's unit order; 0 past
// `rows` and `kn` (a multiple of 4).  Half h of them: it in [4h, 4h + 4).
template <typename L>
__device__ __forceinline__ void gather_n(float v[16], const L& src, int r0,
                                         int rows, int k0, int kn, int tid,
                                         int h) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = tid + kWg * (4 * h + it);
    const int R = r0 + unit_row(i);
    const int K = k0 + 4 * unit_group(i);
    at4(src, min(R, rows - 1), min(K, kn - 4), &v[4 * it]);
    if (!(R < rows && K < kn)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * it + e] = 0.0f;
    }
  }
}
template <typename T, bool kSplit>
__device__ __forceinline__ void scatter_n(char* chunk, const float v[16],
                                          int tid, int h) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = tid + kWg * (4 * h + it);
    put4<T, kSplit>(chunk, unit_row(i), unit_group(i), &v[4 * it]);
  }
}

// The consumer's products over one slot: acc[h] += A_h B_h for h = 0, 1,
// where A_h is X (kSharedA) or Y_h and B_h the other.  bf16: both from
// shared memory (mma_ss).  f32: the A chunks are raw, split into tf32 hi
// and lo as each k-step's fragment loads them (once for both products when
// they share it), and the B chunks hold both planes: 3xTF32 with a third
// less shared-memory traffic than two planes for both operands, which in
// f32 bounds the products.  As flash_wgmma.cuh's mma_chunk, the f32
// products wait for their wgmmas every kF32Group k-steps.
template <typename T, bool kSharedA>
__device__ __forceinline__ void mma_slot(float (*acc)[32], const char* s,
                                         int chunk) {
  if constexpr (Op<T>::kPlanes == 1) {
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const char* y = s + (1 + h) * chunk;
      if constexpr (kSharedA)
        mma_ss<T>(acc[h], s, y);
      else
        mma_ss<T>(acc[h], y, s);
    }
    wgmma_commit();
    wgmma_wait();
  } else {
    uint64_t bh[2], bl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const char* b = kSharedA ? s + (1 + h) * chunk : s;
      bh[h] = gmma_desc(b);
      bl[h] = gmma_desc(b + Op<float>::kPlaneBytes);
    }
#pragma unroll
    for (int k = 0; k < kTile / 8; ++k) {
      const uint64_t o = (uint64_t)((k * kStepBytes) >> 4);
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int h = 0; h < (kSharedA ? 1 : 2); ++h)
        frag_f32(kSharedA ? s : s + (1 + h) * chunk, k, hi[h], lo[h]);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = kSharedA ? 0 : h;
        wgmma_rs<float>(acc[h], hi[a], bh[h] + o);
        wgmma_rs<float>(acc[h], hi[a], bl[h] + o);
        wgmma_rs<float>(acc[h], lo[a], bh[h] + o);
      }
      if (k % kF32Group == kF32Group - 1) {
        wgmma_commit();
        wgmma_wait();
      }
    }
  }
}

// One block's products over the K chunks [c0, c1) (K ends at kn).  Slot s
// of the ring: chunk X (rows [x0, x0 + 64) of the operand lx, `xrows` of
// them), then Y_0 and Y_1 (rows [y0 + 64c, y0 + 64c + 64) of ly, `yrows`),
// each written by its own producer warpgroup; kTrans: both read
// transposed (gather_t), else natural (gather_n).  The consumer multiplies
// X by Y_0 and by Y_1: X is the A operand (kSharedA; the output's rows are
// X's) or the B one (the rows are Y_c's), and then calls epi(c, acc) with
// each m64n64 accumulator.  Thread 0 has initialised the barriers.  With
// `sums` (kRestartBytes of shared memory) the accumulators restart every
// kRestartChunks chunks, each run added in order into the consumer thread's
// own f32 sums there: the tensor cores' f32 sums lose precision with the
// chunks a run adds (their error of the largest element grows about as
// the chunks do), the CUDA cores' ordered sum of the runs does not.
constexpr int kRestartChunks = 8;
constexpr int kRestartBytes = 2 * 32 * kWg * 4;
template <typename T, bool kTrans, bool kSharedA, typename LX, typename LY,
          typename Epi>
__device__ __forceinline__ void run_products(char* smem, uint64_t* full,
                                             uint64_t* empty, const LX& lx,
                                             int x0, int xrows, const LY& ly,
                                             int y0, int yrows, int c0,
                                             int c1, int kn, const Epi& epi,
                                             float* sums = nullptr) {
  constexpr int kChunk = chunk_bytes<T>();
  constexpr int kSlot = slot_bytes<T>();
  Ring ring{smem, full, empty, prod_stages<T>(), 0, 0};
  // the warpgroup's role, broadcast so that the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x / kWg), 0);
  if (wg < kProducers) {  // producer wg writes chunk wg of each slot
    const int tid = threadIdx.x - wg * kWg;
    const int ry = y0 + (wg - 1) * kTile;
    auto gather = [&](float* v, int c, int h) {
      if constexpr (kTrans) {
        if (wg == 0)
          gather_t(v, lx, x0, xrows, c * kTile, kn, tid, h);
        else
          gather_t(v, ly, ry, yrows, c * kTile, kn, tid, h);
      } else {
        if (wg == 0)
          gather_n(v, lx, x0, xrows, c * kTile, kn, tid, h);
        else
          gather_n(v, ly, ry, yrows, c * kTile, kn, tid, h);
      }
    };
    // in f32 the A operands' chunks stay raw (mma_slot splits them)
    const bool raw = Op<T>::kPlanes == 2 && (wg == 0) == kSharedA;
    auto scatter = [&](char* s, const float* v, int h) {
      if constexpr (kTrans) {
        if (raw)
          scatter_t<T, false>(s, v, tid, h);
        else
          scatter_t<T, true>(s, v, tid, h);
      } else {
        if (raw)
          scatter_n<T, false>(s, v, tid, h);
        else
          scatter_n<T, true>(s, v, tid, h);
      }
    };
    // a chunk in two halves, so that one half's reads are in flight while
    // the other is converted: half 1 of chunk c goes out before half 0 is
    // written, half 0 of chunk c + 1 before half 1 is
    float a[16], b[16];
    gather(a, c0, 0);
    for (int c = c0; c < c1; ++c) {
      gather(b, c, 1);
      ring.wait_empty();
      char* s = ring.slot(kSlot) + wg * kChunk;
      scatter(s, a, 0);
      if (c + 1 < c1) gather(a, c + 1, 0);
      scatter(s, b, 1);
      ring.fill();
    }
    return;
  }
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.0f;
  // the thread's sums, [64][kWg] so that a warp's accesses take 32 banks
  const int ct = threadIdx.x - kProducers * kWg;
  bool summed = false;
  for (int c = c0; c < c1; ++c) {
    const int slot = ring.stage;
    ring.wait_full();
    const char* s = ring.slot(kSlot);
    ring.advance();
    mma_slot<T, kSharedA>(acc, s, kChunk);  // ends with its wgmmas done
    ring.release(slot);
    if (sums != nullptr && (c - c0) % kRestartChunks == kRestartChunks - 1 &&
        c + 1 < c1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float& a = acc[i / 32][i % 32];
        sums[i * kWg + ct] = summed ? sums[i * kWg + ct] + a : a;
        a = 0.0f;
      }
      summed = true;
    }
  }
  if (summed) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float& a = acc[i / 32][i % 32];
      a = sums[i * kWg + ct] + a;
    }
  }
  epi(0, acc[0]);
  epi(1, acc[1]);
}

// The barriers of the ring (the producers' threads fill a slot, the
// consumer's 4 warps free it) and the aligned ring itself.
template <typename T>
__device__ __forceinline__ char* prod_smem_init(char* smem_raw,
                                                uint64_t* full,
                                                uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < prod_stages<T>(); ++i) {
      mbar_init(&full[i], kProducers * kWg);
      mbar_init(&empty[i], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return aligned_smem(smem_raw);
}

// The weight gradients' four problems, each [rows[p], G] = A_p^T rnd(g[p])
// over K = T*B rows: dwif, dwib (A = x read transposed through XL:
// ShiftedRowsT, or the boundary) and the hidden problems 2 and 3 (A =
// hp[0], hp[1]: dwhf, dwhb over ys shifted by one step, or the merged
// body's dwh2 column halves over hp2).  Problem p's tiles are blocks
// [tile0[p], tile0[p + 1]): row tile t / pairs, column pair t % pairs
// (columns 128 (t % pairs) ..); its partials, rows of ldo[p] f32 at part +
// slice * per_slice + off[p].  With `restart` the accumulators restart
// every kRestartChunks chunks into sums behind the ring.
template <typename T, typename XL>
struct WgmmaWgrad {
  XL x;
  ShiftedRowsT<T> hp[2];
  RoundedRows<T> g[4];
  int rows[4];
  int tile0[5];
  int off[4];
  int ldo[4];
  int pairs, G, K, slice_chunks, restart;
  size_t per_slice;
  float* part;
};

// grid (tiles, slices): the partial of one 64 x 128 tile over one K slice
template <typename T, typename XL>
__global__ void __launch_bounds__(kProdThreads, 1)
wgrad_wgmma_kernel(const WgmmaWgrad<T, XL> w) {
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kProdStagesMax], empty[kProdStagesMax];
  char* smem = prod_smem_init<T>(smem_raw, full, empty);
  const int bx = blockIdx.x;
  const int p = bx < w.tile0[1] ? 0 : bx < w.tile0[2] ? 1
                                     : bx < w.tile0[3] ? 2 : 3;
  const int t = bx - w.tile0[p];
  const int m0 = (t / w.pairs) * kTile;
  const int n0 = (t % w.pairs) * 2 * kTile;
  const int chunks = (w.K + kTile - 1) / kTile;
  const int c0 = blockIdx.y * w.slice_chunks;
  const int c1 = min(c0 + w.slice_chunks, chunks);
  const RoundedRows<T> g = w.g[p];
  const int rows = w.rows[p], G = w.G, ldo = w.ldo[p];
  float* part = w.part + blockIdx.y * w.per_slice + w.off[p];
  const auto epi = [&](int cw, const float* acc) {
    const int n = n0 + cw * kTile + acc_col();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + acc_row() + 8 * i;
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n + 8 * j < G)
          *reinterpret_cast<float2*>(part + (size_t)m * ldo + n + 8 * j) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  };
  float* sums = w.restart ? reinterpret_cast<float*>(
                                smem + prod_stages<T>() * slot_bytes<T>())
                          : nullptr;
  if (p < 2)
    run_products<T, true, true>(smem, full, empty, w.x, m0, rows, g, n0, G,
                                c0, c1, w.K, epi, sums);
  else
    run_products<T, true, true>(smem, full, empty, w.hp[p - 2], m0, rows, g,
                                n0, G, c0, c1, w.K, epi, sums);
}

template <typename T>
struct WgradOuts {
  T* p[4];
  size_t off[5];
};

// out[e] = the slices' partials of element e added in order, in T
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ part,
                                    const WgradOuts<T> out, int slices) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = out.off[4];
  if (e >= n) return;
  float sum = 0.0f;
  for (int s = 0; s < slices; ++s) sum += part[(size_t)s * n + e];
  const int p = e < out.off[1] ? 0 : e < out.off[2] ? 1 : e < out.off[3] ? 2
                                                                       : 3;
  out.p[p][e - out.off[p]] = from_f<T>(sum);
}

// grid (ceil(W / 64), ceil(T*B / 128)): dx rows [128 y, 128 y + 128),
// columns [64 x, 64 x + 64) over K = 2G, stored by st; with kDirs, grid z
// 2: direction z alone over K = G (a and b at direction z), stored by st
// (z = 0) or st_b.  The column tiles of a row pair are neighbours in the
// launch order, so their reads of the same dxg rows meet in L2.
template <typename T, typename ST, bool kDirs = false>
__global__ void __launch_bounds__(kProdThreads, 1)
dx_wgmma_kernel(DxgRows<T> a, WiT<T> b, const ST st, const ST st_b, int M,
                int W, int K) {
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kProdStagesMax], empty[kProdStagesMax];
  char* smem = prod_smem_init<T>(smem_raw, full, empty);
  const int m0 = blockIdx.y * 2 * kTile;
  const int n0 = blockIdx.x * kTile;
  if constexpr (kDirs) {
    if (blockIdx.z) {
      a.p += a.dir_stride;
      b.wf = b.wb;
    }
  }
  run_products<T, false, false>(
      smem, full, empty, b, n0, W, a, m0, M, 0, (K + kTile - 1) / kTile, K,
      [&](int cw, const float* acc) {
        const int n = n0 + acc_col();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = m0 + cw * kTile + acc_row() + 8 * i;
          if (m >= M) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n + 8 * j + e < W) {
                if (kDirs && blockIdx.z)
                  st_b(m, n + 8 * j + e, acc[4 * j + 2 * i + e]);
                else
                  st(m, n + 8 * j + e, acc[4 * j + 2 * i + e]);
              }
        }
      });
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

static_assert(prod_smem<float>() + kRestartBytes + 2 * 8 * kProdStagesMax <=
                  kSmemMax,
              "the ring and the restart sums pass a block's shared memory");

// The problems' shared fields: K = M rows in slices of slice_chunks
// chunks, G columns, partials into part; no problem yet.
template <typename T, typename XL>
void wgrad_init(WgmmaWgrad<T, XL>& w, const XL& x, int M, int G,
                int slice_chunks, bool restart, float* part) {
  w.x = x;
  w.pairs = ((G + kTile - 1) / kTile + 1) / 2;
  w.G = G;
  w.K = M;
  w.slice_chunks = slice_chunks;
  w.restart = restart;
  w.part = part;
  w.tile0[0] = 0;
}

// Problem p: `rows` rows of A^T rnd(g) into partial rows of stride ldo at
// offset off (of a slice); its tiles follow problem p - 1's.
template <typename T, typename XL>
void wgrad_problem(WgmmaWgrad<T, XL>& w, int p, const RoundedRows<T>& g,
                   int rows, int ldo, size_t off) {
  w.g[p] = g;
  w.rows[p] = rows;
  w.ldo[p] = ldo;
  w.off[p] = (int)off;
  w.tile0[p + 1] = w.tile0[p] + (rows + kTile - 1) / kTile * w.pairs;
}

// The weight gradients' partials (a block a (tile, K slice); slices of
// outs.off[4] f32 each, laid out as the outputs) and their ordered sum
// into outs: two launches.
template <typename T, typename XL>
cudaError_t launch_wgrad(WgmmaWgrad<T, XL>& w, const WgradOuts<T>& outs,
                         cudaStream_t stream) {
  const int chunks = (w.K + kTile - 1) / kTile;
  if (w.slice_chunks <= 0) return cudaErrorInvalidValue;
  const int slices = (chunks + w.slice_chunks - 1) / w.slice_chunks;
  const size_t n = outs.off[4];
  w.per_slice = n;
  const int smem = prod_smem<T>() + (w.restart ? kRestartBytes : 0);
  cudaError_t err = set_smem(wgrad_wgmma_kernel<T, XL>, smem);
  if (err != cudaSuccess) return err;
  wgrad_wgmma_kernel<T, XL><<<dim3(w.tile0[4], slices), kProdThreads, smem,
                              stream>>>(w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      w.part, outs, slices);
  return cudaGetLastError();
}

// dx over M rows and W columns (one launch): the sum of both directions
// (K = 2G) into st, or with kDirs each direction apart (K = G) into st and
// st_b.
template <typename T, typename ST, bool kDirs = false>
cudaError_t launch_dx(const float* dxg, const void* wif, const void* wib,
                      const ST& st, const ST& st_b, int M, int W, int G,
                      cudaStream_t stream) {
  const DxgRows<T> xa = {dxg, (size_t)M * G, G};
  const WiT<T> xb = {static_cast<const T*>(wif), static_cast<const T*>(wib),
                     G};
  const int smem = prod_smem<T>();
  const cudaError_t err = set_smem(dx_wgmma_kernel<T, ST, kDirs>, smem);
  if (err != cudaSuccess) return err;
  dx_wgmma_kernel<T, ST, kDirs><<<dim3((W + kTile - 1) / kTile,
                                       (M + 2 * kTile - 1) / (2 * kTile),
                                       kDirs ? 2 : 1),
                                  kProdThreads, smem, stream>>>(
      xa, xb, st, st_b, M, W, kDirs ? G : 2 * G);
  return cudaGetLastError();
}

// The products of a bidirectional layer backward of gate width G, x read
// through XL and dx stored by dx_st: dwi_d, dwh_d [W or H, G] with hp_f =
// ys_f one step earlier (B rows up), hp_b = ys_b one step later (B rows
// down), 0 past the ends, from dxg and dhg [2, T*B, G] f32 (the LSTM
// passes its gate gradients as both); dx over K = 2G.  The weight
// gradients over K slices of `slice_chunks` chunks through the f32 scratch
// `part` (ceil(ceil(T*B / 64) / slice_chunks) slices of 2 (W + H) G
// elements); with `restart` their accumulators restart every
// kRestartChunks chunks.  Three launches: the partials, their sum, dx.
template <typename T, typename XL, typename ST>
cudaError_t launch_wgmma_products(const XL& x, const void* ysf,
                                  const void* ysb, const ST& dx_st,
                                  const void* wif, const void* wib,
                                  const float* dxg, const float* dhg,
                                  void* dwif, void* dwib, void* dwhf,
                                  void* dwhb, float* part, int slice_chunks,
                                  bool restart, int Tn, int B, int W, int H,
                                  int G, cudaStream_t stream) {
  const int M = Tn * B;
  const size_t dstride = (size_t)M * G;
  WgmmaWgrad<T, XL> w;
  wgrad_init(w, x, M, G, slice_chunks, restart, part);
  w.hp[0] = {static_cast<const T*>(ysf), H, -B, M};
  w.hp[1] = {static_cast<const T*>(ysb), H, B, M};
  WgradOuts<T> outs = {{static_cast<T*>(dwif), static_cast<T*>(dwib),
                        static_cast<T*>(dwhf), static_cast<T*>(dwhb)},
                       {0, 0, 0, 0, 0}};
  const int rows[4] = {W, W, H, H};
  size_t off = 0;
  for (int p = 0; p < 4; ++p) {
    const RoundedRows<T> g = {(p < 2 ? dxg : dhg) + (p & 1) * dstride, G};
    wgrad_problem(w, p, g, rows[p], G, off);
    outs.off[p] = off;
    off += (size_t)rows[p] * G;
  }
  outs.off[4] = off;
  const cudaError_t err = launch_wgrad(w, outs, stream);
  if (err != cudaSuccess) return err;
  return launch_dx<T>(dxg, wif, wib, dx_st, dx_st, M, W, G, stream);
}

// launch_wgmma_products for a dense layer input x [T*B, W] and dx [T*B, W].
template <typename T>
cudaError_t launch_wgmma_dense(const void* x, const void* wif,
                               const void* wib, const void* ysf,
                               const void* ysb, const float* dxg,
                               const float* dhg, void* dx, void* dwif,
                               void* dwib, void* dwhf, void* dwhb,
                               float* part, int slice_chunks, bool restart,
                               int Tn, int B, int W, int H, int G,
                               cudaStream_t stream) {
  return launch_wgmma_products<T>(
      ShiftedRowsT<T>{static_cast<const T*>(x), W, 0, Tn * B}, ysf, ysb,
      Store<T>{static_cast<T*>(dx), W}, wif, wib, dxg, dhg, dwif, dwib, dwhf,
      dwhb, part, slice_chunks, restart, Tn, B, W, H, G, stream);
}

// launch_wgmma_products for the GRU stack's boundary bnd (W = 2 bnd.H, G =
// 3H): dwi reads the maskdropped layer input, dx goes through the
// boundary's VJP into dxa and dxb [T*B, bnd.H].
template <typename T>
cudaError_t launch_wgmma_boundary(const Boundary<T>& bnd, const void* wif,
                                  const void* wib, const void* ysf,
                                  const void* ysb, const float* dxg,
                                  const float* dhg, void* dxa, void* dxb,
                                  void* dwif, void* dwib, void* dwhf,
                                  void* dwhb, float* part, int slice_chunks,
                                  int Tn, int B, int H,
                                  cudaStream_t stream) {
  return launch_wgmma_products<T>(
      bnd, ysf, ysb,
      BoundaryStore<T>{static_cast<T*>(dxa), static_cast<T*>(dxb), bnd},
      wif, wib, dxg, dhg, dwif, dwib, dwhf, dwhb, part, slice_chunks, false,
      Tn, B, 2 * bnd.H, H, 3 * H, stream);
}

// The merged-body GRU backward's products (row 6), G = 3H a direction:
// dwi_d = x^T rnd(dxg_d) [W, G]; dwh2 = hp2^T rnd(dhg2) [2H, 2G], the
// off-diagonal blocks included, as its column halves (problems 2 and 3:
// hp2 unshifted against dhg2's columns [0, G) and [G, 2G), their partials
// one [2H, 2G] block at stride 2G, summed into dwh2 as it lies); dx_d =
// rnd(dxg_d) wi_d^T apart (dxf, dxb [T*B, W]).  dxg [2, T*B, G] f32, each
// direction dense in original time order; dhg2 [T*B, 2G] f32 in kernel
// order, gate-grouped, the rows of hp2 [T*B, 2H] (in T).  The partials as
// launch_wgmma_products' (slices of 2 (W + 2H) G elements).
template <typename T>
cudaError_t launch_wgmma_merged(const void* x, const void* wif,
                                const void* wib, const void* hp2,
                                const float* dxg, const float* dhg2,
                                void* dxf, void* dxb, void* dwif, void* dwib,
                                void* dwh2, float* part, int slice_chunks,
                                bool restart, int Tn, int B, int W, int H,
                                cudaStream_t stream) {
  const int M = Tn * B;
  const int G = 3 * H;
  const size_t dstride = (size_t)M * G;
  WgmmaWgrad<T, ShiftedRowsT<T>> w;
  wgrad_init(w, ShiftedRowsT<T>{static_cast<const T*>(x), W, 0, M}, M, G,
             slice_chunks, restart, part);
  w.hp[0] = w.hp[1] = {static_cast<const T*>(hp2), 2 * H, 0, M};
  const size_t wi = (size_t)W * G;
  wgrad_problem(w, 0, RoundedRows<T>{dxg, G}, W, G, 0);
  wgrad_problem(w, 1, RoundedRows<T>{dxg + dstride, G}, W, G, wi);
  wgrad_problem(w, 2, RoundedRows<T>{dhg2, 2 * G}, 2 * H, 2 * G, 2 * wi);
  wgrad_problem(w, 3, RoundedRows<T>{dhg2 + G, 2 * G}, 2 * H, 2 * G,
                2 * wi + G);
  const size_t n = 2 * wi + (size_t)2 * H * 2 * G;
  const WgradOuts<T> outs = {{static_cast<T*>(dwif), static_cast<T*>(dwib),
                              static_cast<T*>(dwh2), nullptr},
                             {0, wi, 2 * wi, n, n}};
  const cudaError_t err = launch_wgrad(w, outs, stream);
  if (err != cudaSuccess) return err;
  return launch_dx<T, Store<T>, true>(dxg, wif, wib,
                                      Store<T>{static_cast<T*>(dxf), W},
                                      Store<T>{static_cast<T*>(dxb), W}, M,
                                      W, G, stream);
}


// The scans' saved-gates backwards' dwh (lstm_scan_bwd.cu, row 15, G = 4W;
// gru_scan_bwd.cu, row 11, G = 3W), its K-slice partials: block (x, y) is
// the 64 x 128 tile x (row tile x / pairs, column pair x % pairs) of hp^T g
// [W, G] over the K chunks of slice y, into part + y * W * G; each block's
// accumulators restart every kRestartChunks chunks into its sums, behind
// the ring.
template <typename T>
__global__ void __launch_bounds__(kProdThreads, 1)
dwh_wgmma_kernel(const ShiftedRowsT<T> hp, const ShiftedRowsT<T> dg,
                 float* __restrict__ part, int W, int G, int K, int pairs,
                 int slice_chunks) {
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kProdStagesMax], empty[kProdStagesMax];
  char* smem = prod_smem_init<T>(smem_raw, full, empty);
  const int m0 = (blockIdx.x / pairs) * kTile;
  const int n0 = (blockIdx.x % pairs) * 2 * kTile;
  const int chunks = (K + kTile - 1) / kTile;
  const int c0 = blockIdx.y * slice_chunks;
  const int c1 = min(c0 + slice_chunks, chunks);
  float* out = part + (size_t)blockIdx.y * W * G;
  const auto epi = [&](int cw, const float* acc) {
    const int n = n0 + cw * kTile + acc_col();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + acc_row() + 8 * i;
      if (m >= W) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n + 8 * j < G)
          *reinterpret_cast<float2*>(out + (size_t)m * G + n + 8 * j) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  };
  float* sums = reinterpret_cast<float*>(smem + prod_stages<T>() *
                                                   slot_bytes<T>());
  run_products<T, true, true>(smem, full, empty, hp, m0, W, dg, n0, G, c0,
                              c1, K, epi, sums);
}

// dwh [W, G] = hp^T g over K = T*B rows (hp [T*B, W] and g [T*B, G] in T,
// g the rounded gate gradients), f32 partials of `slice_chunks` chunks a
// slice in `part`, added in order into dwh.
template <typename T>
cudaError_t launch_scan_dwh(const void* hp, const void* g, void* dwh,
                            float* part, int slice_chunks, int Tn, int B,
                            int W, int G, cudaStream_t stream) {
  const int K = Tn * B;
  const int chunks = (K + kTile - 1) / kTile;
  if (slice_chunks <= 0) return cudaErrorInvalidValue;
  const int slices = (chunks + slice_chunks - 1) / slice_chunks;
  const int pairs = ((G + kTile - 1) / kTile + 1) / 2;
  const int tiles = (W + kTile - 1) / kTile * pairs;
  constexpr int smem = prod_smem<T>() + kRestartBytes;
  static_assert(smem + 2 * 8 * kProdStagesMax <= kSmemMax,
                "dwh's ring and sums pass a block's shared memory");
  cudaError_t err = set_smem(dwh_wgmma_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dwh_wgmma_kernel<T><<<dim3(tiles, slices), kProdThreads, smem, stream>>>(
      ShiftedRowsT<T>{static_cast<const T*>(hp), W, 0, K},
      ShiftedRowsT<T>{static_cast<const T*>(g), G, 0, K}, part, W, G, K,
      pairs, slice_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)W * G;
  const WgradOuts<T> outs = {{static_cast<T*>(dwh), nullptr, nullptr, nullptr},
                             {0, n, n, n, n}};
  wgrad_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, outs, slices);
  return cudaGetLastError();
}

}  // namespace
