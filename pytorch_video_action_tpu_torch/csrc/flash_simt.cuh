// The SIMT tiles of the split flash backward (flash_bwd.cu's
// flash_bwd_dkdv_kernel and flash_bwd_dq_kernel): tile loads, the f32 FMA
// tile products and the backward's score step (the masked score tile and
// the exp(s - lse) recompute).
//
// Tiles are 64 query rows by 64 key rows by a slab of at most 128 of the
// head's d columns; a wider head is walked in slabs (at most kMaxSlabs):
// the score products sum over every slab, and each output slab is a pass
// of its own.  A block has
// 256 threads, thread (ty, tx) = (tid / 16, tid % 16); in a 64 x 64 score
// tile it owns rows 4ty..4ty+3 and columns tx + 16j (j < 4), in a 64 x d
// output tile rows 4ty..4ty+3 and columns tx + 16j (j < 8).  The 16
// threads of one ty are 16 lanes of one warp, so a row's max and sum are
// 4 register values and a 16-lane butterfly.  Operand tiles sit in shared
// memory as f32 (a bf16 operand converts exactly), rows padded to an odd
// stride: the 16 lanes that read 16 rows at one column hit 16 banks.

#pragma once

#include "flash_common.cuh"

namespace {

constexpr int kDMax = 128;       // the widest slab of d
constexpr int kMaxSlabs = kDHead / kDMax;
constexpr int kLd = kDMax + 1;   // row stride of a [64, slab] tile
constexpr int kLdp = kTile + 1;  // row stride of a [64, 64] tile
constexpr int kThreads = 256;

// Slabs of a head of width d, and slab e's first column and width.
__host__ __device__ __forceinline__ int n_slabs(int d) {
  return (d + kDMax - 1) / kDMax;
}
__device__ __forceinline__ int slab_width(int d, int e) {
  return min(kDMax, d - e * kDMax);
}

// Rows [r0, r0 + 64), columns [c0, c0 + w) of a row-major [rows, ld]
// matrix into a [64][kLd] f32 tile, zero past `rows` and in columns
// [w, kDMax).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int r0,
                                          int rows, int ld, int c0, int w) {
  for (int i = threadIdx.x; i < kTile * kDMax; i += kThreads) {
    const int r = i / kDMax;
    const int c = i % kDMax;
    float v = 0.0f;
    if (r0 + r < rows && c < w)
      v = to_f(src[(size_t)(r0 + r) * ld + c0 + c]);
    dst[r * kLd + c] = v;
  }
}

// Entries [r0, r0 + 64) of a length-`rows` f32 vector, zero past `rows`.
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int rows) {
  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    dst[threadIdx.x] = r < rows ? src[r] : 0.0f;
  }
}

// Whether key k0 + i is attendable: in range and unmasked.
__device__ __forceinline__ void load_key_valid(
    int* dst, const unsigned char* __restrict__ mask_b, int k0, int Tkv) {
  if (threadIdx.x < kTile) {
    const int k = k0 + threadIdx.x;
    dst[threadIdx.x] = (k < Tkv && mask_b[k]) ? 1 : 0;
  }
}

__device__ __forceinline__ void zero_scores(float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
}

// s[i][j] += sum_e a[4ty + i][e] * b[tx + 16j][e] over e < d: a row tile
// times a row tile transposed (q k^T, dout v^T), one slab of d.
__device__ __forceinline__ void tile_abt(const float* a, const float* b,
                                         int d, float s[4][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* ar = a + 4 * ty * kLd;
  const float* br = b + tx * kLd;
#pragma unroll 4
  for (int e = 0; e < d; ++e) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ar[i * kLd + e];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = br[16 * j * kLd + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_k p[4ty + i][k] * b[k][tx + 16j] over the 64 keys: a
// score tile times a row tile (p v, ds k).
__device__ __forceinline__ void tile_pb(const float* p, const float* b,
                                        float acc[4][8]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* pr = p + 4 * ty * kLdp;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float pv[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = pr[i * kLdp + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = b[k * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_q p[q][4ty + i] * b[q][tx + 16j] over the 64 queries: a
// score tile transposed times a row tile (p^T dout, ds^T q).
__device__ __forceinline__ void tile_ptb(const float* p, const float* b,
                                         float acc[4][8]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll 4
  for (int q = 0; q < kTile; ++q) {
    float pv[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[q * kLdp + 4 * ty + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = b[q * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero_acc(float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// Rows [r0, r0 + 64), columns [c0, c0 + w) of a [rows, ld] output from
// this thread's accumulator slots, rows past `rows` and columns past w
// left alone.
template <typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ dst,
                                          float acc[4][8], int r0,
                                          int rows, int ld, int c0, int w) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < w) dst[(size_t)r * ld + c0 + c] = from_f<T>(acc[i][j]);
    }
  }
}

// Shared memory of a backward block: the four operand tiles, the two score
// tiles, and the query tile's lse and delta.
struct BwdSmem {
  float* q;
  float* dout;
  float* k;
  float* v;
  float* p;   // the dropped probabilities, rounded to T (for dv)
  float* ds;  // p (g - delta), rounded to T (for dq and dk)
  float* lse;
  float* delta;
};

constexpr size_t kBwdSmemBytes =
    sizeof(float) * (4 * kTile * kLd + 2 * kTile * kLdp + 2 * kTile);

__device__ __forceinline__ BwdSmem bwd_smem(float* base) {
  BwdSmem s;
  s.q = base;
  s.dout = s.q + kTile * kLd;
  s.k = s.dout + kTile * kLd;
  s.v = s.k + kTile * kLd;
  s.p = s.v + kTile * kLd;
  s.ds = s.p + kTile * kLdp;
  s.lse = s.ds + kTile * kLdp;
  s.delta = s.lse + kTile;
  return s;
}

// The score step of the backward for the query tile at q0 and the key tile
// at k0, from s = q k^T and g = dout v^T summed over every slab of d (lse,
// delta and key_valid already in shared memory):
//   s masked to -1e30, p = exp(s - lse) (0 on query rows past T);
//   with dropout, p_drop = p * m and g *= m, m = kept / keep;
//   ds = p (g - delta) with the undropped p.
// Writes p_drop and ds, each rounded to T, into sm.p and sm.ds.  The
// caller synchronises before and after.
template <typename T>
__device__ __forceinline__ void bwd_probs(const BwdSmem& sm,
                                          const int* key_valid, int q0,
                                          int k0, int Tn, int Tkv,
                                          uint32_t bh, const Dropout& dr,
                                          const float s[4][4],
                                          const float g[4][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float inv_keep = 1.0f / dr.keep;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const bool q_in = q0 + r < Tn;
    const float lse = sm.lse[r];
    const float delta = sm.delta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float sv = key_valid[c] ? s[i][j] : kNegInf;
      const float p = q_in ? expf(sv - lse) : 0.0f;
      float gv = g[i][j];
      float p_drop = p;
      if (dr.on) {
        const float m = kept(dr, bh, Tn, Tkv, q0 + r, k0 + c) ? inv_keep
                                                              : 0.0f;
        p_drop = p * m;
        gv = gv * m;
      }
      sm.p[r * kLdp + c] = rnd<T>(p_drop);
      sm.ds[r * kLdp + c] = rnd<T>(p * (gv - delta));
    }
  }
}

}  // namespace
