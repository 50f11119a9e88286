// Device code shared by MS-TCN's conv kernels (conv_layer_fwd.cu,
// conv_layer_bwd.cu, conv_stage_fwd.cu) for Hopper (sm_90a): the tile
// geometry, slab and weight loads into shared memory, the SIMT tile
// products, and one dilated residual layer over one tile.
//
// C = 64 feature maps.  A tile is 64 frames of one video.  A block has 256
// threads; thread (ty, tx) = (tid / 16, tid % 16) owns rows 4ty..4ty+3 and
// columns tx + 16j (j < 4) of a 64 x 64 result.  Operands sit in shared
// memory as f32 [64][65] (a bf16 value converts exactly): with the odd row
// stride, the 16 lanes of a half-warp reading one column of a [64][65]
// tile at rows 16 apart, or the two half-warps reading rows 4 apart, hit
// distinct banks.

#pragma once

#include "dtype.cuh"
#include "hash.cuh"

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;       // feature maps
constexpr int kRows = 64;    // frames per tile
constexpr int kLd = kC + 1;  // row stride of a tile in shared memory
constexpr int kTile = kRows * kLd;  // floats of one tile
constexpr int kThreads = 256;

// Loads through L2 only (ld.global.cg): the stage kernel reads rows that
// other blocks wrote earlier in the same launch, which L1 may hold stale.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Rows [r0, r0 + 64) of one video's [T, 64] matrix into a tile; rows
// outside [0, T) read 0 (the 'same' padding).  Rows inside [0, T) are read
// as they are, padded frames included.
template <typename T>
__device__ __forceinline__ void load_slab(float* dst, const T* src, int r0,
                                          int Tn) {
  for (int i = threadIdx.x; i < kRows * kC; i += kThreads) {
    const int r = i / kC;
    const int c = i % kC;
    const int t = r0 + r;
    dst[r * kLd + c] =
        (t >= 0 && t < Tn) ? ld(src + (size_t)t * kC + c) : 0.0f;
  }
}

// A row-major [64][64] weight matrix into a tile.
template <typename T>
__device__ __forceinline__ void load_weight(float* dst, const T* src) {
  for (int i = threadIdx.x; i < kC * kC; i += kThreads)
    dst[(i / kC) * kLd + i % kC] = ld(src + i);
}

__device__ __forceinline__ void zero_acc(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// acc[i][j] += sum_k a[4ty + i][k] * b[k][tx + 16j]: A B.
__device__ __forceinline__ void tile_ab(const float* a, const float* b,
                                        float acc[4][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* ar = a + 4 * ty * kLd;
#pragma unroll 8
  for (int k = 0; k < kC; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ar[i * kLd + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k a[4ty + i][k] * b[tx + 16j][k]: A B^T.
__device__ __forceinline__ void tile_abt(const float* a, const float* b,
                                         float acc[4][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* ar = a + 4 * ty * kLd;
  const float* br = b + tx * kLd;
#pragma unroll 8
  for (int k = 0; k < kC; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ar[i * kLd + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = br[16 * j * kLd + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r a[r][4ty + i] * b[r][tx + 16j] over the 64 rows:
// A^T B, a weight gradient's share of one tile.
__device__ __forceinline__ void tile_atb(const float* a, const float* b,
                                         float acc[4][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll 8
  for (int r = 0; r < kRows; ++r) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[r * kLd + 4 * ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[r * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// A thread's slots of a [T, 64] result at rows [t0, t0 + 64), in T.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const float y[4][4],
                                           int t0, int Tn) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[(size_t)t * kC + tx + 16 * j] = from_f<T>(y[i][j]);
  }
}

// ------------------------------------------------------- one layer, forward

// The dropout of one layer over one video: element (t, c) draws idx0 +
// t*64 + c (uint32 wrap); idx0 = b*T*64 in the global stream, 0 in the
// per-video one, whose key comes from the video's own seed.
struct Keep {
  uint32_t key;
  uint32_t thresh;
  float scale;  // 1 / keep
  int on;
  uint32_t idx0;
};

// Shared memory of the forward: w0, w1, w2, wp as tiles, then b_d and b_p,
// the input slab and relu(g).
constexpr size_t kLayerSmemBytes = (6 * kTile + 2 * kC) * sizeof(float);

struct LayerSmem {
  float* w;
  float* bias;
  float* xs;
  float* hs;
};

__device__ __forceinline__ LayerSmem layer_smem(float* s) {
  return {s, s + 4 * kTile, s + 4 * kTile + 2 * kC,
          s + 5 * kTile + 2 * kC};
}

// A layer's weights (w_d [3, 64, 64], w_p [64, 64], b_d, b_p) into shared
// memory; visible to the block after its next barrier.
template <typename T>
__device__ __forceinline__ void load_layer(const LayerSmem& sm, const T* wd,
                                           const T* bd, const T* wp,
                                           const T* bp) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    load_weight(sm.w + k * kTile, wd + (size_t)k * kC * kC);
  load_weight(sm.w + 3 * kTile, wp);
  if (threadIdx.x < kC) {
    sm.bias[threadIdx.x] = ld(bd + threadIdx.x);
    sm.bias[kC + threadIdx.x] = ld(bp + threadIdx.x);
  }
}

// One dilated residual layer over rows [t0, t0 + 64) of one video's [T,
// 64] input `src`, with the layer in `sm`: y = (x + drop(relu(x[t-d] w0 +
// x[t] w1 + x[t+d] w2 + b_d) wp + b_p)) * mask, in f32, the thread's
// slots.  d >= T takes the center tap alone.  Starts and ends with the
// block reading shared memory it wrote after a barrier, so tiles and
// layers may follow one another.
template <typename T>
__device__ __forceinline__ void layer_tile(const LayerSmem& sm, const T* src,
                                           const float* mask_b, int t0,
                                           int Tn, int d, const Keep& kp,
                                           float y[4][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float g[4][4];
  zero_acc(g);
  if (d < Tn) {
    __syncthreads();
    load_slab(sm.xs, src, t0 - d, Tn);
    __syncthreads();
    tile_ab(sm.xs, sm.w, g);
    __syncthreads();
    load_slab(sm.xs, src, t0 + d, Tn);
    __syncthreads();
    tile_ab(sm.xs, sm.w + 2 * kTile, g);
  }
  __syncthreads();
  load_slab(sm.xs, src, t0, Tn);  // the center rows, kept for the residual
  __syncthreads();
  tile_ab(sm.xs, sm.w + kTile, g);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      sm.hs[(4 * ty + i) * kLd + c] = fmaxf(g[i][j] + sm.bias[c], 0.0f);
    }
  __syncthreads();
  float o[4][4];
  zero_acc(o);
  tile_ab(sm.hs, sm.w + 3 * kTile, o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int t = t0 + r;
    const float m = t < Tn ? mask_b[t] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float v = o[i][j] + sm.bias[kC + c];
      if (kp.on) {
        const uint32_t idx = kp.idx0 + (uint32_t)t * (uint32_t)kC + c;
        v = fmix32(idx ^ kp.key) < kp.thresh ? v * kp.scale : 0.0f;
      }
      y[i][j] = (sm.xs[r * kLd + c] + v) * m;
    }
  }
}

}  // namespace
