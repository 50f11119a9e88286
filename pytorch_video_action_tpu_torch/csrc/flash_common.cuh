// Device code shared by every flash-attention kernel (flash_fwd.cu,
// flash_bwd.cu): the tile height, the masked score, the dropout keep bit
// (hash.cuh's fmix32) and the head layouts.  The tensor-core machinery of
// every form is flash_wgmma.cuh.

#pragma once

#include "dtype.cuh"
#include "hash.cuh"

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // query and key rows per tile
constexpr int kDHead = 512;        // the widest head the kernels take
constexpr float kNegInf = -1e30f;  // finite: exp(s - m) stays exp(0)

// The post-softmax dropout: key = fmix32(seed + GOLDEN), thresh =
// round(keep * 2^32); on == 0 turns it off.
struct Dropout {
  uint32_t key;
  uint32_t thresh;
  float keep;
  int on;
};

// Keep bit of score (bh, q, k): the hash of its index in the virtual
// [B, H, T, T_kv] matrix, ((b*H + h)*T + q)*T_kv + k with uint32 wrap,
// xor the key -- the stream of ops/flash.py::block_keep_mask.
__device__ __forceinline__ bool kept(const Dropout& dr, uint32_t bh,
                                     uint32_t Tn, uint32_t Tkv, uint32_t q,
                                     uint32_t k) {
  return fmix32(((bh * Tn + q) * Tkv + k) ^ dr.key) < dr.thresh;
}

// Where head bh's rows start in q, k, v, out and their gradients, and the
// stride between its rows: [B*H, rows, d] (bthd == 0) or the head-major
// flat [B, rows, H*d] (bthd != 0), whose head h is the column slab
// [h*d, (h+1)*d) of every row.  lse, delta and the dropout index stay
// [B*H, T]-indexed in both.
__device__ __forceinline__ size_t head_base(int bthd, int bh, int H, int rows,
                                            int d) {
  return bthd ? ((size_t)(bh / H) * rows * H + bh % H) * d
              : (size_t)bh * rows * d;
}
__device__ __forceinline__ int row_stride(int bthd, int H, int d) {
  return bthd ? H * d : d;
}

}  // namespace
