// The VJP of one MS-TCN dilated residual layer, train form with the global
// or the per-video dropout stream, for Hopper (sm_90a); deterministic (no
// atomics).
//
// Replaces: pytorch_video_action_tpu/ops/conv_pallas.py _layer_bwd_kernel
//   (pallas_call at :528, in _layer_bwd_call), launched from
//   ops/conv.py::_layer_train_fused's custom_vjp backward.
//
// Computes, for x, dy [B, T, 64], the layer's weights and the frame mask
// [B, T] (f32), recomputing the forward from x:
//   g = x[t-d] w0 + x[t] w1 + x[t+d] w2 + b_d,  h = relu(g),
//   dout = drop(dy * mask) (the forward's keep bits: idx = b*T*64 + t*64
//   + c with one key a layer, the global stream, or idx = t*64 + c with
//   the key of seeds[b], the per-video stream; kept values scaled by
//   1/keep),
//   dw_p = h^T dout, db_p = sum dout, dg = (g > 0) dout w_p^T,
//   db_d = sum dg, dw0 = x[t-d]^T dg, dw1 = x^T dg, dw2 = x[t+d]^T dg,
//   dx = dy * mask + dg w1^T + dg[t+d] w0^T + dg[t-d] w2^T
// (rows outside [0, T) are 0; d >= T leaves the center tap).  All
// arithmetic is f32; dx is stored in x's dtype, the gradients in f32.
//
// What bounds it on an H100: 22*B*T*64*64 operations with all three taps
// (the recompute, dh, dw_p, three weight taps, three dx taps) -- 1.38
// GFLOP at B=8, T=1920, 20.7 us at f32's 67 TFLOP/s -- against about
// 12 MB of x, dy and dx in f32: operations.
//
// What the design does about it: the TPU computed dx in the same pass,
// since the video sat in VMEM; dx at row t needs dg at rows t +- d, which
// a 64-frame tile does not hold.  So:
//  * conv_bwd_dg_kernel: a grid of at most one block an SM walks the
//    (video, tile) pairs j, j + blocks, ...; each tile recomputes g from
//    its three x slabs, forms dout, dg (written to f32 scratch) and adds
//    its share of dw0, dw1, dw2, dw_p (registers) and db_d, db_p into the
//    block's own partials, written once at the end.
//  * conv_bwd_reduce: sums the blocks' partials in block order.
//  * conv_bwd_dx_kernel: one block a tile, dx from the dg scratch.
// The products are SIMT f32 FMAs (conv_common.cuh); wgmma is later work.

#include "conv_common.cuh"

namespace {

// The partials of one block: dw0, dw1, dw2, dw_p ([64][64] each), db_d,
// db_p; ops/conv.py::GRAD_FLOATS.
constexpr int kGradFloats = 4 * kC * kC + 2 * kC;
// conv_bwd_dg_kernel: w0, w1, w2, wp, the x slabs at t - d, t, t + d,
// relu(g) (then dg) and dout as tiles, and b_d.
constexpr size_t kDgSmemBytes = (9 * kTile + kC) * sizeof(float);
// conv_bwd_dx_kernel: w0, w1, w2 and one dg slab.
constexpr size_t kDxSmemBytes = 4 * kTile * sizeof(float);

struct BwdArgs {
  const void* x;
  const float* mask;
  const void* dy;
  const void* wd;
  const void* bd;
  const void* wp;
  const int* seeds;  // [B] uint32 bits, dropout 2 only
  float* dg;    // [B, T, 64] f32 scratch
  float* part;  // [blocks, kGradFloats] f32 scratch
  void* dx;
  int B, Tn, d;
  uint32_t key, thresh;
  float scale;
  int dropout;  // 0 off, 1 the global stream, 2 the per-video stream
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv_bwd_dg_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* w = smem;  // w0, w1, w2, wp
  float* xl = w + 4 * kTile;
  float* xc = xl + kTile;
  float* xr = xc + kTile;
  float* hs = xr + kTile;
  float* ds = hs + kTile;
  float* bd = ds + kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* wd = static_cast<const T*>(a.wd);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    load_weight(w + k * kTile, wd + (size_t)k * kC * kC);
  load_weight(w + 3 * kTile, static_cast<const T*>(a.wp));
  if (threadIdx.x < kC) bd[threadIdx.x] = ld(static_cast<const T*>(a.bd) +
                                             threadIdx.x);
  const bool side = a.d < a.Tn;
  const int t_tiles = (a.Tn + kRows - 1) / kRows;
  const int tiles = a.B * t_tiles;
  const size_t video = (size_t)a.Tn * kC;
  float dw0[4][4], dw1[4][4], dw2[4][4], dwp[4][4];
  zero_acc(dw0);
  zero_acc(dw1);
  zero_acc(dw2);
  zero_acc(dwp);
  float sbd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float sbp[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / t_tiles;
    const int t0 = (tile % t_tiles) * kRows;
    const T* xb = static_cast<const T*>(a.x) + b * video;
    const T* dyb = static_cast<const T*>(a.dy) + b * video;
    const float* mask_b = a.mask + (size_t)b * a.Tn;
    const bool per_video = a.dropout == 2;
    const uint32_t key =
        per_video ? stream_key((uint32_t)a.seeds[b]) : a.key;
    const uint32_t idx0 =
        per_video ? 0u : (uint32_t)b * (uint32_t)a.Tn * (uint32_t)kC;
    __syncthreads();  // the previous tile's slabs are read
    load_slab(xc, xb, t0, a.Tn);
    if (side) {
      load_slab(xl, xb, t0 - a.d, a.Tn);
      load_slab(xr, xb, t0 + a.d, a.Tn);
    }
    __syncthreads();
    float g[4][4];
    zero_acc(g);
    if (side) tile_ab(xl, w, g);
    tile_ab(xc, w + kTile, g);
    if (side) tile_ab(xr, w + 2 * kTile, g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int t = t0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        g[i][j] += bd[c];
        hs[r * kLd + c] = fmaxf(g[i][j], 0.0f);
        float v = 0.0f;
        if (t < a.Tn) {
          v = to_f(dyb[(size_t)t * kC + c]) * mask_b[t];
          if (a.dropout) {
            const uint32_t idx = idx0 + (uint32_t)t * (uint32_t)kC + c;
            v = fmix32(idx ^ key) < a.thresh ? v * a.scale : 0.0f;
          }
        }
        ds[r * kLd + c] = v;
        sbp[j] += v;
      }
    }
    __syncthreads();
    tile_atb(hs, ds, dwp);
    float dh[4][4];
    zero_acc(dh);
    tile_abt(ds, w + 3 * kTile, dh);
    __syncthreads();  // relu(g) is read: its tile takes dg
    float* dgb = a.dg + b * video;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int t = t0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float v = g[i][j] > 0.0f ? dh[i][j] : 0.0f;
        hs[r * kLd + c] = v;
        sbd[j] += v;
        if (t < a.Tn) dgb[(size_t)t * kC + c] = v;
      }
    }
    __syncthreads();
    tile_atb(xc, hs, dw1);
    if (side) {
      tile_atb(xl, hs, dw0);
      tile_atb(xr, hs, dw2);
    }
  }

  float* p = a.part + (size_t)blockIdx.x * kGradFloats;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = (4 * ty + i) * kC + tx + 16 * j;
      p[at] = dw0[i][j];
      p[kC * kC + at] = dw1[i][j];
      p[2 * kC * kC + at] = dw2[i][j];
      p[3 * kC * kC + at] = dwp[i][j];
    }
  // the bias partials: each column's 16 row-group sums, added in order
  __syncthreads();
  float* red = ds;  // [2][16][64]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[ty * kC + tx + 16 * j] = sbd[j];
    red[16 * kC + ty * kC + tx + 16 * j] = sbp[j];
  }
  __syncthreads();
  if (threadIdx.x < kC) {
    float s_bd = 0.0f, s_bp = 0.0f;
    for (int k = 0; k < 16; ++k) {
      s_bd += red[k * kC + threadIdx.x];
      s_bp += red[16 * kC + k * kC + threadIdx.x];
    }
    p[4 * kC * kC + threadIdx.x] = s_bd;
    p[4 * kC * kC + kC + threadIdx.x] = s_bp;
  }
}

// grads[i] = sum over blocks k = 0, 1, ... of part[k][i], in that order.
__global__ void conv_bwd_reduce(const float* __restrict__ part,
                                float* __restrict__ grads, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kGradFloats) return;
  float s = part[i];
  for (int k = 1; k < blocks; ++k) s += part[(size_t)k * kGradFloats + i];
  grads[i] = s;
}

// grid (T tiles, B): dx of one tile from the dg scratch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bwd_dx_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* w = smem;  // w0, w1, w2
  float* gs = w + 3 * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const T* wd = static_cast<const T*>(a.wd);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    load_weight(w + k * kTile, wd + (size_t)k * kC * kC);
  const size_t off = (size_t)b * a.Tn * kC;
  const float* dgb = a.dg + off;
  float acc[4][4];
  zero_acc(acc);
  load_slab(gs, dgb, t0, a.Tn);
  __syncthreads();
  tile_abt(gs, w + kTile, acc);
  if (a.d < a.Tn) {
    // g[t] read x[t-d] through w0 and x[t+d] through w2, so their
    // cotangents come from dg[t+d] and dg[t-d]
    __syncthreads();
    load_slab(gs, dgb, t0 + a.d, a.Tn);
    __syncthreads();
    tile_abt(gs, w, acc);
    __syncthreads();
    load_slab(gs, dgb, t0 - a.d, a.Tn);
    __syncthreads();
    tile_abt(gs, w + 2 * kTile, acc);
  }
  const T* dyb = static_cast<const T*>(a.dy) + off;
  const float* mask_b = a.mask + (size_t)b * a.Tn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    if (t >= a.Tn) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      acc[i][j] += to_f(dyb[(size_t)t * kC + c]) * mask_b[t];
    }
  }
  store_tile(static_cast<T*>(a.dx) + off, acc, t0, a.Tn);
}

template <typename T>
cudaError_t run(const BwdArgs& a, float* grads, int blocks,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_bwd_dg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDgSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_bwd_dx_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDxSmemBytes);
  if (err != cudaSuccess) return err;
  conv_bwd_dg_kernel<T><<<blocks, kThreads, kDgSmemBytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_bwd_reduce<<<(kGradFloats + 255) / 256, 256, 0, stream>>>(
      a.part, grads, blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_bwd_dx_kernel<T><<<dim3((a.Tn + kRows - 1) / kRows, a.B), kThreads,
                          kDxSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Device pointers of contiguous tensors:
// x, dy, dx [B, T, 64], w_d [3, 64, 64], b_d [64], w_p [64, 64] in dtype;
// mask [B, T] f32; seeds [B] int32 (uint32 bits, dropout 2 only); scratch
// dg [B, T, 64] and part [blocks, 4*64*64 + 128] f32; output grads
// [4*64*64 + 128] f32 = dw0, dw1, dw2, dw_p, db_d, db_p.  1 <= blocks; 1 <=
// d (d >= T takes the center tap); dropout 0 off, 1 with `key` (the
// forward's global stream), 2 with the keys of `seeds` (its per-video
// stream), `thresh` and `scale` as the forward's.  Launch on `stream`;
// return cudaGetLastError() (0 on success).
int conv_layer_bwd(int dtype, const void* x, const float* mask,
                   const void* dy, const void* wd, const void* bd,
                   const void* wp, const int* seeds, float* dg, float* part,
                   void* dx,
                   float* grads, int blocks, int B, int Tn, int d,
                   unsigned int key, unsigned int thresh, float scale,
                   int dropout, void* stream) {
  if (B <= 0 || Tn <= 0 || d <= 0 || blocks <= 0 || !dg || !part || !dx ||
      !grads || dropout < 0 || dropout > 2 || (dropout == 2 && !seeds))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x,  mask, dy, wd,  bd,  wp,     seeds, dg,     part,
                  dx, B,    Tn, d,   key, thresh, scale, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(a, grads, blocks, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(a, grads, blocks, s);
  return (int)cudaErrorInvalidValue;
}

const char* conv_layer_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
