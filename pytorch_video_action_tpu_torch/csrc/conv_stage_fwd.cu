// All dilated residual layers of one MS-TCN stage in one launch, for Hopper
// (sm_90a).
//
// Replaces: pytorch_video_action_tpu/ops/conv_pallas.py _stage_kernel
//   (pallas_call at :305, in _stage_call), launched by fused_stage from
//   models/mstcn.py::_apply_stage in eval.
//
// Computes, for x [B, T, 64], stacked weights w_d [L, 3, 64, 64], b_d
// [L, 64], w_p [L, 64, 64], b_p [L, 64] and the frame mask [B, T] (f32):
// layer i of conv_layer_fwd.cu at dilation min(2^i, T), i = 0 .. L-1, each
// on the previous one's output, with the per-video dropout stream when
// `dropout` is set (key of seeds[b*L + i], idx = t*64 + c).  The residual
// is carried in f32 from layer to layer and rounded to x's dtype once, at
// the end (conv_pallas.py:250,284).
//
// What bounds it on an H100: the layers' products, 2*B*T*64*64*(taps + 1)
// each -- about 1.95 GFLOP at B=3, T=1280, where 11 of the 20 layers have
// three taps and 9 (d >= T) the center alone: 29 us at f32's 67 TFLOP/s --
// against x and y once (2 MB): operations.
//
// What the design does about it: the TPU kept a video's whole [T, 64]
// activation in VMEM for all layers; an SM's 227 KB hold about 440 f32
// frames, and layer i+1 at frame t reads layer i's output at t +- 2^(i+1),
// anywhere in the video.  So one cooperative launch walks all layers: its
// blocks (no more than can be resident at once) take the (video, 64-frame
// tile) pairs in turn, write the layer's f32 output into one of two device
// buffers, and meet at a grid-wide barrier before the next layer reads
// it.  At B=8, T=2560 a buffer is 5 MB, so both stay in the 50 MB L2.
// Each layer's four weight matrices are loaded into shared memory once a
// block.  The products are SIMT f32 FMAs (conv_common.cuh).  A refused
// cooperative launch is returned, not worked round; a thread-block cluster
// holding a video in distributed shared memory is later work.

#include <cooperative_groups.h>

#include "conv_common.cuh"

namespace cg = cooperative_groups;

namespace {

struct StageArgs {
  const void* x;
  const float* mask;
  const void* wd;
  const void* bd;
  const void* wp;
  const void* bp;
  const int* seeds;
  float* buf;  // [2, B, T, 64] f32: the layers' outputs, in turn
  void* y;
  int B, Tn, L;
  uint32_t thresh;
  float scale;
  int dropout;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_stage_kernel(StageArgs a) {
  extern __shared__ float smem[];
  const LayerSmem sm = layer_smem(smem);
  cg::grid_group grid = cg::this_grid();
  const int t_tiles = (a.Tn + kRows - 1) / kRows;
  const int tiles = a.B * t_tiles;
  const size_t video = (size_t)a.Tn * kC;
  const size_t whole = (size_t)a.B * video;
  const T* wd = static_cast<const T*>(a.wd);
  const T* bd = static_cast<const T*>(a.bd);
  const T* wp = static_cast<const T*>(a.wp);
  const T* bp = static_cast<const T*>(a.bp);
  for (int l = 0; l < a.L; ++l) {
    const int d = (l >= 30 || (1 << l) >= a.Tn) ? a.Tn : (1 << l);
    load_layer(sm, wd + (size_t)l * 3 * kC * kC, bd + (size_t)l * kC,
               wp + (size_t)l * kC * kC, bp + (size_t)l * kC);
    const float* in = a.buf + (size_t)((l + 1) & 1) * whole;
    float* out = a.buf + (size_t)(l & 1) * whole;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b = tile / t_tiles;
      const int t0 = (tile % t_tiles) * kRows;
      Keep kp{0u, a.thresh, a.scale, a.dropout, 0u};
      if (a.dropout) kp.key = stream_key((uint32_t)a.seeds[b * a.L + l]);
      const float* mask_b = a.mask + (size_t)b * a.Tn;
      float y[4][4];
      if (l == 0)
        layer_tile(sm, static_cast<const T*>(a.x) + b * video, mask_b, t0,
                   a.Tn, d, kp, y);
      else
        layer_tile(sm, in + b * video, mask_b, t0, a.Tn, d, kp, y);
      if (l + 1 == a.L)
        store_tile(static_cast<T*>(a.y) + b * video, y, t0, a.Tn);
      else
        store_tile(out + b * video, y, t0, a.Tn);
    }
    if (l + 1 < a.L) grid.sync();  // the layer's output is whole
  }
}

template <typename T>
cudaError_t run(const StageArgs& a, cudaStream_t stream) {
  auto kernel = conv_stage_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kLayerSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, kLayerSmemBytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int tiles = a.B * ((a.Tn + kRows - 1) / kRows);
  const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  void* args[] = {const_cast<StageArgs*>(&a)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(kThreads), args,
                                    kLayerSmemBytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Device pointers of contiguous tensors:
// x, y [B, T, 64], w_d [L, 3, 64, 64], b_d [L, 64], w_p [L, 64, 64], b_p
// [L, 64] in dtype; mask [B, T] f32; seeds [B, L] int32 (uint32 bits, with
// dropout only); buf f32 scratch of 2*B*T*64 (B*T*64 when L == 1).  Launch
// on `stream`; return the launch's error (0 on success).
int conv_stage_fwd(int dtype, const void* x, const float* mask,
                   const void* wd, const void* bd, const void* wp,
                   const void* bp, const int* seeds, float* buf, void* y,
                   int B, int Tn, int L, unsigned int thresh, float scale,
                   int dropout, void* stream) {
  if (B <= 0 || Tn <= 0 || L <= 0 || buf == nullptr ||
      (dropout && seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  const StageArgs a{x,  mask, wd, bd, wp,     bp,    seeds,  buf,
                    y,  B,    Tn, L,  thresh, scale, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(a, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

const char* conv_stage_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
