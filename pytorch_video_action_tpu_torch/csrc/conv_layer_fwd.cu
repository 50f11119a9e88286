// One MS-TCN dilated residual layer, forward, for Hopper (sm_90a): the eval
// form, the train form with the global dropout stream, and the per-video
// stream.
//
// Replaces: pytorch_video_action_tpu/ops/conv_pallas.py _kernel
//   (pallas_call at :132, in _fused_call), launched by
//   fused_dilated_residual from ops/conv.py::dilated_residual_layer.
//
// Computes, for x [B, T, 64], w_d [3, 64, 64], w_p [64, 64], b_d, b_p [64]
// and the frame mask [B, T] (f32):
//   y = (x + drop(relu(x[t-d] w0 + x[t] w1 + x[t+d] w2 + b_d) w_p + b_p))
//       * mask
// with rows outside [0, T) read as 0 and d >= T leaving the center tap.
// drop keeps element (b, t, c) when fmix32(idx ^ key) < thresh and scales
// it by 1/keep: idx = b*T*64 + t*64 + c with one key a layer (mode 1, the
// global stream the model trains with), or idx = t*64 + c with the key of
// seeds[b] (mode 2, the TPU kernel's per-video form); mode 0 is the eval
// form.  Products and the tail are f32; y is stored in x's dtype.
//
// What bounds it on an H100: 2*B*T*64*64*(taps + 1) operations -- 503
// MFLOP at B=8, T=1920 with all three taps, 7.5 us at f32's 67 TFLOP/s --
// against 7.9 MB of x and y in f32 (2.3 us): operations.
//
// What the design does about it: one block of 256 threads per 64-frame
// tile of one video; the layer's four 64 x 64 weight matrices sit in
// shared memory beside one input slab, so a tile reads its three shifted
// slabs (the +-d rows straight from device memory, wherever they lie in
// the video) in turn, and relu(g) never leaves the SM.  The products are
// SIMT f32 FMAs, 16 outputs a thread (conv_common.cuh); 100 KB of shared
// memory lets two blocks share an SM.  wgmma and TMA are later work.

#include "conv_common.cuh"

namespace {

struct FwdArgs {
  const void* x;
  const float* mask;
  const void* wd;
  const void* bd;
  const void* wp;
  const void* bp;
  const int* seeds;
  void* y;
  int Tn, d;
  uint32_t key, thresh;
  float scale;
  int mode;
};

// grid (T tiles, B): one tile of one video.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_layer_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const LayerSmem sm = layer_smem(smem);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  load_layer(sm, static_cast<const T*>(a.wd), static_cast<const T*>(a.bd),
             static_cast<const T*>(a.wp), static_cast<const T*>(a.bp));
  Keep kp{a.key, a.thresh, a.scale, a.mode != 0, 0u};
  if (a.mode == 1) kp.idx0 = (uint32_t)b * (uint32_t)a.Tn * (uint32_t)kC;
  if (a.mode == 2) kp.key = stream_key((uint32_t)a.seeds[b]);
  const size_t off = (size_t)b * a.Tn * kC;
  float y[4][4];
  layer_tile(sm, static_cast<const T*>(a.x) + off, a.mask + (size_t)b * a.Tn,
             t0, a.Tn, a.d, kp, y);
  store_tile(static_cast<T*>(a.y) + off, y, t0, a.Tn);
}

template <typename T>
cudaError_t run(const FwdArgs& a, int B, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_layer_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kLayerSmemBytes);
  if (err != cudaSuccess) return err;
  conv_layer_fwd_kernel<T><<<dim3((a.Tn + kRows - 1) / kRows, B), kThreads,
                             kLayerSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Device pointers of contiguous tensors:
// x, y [B, T, 64], w_d [3, 64, 64], b_d [64], w_p [64, 64], b_p [64] in
// dtype; mask [B, T] f32; seeds [B] int32 (uint32 bits, mode 2 only).
// 1 <= d (d >= T takes the center tap).  mode: 0 eval, 1 global stream
// with `key`, 2 per-video stream.  Launch on `stream`; return
// cudaGetLastError() (0 on success).
int conv_layer_fwd(int dtype, const void* x, const float* mask,
                   const void* wd, const void* bd, const void* wp,
                   const void* bp, const int* seeds, void* y, int B, int Tn,
                   int d, unsigned int key, unsigned int thresh, float scale,
                   int mode, void* stream) {
  if (B <= 0 || Tn <= 0 || d <= 0 || mode < 0 || mode > 2 ||
      (mode == 2 && seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{x, mask, wd, bd, wp, bp, seeds, y, Tn, d, key, thresh,
                  scale, mode};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(a, B, s);
  if (dtype == 1) return (int)run<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* conv_layer_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
