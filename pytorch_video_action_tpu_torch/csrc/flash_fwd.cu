// Flash-attention forward for Hopper (sm_90a): online softmax over key
// tiles with a key mask and post-softmax hash dropout; out and f32 lse.
//
// Replaces: pytorch_video_action_tpu/ops/flash_pallas.py _fwd_kernel,
//   launched by flash_fwd_pallas (the pallas_call at :297), which
//   ops/flash.py::flash_self_attention reaches for padded T >= 1024; and
//   its bthd=True form (flash_fwd_bthd), which
//   ops/flash.py::flash_self_attention_bthd reaches under PVA_FLASH_BTHD=1.
//
// Computes, for each (b, h) of q [B*H, T, d] (pre-scaled by 1/sqrt(d)),
// k and v [B*H, T_kv, d], mask [B, T_kv] (1 = attendable):
//   s = q k^T, -1e30 where the key is masked;  m, l: running max and
//   dropout-free sum of exp(s - m);  acc = sum exp(s - m) * keep / keep_p v
//   out = acc / l and lse = m + log l on rows with a valid key, else 0.
// The keep bit of score (bh, q, k) is the fmix32 hash of its index in the
// virtual [B, H, T, T_kv] matrix (flash_common.cuh::kept), so any tiling
// draws the same mask as ops/flash.py::block_keep_mask and the backward.
// Operands are f32 or bf16, converted exactly to f32; m, l, acc and lse
// are f32; the dropped p is rounded to the input dtype before p v; out is
// stored in the input dtype.
//
// What bounds it on an H100: 4*B*H*T*T_kv*d operations -- 107 GFLOP at the
// bench shape (B=4, H=4, T=4096, d=100), 1.6 ms at f32's 67 TFLOP/s --
// against 33 MB of q, k, v, out and lse (10 us at 3.35 TB/s): operations.
// In bf16 the tensor cores would take it to 0.11 ms; this kernel does not
// use them.
//
// What the design does about it:
//  * One block per (64-query tile, b*h): the grid has ceil(T/64)*B*H
//    blocks (1024 at the bench shape), so every SM has work.
//  * The [64, 64] score tile, m, l and the [64, d] accumulator never leave
//    the SM: the work is O(T * T_kv) products and O(T * d) bytes.
//  * SIMT f32 FMAs on tiles in shared memory: each thread computes 4 x 4
//    scores and 4 x 8 outputs, so a shared-memory load feeds 2 to 4 FMAs.
//  * A head wider than 128 (attn with 2 heads, d = 200, or 1, d = 400)
//    is walked in slabs of 128 columns: q k^T sums over the slabs, and
//    each output slab is a pass of its own over the key tiles, which
//    recomputes q k^T (ns + 1 products' work for ns slabs instead of 2).
//    The tiles, registers and shared memory stay those of d <= 128.
//  * The head-major flat layout [B, T, H*d] differs only in where a head's
//    rows start and their stride (flash_common.cuh::head_base); the
//    arithmetic and its order are the same.
//    wgmma, TMA and double-buffered tiles are later work.

#include "flash_common.cuh"

namespace {

constexpr size_t kFwdSmemBytes =
    sizeof(float) * (3 * kTile * kLd + kTile * kLdp);

// One block an SM: kFwdSmemBytes (113 KB) leaves no room for a second, so
// a thread may take up to 255 registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v,
                 const unsigned char* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Tn, int Tkv, int d,
                 Dropout dr, int bthd) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;
  float* p_s = v_s + kTile * kLd;
  __shared__ int key_valid[kTile];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int ld = row_stride(bthd, H, d);
  const T* qb = q + head_base(bthd, bh, H, Tn, d);
  const T* kb = k + head_base(bthd, bh, H, Tkv, d);
  const T* vb = v + head_base(bthd, bh, H, Tkv, d);
  const unsigned char* mask_b = mask + (size_t)(bh / H) * Tkv;

  // one pass per output slab of d; a head of one slab keeps its q tile
  const int ns = n_slabs(d);
  if (ns == 1) load_tile(q_s, qb, q0, Tn, ld, 0, d);
  for (int o = 0; o < ns; ++o) {
    const int oc = o * kDMax;
    float m[4], l[4], acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNegInf;
      l[i] = 0.0f;
    }
    zero_acc(acc);

    for (int k0 = 0; k0 < Tkv; k0 += kTile) {
      __syncthreads();  // the previous tile's k_s, v_s and p_s are read
      load_tile(v_s, vb, k0, Tkv, ld, oc, slab_width(d, o));
      load_key_valid(key_valid, mask_b, k0, Tkv);
      float s[4][4];
      zero_scores(s);
      for (int e = 0; e < ns; ++e) {  // s = q k^T over every slab
        const int w = slab_width(d, e);
        if (ns > 1) {
          if (e > 0) __syncthreads();  // the previous slab is read
          load_tile(q_s, qb, q0, Tn, ld, e * kDMax, w);
        }
        load_tile(k_s, kb, k0, Tkv, ld, e * kDMax, w);
        __syncthreads();
        tile_abt(q_s, k_s, w, s);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!key_valid[tx + 16 * j]) s[i][j] = kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        const int r = 4 * ty + i;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float p = expf(s[i][j] - m_new);
          sum += p;
          if (dr.on)
            p = kept(dr, bh, Tn, Tkv, q0 + r, k0 + c) ? p / dr.keep : 0.0f;
          p_s[r * kLdp + c] = rnd<T>(p);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
      }
      __syncthreads();  // p_s is complete
      tile_pb(p_s, v_s, acc);
    }

    // rows with no valid key (bucket padding): zero output, zero lse; every
    // pass computes the same m and l
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool valid = m[i] > kNegInf / 2;
      const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = valid ? acc[i][j] / l_safe : 0.0f;
      const int r = q0 + 4 * ty + i;
      if (o == 0 && tx == 0 && r < Tn)
        lse[(size_t)bh * Tn + r] = valid ? m[i] + logf(l_safe) : 0.0f;
    }
    store_acc(out + head_base(bthd, bh, H, Tn, d), acc, q0, Tn, ld, oc,
              slab_width(d, o));
  }
}

template <typename T>
cudaError_t run_fwd(const void* q, const void* k, const void* v,
                    const unsigned char* mask, void* out, float* lse, int BH,
                    int H, int Tn, int Tkv, int d, Dropout dr, int bthd,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + kTile - 1) / kTile, BH);
  flash_fwd_kernel<T><<<grid, kThreads, kFwdSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, H, Tn, Tkv,
      d, dr, bthd);
  return cudaGetLastError();
}

// Checks the arguments and launches in the layout bthd selects.
int fwd_entry(int dtype, const void* q, const void* k, const void* v,
              const unsigned char* mask, void* out, float* lse, int BH, int H,
              int Tn, int Tkv, int d, unsigned int key, unsigned int thresh,
              float keep, int dropout, int bthd, void* stream) {
  if (BH <= 0 || H <= 0 || BH % H || Tn <= 0 || Tkv <= 0 || d <= 0 ||
      n_slabs(d) > kMaxSlabs || (dropout && !(keep > 0.0f)))
    return (int)cudaErrorInvalidValue;
  const Dropout dr{key, thresh, keep, dropout != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_fwd<float>(q, k, v, mask, out, lse, BH, H, Tn, Tkv, d,
                               dr, bthd, s);
  if (dtype == 1)
    return (int)run_fwd<__nv_bfloat16>(q, k, v, mask, out, lse, BH, H, Tn,
                                       Tkv, d, dr, bthd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Device pointers of contiguous tensors:
// q, out [BH, T, d]; k, v [BH, T_kv, d]; mask [BH / H, T_kv] bytes (1 =
// attendable); lse [BH, T] f32.  d in 1..512.  dropout != 0 turns the
// post-softmax dropout on with the stream key `key`, keep threshold
// `thresh` and keep probability `keep`.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int flash_fwd(int dtype, const void* q, const void* k, const void* v,
              const unsigned char* mask, void* out, float* lse, int BH, int H,
              int Tn, int Tkv, int d, unsigned int key, unsigned int thresh,
              float keep, int dropout, void* stream) {
  return fwd_entry(dtype, q, k, v, mask, out, lse, BH, H, Tn, Tkv, d, key,
                   thresh, keep, dropout, 0, stream);
}

// The head-major form (flash_pallas.py _fwd_kernel with bthd=True): q, out
// [BH / H, T, H*d] and k, v [BH / H, T_kv, H*d], head h the column slab
// [h*d, (h+1)*d); lse [BH, T] and the rest as flash_fwd's.
int flash_fwd_bthd(int dtype, const void* q, const void* k, const void* v,
                   const unsigned char* mask, void* out, float* lse, int BH,
                   int H, int Tn, int Tkv, int d, unsigned int key,
                   unsigned int thresh, float keep, int dropout,
                   void* stream) {
  return fwd_entry(dtype, q, k, v, mask, out, lse, BH, H, Tn, Tkv, d, key,
                   thresh, keep, dropout, 1, stream);
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
