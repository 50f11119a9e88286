// Flash-attention backward for Hopper (sm_90a): the fused single-pass form
// and the two-kernel split, both deterministic (no atomics).
//
// Replaces: pytorch_video_action_tpu/ops/flash_pallas.py
//   _bwd_fused_kernel (pallas_call at :487, in _bwd_fused_call), and the
//   split's _dkdv_kernel (:643) and _dq_kernel (:682), all launched by
//   flash_bwd_pallas from ops/flash.py's custom_vjp backward; and the fused
//   kernel's bthd=True form (flash_bwd_fused_bthd), from
//   flash_self_attention_bthd's.  The split takes [B*H, T, d] only: under
//   bthd the caller transposes around it (flash_pallas.py:594-610).
//
// Computes, for q, dout [B*H, T, d], k, v [B*H, T_kv, d], mask [B, T_kv],
// lse and delta = sum(dout * out) [B*H, T] f32:
//   s = q k^T masked to -1e30, p = exp(s - lse), g = dout v^T,
//   with dropout p_drop = p * m, g *= m (m = keep bit / keep, the stream of
//   the forward), ds = p (g - delta) with the undropped p;
//   dv = p_drop^T dout, dk = ds^T q, dq = ds k.
// Query rows past T add nothing (bounds, where the TPU forced lse = +1e30).
// p_drop and ds are rounded to the input dtype before their products; the
// sums are f32; dq is stored f32, dk and dv in the input dtype.
//
// What bounds it on an H100: 10*B*H*T*T_kv*d operations in every form (the
// five products, counted once) -- 268 GFLOP at the bench shape (B=4, H=4,
// T=4096, d=100), 4.0 ms at f32's 67 TFLOP/s -- against about 60 MB of
// operands and gradients: operations.
//
// What the design does about it:
//  * fused (flash_bwd_fused_kernel): the score step -- s, p, g, the mask
//    -- runs once per element for all three gradients.  The TPU form keeps
//    every query of a (b, h) on chip and carries dq across sequential grid
//    steps; an SM holds neither, and blocks run in no order.  So a (b, h)
//    is walked by one block per chunk of its key tiles: for each key tile
//    the block keeps dk and dv in registers and loops over the query tiles,
//    adding each tile's ds k into its own f32 partial dq in device memory,
//    in a fixed order, touched by no other block.  flash_bwd_dq_reduce
//    sums the chunks' partials in chunk order (one chunk writes dq
//    itself).  Chunks = min(key tiles, SMs / (B*H)), chosen by the caller
//    (ops/flash.py::fused_chunks), so B*H*chunks blocks fill the SMs once;
//    with B*H >= SMs each (b, h) is one block.
//  * split (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel, each its own entry
//    point): one block per (key tile, b*h) walks the query tiles for dk
//    and dv; one block per (query tile, b*h) walks the key tiles for dq.
//    Twice the score step, no scratch; ops/flash.py::use_fused picks it
//    for videos whose fused scratch would pass its budget.
//  * The products are SIMT f32 FMAs on 64 x 64 tiles in shared memory
//    (flash_common.cuh).  A head wider than 128 is walked in slabs of 128
//    columns: the score step sums q k^T and dout v^T over the slabs, and
//    each output slab of dk, dv and dq is a pass of its own, recomputing
//    the score step (for ns slabs, 2 ns + 3 products' work instead of 5).
//  * The head-major flat layout [B, T, H*d] differs only in where a head's
//    rows start and their stride (BwdArgs::bthd, flash_common.cuh::
//    head_base); a chunk's partial dq takes dq's layout, so the reduction
//    is the same elementwise sum.
//    wgmma and TMA are later work.

#include "flash_common.cuh"

namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;
  const float* lse;
  const float* delta;
  const void* dout;
  float* dq;
  void* dk;
  void* dv;
  int H, Tn, Tkv, d;
  Dropout dr;
  int bthd;  // the head-major flat layout (flash_common.cuh::head_base)
};

// Where head bh's query rows (q, dout, dq) and key rows (k, v, dk, dv)
// start, and the stride between rows.
__device__ __forceinline__ size_t q_base(const BwdArgs& a, int bh) {
  return head_base(a.bthd, bh, a.H, a.Tn, a.d);
}
__device__ __forceinline__ size_t kv_base(const BwdArgs& a, int bh) {
  return head_base(a.bthd, bh, a.H, a.Tkv, a.d);
}
__device__ __forceinline__ int ld(const BwdArgs& a) {
  return row_stride(a.bthd, a.H, a.d);
}

// The query tile at q0 of (b, h): lse and delta and, for a head of one
// slab, q and dout into shared memory.
template <typename T>
__device__ __forceinline__ void load_query_tile(const BwdSmem& sm,
                                                const BwdArgs& a, int bh,
                                                int q0) {
  if (n_slabs(a.d) == 1) {
    const size_t off = q_base(a, bh);
    load_tile(sm.q, static_cast<const T*>(a.q) + off, q0, a.Tn, ld(a), 0,
              a.d);
    load_tile(sm.dout, static_cast<const T*>(a.dout) + off, q0, a.Tn, ld(a),
              0, a.d);
  }
  load_rows(sm.lse, a.lse + (size_t)bh * a.Tn, q0, a.Tn);
  load_rows(sm.delta, a.delta + (size_t)bh * a.Tn, q0, a.Tn);
}

// The key tile at k0 of (b, h): the keys' validity and, for a head of one
// slab, k and v.
template <typename T>
__device__ __forceinline__ void load_key_tile(const BwdSmem& sm,
                                              int* key_valid,
                                              const BwdArgs& a, int bh,
                                              int k0) {
  if (n_slabs(a.d) == 1) {
    const size_t off = kv_base(a, bh);
    load_tile(sm.k, static_cast<const T*>(a.k) + off, k0, a.Tkv, ld(a), 0,
              a.d);
    load_tile(sm.v, static_cast<const T*>(a.v) + off, k0, a.Tkv, ld(a), 0,
              a.d);
  }
  load_key_valid(key_valid, a.mask + (size_t)(bh / a.H) * a.Tkv, k0, a.Tkv);
}

// The score step (flash_common.cuh::bwd_probs) of query tile q0 and key
// tile k0 for output slab o.  A head of one slab has its tiles in shared
// memory already; a wider head loads q, dout, k and v slab by slab, summing
// q k^T and dout v^T, and ends with slab o in shared memory for the
// products that follow.  The caller synchronises before and after.
template <typename T>
__device__ __forceinline__ void score_step(const BwdSmem& sm,
                                           const int* key_valid,
                                           const BwdArgs& a, int bh, int q0,
                                           int k0, int o) {
  const int ns = n_slabs(a.d);
  float s[4][4], g[4][4];
  zero_scores(s);
  zero_scores(g);
  const size_t q_off = q_base(a, bh);
  const size_t kv_off = kv_base(a, bh);
  const int lda = ld(a);
  for (int i = 0; i < ns; ++i) {
    const int e = (o + 1 + i) % ns;
    const int w = slab_width(a.d, e);
    if (ns > 1) {
      const int c0 = e * kDMax;
      __syncthreads();  // the previous slab is read
      load_tile(sm.q, static_cast<const T*>(a.q) + q_off, q0, a.Tn, lda, c0,
                w);
      load_tile(sm.dout, static_cast<const T*>(a.dout) + q_off, q0, a.Tn,
                lda, c0, w);
      load_tile(sm.k, static_cast<const T*>(a.k) + kv_off, k0, a.Tkv, lda,
                c0, w);
      load_tile(sm.v, static_cast<const T*>(a.v) + kv_off, k0, a.Tkv, lda,
                c0, w);
      __syncthreads();
    }
    tile_abt(sm.q, sm.k, w, s);
    tile_abt(sm.dout, sm.v, w, g);
  }
  bwd_probs<T>(sm, key_valid, q0, k0, a.Tn, a.Tkv, bh, a.dr, s, g);
}

// ------------------------------------------------------------------ fused

// grid (chunks, B*H).  Block (c, bh) takes key tiles [c*n/chunks,
// (c+1)*n/chunks) of n; dq_out is dq itself when chunks == 1, else the
// chunk's slice of the [chunks, B*H, T, d] partial-dq scratch.  Each output
// slab of d is a pass of its own.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_fused_kernel(BwdArgs a, float* __restrict__ part, int chunks) {
  extern __shared__ float smem[];
  const BwdSmem sm = bwd_smem(smem);
  __shared__ int key_valid[kTile];
  const int bh = blockIdx.y;
  const int c = blockIdx.x;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int n_kv = (a.Tkv + kTile - 1) / kTile;
  const int j0 = (int)((long long)c * n_kv / chunks);
  const int j1 = (int)((long long)(c + 1) * n_kv / chunks);
  // a chunk's partial dq has dq's layout
  float* dq_out = (part ? part + (size_t)c * gridDim.y * a.Tn * a.d : a.dq) +
                  q_base(a, bh);
  const size_t kv_off = kv_base(a, bh);
  const int lda = ld(a);
  const int ns = n_slabs(a.d);

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * kTile;
    for (int o = 0; o < ns; ++o) {
      const int oc = o * kDMax;
      const int ow = slab_width(a.d, o);
      float dk[4][8], dv[4][8];
      zero_acc(dk);
      zero_acc(dv);
      __syncthreads();  // the previous key tile is read
      load_key_tile<T>(sm, key_valid, a, bh, k0);
      for (int q0 = 0; q0 < a.Tn; q0 += kTile) {
        __syncthreads();  // the previous query tile and score tiles are read
        load_query_tile<T>(sm, a, bh, q0);
        __syncthreads();
        score_step<T>(sm, key_valid, a, bh, q0, k0, o);
        __syncthreads();
        tile_ptb(sm.p, sm.dout, dv);
        tile_ptb(sm.ds, sm.q, dk);
        float dq[4][8];
        zero_acc(dq);
        tile_pb(sm.ds, sm.k, dq);
        // this thread's slots of the query tile's partial dq: written by
        // the chunk's first key tile, then added to in key-tile order
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = q0 + 4 * ty + i;
          if (r >= a.Tn) continue;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = tx + 16 * jj;
            if (col >= ow) continue;
            float* slot = dq_out + (size_t)r * lda + oc + col;
            *slot = (j == j0) ? dq[i][jj] : *slot + dq[i][jj];
          }
        }
      }
      store_acc(static_cast<T*>(a.dk) + kv_off, dk, k0, a.Tkv, lda, oc, ow);
      store_acc(static_cast<T*>(a.dv) + kv_off, dv, k0, a.Tkv, lda, oc, ow);
    }
  }
}

// dq[i] = sum over chunks c = 0, 1, ... of part[c][i], in that order.
__global__ void flash_bwd_dq_reduce(const float* __restrict__ part,
                                    float* __restrict__ dq, size_t n,
                                    int chunks) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = part[i];
    for (int c = 1; c < chunks; ++c) sum += part[(size_t)c * n + i];
    dq[i] = sum;
  }
}

// ------------------------------------------------------------------ split

// grid (key tiles, B*H): dk and dv of one key tile, walking the query
// tiles, a pass per output slab.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const BwdSmem sm = bwd_smem(smem);
  __shared__ int key_valid[kTile];
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const size_t kv_off = kv_base(a, bh);
  for (int o = 0; o < n_slabs(a.d); ++o) {
    float dk[4][8], dv[4][8];
    zero_acc(dk);
    zero_acc(dv);
    __syncthreads();  // the previous pass's tiles are read
    load_key_tile<T>(sm, key_valid, a, bh, k0);
    for (int q0 = 0; q0 < a.Tn; q0 += kTile) {
      __syncthreads();
      load_query_tile<T>(sm, a, bh, q0);
      __syncthreads();
      score_step<T>(sm, key_valid, a, bh, q0, k0, o);
      __syncthreads();
      tile_ptb(sm.p, sm.dout, dv);
      tile_ptb(sm.ds, sm.q, dk);
    }
    const int oc = o * kDMax;
    const int ow = slab_width(a.d, o);
    store_acc(static_cast<T*>(a.dk) + kv_off, dk, k0, a.Tkv, ld(a), oc, ow);
    store_acc(static_cast<T*>(a.dv) + kv_off, dv, k0, a.Tkv, ld(a), oc, ow);
  }
}

// grid (query tiles, B*H): dq of one query tile, walking the key tiles, a
// pass per output slab.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const BwdSmem sm = bwd_smem(smem);
  __shared__ int key_valid[kTile];
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  load_query_tile<T>(sm, a, bh, q0);
  for (int o = 0; o < n_slabs(a.d); ++o) {
    float dq[4][8];
    zero_acc(dq);
    for (int k0 = 0; k0 < a.Tkv; k0 += kTile) {
      __syncthreads();
      load_key_tile<T>(sm, key_valid, a, bh, k0);
      __syncthreads();
      score_step<T>(sm, key_valid, a, bh, q0, k0, o);
      __syncthreads();
      tile_pb(sm.ds, sm.k, dq);
    }
    store_acc(a.dq + q_base(a, bh), dq, q0, a.Tn, ld(a), o * kDMax,
              slab_width(a.d, o));
  }
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kBwdSmemBytes);
}

template <typename T>
cudaError_t run_fused(const BwdArgs& a, int BH, float* part, int chunks,
                      cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_fused_kernel<T>);
  if (err != cudaSuccess) return err;
  flash_bwd_fused_kernel<T><<<dim3(chunks, BH), kThreads, kBwdSmemBytes,
                              stream>>>(a, part, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const size_t n = (size_t)BH * a.Tn * a.d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  flash_bwd_dq_reduce<<<blocks, 256, 0, stream>>>(part, a.dq, n, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_dkdv(const BwdArgs& a, int BH, cudaStream_t stream) {
  const cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T>);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T><<<dim3((a.Tkv + kTile - 1) / kTile, BH), kThreads,
                             kBwdSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_dq(const BwdArgs& a, int BH, cudaStream_t stream) {
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T><<<dim3((a.Tn + kTile - 1) / kTile, BH), kThreads,
                           kBwdSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

bool bad_args(int BH, int H, int Tn, int Tkv, int d, float keep,
              int dropout) {
  return BH <= 0 || H <= 0 || BH % H || Tn <= 0 || Tkv <= 0 || d <= 0 ||
         n_slabs(d) > kMaxSlabs || (dropout && !(keep > 0.0f));
}

// Checks the fused form's arguments and launches it in the layout bthd
// selects.
int fused_entry(int dtype, const void* q, const void* k, const void* v,
                const unsigned char* mask, const float* lse,
                const float* delta, const void* dout, float* dq, void* dk,
                void* dv, int BH, int H, int Tn, int Tkv, int d,
                unsigned int key, unsigned int thresh, float keep,
                int dropout, float* part, int chunks, int bthd,
                void* stream) {
  if (bad_args(BH, H, Tn, Tkv, d, keep, dropout) || !dq || !dk || !dv ||
      chunks < 1 ||
      chunks > (Tkv + kTile - 1) / kTile || (chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,  k,  v,  mask, lse, delta, dout,
                  dq, dk, dv, H,    Tn,  Tkv,   d,
                  Dropout{key, thresh, keep, dropout != 0}, bthd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = chunks > 1 ? part : nullptr;
  if (dtype == 0) return (int)run_fused<float>(a, BH, scratch, chunks, s);
  if (dtype == 1)
    return (int)run_fused<__nv_bfloat16>(a, BH, scratch, chunks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Device pointers of contiguous tensors:
// q, dout [BH, T, d] and k, v [BH, T_kv, d] in dtype; mask [BH / H, T_kv]
// bytes (1 = attendable); lse, delta [BH, T] f32; outputs dq [BH, T, d] f32,
// dk, dv [BH, T_kv, d] in dtype (an entry point that does not write one
// ignores its pointer).  d in 1..512.  Dropout as flash_fwd's.  Launch on
// `stream`; return cudaGetLastError() (0 on success).

// The split's dk/dv kernel: writes dk and dv.
int flash_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                   const unsigned char* mask, const float* lse,
                   const float* delta, const void* dout, float* dq, void* dk,
                   void* dv, int BH, int H, int Tn, int Tkv, int d,
                   unsigned int key, unsigned int thresh, float keep,
                   int dropout, void* stream) {
  if (bad_args(BH, H, Tn, Tkv, d, keep, dropout) || !dk || !dv)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,  k,  v,  mask, lse, delta, dout,
                  dq, dk, dv, H,    Tn,  Tkv,   d,
                  Dropout{key, thresh, keep, dropout != 0}, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_dkdv<float>(a, BH, s);
  if (dtype == 1) return (int)run_dkdv<__nv_bfloat16>(a, BH, s);
  return (int)cudaErrorInvalidValue;
}

// The split's dq kernel: writes dq.
int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                 const unsigned char* mask, const float* lse,
                 const float* delta, const void* dout, float* dq, void* dk,
                 void* dv, int BH, int H, int Tn, int Tkv, int d,
                 unsigned int key, unsigned int thresh, float keep,
                 int dropout, void* stream) {
  if (bad_args(BH, H, Tn, Tkv, d, keep, dropout) || !dq)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,  k,  v,  mask, lse, delta, dout,
                  dq, dk, dv, H,    Tn,  Tkv,   d,
                  Dropout{key, thresh, keep, dropout != 0}, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_dq<float>(a, BH, s);
  if (dtype == 1) return (int)run_dq<__nv_bfloat16>(a, BH, s);
  return (int)cudaErrorInvalidValue;
}

// The fused form over `chunks` key-tile chunks a (b, h), 1 <= chunks <=
// ceil(T_kv / 64); for chunks > 1, `part` is f32 scratch of chunks*BH*T*d.
int flash_bwd_fused(int dtype, const void* q, const void* k, const void* v,
                    const unsigned char* mask, const float* lse,
                    const float* delta, const void* dout, float* dq, void* dk,
                    void* dv, int BH, int H, int Tn, int Tkv, int d,
                    unsigned int key, unsigned int thresh, float keep,
                    int dropout, float* part, int chunks, void* stream) {
  return fused_entry(dtype, q, k, v, mask, lse, delta, dout, dq, dk, dv, BH,
                     H, Tn, Tkv, d, key, thresh, keep, dropout, part, chunks,
                     0, stream);
}

// The fused form on the head-major flat layout (flash_pallas.py
// _bwd_fused_kernel with bthd=True): q, dout, dq [BH / H, T, H*d] and k, v,
// dk, dv [BH / H, T_kv, H*d], head h the column slab [h*d, (h+1)*d); `part`
// holds each chunk's partial dq in dq's layout; lse, delta [BH, T] and the
// rest as flash_bwd_fused's.
int flash_bwd_fused_bthd(int dtype, const void* q, const void* k,
                         const void* v, const unsigned char* mask,
                         const float* lse, const float* delta,
                         const void* dout, float* dq, void* dk, void* dv,
                         int BH, int H, int Tn, int Tkv, int d,
                         unsigned int key, unsigned int thresh, float keep,
                         int dropout, float* part, int chunks, void* stream) {
  return fused_entry(dtype, q, k, v, mask, lse, delta, dout, dq, dk, dv, BH,
                     H, Tn, Tkv, d, key, thresh, keep, dropout, part, chunks,
                     1, stream);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
