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
// Operands are f32 or bf16; m, l, acc and lse are f32; the dropped p is
// rounded to the input dtype before p v; out is stored in the input dtype.
//
// What bounds it on an H100: 4*B*H*T*T_kv*d operations -- 107 GFLOP at the
// bench shape (B=4, H=4, T=4096, d=100): in bf16 0.11 ms at the tensor
// cores' 989 TFLOP/s; in f32, as 3xTF32's three products, 0.65 ms at
// TF32's 495 TFLOP/s -- against 33 MB of q, k, v, out and lse in f32 (10
// us at 3.35 TB/s), 17 MB in bf16: operations, in both dtypes.
//
// What the design does about it (flash_wgmma.cuh has the pieces):
//  * Both products on the tensor cores with wgmma: s = q k^T (A the q
//    tile from registers, B a chunk of k) and o += p v (A the
//    probabilities converted from s's accumulator, B a transposed chunk of
//    v).  bf16 runs bf16 wgmma (k16); f32 runs 3xTF32 (k8, hi and lo of
//    each operand, three products summed in f32), which keeps f32's 1e-4
//    against the plain version.  d is zero-padded to 64-column chunks
//    inside shared memory only.
//  * A block is one producer warpgroup and NC consumer warpgroups of 64
//    query rows each.  The producer writes each consumer's q tile and the
//    video's key mask into shared memory once, then streams every valid
//    key tile as ceil(d/64) chunks of k and the output slab's NCH chunks
//    of v^T through a ring of up to four slots (mbarriers full/empty), so
//    its loads overlap the consumers' products.  It copies with cp.async
//    (16, 8 or 4 bytes as the address allows, element loads for an odd
//    head width in bf16), splits f32 into tf32 hi and lo, transposes v
//    (permuting its rows for tf32's register A layout) and zero-fills the
//    ragged edges.  TMA is not used: every chunk needs that conversion,
//    and bf16 rows of d = 100 (200 bytes) break TMA's 16-byte stride rule.
//  * A key tile with no attendable key is skipped by producer and
//    consumers alike, and the skip is exact: after a valid key its p =
//    exp(-1e30 - m) is 0 and alpha 1; before one, whatever it added is
//    scaled by alpha = exp(-1e30 - m) = 0 at the first valid tile; a row
//    with no valid key writes 0 either way.  The bucket padding of the
//    shorter videos costs nothing.
//  * Dropout runs on the accumulator fragment: each thread knows the (q,
//    k) of its score elements.
//  * d <= 128: two consumers (128 query rows a block, 384 threads, the
//    output 64 x 128 in 64 registers a thread); the serving shape (B=3,
//    H=4, T=1280) is 120 blocks, one wave on 132 SMs.  d > 128: one
//    consumer whose output slab is 256 columns (128 registers a thread);
//    d = 200 is one pass, d = 400 two (256 + 144 columns), each pass
//    recomputing q k^T, since 400 columns of output do not fit the
//    registers.
//  * The head-major flat layout [B, T, H*d] differs only in where a head's
//    rows start and their stride (flash_common.cuh::head_base); the
//    arithmetic and its order are the same.

#include "flash_wgmma.cuh"

namespace {

constexpr int kStagesMax = 8;

template <typename T, int NCH, int NC>
__global__ void __launch_bounds__(kWg * (NC + 1), 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v,
                 const unsigned char* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Tn, int Tkv, int d,
                 Dropout dr, int bthd, int stages, int side, int direct) {
  constexpr int kPlane = Op<T>::kPlaneBytes;
  constexpr int kBytes = chunk_bytes<T>();
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kStagesMax], empty[kStagesMax], q_full;
  char* smem = aligned_smem(smem_raw);
  const int ne = (d + kTile - 1) / kTile;  // 64-column chunks of d
  char* q_s = smem;                        // consumer c's chunk e at c*ne+e
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(q_s) +
                          NC * ne * kPlane;
  char* stage_s = reinterpret_cast<char*>(mask_s) + ((side + 127) & ~127);
  Ring ring{stage_s + kStageBytes, full, empty, stages, 0, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], kWg);
      mbar_init(&empty[i], 4 * NC);
    }
    mbar_init(&q_full, kWg);
    mbar_init_fence();
  }
  __syncthreads();

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile * NC;
  const int ld = row_stride(bthd, H, d);
  // the video's key mask: in shared memory once the producer copied it
  const unsigned char* mask_b =
      side ? mask_s : mask + (size_t)(bh / H) * Tkv;
  const int n_kv = (Tkv + kTile - 1) / kTile;
  const int passes = (d + NCH * kTile - 1) / (NCH * kTile);

  // the warpgroup's role, broadcast so that the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x / kWg), 0);
  if (wg == 0) {  // the producer
    const int tid = threadIdx.x;
    const T* qb = q + head_base(bthd, bh, H, Tn, d);
    const T* kb = k + head_base(bthd, bh, H, Tkv, d);
    const T* vb = v + head_base(bthd, bh, H, Tkv, d);
    for (int c = 0; c < NC; ++c)
      for (int e = 0; e < ne; ++e)  // the q tiles, raw (f32 unsplit)
        put_raw_chunk(q_s + (c * ne + e) * kPlane, stage_s, qb, ld,
                      q0 + c * kTile, Tn, e * kTile, d - e * kTile, tid);
    if (side) {
      copy_side(mask_s, mask + (size_t)(bh / H) * Tkv, Tkv, tid);
      named_sync(2, kWg);  // the producer reads the copy too
    }
    mbar_arrive(&q_full);
    const int v_kind = Op<T>::kPlanes == 2 ? kTransposedPermuted : kTransposed;
    for (int o = 0; o < passes; ++o) {
      for (int j = 0; j < n_kv; ++j) {
        if (!tile_has_key(mask_b, j, Tkv)) continue;
        for (int e = 0; e < ne; ++e)
          push_chunk(ring, stage_s, kb, ld, j * kTile, Tkv, e * kTile,
                     d - e * kTile, kNatural, direct, tid);
        // the slab's NCH chunks of v^T, zero past d
        for (int c = 0; c < NCH; ++c) {
          const int c0 = (o * NCH + c) * kTile;
          push_chunk(ring, stage_s, vb, ld, j * kTile, Tkv, c0, d - c0, v_kind,
                     direct, tid);
        }
      }
    }
    return;
  }

  // a consumer: query rows [q0 + 64 cw, q0 + 64 cw + 64); this thread's
  // rows row0 and row0 + 8, columns 8jj + cq + {0, 1} of each tile
  const int cw = wg - 1;
  const char* qc = q_s + cw * ne * kPlane;
  const int row0 = q0 + cw * kTile + acc_row();
  const int cq = acc_col();
  T* ob = out + head_base(bthd, bh, H, Tn, d);
  mbar_wait(&q_full, 0);
  for (int o = 0; o < passes; ++o) {
    float acc[NCH][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};

    for (int j = 0; j < n_kv; ++j) {
      if (!tile_has_key(mask_b, j, Tkv)) continue;
      const int k0 = j * kTile;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      for (int e = 0; e < ne; ++e) {  // s = q k^T over every chunk of d
        const int slot = ring.stage;
        ring.wait_full();
        const char* kc = ring.slot(kBytes);
        ring.advance();
        mma_chunk<T>(s, qc + e * kPlane, kc);
        wgmma_commit();
        wgmma_wait();
        ring.release(slot);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int key = k0 + 8 * jj + cq + c2;
          if (!(key < Tkv && mask_b[key])) {
            s[4 * jj + c2] = kNegInf;
            s[4 * jj + 2 + c2] = kNegInf;
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = __expf(m[i] - m_new);
        const int row = row0 + 8 * i;
        float sum = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int idx = 4 * jj + 2 * i + c2;
            float p = __expf(s[idx] - m_new);
            sum += p;
            if (dr.on)
              p = kept(dr, bh, Tn, Tkv, row, k0 + 8 * jj + cq + c2)
                      ? p / dr.keep
                      : 0.0f;
            s[idx] = p;  // rounded to T as the A operand of p v
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            acc[c][4 * jj + 2 * i] *= alpha;
            acc[c][4 * jj + 2 * i + 1] *= alpha;
          }
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {  // o += p v, a chunk of v^T each
        const int slot = ring.stage;
        ring.wait_full();
        const char* vc = ring.slot(kBytes);
        ring.advance();
        mma_acc<T>(acc[c], s, vc);
        wgmma_commit();
        wgmma_wait();
        ring.release(slot);
      }
    }

    // rows with no valid key (bucket padding): zero output, zero lse; every
    // pass computes the same m and l
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const bool valid = m[i] > kNegInf / 2;
      const float l_safe = fmaxf(l[i], 1e-30f);
      if (row >= Tn) continue;
      if (o == 0 && cq == 0)
        lse[(size_t)bh * Tn + row] = valid ? m[i] + logf(l_safe) : 0.0f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int c0 = (o * NCH + c) * kTile;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int col = c0 + 8 * jj + cq + c2;
            if (col < d)
              ob[(size_t)row * ld + col] = from_f<T>(
                  valid ? acc[c][4 * jj + 2 * i + c2] / l_safe : 0.0f);
          }
      }
    }
  }
}

template <typename T, int NCH, int NC>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const unsigned char* mask, void* out, float* lse,
                       int BH, int H, int Tn, int Tkv, int d, Dropout dr,
                       int bthd, cudaStream_t stream) {
  constexpr int kStatic = 8 * (2 * kStagesMax + 1);
  constexpr int kLeast = 2;  // k and v at once
  const int base = NC * ((d + kTile - 1) / kTile) * Op<T>::kPlaneBytes +
                   kStageBytes + kSmemAlign;
  const int side = side_within(side_bytes(Tkv, 0), kStatic + base,
                               chunk_bytes<T>(), kLeast);
  const int fixed = base + ((side + 127) & ~127);
  const int stages = ring_stages(kStatic + fixed, chunk_bytes<T>(),
                                 kStagesMax);
  if (stages < kLeast) return cudaErrorInvalidValue;
  const int bytes = fixed + stages * chunk_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NCH, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // bf16 chunks go straight into the ring when every row is 8-byte aligned
  const int ld = bthd ? H * d : d;
  const int direct = direct_rows(k, ld, d, sizeof(T)) &&
                     direct_rows(v, ld, d, sizeof(T));
  const dim3 grid((Tn + kTile * NC - 1) / (kTile * NC), BH);
  flash_fwd_kernel<T, NCH, NC><<<grid, kWg * (NC + 1), bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, H, Tn, Tkv,
      d, dr, bthd, stages, side, direct);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_fwd(const void* q, const void* k, const void* v,
                    const unsigned char* mask, void* out, float* lse, int BH,
                    int H, int Tn, int Tkv, int d, Dropout dr, int bthd,
                    cudaStream_t stream) {
  if (d <= 2 * kTile)
    return launch_fwd<T, 2, 2>(q, k, v, mask, out, lse, BH, H, Tn, Tkv, d,
                               dr, bthd, stream);
  return launch_fwd<T, 4, 1>(q, k, v, mask, out, lse, BH, H, Tn, Tkv, d, dr,
                             bthd, stream);
}

// Checks the arguments and launches in the layout bthd selects.
int fwd_entry(int dtype, const void* q, const void* k, const void* v,
              const unsigned char* mask, void* out, float* lse, int BH, int H,
              int Tn, int Tkv, int d, unsigned int key, unsigned int thresh,
              float keep, int dropout, int bthd, void* stream) {
  if (BH <= 0 || H <= 0 || BH % H || Tn <= 0 || Tkv <= 0 || d <= 0 ||
      d > kDHead || (dropout && !(keep > 0.0f)))
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
