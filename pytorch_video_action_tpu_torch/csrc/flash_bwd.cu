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
// What bounds it on an H100: operations.  The fused form does 10*B*H*T*
// T_kv*d (the five products, counted once): 268 GFLOP at the bench shape
// (B=4, H=4, T=4096, d=100), in bf16 0.27 ms at the tensor cores' 989
// TFLOP/s, in f32, as 3xTF32's three products, 1.63 ms at TF32's 495
// TFLOP/s (4.0 ms at f32's 67 TFLOP/s outside the tensor cores).  The
// split does the score products twice, 14*B*H*T*T_kv*d: 0.38 ms bf16,
// 2.28 ms f32 there.  About 60 MB of operands and gradients in f32 take
// 18 us at 3.35 TB/s.
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
//  * Its five products run on the tensor cores with wgmma (flash_wgmma.cuh:
//    bf16, or f32 as 3xTF32), keys as the M rows of s^T = k q^T and dp^T =
//    v dout^T, so that p^T and ds^T sit in the accumulator layout that dv
//    += p_drop^T dout and dk += ds^T q take as their register A operand;
//    dq = ds k reads ds from a [query][key] chunk the consumer stages in
//    shared memory.  A producer warpgroup streams, for every query tile,
//    the chunks of k, q, v and dout (64 columns of d each) and the output
//    slab's transposed chunks of dout, q and k through a ring of up to six
//    slots; the consumer warpgroup takes them in the same order.
//  * A key tile with no attendable key (bucket padding) writes dk = dv = 0
//    and skips the query walk: its p and ds are exactly 0.  A chunk whose
//    first such tiles are skipped still writes its partial dq at its
//    first tile with a key, and a chunk with none writes zeros.
//  * The consumer prefetches the query tile's old partial dq (cp.async
//    into its own shared memory) while the tile's products run, and the
//    key mask, lse and delta of the (b, h) sit in shared memory.
//  * A head wider than 128 is walked in output slabs of 128 columns (dk
//    and dv of a slab take 128 registers a thread), each recomputing the
//    score products over all of d.
//  * split (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel, each its own entry
//    point; ops/flash.py::use_fused picks it for videos whose fused scratch
//    would pass its budget): twice the score step, no scratch, no
//    reduction.  Its bound is the fused form's with the score products
//    counted twice: 4 products for dk and dv, 3 for dq.  Both kernels are
//    the forward's shape (flash_fwd.cu): a producer warpgroup and NC
//    consumer warpgroups of 64 rows each, whose A operands (the rows'
//    own tiles, raw: f32 is split as each k-step loads it) the producer
//    writes into shared memory once, then streams the walked tiles' B
//    chunks through the ring; every product is wgmma (3xTF32 or bf16).
//    - flash_bwd_dq_kernel: queries as the M rows.  For every key tile
//      with an attendable key, s = q k^T and dp = dout v^T (A the resident
//      q and dout, B natural chunks of k and v), the score step on the
//      accumulators (dropout included), ds rounded to T, and dq += ds k
//      (A ds converted from the accumulator, B the slab's transposed k
//      chunks, permuted for tf32).  dq stays in registers for the whole
//      walk and is stored once.  Key tiles with no attendable key are
//      skipped by producer and consumers alike (their ds is exactly 0).
//    - flash_bwd_dkdv_kernel: keys as the M rows, as the fused form, each
//      consumer its own key tile: s^T = k q^T and dp^T = v dout^T (A the
//      resident k and v), so that p_drop^T and ds^T sit in the
//      accumulator layout that dv += p_drop^T dout and dk += ds^T q take
//      as their register A operand.  None of the fused form's dq work
//      (no ds staging, no partial dq), k and v converted once a key tile,
//      not with every query tile, and two consumers share every q and
//      dout chunk the producer converts: 4 chunks a key tile and query
//      tile in f32 against the fused form's 14.  A block whose key tiles
//      have no attendable key writes dk = dv = 0 and skips the query
//      walk.
//    - d <= 128: two consumers (128 rows a block), each with 240
//      registers, the producer keeping 24 (setmaxnreg, flash_wgmma.cuh):
//      a dk/dv consumer holds dk and dv of a 128-column slab, s^T and dp^T
//      (192 registers).  d > 128: one consumer, the dq kernel's output
//      slab 256 columns (d = 200 one pass, 400 two), dk and dv slabs of
//      128 columns; each pass recomputes the score products over all of
//      d.
//    - Where the consumers' A operands do not fit beside a ring of two
//      slots (f32 at d > 256), they come through the ring as raw chunks
//      with each walked tile instead.  In bf16, when the ring holds a
//      whole walked tile, the slab's products read the tile's natural
//      chunks again (MN-major) instead of the producer sending them twice.
//  * The head-major flat layout [B, T, H*d] differs only in where a head's
//    rows start and their stride (BwdArgs::bthd, flash_common.cuh::
//    head_base); a chunk's partial dq takes dq's layout, so the reduction
//    is the same elementwise sum.

#include "flash_wgmma.cuh"

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

// ------------------------------------------------------------------ fused

constexpr int kBwdStagesMax = 12;
constexpr int kDqBytes = 2 * 32 * kWg * 4;  // the consumer's dq prefetch


// grid (chunks, B*H), 256 threads: a producer warpgroup and a consumer
// warpgroup.  Block (c, bh) takes key tiles [c*n/chunks, (c+1)*n/chunks)
// of n; dq_out is dq itself when chunks == 1, else the chunk's slice of
// the [chunks, B*H, T, d] partial-dq scratch.  For each key tile with an
// attendable key and each output slab of 128 columns, the consumer keeps
// dk and dv in registers and walks every query tile: s^T = k q^T and
// dp^T = v dout^T (keys as the 64 M rows, over every chunk of d), the
// score step in registers, dv += p_drop^T dout and dk += ds^T q (A the
// two score accumulators), and dq = ds k (A the ds tile staged in shared
// memory) added into the partial dq.  The producer streams, a query tile,
// the natural chunks k, q, v, dout of each 64 columns of d, then the
// slab's transposed chunks of dout, q and k.
template <typename T>
__global__ void __launch_bounds__(2 * kWg, 1)
flash_bwd_fused_kernel(BwdArgs a, float* __restrict__ part, int chunks,
                       int stages, int side, int direct) {
  constexpr int kBytes = chunk_bytes<T>();
  constexpr bool kPermute = Op<T>::kPlanes == 2;  // tf32's register A
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kBwdStagesMax], empty[kBwdStagesMax], side_full;
  char* smem = aligned_smem(smem_raw);
  char* ds_s = smem;                // ds as a [query][key] chunk
  char* dq_s = smem + kBytes;       // each thread's prefetched partial dq
  char* side_s = dq_s + kDqBytes;   // lse, delta [T] f32, then the key mask
  char* stage_s = side_s + ((side + 127) & ~127);
  Ring ring{stage_s + kStageBytes, full, empty, stages, 0, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], kWg);
      mbar_init(&empty[i], 4);
    }
    mbar_init(&side_full, kWg);
    mbar_init_fence();
  }
  __syncthreads();

  const int bh = blockIdx.y;
  const int c = blockIdx.x;
  const int Tn = a.Tn, Tkv = a.Tkv, d = a.d;
  const int n_kv = (Tkv + kTile - 1) / kTile;
  const int j0 = (int)((long long)c * n_kv / chunks);
  const int j1 = (int)((long long)(c + 1) * n_kv / chunks);
  const int lda = ld(a);
  const int ne = (d + kTile - 1) / kTile;  // 64-column chunks of d
  const int passes = (ne + 1) / 2;         // output slabs of two chunks
  // the video's key mask, lse and delta: in shared memory once the
  // producer copied them
  float* lse_s = reinterpret_cast<float*>(side_s);
  float* delta_s = lse_s + Tn;
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(delta_s + Tn);
  const unsigned char* mask_b =
      side ? mask_s : a.mask + (size_t)(bh / a.H) * Tkv;
  const float* lse_b = side ? lse_s : a.lse + (size_t)bh * Tn;
  const float* delta_b = side ? delta_s : a.delta + (size_t)bh * Tn;
  const T* qb = static_cast<const T*>(a.q) + q_base(a, bh);
  const T* dob = static_cast<const T*>(a.dout) + q_base(a, bh);
  const T* kb = static_cast<const T*>(a.k) + kv_base(a, bh);
  const T* vb = static_cast<const T*>(a.v) + kv_base(a, bh);

  // the warpgroup's role, broadcast so that the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x / kWg), 0);
  if (wg == 0) {  // the producer
    const int tid = threadIdx.x;
    if (side) {
      copy_side(lse_s, a.lse + (size_t)bh * Tn, Tn, tid);
      copy_side(delta_s, a.delta + (size_t)bh * Tn, Tn, tid);
      copy_side(mask_s, a.mask + (size_t)(bh / a.H) * Tkv, Tkv, tid);
      named_sync(2, kWg);  // the producer reads the mask too
    }
    mbar_arrive(&side_full);
    const int kind_t = kPermute ? kTransposedPermuted : kTransposed;
    auto push = [&](const T* src, int r0, int rows, int c0, int kind) {
      push_chunk(ring, stage_s, src, lda, r0, rows, c0, d - c0, kind, direct,
                 tid);
    };
    for (int j = j0; j < j1; ++j) {
      if (!tile_has_key(mask_b, j, Tkv)) continue;
      const int k0 = j * kTile;
      for (int o = 0; o < passes; ++o) {
        for (int q0 = 0; q0 < Tn; q0 += kTile) {
          for (int e = 0; e < ne; ++e) {
            const int c0 = e * kTile;
            push(kb, k0, Tkv, c0, kNatural);
            push(qb, q0, Tn, c0, kNatural);
            push(vb, k0, Tkv, c0, kNatural);
            push(dob, q0, Tn, c0, kNatural);
          }
          // the slab's two chunks (the second zero past d)
          for (int cc = 0; cc < 2; ++cc)
            push(dob, q0, Tn, (2 * o + cc) * kTile, kind_t);
          for (int cc = 0; cc < 2; ++cc)
            push(qb, q0, Tn, (2 * o + cc) * kTile, kind_t);
          for (int cc = 0; cc < 2; ++cc)
            push(kb, k0, Tkv, (2 * o + cc) * kTile, kTransposed);
        }
      }
    }
    return;
  }

  // the consumer: accumulator rows r and r + 8 (keys, or queries in the dq
  // product), columns 8jj + cq + {0, 1}
  const int tid = threadIdx.x - kWg;
  const int r = acc_row();
  const int cq = acc_col();
  float* dq_out = (part ? part + (size_t)c * gridDim.y * Tn * d : a.dq) +
                  q_base(a, bh);
  T* dkb = static_cast<T*>(a.dk) + kv_base(a, bh);
  T* dvb = static_cast<T*>(a.dv) + kv_base(a, bh);
  const Dropout dr = a.dr;
  const float inv_keep = 1.0f / dr.keep;
  auto take = [&](int& slot) -> const char* {
    slot = ring.stage;
    ring.wait_full();
    const char* p = ring.slot(kBytes);
    ring.advance();
    return p;
  };
  // the chunk's first key tile with an attendable key writes its partial
  // dq; the later ones add to it, in key-tile order
  bool first = true;
  mbar_wait(&side_full, 0);

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * kTile;
    if (!tile_has_key(mask_b, j, Tkv)) {
      // no attendable key: its p and ds are exactly 0, so dk = dv = 0 and
      // it adds nothing to dq
      for (int i = tid; i < kTile * d; i += kWg) {
        const int row = k0 + i / d;
        if (row < Tkv) {
          dkb[(size_t)row * lda + i % d] = from_f<T>(0.0f);
          dvb[(size_t)row * lda + i % d] = from_f<T>(0.0f);
        }
      }
      continue;
    }
    const bool kv_in[2] = {k0 + r < Tkv && mask_b[k0 + r],
                           k0 + r + 8 < Tkv && mask_b[k0 + r + 8]};
    for (int o = 0; o < passes; ++o) {
      float dk[2][32], dv[2][32];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
#pragma unroll
        for (int i = 0; i < 32; ++i) dk[cc][i] = dv[cc][i] = 0.0f;

      for (int q0 = 0; q0 < Tn; q0 += kTile) {
        if (!first) {
          // this thread's slots of the query tile's partial dq, copied
          // into its own shared memory while the tile's products run
          // (element i of chunk cc at (cc * 32 + i) * 128 + tid)
          float* pre = reinterpret_cast<float*>(dq_s) + tid;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int c2 = 0; c2 < 2; ++c2) {
                  const int row = q0 + r + 8 * i;
                  const int col = (2 * o + cc) * kTile + 8 * jj + cq + c2;
                  if (row < Tn && col < d)
                    cp_async<4>(pre + (cc * 32 + 4 * jj + 2 * i + c2) * kWg,
                                dq_out + (size_t)row * lda + col);
                }
          cp_async_commit();
        }
        // s^T = k q^T and dp^T = v dout^T over every chunk of d
        float st[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.0f;
        for (int e = 0; e < ne; ++e) {
          int s1, s2, s3, s4;
          const char* kc = take(s1);
          const char* qc = take(s2);
          const char* vc = take(s3);
          const char* oc = take(s4);
          wgmma_fence();
          mma_ss<T>(st, kc, qc);
          mma_ss<T>(dp, vc, oc);
          wgmma_commit();
          wgmma_wait();
          ring.release(s1);
          ring.release(s2);
          ring.release(s3);
          ring.release(s4);
        }
        // the score step: p = exp(s - lse) (0 past T), the dropout on p and
        // on g = dout v^T, ds = p (g - delta) with the undropped p; p_drop
        // into st and ds into dp, each rounded to T
        named_sync(1, kWg);  // the previous query tile's ds is read
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int ql = 8 * jj + cq + c2;
            const int query = q0 + ql;
            const bool q_in = query < Tn;
            const float lse_q = q_in ? lse_b[query] : 0.0f;
            const float delta_q = q_in ? delta_b[query] : 0.0f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int idx = 4 * jj + 2 * i + c2;
              const float sv = kv_in[i] ? st[idx] : kNegInf;
              const float p = q_in ? __expf(sv - lse_q) : 0.0f;
              float g = dp[idx];
              float p_drop = p;
              if (dr.on) {
                const float mm =
                    kept(dr, bh, Tn, Tkv, query, k0 + r + 8 * i) ? inv_keep
                                                                 : 0.0f;
                p_drop = p * mm;
                g = g * mm;
              }
              st[idx] = rnd<T>(p_drop);
              dp[idx] = rnd<T>(p * (g - delta_q));
              put1(ds_s, ql, r + 8 * i, from_f<T>(dp[idx]));
            }
          }
        fence_async_smem();  // the staged ds is read by wgmma
        named_sync(1, kWg);  // ds is staged
        {  // dv += p_drop^T dout, then dk += ds^T q, the slab's two chunks
          int s1, s2;
          const char* b1 = take(s1);
          const char* b2 = take(s2);
          mma_acc<T>(dv[0], st, b1);
          mma_acc<T>(dv[1], st, b2);
          wgmma_commit();
          wgmma_wait();
          ring.release(s1);
          ring.release(s2);
          b1 = take(s1);
          b2 = take(s2);
          mma_acc<T>(dk[0], dp, b1);
          mma_acc<T>(dk[1], dp, b2);
          wgmma_commit();
          wgmma_wait();
          ring.release(s1);
          ring.release(s2);
        }
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {  // dq = ds k, into the partial dq
          const int c0 = (2 * o + cc) * kTile;
          float dq[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) dq[i] = 0.0f;
          int slot;
          const char* b = take(slot);
          wgmma_fence();
          mma_ss<T, true>(dq, ds_s, b);
          wgmma_commit();
          wgmma_wait();
          ring.release(slot);
          if (!first) {  // the old partial dq, prefetched at the tile's start
            cp_async_wait<0>();
            const float* old = reinterpret_cast<const float*>(dq_s) +
                               cc * 32 * kWg + tid;
#pragma unroll
            for (int i = 0; i < 32; ++i) dq[i] += old[i * kWg];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int c2 = 0; c2 < 2; ++c2) {
                const int row = q0 + r + 8 * i;
                const int col = c0 + 8 * jj + cq + c2;
                if (row < Tn && col < d)
                  dq_out[(size_t)row * lda + col] = dq[4 * jj + 2 * i + c2];
              }
        }
      }
      // this slab of dk and dv
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = k0 + r + 8 * i;
        if (row >= Tkv) continue;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
              const int col = (2 * o + cc) * kTile + 8 * jj + cq + c2;
              if (col >= d) continue;
              dkb[(size_t)row * lda + col] =
                  from_f<T>(dk[cc][4 * jj + 2 * i + c2]);
              dvb[(size_t)row * lda + col] =
                  from_f<T>(dv[cc][4 * jj + 2 * i + c2]);
            }
      }
    }
    first = false;
  }
  if (first)  // no key tile of the chunk has an attendable key
    for (int i = tid; i < Tn * d; i += kWg)
      dq_out[(size_t)(i / d) * lda + i % d] = 0.0f;
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

template <typename T>
cudaError_t run_fused(const BwdArgs& a, int BH, float* part, int chunks,
                      cudaStream_t stream) {
  constexpr int kStatic = 8 * (2 * kBwdStagesMax + 1);
  constexpr int kLeast = 4;  // k, q, v and dout at once
  const int base = chunk_bytes<T>() + kDqBytes + kStageBytes + kSmemAlign;
  const int side = side_within(side_bytes(a.Tkv, 2 * a.Tn), kStatic + base,
                               chunk_bytes<T>(), kLeast);
  const int fixed = base + ((side + 127) & ~127);
  const int stages = ring_stages(kStatic + fixed, chunk_bytes<T>(),
                                 kBwdStagesMax);
  if (stages < kLeast) return cudaErrorInvalidValue;
  // bf16 chunks go straight into the ring when every row is 8-byte aligned
  const int ldr = a.bthd ? a.H * a.d : a.d;
  const int direct = direct_rows(a.q, ldr, a.d, sizeof(T)) &&
                     direct_rows(a.k, ldr, a.d, sizeof(T)) &&
                     direct_rows(a.v, ldr, a.d, sizeof(T)) &&
                     direct_rows(a.dout, ldr, a.d, sizeof(T));
  const int bytes = fixed + stages * chunk_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_fused_kernel<T><<<dim3(chunks, BH), 2 * kWg, bytes, stream>>>(
      a, part, chunks, stages, side, direct);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const size_t n = (size_t)BH * a.Tn * a.d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  flash_bwd_dq_reduce<<<blocks, 256, 0, stream>>>(part, a.dq, n, chunks);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ split

constexpr int kSplitStagesMax = 12;

// A split kernel's shared memory, laid out on the host (split_plan): ring
// slots; the side copy's bytes (0: read in place); whether the consumers'
// A operands stay in shared memory for the whole walk (resident) or come
// through the ring as raw chunks with each walked tile; whether bf16
// chunks go straight into the ring (direct); whether the slab's products
// read the walked tile's natural bf16 chunks again (reuse).
struct SplitPlan {
  int stages, side, resident, direct, reuse;
};

// The consumers' A operands: consumer c's chunk e of operand t (0: q or k,
// 1: dout or v) at ((c * 2 + t) * ne + e) raw planes.
template <typename T>
__device__ __forceinline__ char* res_chunk(char* res, int c, int t, int ne,
                                           int e) {
  return res + (size_t)((c * 2 + t) * ne + e) * Op<T>::kPlaneBytes;
}

// A split kernel's dynamic shared memory from its aligned start: the
// resident operands, the side copy, the producer's staging slots, then
// the ring.  Thread 0 initialises the barriers (res_full: the producer's
// 128 threads announce the resident operands and the side copy).
struct SplitSmem {
  char* res;
  char* side;
  char* stage;
};
template <typename T, int NC>
__device__ __forceinline__ SplitSmem split_smem(char* smem_raw,
                                                const SplitPlan& p, int ne,
                                                uint64_t* full,
                                                uint64_t* empty,
                                                uint64_t* res_full) {
  SplitSmem sm;
  sm.res = aligned_smem(smem_raw);
  sm.side = sm.res + (p.resident ? NC * 2 * ne * Op<T>::kPlaneBytes : 0);
  sm.stage = sm.side + ((p.side + 127) & ~127);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], kWg);
      mbar_init(&empty[i], 4 * NC);
    }
    mbar_init(res_full, kWg);
    mbar_init_fence();
  }
  __syncthreads();
  return sm;
}

// grid (ceil(T / (64 NC)), B*H), (NC + 1) warpgroups: dq of NC query tiles
// of 64 rows, consumer c the rows [q0 + 64c, q0 + 64c + 64), its output
// slab NCH chunks (64 NCH columns) a pass.  The producer writes each
// consumer's q and dout (resident) and the video's key mask (side), then,
// a pass, for each key tile with an attendable key the chunks k_e, v_e of
// each 64 columns of d (each preceded by q_e or dout_e, raw, when those
// are not resident) and, unless reused, the slab's transposed chunks of
// k.
template <typename T, int NCH, int NC>
__global__ void __launch_bounds__(kWg * (NC + 1), 1)
flash_bwd_dq_kernel(BwdArgs a, SplitPlan p) {
  constexpr int kBytes = chunk_bytes<T>();
  // two consumers take the producer's registers: its loops stay rolled
  constexpr bool kLean = NC > 1;
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kSplitStagesMax], empty[kSplitStagesMax], res_full;
  const int Tn = a.Tn, Tkv = a.Tkv, d = a.d;
  const int ne = (d + kTile - 1) / kTile;  // 64-column chunks of d
  const SplitSmem sm = split_smem<T, NC>(smem_raw, p, ne, full, empty,
                                         &res_full);
  Ring ring{sm.stage + kStageBytes, full, empty, p.stages, 0, 0};
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(sm.side);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile * NC;
  const int lda = ld(a);
  const int n_kv = (Tkv + kTile - 1) / kTile;
  const int passes = (d + NCH * kTile - 1) / (NCH * kTile);
  const unsigned char* mask_b =
      p.side ? mask_s : a.mask + (size_t)(bh / a.H) * Tkv;

  // the warpgroup's role, broadcast so that the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x / kWg), 0);
  if (wg == 0) {  // the producer
    if constexpr (NC > 1) regs_dec<kProducerRegs>();
    const int tid = threadIdx.x;
    const T* qb = static_cast<const T*>(a.q) + q_base(a, bh);
    const T* dob = static_cast<const T*>(a.dout) + q_base(a, bh);
    const T* kb = static_cast<const T*>(a.k) + kv_base(a, bh);
    const T* vb = static_cast<const T*>(a.v) + kv_base(a, bh);
    if (p.resident)
      for (int c = 0; c < NC; ++c)
        for (int e = 0; e < ne; ++e) {
          const int c0 = e * kTile;
          put_raw_chunk<kLean>(res_chunk<T>(sm.res, c, 0, ne, e), sm.stage,
                               qb, lda, q0 + c * kTile, Tn, c0, d - c0, tid);
          put_raw_chunk<kLean>(res_chunk<T>(sm.res, c, 1, ne, e), sm.stage,
                               dob, lda, q0 + c * kTile, Tn, c0, d - c0, tid);
        }
    if (p.side) {
      copy_side(mask_s, a.mask + (size_t)(bh / a.H) * Tkv, Tkv, tid);
      named_sync(2, kWg);  // the producer reads the copy too
    }
    mbar_arrive(&res_full);
    const int kind_t =
        Op<T>::kPlanes == 2 ? kTransposedPermuted : kTransposed;
    auto push = [&](const T* src, int r0, int rows, int c0, int kind) {
      push_chunk<kLean>(ring, sm.stage, src, lda, r0, rows, c0, d - c0, kind,
                        p.direct, tid);
    };
    for (int o = 0; o < passes; ++o)
      for (int j = 0; j < n_kv; ++j) {
        if (!tile_has_key(mask_b, j, Tkv)) continue;
        const int k0 = j * kTile;
        for (int e = 0; e < ne; ++e) {
          const int c0 = e * kTile;
          if (!p.resident) push(qb, q0, Tn, c0, kRaw);
          push(kb, k0, Tkv, c0, kNatural);
          if (!p.resident) push(dob, q0, Tn, c0, kRaw);
          push(vb, k0, Tkv, c0, kNatural);
        }
        if (!p.reuse)  // the slab's NCH chunks of k^T, zero past d
          for (int c = 0; c < NCH; ++c)
            push(kb, k0, Tkv, (o * NCH + c) * kTile, kind_t);
      }
    return;
  }

  if constexpr (NC > 1) regs_inc<kConsumerRegs>();
  // a consumer: rows row0 and row0 + 8 (queries), columns 8jj + cq + {0, 1}
  // of each tile (keys; the slab's columns of d in dq)
  const int cw = wg - 1;
  const int row0 = q0 + cw * kTile + acc_row();
  const int cq = acc_col();
  bool q_in[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    q_in[i] = row < Tn;
    lse_r[i] = q_in[i] ? a.lse[(size_t)bh * Tn + row] : 0.0f;
    delta_r[i] = q_in[i] ? a.delta[(size_t)bh * Tn + row] : 0.0f;
  }
  const char* res_q = res_chunk<T>(sm.res, cw, 0, ne, 0);
  const char* res_do = res_chunk<T>(sm.res, cw, 1, ne, 0);
  float* dqb = a.dq + q_base(a, bh);
  const Dropout dr = a.dr;
  const float inv_keep = 1.0f / dr.keep;
  auto take = [&](int& slot) -> const char* {
    slot = ring.stage;
    ring.wait_full();
    const char* c = ring.slot(kBytes);
    ring.advance();
    return c;
  };
  mbar_wait(&res_full, 0);

  for (int o = 0; o < passes; ++o) {
    float dq[NCH][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[c][i] = 0.0f;

    for (int j = 0; j < n_kv; ++j) {
      if (!tile_has_key(mask_b, j, Tkv)) continue;
      const int k0 = j * kTile;
      const int start = ring.stage;  // the tile's first chunk (reuse)
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
      for (int e = 0; e < ne; ++e) {  // s = q k^T, dp = dout v^T
        int sq, sk, sd, sv;
        const char* qa = p.resident ? res_q + e * Op<T>::kPlaneBytes
                                    : take(sq);
        const char* kc = take(sk);
        const char* da = p.resident ? res_do + e * Op<T>::kPlaneBytes
                                    : take(sd);
        const char* vc = take(sv);
        mma_chunk<T>(s, qa, kc);
        wgmma_commit();
        wgmma_wait();
        mma_chunk<T>(dp, da, vc);
        wgmma_commit();
        wgmma_wait();
        if (!p.resident) {
          ring.release(sq);
          ring.release(sd);
        }
        ring.release(sv);
        if (!(p.reuse && e / NCH == o)) ring.release(sk);
      }
      // the score step: p = exp(s - lse) (0 past T), the dropout on g =
      // dout v^T, ds = p (g - delta) rounded to T, into s
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int key = k0 + 8 * jj + cq + c2;
          const bool kv = key < Tkv && mask_b[key];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = 4 * jj + 2 * i + c2;
            const float sv = kv ? s[idx] : kNegInf;
            const float pr = q_in[i] ? __expf(sv - lse_r[i]) : 0.0f;
            float g = dp[idx];
            if (dr.on)
              g = g * (kept(dr, bh, Tn, Tkv, row0 + 8 * i, key) ? inv_keep
                                                                : 0.0f);
            s[idx] = rnd<T>(pr * (g - delta_r[i]));
          }
        }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {  // dq += ds k, a chunk of k^T each
        int slot;
        const char* b;
        if (p.reuse) {  // the tile's natural chunk of k, read MN-major
          slot = (start + 2 * (o * NCH + c)) % p.stages;
          b = ring.slots + (size_t)slot * kBytes;
        } else {
          b = take(slot);
        }
        mma_acc<T>(dq[c], s, b);
        wgmma_commit();
        wgmma_wait();
        ring.release(slot);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Tn) continue;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int col = (o * NCH + c) * kTile + 8 * jj + cq + c2;
            if (col < d)
              dqb[(size_t)row * lda + col] = dq[c][4 * jj + 2 * i + c2];
          }
    }
  }
}

// grid (ceil(T_kv / (64 NC)), B*H), (NC + 1) warpgroups: dk and dv of NC
// key tiles of 64 rows, consumer c the key tile blockIdx.x * NC + c, its
// output slabs two chunks (128 columns) a pass.  The producer writes each
// consumer's k and v (resident) and lse and delta (side); then, unless no
// key tile of the block has an attendable key, a pass, for each query
// tile the chunks q_e, dout_e of each 64 columns of d (each preceded by
// k_e or v_e, raw, when those are not resident) and, unless reused, the
// slab's transposed chunks of dout and q.
template <typename T, int NC>
__global__ void __launch_bounds__(kWg * (NC + 1), 1)
flash_bwd_dkdv_kernel(BwdArgs a, SplitPlan p) {
  constexpr int kBytes = chunk_bytes<T>();
  // two consumers take the producer's registers: its loops stay rolled
  constexpr bool kLean = NC > 1;
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kSplitStagesMax], empty[kSplitStagesMax], res_full;
  const int Tn = a.Tn, Tkv = a.Tkv, d = a.d;
  const int ne = (d + kTile - 1) / kTile;  // 64-column chunks of d
  const SplitSmem sm = split_smem<T, NC>(smem_raw, p, ne, full, empty,
                                         &res_full);
  Ring ring{sm.stage + kStageBytes, full, empty, p.stages, 0, 0};
  float* lse_s = reinterpret_cast<float*>(sm.side);
  float* delta_s = lse_s + Tn;

  const int bh = blockIdx.y;
  const int j0 = blockIdx.x * NC;  // the block's first key tile
  const int lda = ld(a);
  const int passes = (ne + 1) / 2;  // output slabs of two chunks
  const unsigned char* mask_b = a.mask + (size_t)(bh / a.H) * Tkv;
  const float* lse_b = p.side ? lse_s : a.lse + (size_t)bh * Tn;
  const float* delta_b = p.side ? delta_s : a.delta + (size_t)bh * Tn;
  bool any = false;  // whether a key tile of the block has a valid key
#pragma unroll
  for (int c = 0; c < NC; ++c) any = tile_has_key(mask_b, j0 + c, Tkv) || any;

  // the warpgroup's role, broadcast so that the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x / kWg), 0);
  if (wg == 0) {  // the producer
    if constexpr (NC > 1) regs_dec<kProducerRegs>();
    const int tid = threadIdx.x;
    const T* qb = static_cast<const T*>(a.q) + q_base(a, bh);
    const T* dob = static_cast<const T*>(a.dout) + q_base(a, bh);
    const T* kb = static_cast<const T*>(a.k) + kv_base(a, bh);
    const T* vb = static_cast<const T*>(a.v) + kv_base(a, bh);
    if (p.resident && any)
      for (int c = 0; c < NC; ++c)
        for (int e = 0; e < ne; ++e) {
          const int c0 = e * kTile;
          const int k0 = (j0 + c) * kTile;
          put_raw_chunk<kLean>(res_chunk<T>(sm.res, c, 0, ne, e), sm.stage,
                               kb, lda, k0, Tkv, c0, d - c0, tid);
          put_raw_chunk<kLean>(res_chunk<T>(sm.res, c, 1, ne, e), sm.stage,
                               vb, lda, k0, Tkv, c0, d - c0, tid);
        }
    if (p.side && any) {
      copy_side(lse_s, a.lse + (size_t)bh * Tn, Tn, tid);
      copy_side(delta_s, a.delta + (size_t)bh * Tn, Tn, tid);
    }
    mbar_arrive(&res_full);
    if (!any) return;
    const int kind_t =
        Op<T>::kPlanes == 2 ? kTransposedPermuted : kTransposed;
    auto push = [&](const T* src, int r0, int rows, int c0, int kind) {
      push_chunk<kLean>(ring, sm.stage, src, lda, r0, rows, c0, d - c0, kind,
                        p.direct, tid);
    };
    for (int o = 0; o < passes; ++o)
      for (int q0 = 0; q0 < Tn; q0 += kTile) {
        for (int e = 0; e < ne; ++e) {
          const int c0 = e * kTile;
          if (!p.resident) push(kb, j0 * kTile, Tkv, c0, kRaw);
          push(qb, q0, Tn, c0, kNatural);
          if (!p.resident) push(vb, j0 * kTile, Tkv, c0, kRaw);
          push(dob, q0, Tn, c0, kNatural);
        }
        if (!p.reuse) {  // the slab's two chunks of each (zero past d)
          for (int c = 0; c < 2; ++c)
            push(dob, q0, Tn, (2 * o + c) * kTile, kind_t);
          for (int c = 0; c < 2; ++c)
            push(qb, q0, Tn, (2 * o + c) * kTile, kind_t);
        }
      }
    return;
  }

  if constexpr (NC > 1) regs_inc<kConsumerRegs>();
  // a consumer: rows r and r + 8 of its key tile, columns 8jj + cq + {0,
  // 1} of each tile (queries; the slab's columns of d in dk and dv)
  const int cw = wg - 1;
  const int k0 = (j0 + cw) * kTile;
  const int r = acc_row();
  const int cq = acc_col();
  T* dkb = static_cast<T*>(a.dk) + kv_base(a, bh);
  T* dvb = static_cast<T*>(a.dv) + kv_base(a, bh);
  if (!any) {
    // no attendable key in the block: p and ds are exactly 0, so dk = dv
    // = 0
    const int tid = threadIdx.x - kWg * wg;
    for (int i = tid; i < kTile * d; i += kWg) {
      const int row = k0 + i / d;
      if (row < Tkv) {
        dkb[(size_t)row * lda + i % d] = from_f<T>(0.0f);
        dvb[(size_t)row * lda + i % d] = from_f<T>(0.0f);
      }
    }
    return;
  }
  // a key tile with no valid key beside one with some computes p = ds = 0
  // with it, and stores zeros
  const bool own = tile_has_key(mask_b, j0 + cw, Tkv);
  const bool kv_in[2] = {k0 + r < Tkv && mask_b[k0 + r],
                         k0 + r + 8 < Tkv && mask_b[k0 + r + 8]};
  const char* res_k = res_chunk<T>(sm.res, cw, 0, ne, 0);
  const char* res_v = res_chunk<T>(sm.res, cw, 1, ne, 0);
  const Dropout dr = a.dr;
  const float inv_keep = 1.0f / dr.keep;
  auto take = [&](int& slot) -> const char* {
    slot = ring.stage;
    ring.wait_full();
    const char* c = ring.slot(kBytes);
    ring.advance();
    return c;
  };
  // the walked tile's natural chunk at `off` from its first (reuse)
  auto again = [&](int start, int off, int& slot) -> const char* {
    slot = (start + off) % p.stages;
    return ring.slots + (size_t)slot * kBytes;
  };
  mbar_wait(&res_full, 0);

  for (int o = 0; o < passes; ++o) {
    float dk[2][32], dv[2][32];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.0f;

    for (int q0 = 0; q0 < Tn; q0 += kTile) {
      const int start = ring.stage;
      float st[32], dp[32];  // s^T = k q^T and dp^T = v dout^T
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.0f;
      for (int e = 0; e < ne; ++e) {
        int sk, sq, sv, so;
        const char* ka = p.resident ? res_k + e * Op<T>::kPlaneBytes
                                    : take(sk);
        const char* qc = take(sq);
        const char* va = p.resident ? res_v + e * Op<T>::kPlaneBytes
                                    : take(sv);
        const char* oc = take(so);
        mma_chunk<T>(st, ka, qc);
        wgmma_commit();
        wgmma_wait();
        mma_chunk<T>(dp, va, oc);
        wgmma_commit();
        wgmma_wait();
        if (!p.resident) {
          ring.release(sk);
          ring.release(sv);
        }
        if (!(p.reuse && e / 2 == o)) {
          ring.release(sq);
          ring.release(so);
        }
      }
      // the score step: p = exp(s - lse) (0 past T), the dropout on p and
      // on g = dout v^T, ds = p (g - delta) with the undropped p; p_drop
      // into st and ds into dp, each rounded to T
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int query = q0 + 8 * jj + cq + c2;
          const bool q_in = query < Tn;
          const float lse_q = q_in ? lse_b[query] : 0.0f;
          const float delta_q = q_in ? delta_b[query] : 0.0f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = 4 * jj + 2 * i + c2;
            const float sv = kv_in[i] ? st[idx] : kNegInf;
            const float pr = q_in ? __expf(sv - lse_q) : 0.0f;
            float g = dp[idx];
            float p_drop = pr;
            if (dr.on) {
              const float mm =
                  kept(dr, bh, Tn, Tkv, query, k0 + r + 8 * i) ? inv_keep
                                                               : 0.0f;
              p_drop = pr * mm;
              g = g * mm;
            }
            st[idx] = rnd<T>(p_drop);
            dp[idx] = rnd<T>(pr * (g - delta_q));
          }
        }
      {  // dv += p_drop^T dout, then dk += ds^T q, the slab's two chunks
        int s1, s2;
        const char* b1 = p.reuse ? again(start, 2 * (2 * o) + 1, s1)
                                 : take(s1);
        const char* b2 = p.reuse ? again(start, 2 * (2 * o + 1) + 1, s2)
                                 : take(s2);
        mma_acc<T>(dv[0], st, b1);
        mma_acc<T>(dv[1], st, b2);
        wgmma_commit();
        wgmma_wait();
        ring.release(s1);
        ring.release(s2);
        b1 = p.reuse ? again(start, 2 * (2 * o), s1) : take(s1);
        b2 = p.reuse ? again(start, 2 * (2 * o + 1), s2) : take(s2);
        mma_acc<T>(dk[0], dp, b1);
        mma_acc<T>(dk[1], dp, b2);
        wgmma_commit();
        wgmma_wait();
        ring.release(s1);
        ring.release(s2);
      }
    }
    // this slab of dk and dv
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + r + 8 * i;
      if (row >= Tkv) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int col = (2 * o + c) * kTile + 8 * jj + cq + c2;
            if (col >= d) continue;
            dkb[(size_t)row * lda + col] =
                from_f<T>(own ? dk[c][4 * jj + 2 * i + c2] : 0.0f);
            dvb[(size_t)row * lda + col] =
                from_f<T>(own ? dv[c][4 * jj + 2 * i + c2] : 0.0f);
          }
    }
  }
}

// The layout of a split kernel with NC consumers and output slabs of NCH
// chunks, wanting `side` bytes of side copy; false when not even the
// streamed form's ring fits.  `bytes` gets the dynamic shared memory.
template <typename T>
bool split_plan(SplitPlan& p, int& bytes, const BwdArgs& a, int nc, int nch,
                int side) {
  constexpr int kStatic = 8 * (2 * kSplitStagesMax + 1);
  const int chunk = chunk_bytes<T>();
  const int ne = (a.d + kTile - 1) / kTile;
  const int res = nc * 2 * ne * Op<T>::kPlaneBytes;
  // resident while a ring of two slots (one walked chunk of each score
  // product) fits beside; streamed, a consumer holds four at once
  p.resident = ring_stages(kStatic + kStageBytes + kSmemAlign + res, chunk,
                           kSplitStagesMax) >= 2;
  if (!p.resident && nc > 1) return false;
  const int least = p.resident ? 2 : 4;
  const int base = kStageBytes + kSmemAlign + (p.resident ? res : 0);
  p.side = side_within(side, kStatic + base, chunk, least);
  const int fixed = base + ((p.side + 127) & ~127);
  p.stages = ring_stages(kStatic + fixed, chunk, kSplitStagesMax);
  p.direct = direct_rows(a.q, a.d, a.d, sizeof(T)) &&
             direct_rows(a.k, a.d, a.d, sizeof(T)) &&
             direct_rows(a.v, a.d, a.d, sizeof(T)) &&
             direct_rows(a.dout, a.d, a.d, sizeof(T));
  // the slab's chunks are the walked tile's own natural ones when each
  // slab chunk is one and the ring holds a whole tile
  p.reuse = sizeof(T) == 2 && p.resident && ne % nch == 0 &&
            p.stages >= 2 * ne;
  bytes = fixed + p.stages * chunk;
  return p.stages >= least;
}

template <typename T, int NCH, int NC>
cudaError_t launch_dq(const BwdArgs& a, int BH, cudaStream_t stream) {
  SplitPlan p;
  int bytes;
  if (!split_plan<T>(p, bytes, a, NC, NCH, side_bytes(a.Tkv, 0)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, NCH, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tn + kTile * NC - 1) / (kTile * NC), BH);
  flash_bwd_dq_kernel<T, NCH, NC><<<grid, kWg * (NC + 1), bytes, stream>>>(
      a, p);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkdv(const BwdArgs& a, int BH, cudaStream_t stream) {
  SplitPlan p;
  int bytes;
  if (!split_plan<T>(p, bytes, a, NC, 2, side_bytes(0, 2 * a.Tn)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tkv + kTile * NC - 1) / (kTile * NC), BH);
  flash_bwd_dkdv_kernel<T, NC><<<grid, kWg * (NC + 1), bytes, stream>>>(a, p);
  return cudaGetLastError();
}

// d <= 128: two consumers, which take the producer's spare registers
// (setmaxnreg; at 168 a thread ptxas serialized their wgmma and a dk/dv
// consumer spilled); a wider head one, the dq kernel's output slab 256
// columns.
template <typename T>
cudaError_t run_dq(const BwdArgs& a, int BH, cudaStream_t stream) {
  if (a.d <= 2 * kTile) return launch_dq<T, 2, 2>(a, BH, stream);
  return launch_dq<T, 4, 1>(a, BH, stream);
}

template <typename T>
cudaError_t run_dkdv(const BwdArgs& a, int BH, cudaStream_t stream) {
  if (a.d <= 2 * kTile) return launch_dkdv<T, 2>(a, BH, stream);
  return launch_dkdv<T, 1>(a, BH, stream);
}

bool bad_args(int BH, int H, int Tn, int Tkv, int d, float keep,
              int dropout) {
  return BH <= 0 || H <= 0 || BH % H || Tn <= 0 || Tkv <= 0 || d <= 0 ||
         d > kDHead || (dropout && !(keep > 0.0f));
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
