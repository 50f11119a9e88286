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
// T=4096, d=100): in bf16 0.27 ms at the tensor cores' 989 TFLOP/s; in
// f32, as 3xTF32's three products, 1.63 ms at TF32's 495 TFLOP/s (4.0 ms
// at f32's 67 TFLOP/s outside the tensor cores) -- against about 60 MB of
// operands and gradients in f32 (18 us at 3.35 TB/s): operations.
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
//    point): one block per (key tile, b*h) walks the query tiles for dk
//    and dv; one block per (query tile, b*h) walks the key tiles for dq.
//    Twice the score step, no scratch; ops/flash.py::use_fused picks it
//    for videos whose fused scratch would pass its budget.  Its products
//    are SIMT f32 FMAs on 64 x 64 tiles in shared memory (flash_simt.cuh),
//    a head wider than 128 walked in slabs of 128 columns, each output
//    slab a pass of its own that recomputes the score step.
//  * The head-major flat layout [B, T, H*d] differs only in where a head's
//    rows start and their stride (BwdArgs::bthd, flash_common.cuh::
//    head_base); a chunk's partial dq takes dq's layout, so the reduction
//    is the same elementwise sum.

#include "flash_simt.cuh"
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
