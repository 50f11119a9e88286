// The Hopper (sm_90a) machinery of the flash forward (flash_fwd.cu) and
// the flash backward's fused and split forms (flash_bwd.cu): warpgroup
// products (wgmma), the ring of operand chunks that a producer warpgroup
// fills and the consumer warpgroups drain (mbarriers), and the conversions
// between device memory, the chunks, the accumulators and the register A
// operand.
//
// Chunks.  Every shared-memory operand is a chunk: 64 rows by 64 columns
// in wgmma's K-major layout without swizzle.  A row's 16-byte group g
// (columns [g*E, (g+1)*E), E = 16 / sizeof(element): 4 f32, 8 bf16) sits
// at g * 1024 + row * 16 bytes, so the 8-row core matrices are 128
// contiguous bytes, the next 8 rows 128 bytes on (SBO) and the next group
// along K 1024 bytes on (LBO).  A k-step of wgmma (16 bf16 or 8 tf32
// columns, two groups) starts 2048 bytes after the previous one.  An f32
// chunk has two planes 16 KB apart: hi = tf32(x) and lo = tf32(x - hi).
//
// Products, all m64n64 over a chunk's K of 64.  bf16: wgmma k16 bf16,
// f32 accumulate.  f32: 3xTF32 on wgmma k8 tf32: a b ~ a_hi b_hi + a_hi
// b_lo + a_lo b_hi, each term with an f32 sum (the dropped a_lo b_lo is
// 2^-22 of a b), PyTorch's own OpMultiplyAddFastF32 scheme.  B is always a
// chunk; A is a chunk too (mma_ss), or registers (mma_chunk: loaded from
// a raw chunk and split; mma_acc: converted from an accumulator).  tf32
// wgmma reads K-major operands only, and its register A layout takes
// columns (q, q+4) of a k-step where the accumulator holds (2q, 2q+1); so
// the B chunk of a product whose A comes from an accumulator stores
// column c of each group of 8 at (c >> 1) + 4 (c & 1) (the producer's
// kTransposedPermuted chunks).  bf16 needs no permutation.
//
// The producer copies a bf16 chunk whose rows are 8-byte aligned straight
// into its ring slot (cp.async, the slot's barrier counting the copies);
// any other chunk's 4-element units go into its own staging slots (16, 8
// or 4 bytes as the address allows, element loads for an odd head width in
// bf16) and are converted into a free ring slot (the tf32 split, the
// transpose, zeros past the edges), fenced for wgmma and announced on the
// slot's full barrier.  A raw chunk (kRaw) is an f32 chunk left unsplit,
// one plane, for a consumer that splits it as a register A operand
// (mma_chunk); in bf16 raw and natural are the same chunk.

#pragma once

#include "flash_common.cuh"

namespace {

constexpr int kWg = 128;              // threads of a warpgroup
constexpr int kGroupBytes = 1024;     // LBO: the next 16-byte group along K
constexpr int kStepBytes = 2048;      // the next wgmma k-step
constexpr int kSmemMax = 232448;      // an H100 block's shared memory
constexpr int kSmemAlign = 128;

// Per element type: chunk planes (tf32 hi and lo, or bf16) and bytes.
template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int kPlanes = 2;
  static constexpr int kPlaneBytes = kTile * kTile * 4;
};
template <>
struct Op<__nv_bfloat16> {
  static constexpr int kPlanes = 1;
  static constexpr int kPlaneBytes = kTile * kTile * 2;
};
template <typename T>
__host__ __device__ constexpr int chunk_bytes() {
  return Op<T>::kPlanes * Op<T>::kPlaneBytes;
}

// Ring slots of `bytes` each that fit beside `fixed` bytes, at most `most`.
__host__ __device__ constexpr int ring_stages(int fixed, int bytes,
                                             int most) {
  return (kSmemMax - fixed) / bytes < most ? (kSmemMax - fixed) / bytes
                                            : most;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma descriptor of the K-major, unswizzled operand at `p`: LBO 1024,
// SBO 128 (chunk layout above).
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)(kGroupBytes >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

// The descriptor of a bf16 natural chunk read as an MN-major B operand
// (its rows the K dimension, its columns N): 8 columns of N are 16
// contiguous bytes, the next 8 rows along K 128 bytes on (LBO), the next 8
// columns of N 1024 bytes on (SBO); a k16 step is 16 rows, 256 bytes.
constexpr int kStepBytesMn = 256;
__device__ __forceinline__ uint64_t gmma_desc_mn(const void* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(kGroupBytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Each product helper below fences (wgmma.fence) after writing a k-step's
// A registers and before its wgmma, as the accumulator's and A's
// registers written by other instructions require; its caller commits and
// waits before touching the accumulator again.

// One m64n64 wgmma of each operand form: `shape` its shape and types, the
// immediates after the scale-d predicate in `imm` (scale a, scale b, and
// for 16-bit types the transpose bits: A's in the SS form, then B's).
// Operands 0-31 are the accumulator d[32], in the layout of m64n64
// (d[4j + 2i + c] = D[16w + lane/4 + 8i][8j + 2(lane%4) + c]).
#define PVA_WGMMA_ACC                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define PVA_WGMMA_ACC_OPERANDS(d)                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
      "+f"(d[30]), "+f"(d[31])

// d[32] += a b: A (64 x k-step) in registers (a[4]), B a descriptor.
template <typename T, int kTransB = 0>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc);
#define PVA_WGMMA_RS(T, kTransB, shape, imm)                             \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_rs<T, kTransB>(                  \
      float* d, const uint32_t* a, uint64_t desc) {                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"            \
                 "wgmma.mma_async.sync.aligned." shape " " PVA_WGMMA_ACC \
                 ", {%32, %33, %34, %35}, %36, p, " imm ";\n}\n"         \
                 : PVA_WGMMA_ACC_OPERANDS(d)                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),          \
                   "l"(desc), "r"(1));                                   \
  }
PVA_WGMMA_RS(float, 0, "m64n64k8.f32.tf32.tf32", "1, 1")
PVA_WGMMA_RS(__nv_bfloat16, 0, "m64n64k16.f32.bf16.bf16", "1, 1, 0")
// bf16 with B MN-major (trans-b): a natural chunk read as its transpose.
PVA_WGMMA_RS(__nv_bfloat16, 1, "m64n64k16.f32.bf16.bf16", "1, 1, 1")
#undef PVA_WGMMA_RS

// d[32] += a b, both operands 64 x k-step in shared memory (descriptors).
template <typename T, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db);
#define PVA_WGMMA_SS(T, kTransB, shape, imm)                             \
  template <>                                                            \
  __device__ __forceinline__ void wgmma_ss<T, kTransB>(                  \
      float* d, uint64_t da, uint64_t db) {                              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"            \
                 "wgmma.mma_async.sync.aligned." shape " " PVA_WGMMA_ACC \
                 ", %32, %33, p, " imm ";\n}\n"                          \
                 : PVA_WGMMA_ACC_OPERANDS(d)                             \
                 : "l"(da), "l"(db), "r"(1));                            \
  }
PVA_WGMMA_SS(float, 0, "m64n64k8.f32.tf32.tf32", "1, 1")
PVA_WGMMA_SS(__nv_bfloat16, 0, "m64n64k16.f32.bf16.bf16", "1, 1, 0, 0")
PVA_WGMMA_SS(__nv_bfloat16, 1, "m64n64k16.f32.bf16.bf16", "1, 1, 0, 1")
#undef PVA_WGMMA_SS
#undef PVA_WGMMA_ACC_OPERANDS
#undef PVA_WGMMA_ACC

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Spins until the barrier's phase of parity `parity` completes.  A wait
// that outlasts 2^24 polls (seconds) traps, so a broken ring fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) asm volatile("trap;");
  }
}
// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The warpgroup's registers a thread set to N (setmaxnreg): a block of a
// producer and two consumer warpgroups starts at 168 each (384 threads),
// and the producer, which holds no accumulator, hands the consumers all
// but 24 of its own: 24 + 2 * 240 = 3 * 168.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// A barrier of the `count` threads of named barrier `id` (1.. ; 0 is
// __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The ring: `stages` chunk slots, each with a full barrier (the producer
// warpgroup's 128 threads arrive) and an empty one (each consumer warp
// arrives once).  Producer and consumers walk the same sequence of chunks,
// each with its own Ring cursor.
struct Ring {
  char* slots;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ char* slot(int bytes) const {
    return slots + (size_t)stage * bytes;
  }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // producer: wait until the slot is free (the first lap passes at once)
  __device__ __forceinline__ void wait_empty() {
    mbar_wait(&empty[stage], phase ^ 1);
  }
  __device__ __forceinline__ void fill() {
    fence_async_smem();
    mbar_arrive(&full[stage]);
    advance();
  }
  // consumer
  __device__ __forceinline__ void wait_full() {
    mbar_wait(&full[stage], phase);
  }
  __device__ __forceinline__ void release(int slot_stage) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot_stage]);
  }
};

// The dynamic shared memory from its first kSmemAlign-aligned byte (the
// launch asks for kSmemAlign bytes more than it uses).
__device__ __forceinline__ char* aligned_smem(char* base) {
  const uint32_t off = smem_u32(base);
  return base + (((off + kSmemAlign - 1) & ~(uint32_t)(kSmemAlign - 1)) - off);
}

// ------------------------------------------------------------ tf32 split

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ------------------------------------------------- producer: chunk writes

// The unit i (0..1023) of a chunk written by 4 elements: row and 4-column
// group, 8 rows a warp's quarter so that a quarter's 16-byte stores hit
// every bank once.  A producer that gives its registers to its consumers
// (the split backward's, setmaxnreg) walks a thread's 8 units as a loop
// (kLean); the others unroll it.
__device__ __forceinline__ int unit_row(int i) {
  return (i & 7) | (((i >> 5) & 7) << 3);
}
__device__ __forceinline__ int unit_group(int i) {
  return ((i >> 3) & 3) | ((i >> 8) << 2);
}

// Chunk row n, columns 4g..4g+3 from v (the chunk's own layout), as tf32
// hi and lo planes (f32, split) or raw f32 (f32, !split) or bf16.
template <typename T, bool kSplit>
__device__ __forceinline__ void put4(char* chunk, int n, int g,
                                     const float v[4]);
template <>
__device__ __forceinline__ void put4<float, true>(char* chunk, int n, int g,
                                                  const float v[4]) {
  uint4 hi, lo;
  split_tf32(v[0], hi.x, lo.x);
  split_tf32(v[1], hi.y, lo.y);
  split_tf32(v[2], hi.z, lo.z);
  split_tf32(v[3], hi.w, lo.w);
  char* p = chunk + g * kGroupBytes + n * 16;
  *reinterpret_cast<uint4*>(p) = hi;
  *reinterpret_cast<uint4*>(p + Op<float>::kPlaneBytes) = lo;
}
template <>
__device__ __forceinline__ void put4<float, false>(char* chunk, int n, int g,
                                                   const float v[4]) {
  *reinterpret_cast<float4*>(chunk + g * kGroupBytes + n * 16) =
      make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void put4<__nv_bfloat16, false>(char* chunk, int n,
                                                           int g,
                                                           const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const uint32_t*>(&a);
  x.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(chunk + (g >> 1) * kGroupBytes + n * 16 +
                            (g & 1) * 8) = x;
}
template <>
__device__ __forceinline__ void put4<__nv_bfloat16, true>(char* chunk, int n,
                                                          int g,
                                                          const float v[4]) {
  put4<__nv_bfloat16, false>(chunk, n, g, v);
}

// One element (chunk row n, column k) of the chunk: hi and lo (f32) or the
// value (bf16).
__device__ __forceinline__ void put1(char* chunk, int n, int k, float v) {
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  char* p = chunk + (k >> 2) * kGroupBytes + n * 16 + (k & 3) * 4;
  *reinterpret_cast<uint32_t*>(p) = hi;
  *reinterpret_cast<uint32_t*>(p + Op<float>::kPlaneBytes) = lo;
}
__device__ __forceinline__ void put1(char* chunk, int n, int k,
                                     __nv_bfloat16 v) {
  *reinterpret_cast<__nv_bfloat16*>(chunk + (k >> 3) * kGroupBytes + n * 16 +
                                    (k & 7) * 2) = v;
}

// ------------------------------------------ producer: cp.async staging

// A chunk's raw units in a thread's own staging slots: unit i (thread tid
// = i % 128) at i * 16 bytes, so a thread reads back only what it copied.
constexpr int kStageBytes = 8 * kWg * 16;

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copies of this thread's 8 units of the chunk of rows [r0, r0
// + 64) and columns [c0, c0 + 64) of the row-major `src` (row stride ld)
// into `stage`: one cp.async of the unit's 4 elements (16 bytes f32, 8
// bf16) where the address allows, two of half that, or, for an odd head
// width in bf16 and the ragged edge, element loads; zero past `rows` and
// at columns >= `cols` (relative to c0).
template <bool kLean = false, typename T>
__device__ __forceinline__ void stage_chunk(char* stage,
                                            const T* __restrict__ src,
                                            int ld, int r0, int rows, int c0,
                                            int cols, int tid) {
  constexpr int kB = 4 * sizeof(T);
#pragma unroll(kLean ? 1 : 8)
  for (int it = 0; it < 8; ++it) {
    const int i = tid + kWg * it;
    const int n = unit_row(i);
    const int g = unit_group(i);
    char* dst = stage + i * 16;
    const int w = cols - 4 * g;
    if (r0 + n >= rows || w <= 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const T* p = src + (size_t)(r0 + n) * ld + c0 + 4 * g;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if (w >= 4 && a % kB == 0) {
      cp_async<kB>(dst, p);
    } else if (w >= 4 && a % (kB / 2) == 0) {
      cp_async<kB / 2>(dst, p);
      cp_async<kB / 2>(dst + kB / 2, p + 2);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = e < w ? p[e] : from_f<T>(0.0f);
    }
  }
}

// This thread's unit i back from its staging slots, as f32.
__device__ __forceinline__ void unstage(const char* stage, int i, float v[4],
                                        float) {
  const float4 x = *reinterpret_cast<const float4*>(stage + i * 16);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void unstage(const char* stage, int i, float v[4],
                                        __nv_bfloat16) {
  const uint2 x = *reinterpret_cast<const uint2*>(stage + i * 16);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// A bf16 chunk straight into the ring slot, for rows whose 4-element
// units are 8-byte aligned: unit (n, g) lands at its place in the chunk
// ((g >> 1) * 1024 + n * 16 + (g & 1) * 8) by one 8-byte cp.async, the
// ragged edge zero-filled by the copy itself (a shorter source size), and
// the slot's full barrier takes each thread's arrival once its copies
// land (cp.async.mbarrier.arrive.noinc): the producer never waits for
// them, so every ring slot can have its loads in flight.
template <bool kLean = false>
__device__ __forceinline__ void push_direct(Ring& ring,
                                            const __nv_bfloat16* src, int ld,
                                            int r0, int rows, int c0,
                                            int cols, int tid) {
  ring.wait_empty();
  char* chunk = ring.slot(chunk_bytes<__nv_bfloat16>());
#pragma unroll(kLean ? 1 : 8)
  for (int it = 0; it < 8; ++it) {
    const int i = tid + kWg * it;
    const int n = unit_row(i);
    const int g = unit_group(i);
    const int w = cols - 4 * g;
    const bool in = r0 + n < rows && w > 0;
    const __nv_bfloat16* p =
        in ? src + (size_t)(r0 + n) * ld + c0 + 4 * g : src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_u32(chunk + (g >> 1) * kGroupBytes + n * 16 +
                              (g & 1) * 8)),
                 "l"(p), "r"(in ? 2 * min(w, 4) : 0)
                 : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(&ring.full[ring.stage]))
               : "memory");
  ring.advance();
}

// One chunk into the ring: with `direct` (bf16, aligned rows) push_direct;
// else its copies (cp.async, into the thread's own staging slots), then,
// once they land, the conversion into the next free ring slot (tf32 hi
// and lo, the transpose) and the slot's fill.  Copies started ahead of
// the conversion (a deeper staging) measured slower on an H100: the
// conversion's shared-memory accesses then queue behind them.  A bf16
// chunk is always natural: the products read it transposed (MN-major).
enum ChunkKind { kNatural, kTransposed, kTransposedPermuted, kRaw };
template <bool kLean = false, typename T>
__device__ __forceinline__ void push_chunk(Ring& ring, char* stage,
                                           const T* src, int ld, int r0,
                                           int rows, int c0, int cols,
                                           int kind, bool direct, int tid) {
  if constexpr (Op<T>::kPlanes == 1) {
    kind = kNatural;
    if (direct) {
      push_direct<kLean>(ring, src, ld, r0, rows, c0, cols, tid);
      return;
    }
  }
  stage_chunk<kLean>(stage, src, ld, r0, rows, c0, cols, tid);
  cp_async_commit();
  cp_async_wait<0>();
  ring.wait_empty();
  char* chunk = ring.slot(chunk_bytes<T>());
#pragma unroll(kLean ? 1 : 8)
  for (int it = 0; it < 8; ++it) {
    const int i = tid + kWg * it;
    float v[4];
    unstage(stage, i, v, T());
    if (kind == kNatural) {
      put4<T, true>(chunk, unit_row(i), unit_group(i), v);
    } else if (kind == kRaw) {
      put4<T, false>(chunk, unit_row(i), unit_group(i), v);
    } else {
      const int k = unit_row(i);
      const int g = unit_group(i);
      const int kk = kind == kTransposedPermuted
                         ? (k & ~7) | ((k & 7) >> 1) | ((k & 1) << 2)
                         : k;
#pragma unroll
      for (int e = 0; e < 4; ++e) put1(chunk, 4 * g + e, kk, from_f<T>(v[e]));
    }
  }
  ring.fill();
}

// The raw chunk (f32 unsplit, or bf16) of rows [r0, r0 + 64) and columns
// [c0, c0 + 64) of the row-major `src` at `chunk`, outside the ring: a
// consumer's resident A operand, written by the producer through its
// staging slots (zero past `rows` and `cols`); the caller announces it.
template <bool kLean = false, typename T>
__device__ __forceinline__ void put_raw_chunk(char* chunk, char* stage,
                                              const T* src, int ld, int r0,
                                              int rows, int c0, int cols,
                                              int tid) {
  stage_chunk<kLean>(stage, src, ld, r0, rows, c0, cols, tid);
  cp_async_commit();
  cp_async_wait<0>();
#pragma unroll(kLean ? 1 : 8)
  for (int it = 0; it < 8; ++it) {
    const int i = tid + kWg * it;
    float v[4];
    unstage(stage, i, v, T());
    put4<T, false>(chunk, unit_row(i), unit_group(i), v);
  }
}

// Whether a bf16 operand's chunks can take push_direct: every row's units
// 8-byte aligned (the base, the row stride and d multiples of 4 elements).
__host__ __device__ __forceinline__ bool direct_rows(const void* p, int ld,
                                                    int d, int elem) {
  return elem == 2 && reinterpret_cast<uintptr_t>(p) % 8 == 0 &&
         ld % 4 == 0 && d % 4 == 0;
}

// Per-video data that every tile reads -- the key mask and, in the
// backward, lse and delta -- copied by the producer into shared memory
// once, when it fits in kSideMax bytes, so that the tile loops read no
// device memory for it; a longer video is read in place, through the same
// generic pointers.
constexpr int kSideMax = 32 * 1024;
// Bytes of a key mask of Tkv and `floats` f32 values, or 0 past kSideMax.
__host__ __device__ __forceinline__ int side_bytes(int Tkv, int floats) {
  const int n = ((Tkv + 15) & ~15) + 4 * floats;
  return n <= kSideMax ? n : 0;
}
// `side` when it, `fixed` bytes and `least` ring slots of `bytes` fit in a
// block's shared memory together, else 0: the ring comes first, and a
// video whose side copy would crowd it out is read in place.
__host__ __forceinline__ int side_within(int side, int fixed, int bytes,
                                         int least) {
  return ring_stages(fixed + ((side + 127) & ~127), bytes, least) < least
             ? 0
             : side;
}
// Copies n elements (tid 0..127 of the producer); the caller syncs.
template <typename U>
__device__ __forceinline__ void copy_side(U* dst, const U* __restrict__ src,
                                          int n, int tid) {
  for (int i = tid; i < n; i += kWg) dst[i] = src[i];
}

// ------------------------------------------ consumer: register A operands

// A fragment of k-step s from a chunk whose rows are A's rows (row r =
// 16 * warp + lane / 4 of the warpgroup, column q = lane % 4): the four
// 32-bit words at columns (q, q + 4) of the step (tf32) or (2q, 2q + 1)
// and (2q + 8, 2q + 9) (bf16), rows r and r + 8.  An f32 chunk's raw
// plane is split into tf32 hi and lo here.
__device__ __forceinline__ void frag_f32(const char* chunk, int s,
                                         uint32_t hi[4], uint32_t lo[4]) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const char* p = chunk + s * kStepBytes + r * 16 + (lane & 3) * 4;
  const int off[4] = {0, 128, kGroupBytes, kGroupBytes + 128};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32(*reinterpret_cast<const float*>(p + off[i]), hi[i], lo[i]);
}
__device__ __forceinline__ void frag_bf16(const char* chunk, int s,
                                          uint32_t a[4]) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const char* p = chunk + s * kStepBytes + r * 16 + (lane & 3) * 4;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 128);
  a[2] = *reinterpret_cast<const uint32_t*>(p + kGroupBytes);
  a[3] = *reinterpret_cast<const uint32_t*>(p + kGroupBytes + 128);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The products below are m64n64 over a K of 64 (a chunk: 4 bf16 or 8
// tf32 k-steps, fully unrolled, so that no wgmma sits behind a run-time
// branch or loop); columns past d are zero in both operands.  An f32
// product waits for its wgmmas every kF32Group k-steps: the A registers
// (hi and lo, 8 a step) of every wgmma in flight stay allocated, and eight
// steps' worth beside the accumulators would exceed the registers, which
// makes the compiler serialize every wgmma.
constexpr int kF32Group = 2;

// c[32] += A B, A from a chunk (rows = A's rows; raw, split here in f32),
// B the chunk b: 3xTF32 or bf16.
template <typename T>
__device__ __forceinline__ void mma_chunk(float* c, const char* a,
                                          const char* b) {
  const uint64_t bd = gmma_desc(b);
  if constexpr (Op<T>::kPlanes == 2) {
    const uint64_t bl = gmma_desc(b + Op<float>::kPlaneBytes);
#pragma unroll
    for (int s = 0; s < kTile / 8; ++s) {
      uint32_t hi[4], lo[4];
      frag_f32(a, s, hi, lo);
      const uint64_t o = (uint64_t)((s * kStepBytes) >> 4);
      wgmma_fence();
      wgmma_rs<float>(c, hi, bd + o);
      wgmma_rs<float>(c, hi, bl + o);
      wgmma_rs<float>(c, lo, bd + o);
      if (s % kF32Group == kF32Group - 1) {
        wgmma_commit();
        wgmma_wait();
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < kTile / 16; ++s) {
      uint32_t f[4];
      frag_bf16(a, s, f);
      wgmma_fence();
      wgmma_rs<__nv_bfloat16>(c, f,
                                  bd + (uint64_t)((s * kStepBytes) >> 4));
    }
  }
}

// c[32] += A B, A converted from the accumulator `p` of an m64n64 product
// over K = its 64 columns, B the chunk b holding B's K rows: in f32 split
// into tf32 hi and lo, b a transposed chunk stored permuted (its rows are
// B's N, K-major); in bf16 rounded, b a natural chunk (its rows are B's
// K) read MN-major.
template <typename T>
__device__ __forceinline__ void mma_acc(float* c, const float* p,
                                        const char* b) {
  if constexpr (Op<T>::kPlanes == 2) {
    const uint64_t bh = gmma_desc(b);
    const uint64_t bl = gmma_desc(b + Op<float>::kPlaneBytes);
#pragma unroll
    for (int s = 0; s < kTile / 8; ++s) {
      uint32_t hi[4], lo[4];
      split_tf32(p[4 * s + 0], hi[0], lo[0]);
      split_tf32(p[4 * s + 2], hi[1], lo[1]);
      split_tf32(p[4 * s + 1], hi[2], lo[2]);
      split_tf32(p[4 * s + 3], hi[3], lo[3]);
      const uint64_t o = (uint64_t)((s * kStepBytes) >> 4);
      wgmma_fence();
      wgmma_rs<float>(c, hi, bh + o);
      wgmma_rs<float>(c, hi, bl + o);
      wgmma_rs<float>(c, lo, bh + o);
      if (s % kF32Group == kF32Group - 1) {
        wgmma_commit();
        wgmma_wait();
      }
    }
  } else {
    const uint64_t bd = gmma_desc_mn(b);
#pragma unroll
    for (int s = 0; s < kTile / 16; ++s) {
      uint32_t a[4];
      a[0] = pack_bf16(p[8 * s + 0], p[8 * s + 1]);
      a[1] = pack_bf16(p[8 * s + 2], p[8 * s + 3]);
      a[2] = pack_bf16(p[8 * s + 4], p[8 * s + 5]);
      a[3] = pack_bf16(p[8 * s + 6], p[8 * s + 7]);
      wgmma_fence();
      wgmma_rs<__nv_bfloat16, 1>(c, a,
                                 bd + (uint64_t)((s * kStepBytesMn) >> 4));
    }
  }
}

// c[32] += A B with both from chunks in shared memory (A's rows the
// chunk's rows, hi and lo planes in f32): no A registers, so the products
// of a whole chunk issue back to back.  kTransB: B is stored as the
// operand it is the transpose of -- in f32 a transposed chunk (K-major,
// as always), in bf16 the natural chunk read MN-major.  The caller fences
// before (the accumulator was written) and commits and waits after.
template <typename T, bool kTransB = false>
__device__ __forceinline__ void mma_ss(float* c, const char* a,
                                       const char* b) {
  const uint64_t ad = gmma_desc(a);
  const uint64_t bd = kTransB && Op<T>::kPlanes == 1 ? gmma_desc_mn(b)
                                                     : gmma_desc(b);
  if constexpr (Op<T>::kPlanes == 2) {
    const uint64_t al = gmma_desc(a + Op<float>::kPlaneBytes);
    const uint64_t bl = gmma_desc(b + Op<float>::kPlaneBytes);
#pragma unroll
    for (int s = 0; s < kTile / 8; ++s) {
      const uint64_t o = (uint64_t)((s * kStepBytes) >> 4);
      wgmma_ss<float>(c, ad + o, bd + o);
      wgmma_ss<float>(c, ad + o, bl + o);
      wgmma_ss<float>(c, al + o, bd + o);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kTile / 16; ++s) {
      const uint64_t o = (uint64_t)((s * kStepBytes) >> 4);
      if constexpr (kTransB)
        wgmma_ss<__nv_bfloat16, 1>(
            c, ad + o, bd + (uint64_t)((s * kStepBytesMn) >> 4));
      else
        wgmma_ss<__nv_bfloat16>(c, ad + o, bd + o);
    }
  }
}

// Whether key tile j ([64j, 64j + 64)) of the video's mask holds an
// attendable key.  Every lane of the warp calls it and gets the answer.
__device__ __forceinline__ bool tile_has_key(
    const unsigned char* __restrict__ mask_b, int j, int Tkv) {
  const int k = kTile * j + 2 * (threadIdx.x & 31);
  const bool any = (k < Tkv && mask_b[k]) || (k + 1 < Tkv && mask_b[k + 1]);
  // broadcast from lane 0, so that the compiler sees a warp-uniform value
  return __shfl_sync(0xffffffffu, (int)__any_sync(0xffffffffu, any), 0);
}

// The accumulator's rows and columns of this thread in an m64nN product:
// rows r and r + 8, columns 8j + 2c + {0, 1}.
__device__ __forceinline__ int acc_row() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int acc_col() { return 2 * (threadIdx.x & 3); }

}  // namespace
