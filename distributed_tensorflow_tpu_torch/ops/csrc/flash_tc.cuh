// Tensor-core pieces of the bf16 kernels for Hopper (sm_90a):
// asynchronous tile loads into 128-byte-swizzled shared memory, wgmma
// descriptors and the wgmma forms the kernels use, and the tiles of the
// dropout keep bits that the forward emits (or the flash_bwd_keep pre-pass
// draws) for the backward kernels.
//
// A block is one warpgroup (128 threads) that owns 64 rows.  A tile of 64
// rows by D bf16 is held as ceil(D / 64) panels of 64 rows x 64 columns
// (128 bytes a row); 16-byte chunk c of row r sits at chunk c ^ (r % 8) of
// the row, the layout wgmma's 128-byte swizzle reads.  For D < 64 only the
// first D columns of a panel are written: products over the head dim run
// D / 16 k-steps, and outputs with the head dim as N run N = 64 and drop
// the columns past D.
//
// wgmma m64nNk16 accumulator layout (f32, N / 2 registers a thread):
// register 4j + 2i + c of thread (warp w, lane l) is row 16w + l/4 + 8i,
// column 8j + 2(l%4) + c.  Packing registers 4j..4j+3 of two neighbouring
// n8 blocks gives the bf16 A fragment of one k16 step, so a score tile
// feeds the next product from registers without a trip through memory.
#pragma once

#include "flash_common.cuh"

namespace dtt {
namespace tc {

constexpr int kThreadsTC = 128;        // one warpgroup
constexpr int kPanelBytes = 64 * 128;  // 64 rows x 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int panels() { return D > 64 ? D / 64 : 1; }
template <int D>
__host__ __device__ constexpr int tile_bytes() { return panels<D>() * kPanelBytes; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without the registers; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's completed cp.async writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows t0 .. t0+63 of head (b, h) into a swizzled tile; rows past seq are zeros.
template <int D>
__device__ __forceinline__ void load_tile_async(uint8_t* dst, const __nv_bfloat16* __restrict__ src,
                                                View v, int b, int h, int t0, int seq) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  const __nv_bfloat16* base = src + b * v.sb + h * v.sh;
  const uint32_t d0 = smem_u32(dst);
#pragma unroll
  for (int n = 0; n < 64 * CPR / kThreadsTC; ++n) {
    const int i = threadIdx.x + n * kThreadsTC, r = i / CPR, c = i % CPR, t = t0 + r;
    const uint32_t off = (c / 8) * kPanelBytes + r * 128 + (((c % 8) ^ (r & 7)) << 4);
    const bool in = t < seq;
    cp_async16(d0 + off, in ? base + (long long)t * v.st + c * 8 : base, in ? 16 : 0);
  }
}

// One entry of a (B, H, T) f32 row statistic: *dst = src[bh*seq + t], 0 past seq.
__device__ __forceinline__ void load_stat_async(float* dst, const float* __restrict__ src, int bh,
                                                int t, int seq) {
  const bool in = t < seq;
  cp_async4(smem_u32(dst), in ? src + (long long)bh * seq + t : src, in ? 4 : 0);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand.
__device__ __forceinline__ uint64_t desc_b128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}
// K-major (the k16 step's 16 columns contiguous in each row): step j of a
// panel starts 32 bytes further along the row; 8-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(const uint8_t* panel, int j) {
  return desc_b128(smem_u32(panel) + 32 * j, 16, 1024);
}
// MN-major (transposed: the k16 step runs down 16 rows): step j starts 16
// rows (2048 bytes) further; 8-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* panel, int j) {
  return desc_b128(smem_u32(panel) + 2048 * j, kPanelBytes, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DTT_ACC32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define DTT_OUT32(d)                                                                      \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),     \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),          \
      "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),       \
      "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),       \
      "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),       \
      "=f"(d[31])
#define DTT_ACC16(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define DTT_OUT16(d)                                                                      \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),     \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),          \
      "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
#define DTT_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define DTT_D32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64x64) = A (64x16, shared, K-major) * B (16x64, shared, K-major).  d is
// only written, so its registers are free before the product is issued.
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DTT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DTT_OUT32(d)
      : "l"(da), "l"(db), "n"(0));
}

// d (64x64) += A (64x16, shared, K-major) * B (16x64, shared, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DTT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DTT_ACC32(d)
      : "l"(da), "l"(db), "n"(1));
}

// The same two for a 64x32 d (N = 32).
__device__ __forceinline__ void wgmma_ss_first(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " DTT_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : DTT_OUT16(d)
      : "l"(da), "l"(db), "n"(0));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " DTT_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : DTT_ACC16(d)
      : "l"(da), "l"(db), "n"(1));
}

// d (64x64) += A (64x16, registers) * B (16x64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DTT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DTT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef DTT_D16
#undef DTT_OUT16
#undef DTT_ACC16
#undef DTT_D32
#undef DTT_OUT32
#undef DTT_ACC32

// d = A B^T over the head dim, N = 2R rows of B: A and B are swizzled
// 64-row tiles (B may start at row 32 of one), D / 16 k-steps.
template <int D, int R>
__device__ __forceinline__ void gemm_rows(float (&d)[R], const uint8_t* a, const uint8_t* b) {
  wgmma_ss_first(d, desc_k(a, 0), desc_k(b, 0));
#pragma unroll
  for (int j = 1; j < D / 16; ++j) {
    const int p = j / 4, jj = j % 4;
    wgmma_ss(d, desc_k(a + p * kPanelBytes, jj), desc_k(b + p * kPanelBytes, jj));
  }
}

// acc[p] += A (64 x 16KS from registers, a[k16 step]) * rows 16 kk0 ..
// 16 (kk0 + KS) - 1 of tile (64 rows x D, MN-major).
template <int D, int KS>
__device__ __forceinline__ void gemm_acc(float (&acc)[panels<D>()][32], const uint32_t (&a)[KS][4],
                                         const uint8_t* tile, int kk0) {
#pragma unroll
  for (int p = 0; p < panels<D>(); ++p)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs_t(acc[p], a[kk], desc_mn(tile + p * kPanelBytes, kk0 + kk));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragments of the k16 steps of a 64 x 2R accumulator tile.
template <int R>
__device__ __forceinline__ void to_a_frags(const float (&x)[R], uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// The 128 keep words of tile (query tile qt, key tile kt) in a buffer of
// n x n tiles a head (flash_bwd_keep.cu's layout; the forward writes it too).
template <typename W>
__device__ __forceinline__ W* keep_tile(W* bits, int bh, int qt, int kt, int n) {
  return bits + (((long long)bh * n + qt) * n + kt) * 128;
}

// Zeros the keep tiles kt0 .. n - 1 of row (bh, qt), the tiles a causal
// query tile does not reach, 16 bytes a thread.
__device__ __forceinline__ void zero_keep_tiles(uint32_t* bits, int bh, int qt, int kt0, int n) {
  uint4* z = reinterpret_cast<uint4*>(keep_tile(bits, bh, qt, kt0, n));
  for (int i = threadIdx.x; i < (n - kt0) * 32; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Copies a 512-byte keep tile to shared memory (threads 0..31, 16 bytes each).
__device__ __forceinline__ void load_keep_async(uint32_t* dst, const uint32_t* src) {
  if (threadIdx.x < 32) cp_async16(smem_u32(dst + 4 * threadIdx.x), src + 4 * threadIdx.x, 16);
}

// Stores an accumulator tile (rows t0.., columns p*64..) as bf16, dropping
// rows past seq and columns past D.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ dst, View v, int b, int h,
                                          int t0, int seq, const float (&acc)[panels<D>()][32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + r0 + 8 * i;
    if (t >= seq) continue;
    __nv_bfloat16* row = dst + b * v.sb + (long long)t * v.st + h * v.sh;
#pragma unroll
    for (int p = 0; p < panels<D>(); ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + c0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(acc[p][4 * j + 2 * i], acc[p][4 * j + 2 * i + 1]);
      }
  }
}

// 1024-byte aligned start of dynamic shared memory (the swizzle repeats
// every 8 rows of 128 bytes); launches ask for 1024 bytes more than they use.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

}  // namespace tc
}  // namespace dtt

// Returns LAUNCH(D) for a supported head dim; falls through otherwise.
#define DTT_HEAD_DIMS(head_dim, LAUNCH) \
  switch (head_dim) {                   \
    case 16: return LAUNCH(16);         \
    case 32: return LAUNCH(32);         \
    case 64: return LAUNCH(64);         \
    case 128: return LAUNCH(128);       \
  }
