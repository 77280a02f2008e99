// Shared pieces of the flash-attention kernels for Hopper (sm_90a):
// element conversion, strided tile loads, the row reductions of a 16-lane
// thread group, and the Philox-4x32-10 dropout mask.
//
// The float32 kernels run 256 threads on 64-row tiles (the bf16 kernels'
// pieces are in flash_tc.cuh).  A thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty*4 .. ty*4+3 of a 64x64 score tile and columns tx*4 ..
// tx*4+3, and columns tx + 16*e of a 64xD output tile.  Tiles live in
// shared memory as f32 (rows padded by one word against bank conflicts) and
// all arithmetic is f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dtt {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;

// A (B, T, H, D) tensor read through its strides (in elements); the head
// dim D is contiguous.
struct View {
  long long sb, st, sh;
};

struct Dropout {
  uint32_t key0, key1;  // Philox key: the 64-bit seed
  uint32_t thresh;      // keep iff the 32-bit draw >= thresh (P = 1 - rate)
  float scale;          // 1 / (1 - rate)
  int on;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// dst[r * LD + d] = src[b, t0 + r, h, d] for r < 64, zero past the end.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          View v, int b, int h, int t0, int seq) {
  const float* base = src + b * v.sb + h * v.sh;
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    dst[r * LD + d] = t < seq ? base[(long long)t * v.st + d] : 0.f;
  }
}

// Reductions over the 16 lanes (one tx group) that share a row.
__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Philox-4x32-10 (Salmon et al., SC'11; Random123's constants).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Keep-scales of keys 4*k4 .. 4*k4+3 for query row q of head bh.  The
// counter is the element's position (k4, q, bh, 0) and word j belongs to
// key 4*k4+j, so the mask does not depend on the tiling and the plain
// PyTorch version rebuilds it bit for bit.
__device__ __forceinline__ void dropout4(const Dropout& dr, int bh, int q, int k4, float out[4]) {
  const uint4 r = philox4x32_10(make_uint4((uint32_t)k4, (uint32_t)q, (uint32_t)bh, 0u),
                                dr.key0, dr.key1);
  out[0] = r.x >= dr.thresh ? dr.scale : 0.f;
  out[1] = r.y >= dr.thresh ? dr.scale : 0.f;
  out[2] = r.z >= dr.thresh ? dr.scale : 0.f;
  out[3] = r.w >= dr.thresh ? dr.scale : 0.f;
}

__device__ __forceinline__ bool key_ok(const int* __restrict__ kv_mask, int b, int seq, int q,
                                       int k, int causal) {
  return q < seq && k < seq && (!causal || k <= q) &&
         (kv_mask == nullptr || kv_mask[(long long)b * seq + k] > 0);
}

// Number of 64-key tiles a 64-query tile starting at q0 reads.
__device__ __forceinline__ int key_tiles(int q0, int seq, int causal) {
  int n = (seq + kBlockK - 1) / kBlockK;
  if (causal) n = min(n, (q0 + kBlockQ - 1) / kBlockK + 1);
  return n;
}

template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, View v, int b, int h, int t0,
                                           int seq, const float (&acc)[4][D / 16]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= seq) continue;
    float* row = dst + b * v.sb + (long long)t * v.st + h * v.sh;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) row[tx + 16 * e] = acc[i][e];
  }
}

}  // namespace dtt

// Instantiates LAUNCH(T, D) for the supported element types and head dims;
// returns cudaErrorInvalidValue for anything else.
#define DTT_DISPATCH(dtype, head_dim, LAUNCH)                        \
  do {                                                               \
    if ((dtype) == 0) {                                              \
      switch (head_dim) {                                            \
        case 16: return LAUNCH(float, 16);                           \
        case 32: return LAUNCH(float, 32);                           \
        case 64: return LAUNCH(float, 64);                           \
        case 128: return LAUNCH(float, 128);                         \
      }                                                              \
    } else if ((dtype) == 1) {                                       \
      switch (head_dim) {                                            \
        case 16: return LAUNCH(__nv_bfloat16, 16);                   \
        case 32: return LAUNCH(__nv_bfloat16, 32);                   \
        case 64: return LAUNCH(__nv_bfloat16, 64);                   \
        case 128: return LAUNCH(__nv_bfloat16, 128);                 \
      }                                                              \
    }                                                                \
    return (int)cudaErrorInvalidValue;                               \
  } while (0)
