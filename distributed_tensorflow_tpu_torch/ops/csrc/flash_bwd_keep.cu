// Flash-attention backward pre-pass, the dropout keep bits, for Hopper.
//
// Part of _flash_bwd_tpu (:755 of distributed_tensorflow_tpu/ops/
// flash_attention.py), whose dQ (:831) and dK/dV (:905) kernels each redraw
// the dropout mask of every tile they visit (_tile_dropout, :158).  In
// training the forward kernel writes these bits as it draws them; this
// kernel draws them the same way (Philox-4x32-10 counted by element
// position, flash_common.cuh) for callers of the backward kernels that
// have no forward's bits, into the layout both backward kernels read:
//   bits[bh][qt][kt][2 r + w], bit i = keep of query 64 qt + r, key 64 kt + 32 w + i,
// a 512-byte tile for each pair of 64-query and 64-key tiles; tiles a causal
// row does not reach are 0.
//
// Bound on the card: the Philox rounds on the CUDA cores (one draw of ten
// rounds for every 4 (query, key) pairs); the bits written are 1/32 of a
// float mask.  One block per (batch*head, query tile), 128 threads, each
// drawing the 8 x 4 bits of one word per key tile.
#include "flash_tc.cuh"

namespace dtt {

// Word w of query row q0 + r of the tile at keys k0.. (k0 a multiple of 64):
// bit i keeps key k0 + 32 w + i, one Philox draw per 4 keys as dropout4
// draws them.  A thread t of 128 gives word t = 2 r + w of the tile.
__device__ __forceinline__ uint32_t keep_word(const Dropout& dr, int bh, int q0, int k0) {
  const int t = threadIdx.x, r = t >> 1, w = t & 1;
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 x = philox4x32_10(
        make_uint4((uint32_t)((k0 >> 2) + 8 * w + i), (uint32_t)(q0 + r), (uint32_t)bh, 0u),
        dr.key0, dr.key1);
    bits |= ((uint32_t)(x.x >= dr.thresh) | (uint32_t)(x.y >= dr.thresh) << 1 |
             (uint32_t)(x.z >= dr.thresh) << 2 | (uint32_t)(x.w >= dr.thresh) << 3)
            << (4 * i);
  }
  return bits;
}

__global__ void __launch_bounds__(tc::kThreadsTC)
    flash_bwd_keep_kernel(uint32_t* __restrict__ bits, int seq, int causal, Dropout dr) {
  const int bh = blockIdx.x, qt = blockIdx.y, n_t = gridDim.y, q0 = qt * 64;
  const int n_kt = key_tiles(q0, seq, causal);
  uint32_t* row = bits + ((long long)bh * n_t + qt) * n_t * 128;
  for (int kt = 0; kt < n_t; ++kt)
    row[kt * 128 + threadIdx.x] = kt < n_kt ? keep_word(dr, bh, q0, kt * 64) : 0u;
}

}  // namespace dtt

// bits: (B*H, n, n, 128) uint32 with n = ceil(seq / 64).  Keep iff the
// 32-bit draw >= drop_thresh, keyed by (seed_lo, seed_hi).  Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int dtt_flash_bwd_keep(unsigned int* bits, int B, int H, int seq, int causal,
                                  unsigned int seed_lo, unsigned int seed_hi,
                                  unsigned int drop_thresh, void* stream) {
  using namespace dtt;
  const Dropout dr{seed_lo, seed_hi, drop_thresh, 1.f, 1};
  const dim3 grid(B * H, (seq + 63) / 64);
  flash_bwd_keep_kernel<<<grid, tc::kThreadsTC, 0, (cudaStream_t)stream>>>(bits, seq, causal, dr);
  return (int)cudaGetLastError();
}
