// Flash-attention backward pre-pass, Delta, for Hopper.
//
// Part of _flash_bwd_tpu (:755 of distributed_tensorflow_tpu/ops/
// flash_attention.py), whose dQ (:831) and dK/dV (:905) kernels each compute
// rowsum(dO * O) for the tiles they visit.  In training the dQ kernel
// computes it for its rows (in this kernel's order, so to the same bits)
// and hands it to dK/dV; this kernel computes it for callers with no dQ
// before them, into the (B, H, T) float32 buffer both backward kernels read:
//   Delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] - g_lse[b, h, t],
// so dK/dV never reads O.
//
// Bound on the card: bytes (O and dO read once, 4 bytes written a row).
// D / V threads share a row, each reading 16 bytes (V elements) of O and of
// dO, and the row's sum is reduced with shuffles.
#include "flash_common.cuh"

namespace dtt {

constexpr int kDeltaThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                           const float* __restrict__ g_lse, float* __restrict__ delta, View ov,
                           View gv, int H, int seq, long long rows) {
  constexpr int V = 16 / sizeof(T), R = D / V;  // R is a power of two <= 32
  const long long i = (long long)blockIdx.x * kDeltaThreads + threadIdx.x;
  const long long row = i / R;  // (b * seq + t) * H + h
  const int part = (int)(i % R);
  const int h = (int)(row % H), t = (int)(row / H % seq), b = (int)(row / H / seq);
  float acc = 0.f;
  if (row < rows) {
    const uint4 ox = *reinterpret_cast<const uint4*>(o + b * ov.sb + (long long)t * ov.st +
                                                     h * ov.sh + part * V);
    const uint4 gx = *reinterpret_cast<const uint4*>(g + b * gv.sb + (long long)t * gv.st +
                                                     h * gv.sh + part * V);
    const T* op = reinterpret_cast<const T*>(&ox);
    const T* gp = reinterpret_cast<const T*>(&gx);
#pragma unroll
    for (int e = 0; e < V; ++e) acc = fmaf(to_f32(gp[e]), to_f32(op[e]), acc);
  }
#pragma unroll
  for (int off = R / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) {
    const long long idx = ((long long)b * H + h) * seq + t;
    delta[idx] = acc - (g_lse != nullptr ? g_lse[idx] : 0.f);
  }
}

template <typename T, int D>
int launch_delta(const void* o, const void* g, const float* g_lse, float* delta, int B, int H,
                 int seq, View ov, View gv, cudaStream_t stream) {
  constexpr int R = D / (16 / sizeof(T));
  const long long rows = (long long)B * H * seq;
  const long long blocks = (rows * R + kDeltaThreads - 1) / kDeltaThreads;
  flash_bwd_delta_kernel<T, D><<<(unsigned int)blocks, kDeltaThreads, 0, stream>>>(
      (const T*)o, (const T*)g, g_lse, delta, ov, gv, H, seq, rows);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements and rows
// 16-byte aligned; g_lse (B, H, T) float32 or null; delta (B, H, T) float32.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int dtt_flash_bwd_delta(int dtype, int head_dim, const void* o, const void* g,
                                   const float* g_lse, float* delta, int B, int H, int seq,
                                   long long o_sb, long long o_st, long long o_sh,
                                   long long g_sb, long long g_st, long long g_sh,
                                   void* stream) {
  using namespace dtt;
  const View ov{o_sb, o_st, o_sh}, gv{g_sb, g_st, g_sh};
  const cudaStream_t st = (cudaStream_t)stream;
#define DTT_DELTA(T, D) launch_delta<T, D>(o, g, g_lse, delta, B, H, seq, ov, gv, st)
  DTT_DISPATCH(dtype, head_dim, DTT_DELTA);
#undef DTT_DELTA
}
