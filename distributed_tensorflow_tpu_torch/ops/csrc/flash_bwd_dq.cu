// Flash-attention backward, dQ, for Hopper.
//
// Replaces the TPU kernels _dq_kernel_resident (:339) and _bwd_dq_kernel
// (:610), the first pallas_call (:831) of _flash_bwd_tpu (:755) in
// distributed_tensorflow_tpu/ops/flash_attention.py.  Per (query tile of 64
// rows, batch*head) one block streams the 64-key tiles of K and V and
// recomputes P = exp(S - lse) from the saved lse:
//   dP = dO V^T (times the dropout keep-scale), dS = P (dP - Delta) scale,
//   dQ += dS K,
// with Delta = rowsum(dO * O) - g_lse from the flash_bwd_delta pre-pass and
// the keep bits from the flash_bwd_keep pre-pass (the mask is drawn once per
// backward, not once per kernel).  No (T, T) buffer exists and no atomics
// are used: each block owns its rows of dQ, so the result is the same from
// run to run.
//
// Bound on the card: 6*D flops per (query, key) pair; at GPT-2 medium's
// shapes the flops bound (tensor cores) and the bytes bound are within 5% of
// each other.  Two designs, picked by the element type:
// - bfloat16: one warpgroup per 64 query rows.  K and V tiles (and the keep
//   bits) stream through two cp.async buffers (tile i+1 loads while tile i
//   computes) in the 128-byte-swizzled layout wgmma reads; S = Q K^T and
//   dP = dO V^T run as wgmma from shared memory, and dQ += dS K as wgmma
//   with dS from registers (bf16) and K read transposed (MN-major) from the
//   same tile.  What bounds it is latency: each tile is a chain of products
//   and the element-wise work (exp, mask, dS) between them, and three blocks
//   an SM (168 registers a thread) overlap their chains.  Deferring the dQ
//   product's wait to the next tile costs registers and a block an SM, and
//   measured slower (PERF.md).
// - float32: PR 1's f32 FMAs from shared-memory tiles (tensor cores would be
//   TF32, which cannot meet the f32 tolerance).
#include "flash_tc.cuh"

namespace dtt {

// ---- float32: FMAs on the CUDA cores ---------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_mask, float* __restrict__ dq, View qv, View kvw,
                     View vv, View gv, View dqv, int H, int seq, float scale, int causal,
                     const uint32_t* __restrict__ keep_bits, float drop_scale) {
  constexpr int LD = D + 1, LDP = kBlockK + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kBlockQ * LD;
  float* Ks = Gs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  load_tile<D, LD>(Qs, q, qv, b, h, q0, seq);
  load_tile<D, LD>(Gs, g, gv, b, h, q0, seq);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    const long long idx = (long long)bh * seq + t;
    lse_r[i] = t < seq ? lse[idx] : 0.f;
    delta_r[i] = t < seq ? delta[idx] : 0.f;
  }

  float dqa[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dqa[i][e] = 0.f;

  const int n_kt = key_tiles(q0, seq, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile<D, LD>(Ks, k, kvw, b, h, k0, seq);
    load_tile<D, LD>(Vs, v, vv, b, h, k0, seq);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], gg[4], kk[4], vk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * LD + d];
        gg[i] = Gs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = Ks[(tx * 4 + j) * LD + d];
        vk[j] = Vs[(tx * 4 + j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(gg[i], vk[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float keep[4] = {1.f, 1.f, 1.f, 1.f};
      if (keep_bits != nullptr) {  // keys tx*4 .. tx*4+3 of row ty*4+i
        const uint32_t w = tc::keep_tile(keep_bits, bh, blockIdx.x, kt, gridDim.x)
                               [2 * (ty * 4 + i) + (tx >> 3)] >> (4 * (tx & 7));
#pragma unroll
        for (int j = 0; j < 4; ++j) keep[j] = (w >> j) & 1u ? drop_scale : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = key_ok(kv_mask, b, seq, qpos, k0 + tx * 4 + j, causal)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
        Ps[(ty * 4 + i) * LDP + tx * 4 + j] = p * (dp[i][j] * keep[j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float kr[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) kr[e] = Ks[kk * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ps[(ty * 4 + i) * LDP + kk];
#pragma unroll
        for (int e = 0; e < DPT; ++e) dqa[i][e] = fmaf(ds, kr[e], dqa[i][e]);
      }
    }
  }
  store_rows<D>(dq, dqv, b, h, q0, seq, dqa);
}

template <int D>
int launch_dq_fma(const void* q, const void* k, const void* v, const void* g, const float* lse,
                  const float* delta, const int* kv_mask, void* dq, int B, int H, int seq,
                  View qv, View kvw, View vv, View gv, View dqv, float scale, int causal,
                  const uint32_t* keep_bits, float drop_scale, cudaStream_t stream) {
  constexpr int LD = D + 1;
  constexpr int smem =
      sizeof(float) * (2 * kBlockQ * LD + 2 * kBlockK * LD + kBlockQ * (kBlockK + 1));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, B * H);
  flash_bwd_dq_fma<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g, lse, delta, kv_mask,
      (float*)dq, qv, kvw, vv, gv, dqv, H, seq, scale, causal, keep_bits, drop_scale);
  return (int)cudaGetLastError();
}

// ---- bfloat16: wgmma on the tensor cores -----------------------------------

template <int D>
__global__ void __launch_bounds__(tc::kThreadsTC)
    flash_bwd_dq_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_mask, __nv_bfloat16* __restrict__ dq, View qv,
                    View kvw, View vv, View gv, View dqv, int H, int seq, float scale,
                    int causal, const uint32_t* __restrict__ keep_bits, float drop_scale) {
  using namespace tc;
  constexpr int TB = tile_bytes<D>(), NP = panels<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Gs = Qs + TB;
  uint8_t* Ks = Gs + TB;      // two buffers
  uint8_t* Vs = Ks + 2 * TB;  // two buffers
  uint32_t* keep = reinterpret_cast<uint32_t*>(Vs + 2 * TB);  // two tiles of 128 words

  // This thread's rows (r0, r0 + 8) and columns (8j + c0, 8j + c0 + 1) of a score tile.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * 64;  // the longest rows first (causal)
  const int n_kt = key_tiles(q0, seq, causal);
  const bool drop = keep_bits != nullptr;
  const float sl2 = scale * kLog2e;

  load_tile_async<D>(Qs, q, qv, b, h, q0, seq);
  load_tile_async<D>(Gs, g, gv, b, h, q0, seq);
  load_tile_async<D>(Ks, k, kvw, b, h, 0, seq);
  load_tile_async<D>(Vs, v, vv, b, h, 0, seq);
  if (drop) load_keep_async(keep, keep_tile(keep_bits, bh, qt, 0, gridDim.y));
  cp_async_commit();

  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    const long long idx = (long long)bh * seq + t;
    lse2[i] = t < seq ? lse[idx] * kLog2e : 0.f;
    dlt[i] = t < seq ? delta[idx] : 0.f;
  }

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[p][x] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * 64, cur = kt & 1;
    __syncthreads();  // every warp is done with the buffers the prefetch overwrites
    if (kt + 1 < n_kt) {
      load_tile_async<D>(Ks + (cur ^ 1) * TB, k, kvw, b, h, k0 + 64, seq);
      load_tile_async<D>(Vs + (cur ^ 1) * TB, v, vv, b, h, k0 + 64, seq);
      if (drop) {
        load_keep_async(keep + (cur ^ 1) * 128, keep_tile(keep_bits, bh, qt, kt + 1, gridDim.y));
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    const uint8_t* Kc = Ks + cur * TB;
    float s[32], dp[32];
    wg_fence();
    gemm_rows<D>(s, Qs, Kc);
    gemm_rows<D>(dp, Gs, Vs + cur * TB);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool full = kv_mask == nullptr && q0 + 64 <= seq && k0 + 64 <= seq &&
                      (!causal || k0 + 63 <= q0);
    uint32_t kw[2][2] = {{0u, 0u}, {0u, 0u}};
    if (drop) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kw[i][0] = keep[cur * 128 + 2 * (r0 + 8 * i)];
        kw[i][1] = keep[cur * 128 + 2 * (r0 + 8 * i) + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 4 * j + 2 * i + c, kc = 8 * j + c0 + c;
          float p = exp2f(fmaf(s[x], sl2, -lse2[i]));
          if (!full && !key_ok(kv_mask, b, seq, q0 + r0 + 8 * i, k0 + kc, causal)) p = 0.f;
          float dpv = dp[x];
          if (drop) dpv = (kw[i][j >> 2] >> (kc & 31)) & 1u ? dpv * drop_scale : 0.f;
          s[x] = p * (dpv - dlt[i]) * scale;  // dS
        }
    uint32_t a[4][4];
    to_a_frags(s, a);
    wg_fence();
    gemm_acc<D>(acc, a, Kc, 0);  // dQ += dS K
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
  }
  store_acc<D>(dq, dqv, b, h, q0, seq, acc);
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* g, const float* lse,
                 const float* delta, const int* kv_mask, void* dq, int B, int H, int seq, View qv,
                 View kvw, View vv, View gv, View dqv, float scale, int causal,
                 const uint32_t* keep_bits, float drop_scale, cudaStream_t stream) {
  constexpr int smem = 6 * tc::tile_bytes<D>() + 2 * 128 * 4 + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (seq + 63) / 64);
  flash_bwd_dq_tc<D><<<grid, tc::kThreadsTC, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)g, lse, delta, kv_mask, (__nv_bfloat16*)dq, qv, kvw, vv, gv, dqv, H,
      seq, scale, causal, keep_bits, drop_scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; lse and delta
// are (B, H, T) float32, kv_mask (B, T) int32 or null, keep_bits the
// dropout pre-pass's bits (flash_bwd_keep.cu) or null without dropout, each
// kept score scaled by drop_scale.  bf16 tensors need 16-byte aligned rows.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int dtt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const void* g, const float* lse,
                                const float* delta, const int* kv_mask, void* dq, int B, int H,
                                int seq, long long q_sb, long long q_st, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh, long long v_sb,
                                long long v_st, long long v_sh, long long g_sb, long long g_st,
                                long long g_sh, long long dq_sb, long long dq_st,
                                long long dq_sh, float scale, int causal,
                                const unsigned int* keep_bits, float drop_scale, void* stream) {
  using namespace dtt;
  const View qv{q_sb, q_st, q_sh}, kvw{k_sb, k_st, k_sh}, vv{v_sb, v_st, v_sh},
      gv{g_sb, g_st, g_sh}, dqv{dq_sb, dq_st, dq_sh};
  const cudaStream_t st = (cudaStream_t)stream;
#define DTT_DQ_FMA(D) launch_dq_fma<D>(q, k, v, g, lse, delta, kv_mask, dq, B, H, seq, qv, kvw, vv, gv, dqv, scale, causal, keep_bits, drop_scale, st)
#define DTT_DQ_TC(D) launch_dq_tc<D>(q, k, v, g, lse, delta, kv_mask, dq, B, H, seq, qv, kvw, vv, gv, dqv, scale, causal, keep_bits, drop_scale, st)
  if (dtype == 0) {
    DTT_HEAD_DIMS(head_dim, DTT_DQ_FMA);
  } else if (dtype == 1) {
    DTT_HEAD_DIMS(head_dim, DTT_DQ_TC);
  }
#undef DTT_DQ_FMA
#undef DTT_DQ_TC
  return (int)cudaErrorInvalidValue;
}
