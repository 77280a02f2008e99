// Flash-attention backward, dQ, for Hopper.
//
// Replaces the TPU kernels _dq_kernel_resident and _bwd_dq_kernel, the
// first pallas_call of _flash_bwd_tpu
// (distributed_tensorflow_tpu/ops/flash_attention.py).  Per (query tile of
// 64 rows, batch*head) one block computes Delta = rowsum(dO * O) - g_lse
// for its rows, then streams 64-key tiles of K and V and recomputes
// P = exp(S - lse) from the saved lse:
//   dP = dO V^T (times the dropout keep-scale), dS = P (dP - Delta) scale,
//   dQ += dS K.
// No (T, T) buffer exists and no atomics are used: each block owns its
// rows of dQ, so the result is the same from run to run.
//
// Bound on the card: 6*D flops per (query, key) pair, tensor-core bound at
// GPT-2 medium's shapes.  Like the forward, this version runs the three
// products as f32 FMAs from shared-memory tiles; wgmma is the next step.
#include "flash_common.cuh"

namespace dtt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ o, const T* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ g_lse,
                        const int* __restrict__ kv_mask, T* __restrict__ dq, View qv, View kvw,
                        View vv, View ov, View gv, View dqv, int H, int seq, float scale,
                        int causal, Dropout dr) {
  constexpr int LD = D + 1, LDP = kBlockK + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kBlockQ * LD;
  float* Ks = Gs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * LD;
  float* lse_s = Ps + kBlockQ * LDP;
  float* delta_s = lse_s + kBlockQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  load_tile<T, D, LD>(Qs, q, qv, b, h, q0, seq);
  load_tile<T, D, LD>(Gs, g, gv, b, h, q0, seq);
  __syncthreads();
  {  // Delta and lse of the 64 rows: four threads per row.
    const int r = tid >> 2, part = tid & 3, t = q0 + r;
    float acc = 0.f;
    if (t < seq) {
      const T* orow = o + b * ov.sb + (long long)t * ov.st + h * ov.sh;
      for (int d = part; d < D; d += 4) acc = fmaf(Gs[r * LD + d], to_f32(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const long long idx = (long long)bh * seq + t;
      lse_s[r] = t < seq ? lse[idx] : 0.f;
      delta_s[r] = acc - (g_lse != nullptr && t < seq ? g_lse[idx] : 0.f);
    }
  }
  __syncthreads();
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse_s[ty * 4 + i];
    delta_r[i] = delta_s[ty * 4 + i];
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
    load_tile<T, D, LD>(Ks, k, kvw, b, h, k0, seq);
    load_tile<T, D, LD>(Vs, v, vv, b, h, k0, seq);
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
      if (dr.on) dropout4(dr, bh, qpos, (k0 >> 2) + tx, keep);
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
  store_rows<T, D>(dq, dqv, b, h, q0, seq, dqa);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* g,
              const float* lse, const float* g_lse, const int* kv_mask, void* dq, int B, int H,
              int seq, View qv, View kvw, View vv, View ov, View gv, View dqv, float scale,
              int causal, Dropout dr, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem =
      sizeof(float) * (size_t)(2 * kBlockQ * LD + 2 * kBlockK * LD + kBlockQ * (kBlockK + 1) + 2 * kBlockQ);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)g, lse, g_lse, kv_mask, (T*)dq,
      qv, kvw, vv, ov, gv, dqv, H, seq, scale, causal, dr);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; lse and
// g_lse are (B, H, T) float32 (g_lse may be null), kv_mask (B, T) int32 or
// null.  Returns the CUDA error code of the launch (0 = launched).
extern "C" int dtt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const void* o, const void* g, const float* lse,
                                const float* g_lse, const int* kv_mask, void* dq, int B, int H,
                                int seq, long long q_sb, long long q_st, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh, long long v_sb,
                                long long v_st, long long v_sh, long long o_sb, long long o_st,
                                long long o_sh, long long g_sb, long long g_st, long long g_sh,
                                long long dq_sb, long long dq_st, long long dq_sh, float scale,
                                int causal, unsigned int seed_lo, unsigned int seed_hi,
                                unsigned int drop_thresh, float drop_scale, int drop_on,
                                void* stream) {
  using namespace dtt;
  const View qv{q_sb, q_st, q_sh}, kvw{k_sb, k_st, k_sh}, vv{v_sb, v_st, v_sh},
      ov{o_sb, o_st, o_sh}, gv{g_sb, g_st, g_sh}, dqv{dq_sb, dq_st, dq_sh};
  const Dropout dr{seed_lo, seed_hi, drop_thresh, drop_scale, drop_on};
  const cudaStream_t st = (cudaStream_t)stream;
#define DTT_DQ(T, D) launch_dq<T, D>(q, k, v, o, g, lse, g_lse, kv_mask, dq, B, H, seq, qv, kvw, vv, ov, gv, dqv, scale, causal, dr, st)
  DTT_DISPATCH(dtype, head_dim, DTT_DQ);
#undef DTT_DQ
}
