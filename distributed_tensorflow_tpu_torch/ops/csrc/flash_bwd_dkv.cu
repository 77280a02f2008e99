// Flash-attention backward, dK and dV, for Hopper.
//
// Replaces the TPU kernels _dkv_kernel_resident and _bwd_dkv_kernel, the
// second pallas_call of _flash_bwd_tpu
// (distributed_tensorflow_tpu/ops/flash_attention.py).  Per (key tile of
// 64 rows, batch*head) one block keeps its K and V tile in shared memory
// and streams the 64-query tiles from its causal lower bound, recomputing
// P = exp(S - lse) and Delta = rowsum(dO * O) - g_lse per query tile:
//   dV += (P * M)^T dO,  dS = P (dP * M - Delta) scale,  dK += dS^T Q,
// with M the dropout keep-scale.  Each block owns its rows of dK and dV, so
// there are no atomics and the sums run in a fixed order.
//
// Bound on the card: 8*D flops per (query, key) pair, tensor-core bound at
// GPT-2 medium's shapes.  This version runs the four products as f32 FMAs
// from shared-memory tiles; wgmma is the next step.
#include "flash_common.cuh"

namespace dtt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ o, const T* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ g_lse,
                         const int* __restrict__ kv_mask, T* __restrict__ dk, T* __restrict__ dv,
                         View qv, View kvw, View vv, View ov, View gv, View dkv, View dvv, int H,
                         int seq, float scale, int causal, Dropout dr) {
  constexpr int LD = D + 1, LDQ = kBlockQ + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlockK * LD;
  float* Qs = Vs + kBlockK * LD;
  float* Gs = Qs + kBlockQ * LD;
  float* PVs = Gs + kBlockQ * LD;  // (key, query): P * M
  float* DSs = PVs + kBlockK * LDQ;  // (key, query): dS
  float* lse_s = DSs + kBlockK * LDQ;
  float* delta_s = lse_s + kBlockQ;

  // Here a thread owns keys ty*4 .. ty*4+3 and queries tx*4 .. tx*4+3 of
  // the score tile, and keys ty*4+i, columns tx + 16*e of dK and dV.
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBlockK;

  load_tile<T, D, LD>(Ks, k, kvw, b, h, k0, seq);
  load_tile<T, D, LD>(Vs, v, vv, b, h, k0, seq);

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int n_qt = (seq + kBlockQ - 1) / kBlockQ;
  for (int qt = causal ? k0 / kBlockQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();  // K/V ready; last tile's readers of Qs/Gs/PVs/DSs done
    load_tile<T, D, LD>(Qs, q, qv, b, h, q0, seq);
    load_tile<T, D, LD>(Gs, g, gv, b, h, q0, seq);
    __syncthreads();
    {  // Delta and lse of the tile's 64 query rows: four threads per row.
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

    float st[4][4], dpt[4][4];  // [key i][query j]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kk[4], vk[4], qq[4], gg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = Ks[(ty * 4 + i) * LD + d];
        vk[i] = Vs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qq[j] = Qs[(tx * 4 + j) * LD + d];
        gg[j] = Gs[(tx * 4 + j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kk[i], qq[j], st[i][j]);
          dpt[i][j] = fmaf(vk[i], gg[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx * 4 + j, qpos = q0 + r;
      const float lse_j = lse_s[r], delta_j = delta_s[r];
      float keep[4] = {1.f, 1.f, 1.f, 1.f};
      if (dr.on) dropout4(dr, bh, qpos, (k0 >> 2) + ty, keep);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key_ok(kv_mask, b, seq, qpos, k0 + ty * 4 + i, causal)
                            ? expf(st[i][j] * scale - lse_j)
                            : 0.f;
        PVs[(ty * 4 + i) * LDQ + r] = p * keep[i];
        DSs[(ty * 4 + i) * LDQ + r] = p * (dpt[i][j] * keep[i] - delta_j) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBlockQ; ++r) {
      float gr[DPT], qr[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        gr[e] = Gs[r * LD + tx + 16 * e];
        qr[e] = Qs[r * LD + tx + 16 * e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = PVs[(ty * 4 + i) * LDQ + r], ds = DSs[(ty * 4 + i) * LDQ + r];
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          dva[i][e] = fmaf(pv, gr[e], dva[i][e]);
          dka[i][e] = fmaf(ds, qr[e], dka[i][e]);
        }
      }
    }
  }
  store_rows<T, D>(dk, dkv, b, h, k0, seq, dka);
  store_rows<T, D>(dv, dvv, b, h, k0, seq, dva);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* g,
               const float* lse, const float* g_lse, const int* kv_mask, void* dk, void* dv,
               int B, int H, int seq, View qv, View kvw, View vv, View ov, View gv, View dkv,
               View dvv, float scale, int causal, Dropout dr, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = sizeof(float) * (size_t)(2 * kBlockK * LD + 2 * kBlockQ * LD +
                                               2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kBlockK - 1) / kBlockK, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)g, lse, g_lse, kv_mask,
      (T*)dk, (T*)dv, qv, kvw, vv, ov, gv, dkv, dvv, H, seq, scale, causal, dr);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; lse and
// g_lse are (B, H, T) float32 (g_lse may be null), kv_mask (B, T) int32 or
// null.  Returns the CUDA error code of the launch (0 = launched).
extern "C" int dtt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* o, const void* g, const float* lse,
                                 const float* g_lse, const int* kv_mask, void* dk, void* dv,
                                 int B, int H, int seq, long long q_sb, long long q_st,
                                 long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh, long long o_sb,
                                 long long o_st, long long o_sh, long long g_sb, long long g_st,
                                 long long g_sh, long long dk_sb, long long dk_st,
                                 long long dk_sh, long long dv_sb, long long dv_st,
                                 long long dv_sh, float scale, int causal,
                                 unsigned int seed_lo, unsigned int seed_hi,
                                 unsigned int drop_thresh, float drop_scale, int drop_on,
                                 void* stream) {
  using namespace dtt;
  const View qv{q_sb, q_st, q_sh}, kvw{k_sb, k_st, k_sh}, vv{v_sb, v_st, v_sh},
      ov{o_sb, o_st, o_sh}, gv{g_sb, g_st, g_sh}, dkv{dk_sb, dk_st, dk_sh},
      dvv{dv_sb, dv_st, dv_sh};
  const Dropout dr{seed_lo, seed_hi, drop_thresh, drop_scale, drop_on};
  const cudaStream_t stm = (cudaStream_t)stream;
#define DTT_DKV(T, D) launch_dkv<T, D>(q, k, v, o, g, lse, g_lse, kv_mask, dk, dv, B, H, seq, qv, kvw, vv, ov, gv, dkv, dvv, scale, causal, dr, stm)
  DTT_DISPATCH(dtype, head_dim, DTT_DKV);
#undef DTT_DKV
}
