// Flash-attention forward for Hopper.
//
// Replaces the TPU kernels _fwd_kernel_resident and _fwd_kernel, launched
// by _flash_fwd_tpu (distributed_tensorflow_tpu/ops/flash_attention.py).
// Per (query tile of 64 rows, batch*head) one block streams 64-key tiles of
// K and V through shared memory with the online softmax: running max m,
// denominator l and an f32 accumulator rescaled by alpha = exp(m_old -
// m_new).  Key tiles wholly above the causal diagonal are never loaded.
// Dropout keeps l and lse on the undropped probabilities; only the P.V
// product sees the mask (softmax-dropout, as the TPU kernel).
//
// Bound on the card: at GPT-2 medium's shapes the work is 4*D flops per
// (query, key) pair against 2*D bytes per row read, so the tensor cores'
// rate bounds it.  This first version does the products with f32 FMAs on
// the CUDA cores from shared-memory tiles (each thread a 4x4 register
// tile), which keeps every input type on one exact f32 path; moving the
// two products onto wgmma is the next step (PERF.md).
#include "flash_common.cuh"

namespace dtt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ kv_mask, T* __restrict__ o, float* __restrict__ lse,
                     View qv, View kvw, View vv, View ov, int H, int seq, float scale, int causal,
                     Dropout dr) {
  constexpr int LD = D + 1, LDP = kBlockK + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  load_tile<T, D, LD>(Qs, q, qv, b, h, q0, seq);

  float acc[4][DPT];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int n_kt = key_tiles(q0, seq, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // Qs ready; last tile's readers of Ks/Vs/Ps done
    load_tile<T, D, LD>(Ks, k, kvw, b, h, k0, seq);
    load_tile<T, D, LD>(Vs, v, vv, b, h, k0, seq);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx * 4 + j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = key_ok(kv_mask, b, seq, qpos, k0 + tx * 4 + j, causal) ? s[i][j] * scale
                                                                          : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m_run[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_use);
      float p[4], rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_use);
        rs += p[j];
      }
      rs = group16_sum(rs);
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = m_new;
      if (dr.on) {
        float keep[4];
        dropout4(dr, bh, qpos, (k0 >> 2) + tx, keep);
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] *= keep[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LDP + tx * 4 + j] = p[j];
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float vk[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) vk[e] = Vs[kk * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pk = Ps[(ty * 4 + i) * LDP + kk];
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pk, vk[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_safe = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = acc[i][e] / l_safe;
    const int qpos = q0 + ty * 4 + i;
    if (lse != nullptr && tx == 0 && qpos < seq)
      // Rows with no valid key get -1e30: exp(lse - x) is then an exact
      // zero in ring attention's cross-block combine.
      lse[(long long)bh * seq + qpos] = l_run[i] > 0.f ? m_run[i] + logf(l_safe) : -1e30f;
  }
  store_rows<T, D>(o, ov, b, h, q0, seq, acc);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* kv_mask, void* o, float* lse,
               int B, int H, int seq, View qv, View kvw, View vv, View ov, float scale, int causal,
               Dropout dr, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = sizeof(float) * (size_t)(kBlockQ * LD + 2 * kBlockK * LD + kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_mask, (T*)o, lse, qv, kvw, vv, ov, H, seq, scale,
      causal, dr);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  kv_mask
// (B, T) int32 and lse (B, H, T) float32 may be null.  Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int dtt_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                             const int* kv_mask, void* o, float* lse, int B, int H, int seq,
                             long long q_sb, long long q_st, long long q_sh, long long k_sb,
                             long long k_st, long long k_sh, long long v_sb, long long v_st,
                             long long v_sh, long long o_sb, long long o_st, long long o_sh,
                             float scale, int causal, unsigned int seed_lo, unsigned int seed_hi,
                             unsigned int drop_thresh, float drop_scale, int drop_on,
                             void* stream) {
  using namespace dtt;
  const View qv{q_sb, q_st, q_sh}, kvw{k_sb, k_st, k_sh}, vv{v_sb, v_st, v_sh}, ov{o_sb, o_st, o_sh};
  const Dropout dr{seed_lo, seed_hi, drop_thresh, drop_scale, drop_on};
  const cudaStream_t st = (cudaStream_t)stream;
#define DTT_FWD(T, D) launch_fwd<T, D>(q, k, v, kv_mask, o, lse, B, H, seq, qv, kvw, vv, ov, scale, causal, dr, st)
  DTT_DISPATCH(dtype, head_dim, DTT_FWD);
#undef DTT_FWD
}
