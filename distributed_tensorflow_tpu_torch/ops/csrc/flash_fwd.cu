// Flash-attention forward for Hopper.
//
// Replaces the TPU kernels _fwd_kernel_resident (:276) and _fwd_kernel
// (:187), the pallas_call (:592) of _flash_fwd_tpu (:521) in
// distributed_tensorflow_tpu/ops/flash_attention.py.  Per (query tile of 64
// rows, batch*head) one block streams the 64-key tiles of K and V with the
// online softmax: running max m, denominator l and an f32 accumulator
// rescaled by alpha = exp(m_old - m_new).  Key tiles wholly above the causal
// diagonal are never loaded.  Dropout keeps l and lse on the undropped
// probabilities; only the P.V product sees the mask (softmax-dropout, as the
// TPU kernel).  The mask is drawn in place with the Philox counters of
// flash_common.cuh, so it is bit for bit the flash_bwd_keep pre-pass's bits
// and the plain version's dropout_mask.
//
// Bound on the card: per (query, key) pair 4*D flops on the tensor cores,
// one exponential on the special-function units (16 a clock per SM, which
// at D = 64 take as long as the flops) and, under dropout, a quarter of a
// Philox-4x32-10 draw (~50 integer operations, which take longer than both);
// at GPT-2 medium's shapes the bytes (each input read once) bound 1.16 times
// the flops bound.  Two designs, picked by the element type:
// - bfloat16: one warpgroup (128 threads) per 64 query rows.  Q is loaded
//   once and K and V tiles stream through two cp.async buffers (tile i+1
//   loads while tile i computes) in the 128-byte-swizzled layout wgmma reads.
//   S = Q K^T is a wgmma from shared memory, and the tile's Philox draws run
//   while it does.  The online softmax runs in registers on the accumulator
//   layout (flash_tc.cuh), where the four lanes of a quad hold one row; P
//   times the keep-scale goes to acc += P V as bf16 A fragments from
//   registers (rounded as the TPU kernel rounds P to the input dtype), with V
//   read transposed (MN-major) from its tile.  Each block's tile is a chain
//   of product, softmax, product; at ~126 registers four blocks share an SM
//   and overlap their chains.  Two variants were no faster and were not
//   kept (PERF.md): the next tile's S issued before this tile's softmax
//   (more registers, three blocks an SM), and two warpgroups a block sharing
//   each K and V tile.
// - float32: f32 FMAs from shared-memory tiles (tensor cores would be
//   TF32, which cannot meet the f32 tolerance).
#include "flash_tc.cuh"

namespace dtt {

// ---- float32: FMAs on the CUDA cores ---------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ kv_mask,
                  float* __restrict__ o, float* __restrict__ lse, View qv, View kvw, View vv,
                  View ov, int H, int seq, float scale, int causal, Dropout dr) {
  constexpr int LD = D + 1, LDP = kBlockK + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  load_tile<D, LD>(Qs, q, qv, b, h, q0, seq);

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
    load_tile<D, LD>(Ks, k, kvw, b, h, k0, seq);
    load_tile<D, LD>(Vs, v, vv, b, h, k0, seq);
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
  store_rows<D>(o, ov, b, h, q0, seq, acc);
}

template <int D>
int launch_fwd_fma(const void* q, const void* k, const void* v, const int* kv_mask, void* o,
                   float* lse, int B, int H, int seq, View qv, View kvw, View vv, View ov,
                   float scale, int causal, Dropout dr, cudaStream_t stream) {
  constexpr int LD = D + 1;
  constexpr int smem = sizeof(float) * (kBlockQ * LD + 2 * kBlockK * LD + kBlockQ * (kBlockK + 1));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_fma<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, kv_mask, (float*)o, lse, qv, kvw, vv,
      ov, H, seq, scale, causal, dr);
  return (int)cudaGetLastError();
}

// ---- bfloat16: wgmma on the tensor cores -----------------------------------

// 2^x on the special-function unit, results below 2^-126 flushed to zero
// (exp2f adds a rescale around it for them; here they are negligible terms
// of a sum whose largest term is 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The dropout keep bits of this thread's elements of the score tile at keys
// k0.., rows r0 (keep[0]) and r0 + 8 (keep[1]): bit 2j + c is column
// 8j + c0 + c.  Lanes l and l^1 hold the 4 keys of one Philox draw (columns
// 8j + 4g .. 8j + 4g + 3 with g = (l / 2) % 2) in both rows: the even lane
// draws row r0 and the odd lane row r0 + 8, and each passes its partner the
// bits of the partner's two columns.  One draw per 4 elements, as dropout4.
__device__ __forceinline__ void fwd_keep_bits(const Dropout& dr, int bh, int qr0, int k0,
                                              uint32_t (&keep)[2]) {
  const int lane = threadIdx.x & 31, e = lane & 1;
  const uint32_t qd = qr0 + 8 * e, k4 = (k0 >> 2) + ((lane >> 1) & 1);
  uint32_t own = 0u, give = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 r = philox4x32_10(make_uint4(k4 + 2 * j, qd, (uint32_t)bh, 0u), dr.key0, dr.key1);
    const uint32_t lo = (uint32_t)(r.x >= dr.thresh) | (uint32_t)(r.y >= dr.thresh) << 1;
    const uint32_t hi = (uint32_t)(r.z >= dr.thresh) | (uint32_t)(r.w >= dr.thresh) << 1;
    own |= (e ? hi : lo) << (2 * j);
    give |= (e ? lo : hi) << (2 * j);
  }
  const uint32_t got = __shfl_xor_sync(0xffffffffu, give, 1);
  keep[0] = e ? got : own;
  keep[1] = e ? own : got;
}

template <int D>
__global__ void __launch_bounds__(tc::kThreadsTC)
    flash_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_mask,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, View qv, View kvw,
                 View vv, View ov, int H, int seq, float scale, int causal, Dropout dr) {
  using namespace tc;
  constexpr int TB = tile_bytes<D>(), NP = panels<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + TB;      // two buffers
  uint8_t* Vs = Ks + 2 * TB;  // two buffers

  // This thread's rows (r0, r0 + 8) and columns (8j + c0, 8j + c0 + 1) of a score tile.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;  // the longest rows first (causal)
  const int n_kt = key_tiles(q0, seq, causal);
  // Scores in log2 units: exp(scale s - m) = 2^(s sl2 - m'), one FMA; with
  // scale > 0 the largest raw score gives the largest scaled one.
  const float sl2 = scale * kLog2e;

  load_tile_async<D>(Qs, q, qv, b, h, q0, seq);
  load_tile_async<D>(Ks, k, kvw, b, h, 0, seq);
  load_tile_async<D>(Vs, v, vv, b, h, 0, seq);
  cp_async_commit();

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[p][x] = 0.f;
  // Rows r0 and r0 + 8: the running max (log2 units, the same in the four
  // lanes of the quad) and this lane's part of the denominator (the quad's
  // four parts are added once, at the end).
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * 64, cur = kt & 1;
    __syncthreads();  // every warp is done with the buffers the prefetch overwrites
    if (kt + 1 < n_kt) {
      load_tile_async<D>(Ks + (cur ^ 1) * TB, k, kvw, b, h, k0 + 64, seq);
      load_tile_async<D>(Vs + (cur ^ 1) * TB, v, vv, b, h, k0 + 64, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    float s[32];
    wg_fence();
    gemm_rows<D>(s, Qs, Ks + cur * TB);  // S = Q K^T
    wg_commit();
    uint32_t keep[2] = {0u, 0u};
    if (dr.on) fwd_keep_bits(dr, bh, q0 + r0, k0, keep);  // while the product runs
    wg_wait<0>();
    fence_regs(s);

    const bool full = kv_mask == nullptr && q0 + 64 <= seq && k0 + 64 <= seq &&
                      (!causal || k0 + 63 <= q0);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 4 * j + 2 * i + c;
          if (!full && !key_ok(kv_mask, b, seq, q0 + r0 + 8 * i, k0 + 8 * j + c0 + c, causal))
            s[x] = -INFINITY;
          mx = fmaxf(mx, s[x]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx * sl2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet: p = 0
      alpha[i] = ex2(m_run[i] - m_use);                      // 0 while m_run is -inf
      m_run[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 4 * j + 2 * i + c;
          s[x] = ex2(fmaf(s[x], sl2, -m_use));
          rs += s[x];
        }
      l_run[i] = l_run[i] * alpha[i] + rs;  // l takes the undropped p
    }

    if (dr.on) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * j + 2 * i + c;
            s[x] = (keep[i] >> (2 * j + c)) & 1u ? s[x] * dr.scale : 0.f;
          }
    }

    // The previous P V product is complete (waited for and fenced below),
    // so its accumulator can be rescaled.
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[p][x] *= alpha[(x >> 1) & 1];
    uint32_t a[4][4];
    to_a_frags(s, a);
    wg_fence();
    gemm_acc<D>(acc, a, Vs + cur * TB, 0);  // acc += P V
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f), inv = 1.f / l_safe;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[p][4 * j + 2 * i] *= inv;
        acc[p][4 * j + 2 * i + 1] *= inv;
      }
    const int t = q0 + r0 + 8 * i;
    if (lse != nullptr && (lane & 3) == 0 && t < seq)
      // A row with no valid key gets -1e30, as the float32 kernel.
      lse[(long long)bh * seq + t] =
          l > 0.f ? m_run[i] * 0.6931471805599453f + logf(l_safe) : -1e30f;
  }
  store_acc<D>(o, ov, b, h, q0, seq, acc);
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, const int* kv_mask, void* o,
                  float* lse, int B, int H, int seq, View qv, View kvw, View vv, View ov,
                  float scale, int causal, Dropout dr, cudaStream_t stream) {
  constexpr int smem = 5 * tc::tile_bytes<D>() + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (seq + 63) / 64);
  flash_fwd_tc<D><<<grid, tc::kThreadsTC, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, kv_mask,
      (__nv_bfloat16*)o, lse, qv, kvw, vv, ov, H, seq, scale, causal, dr);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  kv_mask
// (B, T) int32 and lse (B, H, T) float32 may be null.  bf16 tensors need
// 16-byte aligned rows and scale > 0.  Returns the CUDA error code of the
// launch (0 = launched).
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
#define DTT_FWD_FMA(D) launch_fwd_fma<D>(q, k, v, kv_mask, o, lse, B, H, seq, qv, kvw, vv, ov, scale, causal, dr, st)
#define DTT_FWD_TC(D) launch_fwd_tc<D>(q, k, v, kv_mask, o, lse, B, H, seq, qv, kvw, vv, ov, scale, causal, dr, st)
  if (dtype == 0) {
    DTT_HEAD_DIMS(head_dim, DTT_FWD_FMA);
  } else if (dtype == 1 && scale > 0.f) {
    DTT_HEAD_DIMS(head_dim, DTT_FWD_TC);
  }
#undef DTT_FWD_FMA
#undef DTT_FWD_TC
  return (int)cudaErrorInvalidValue;
}
