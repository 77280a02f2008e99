// Flash-attention backward, dK and dV, for Hopper.
//
// Replaces the TPU kernels _dkv_kernel_resident (:400) and _bwd_dkv_kernel
// (:676), the second pallas_call (:905) of _flash_bwd_tpu (:755) in
// distributed_tensorflow_tpu/ops/flash_attention.py.  Per (key tile of 64
// rows, batch*head) one block keeps its K and V tile in shared memory and
// streams the 64-query tiles from its causal lower bound, recomputing
// P = exp(S - lse) per query tile:
//   dV += (P * M)^T dO,  dS = P (dP * M - Delta) scale,  dK += dS^T Q,
// with M the dropout keep-scale from the flash_bwd_keep pre-pass's bits and
// Delta = rowsum(dO * O) - g_lse from the flash_bwd_delta pre-pass (O is not
// read here).  Each block owns its rows of dK and dV, so there are no
// atomics and the sums run in a fixed order.
//
// Bound on the card: 8*D flops per (query, key) pair; at GPT-2 medium's
// shapes the flops bound (tensor cores) is the larger.  Two designs, picked
// by the element type:
// - bfloat16: one warpgroup per 64 key rows.  Q and dO tiles (with their
//   lse, Delta and keep bits) stream through three cp.async buffers in the
//   128-byte-swizzled layout wgmma reads.  The scores are computed
//   transposed, S^T = K Q^T and dP^T = V dO^T, so the block's rows are keys
//   and P^T and dS^T are already the A operands of dV += (P^T M) dO and
//   dK += dS^T Q: they go to the tensor cores from registers as bf16, with
//   dO and Q read transposed (MN-major) from the tiles the scores used.
//   What bounds it is latency, as in dQ, and the registers that set how many
//   blocks an SM overlaps: the tile's scores are taken in two halves of 32
//   queries (N = 32), which keeps a thread at 168 registers without spills
//   at D <= 64, so three blocks fit an SM, and lets the second half's scores
//   run while the first half's dV, dK products do.
// - float32: PR 1's f32 FMAs from shared-memory tiles (tensor cores would be
//   TF32, which cannot meet the f32 tolerance).
#include "flash_tc.cuh"

namespace dtt {

// ---- float32: FMAs on the CUDA cores ---------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ kv_mask, float* __restrict__ dk,
                      float* __restrict__ dv, View qv, View kvw, View vv, View gv, View dkv,
                      View dvv, int H, int seq, float scale, int causal,
                      const uint32_t* __restrict__ keep_bits, float drop_scale) {
  constexpr int LD = D + 1, LDQ = kBlockQ + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlockK * LD;
  float* Qs = Vs + kBlockK * LD;
  float* Gs = Qs + kBlockQ * LD;
  float* PVs = Gs + kBlockQ * LD;    // (key, query): P * M
  float* DSs = PVs + kBlockK * LDQ;  // (key, query): dS
  float* lse_s = DSs + kBlockK * LDQ;
  float* delta_s = lse_s + kBlockQ;

  // Here a thread owns keys ty*4 .. ty*4+3 and queries tx*4 .. tx*4+3 of
  // the score tile, and keys ty*4+i, columns tx + 16*e of dK and dV.
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBlockK;

  load_tile<D, LD>(Ks, k, kvw, b, h, k0, seq);
  load_tile<D, LD>(Vs, v, vv, b, h, k0, seq);

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int n_qt = (seq + kBlockQ - 1) / kBlockQ;
  for (int qt = causal ? k0 / kBlockQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();  // K/V ready; last tile's readers of Qs/Gs/PVs/DSs done
    load_tile<D, LD>(Qs, q, qv, b, h, q0, seq);
    load_tile<D, LD>(Gs, g, gv, b, h, q0, seq);
    if (tid < kBlockQ) {
      const int t = q0 + tid;
      const long long idx = (long long)bh * seq + t;
      lse_s[tid] = t < seq ? lse[idx] : 0.f;
      delta_s[tid] = t < seq ? delta[idx] : 0.f;
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
      if (keep_bits != nullptr) {  // keys ty*4 .. ty*4+3 of query row r
        const uint32_t w = tc::keep_tile(keep_bits, bh, qt, blockIdx.x, n_qt)
                               [2 * r + (ty >> 3)] >> (4 * (ty & 7));
#pragma unroll
        for (int i = 0; i < 4; ++i) keep[i] = (w >> i) & 1u ? drop_scale : 0.f;
      }
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
  store_rows<D>(dk, dkv, b, h, k0, seq, dka);
  store_rows<D>(dv, dvv, b, h, k0, seq, dva);
}

template <int D>
int launch_dkv_fma(const void* q, const void* k, const void* v, const void* g, const float* lse,
                   const float* delta, const int* kv_mask, void* dk, void* dv, int B, int H,
                   int seq, View qv, View kvw, View vv, View gv, View dkv, View dvv, float scale,
                   int causal, const uint32_t* keep_bits, float drop_scale,
                   cudaStream_t stream) {
  constexpr int LD = D + 1;
  constexpr int smem = sizeof(float) * (2 * kBlockK * LD + 2 * kBlockQ * LD +
                                        2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq + kBlockK - 1) / kBlockK, B * H);
  flash_bwd_dkv_fma<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g, lse, delta, kv_mask,
      (float*)dk, (float*)dv, qv, kvw, vv, gv, dkv, dvv, H, seq, scale, causal, keep_bits,
      drop_scale);
  return (int)cudaGetLastError();
}

// ---- bfloat16: wgmma on the tensor cores -----------------------------------

constexpr int kStages = 3;  // buffers of the streamed Q and dO tiles

// Three blocks an SM (at most 168 registers a thread) up to D = 64; two at D = 128.
template <int D>
__global__ void __launch_bounds__(tc::kThreadsTC, D > 64 ? 2 : 3)
    flash_bwd_dkv_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_mask, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, View qv, View kvw, View vv, View gv,
                     View dkv, View dvv, int H, int seq, float scale, int causal,
                     const uint32_t* __restrict__ keep_bits, float drop_scale) {
  using namespace tc;
  constexpr int TB = tile_bytes<D>(), NP = panels<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + TB;
  uint8_t* Qs = Vs + TB;                // kStages buffers
  uint8_t* Gs = Qs + kStages * TB;      // kStages buffers
  float* stats = reinterpret_cast<float*>(Gs + kStages * TB);  // [buffer][lse 64, Delta 64]
  uint32_t* keep = reinterpret_cast<uint32_t*>(stats + 128 * kStages);  // kStages x 128 words

  // This thread's keys (rows r0, r0 + 8) and queries (columns 8j + c0,
  // 8j + c0 + 1) of a transposed score tile.
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * 64;  // under causal the first key tiles stream the most query tiles
  const int n_qt = (seq + 63) / 64, qt0 = causal ? blockIdx.y : 0;
  const float sl2 = scale * kLog2e;
  const bool drop = keep_bits != nullptr;

  load_tile_async<D>(Ks, k, kvw, b, h, k0, seq);
  load_tile_async<D>(Vs, v, vv, b, h, k0, seq);
  load_tile_async<D>(Qs, q, qv, b, h, qt0 * 64, seq);
  load_tile_async<D>(Gs, g, gv, b, h, qt0 * 64, seq);
  load_stat_async(stats + tid, tid < 64 ? lse : delta, bh, qt0 * 64 + (tid & 63), seq);
  if (drop) load_keep_async(keep, keep_tile(keep_bits, bh, qt0, blockIdx.y, n_qt));
  cp_async_commit();

  float dka[NP][32], dva[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int x = 0; x < 32; ++x) dka[p][x] = dva[p][x] = 0.f;

  // Per query tile, in two halves of 32 queries: S^T and dP^T go to the
  // tensor cores, P^T M and dS^T are formed in registers, and dV, dK are
  // issued without waiting for them: the second half's scores overlap the
  // first half's dV, dK products.  The buffer a prefetch fills was last read
  // two tiles back.
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * 64, cur = (qt - qt0) % kStages;
    if (qt + 1 < n_qt) {
      const int nxt = (qt + 1 - qt0) % kStages;
      load_tile_async<D>(Qs + nxt * TB, q, qv, b, h, q0 + 64, seq);
      load_tile_async<D>(Gs + nxt * TB, g, gv, b, h, q0 + 64, seq);
      load_stat_async(stats + nxt * 128 + tid, tid < 64 ? lse : delta, bh,
                      q0 + 64 + (tid & 63), seq);
      if (drop) {
        load_keep_async(keep + nxt * 128, keep_tile(keep_bits, bh, qt + 1, blockIdx.y, n_qt));
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();  // tile qt (with its lse, Delta and keep bits) is in

    const uint8_t* Qc = Qs + cur * TB;
    const uint8_t* Gc = Gs + cur * TB;
    const float* lse_c = stats + cur * 128;
    const float* dlt_c = lse_c + 64;
    const uint32_t* keep_c = keep + cur * 128;
    const bool full = kv_mask == nullptr && q0 + 64 <= seq && k0 + 64 <= seq &&
                      (!causal || k0 + 63 <= q0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float st[16], dpt[16];  // queries 32 half + (8j + c0 + c)
      wg_fence();
      gemm_rows<D>(st, Ks, Qc + half * 32 * 128);   // S^T = K Q^T
      gemm_rows<D>(dpt, Vs, Gc + half * 32 * 128);  // dP^T = V dO^T
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qc = 32 * half + 8 * j + c0 + c;
          const float l2 = lse_c[qc] * kLog2e, dl = dlt_c[qc];
          // Keys r0 and r0 + 8 lie in one 32-key half: one word holds both bits.
          const uint32_t kw = drop ? keep_c[2 * qc + (r0 >> 5)] : 0u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * j + 2 * i + c;
            float p = exp2f(fmaf(st[x], sl2, -l2));
            if (!full && !key_ok(kv_mask, b, seq, q0 + qc, k0 + r0 + 8 * i, causal)) p = 0.f;
            float pm = p, dpv = dpt[x];
            if (drop) {
              const bool kept = (kw >> ((r0 + 8 * i) & 31)) & 1u;
              pm = kept ? p * drop_scale : 0.f;
              dpv = kept ? dpv * drop_scale : 0.f;
            }
            st[x] = pm;                       // P^T M
            dpt[x] = p * (dpv - dl) * scale;  // dS^T
          }
        }
      uint32_t av[2][4], ak[2][4];
      to_a_frags(st, av);
      to_a_frags(dpt, ak);
      wg_fence();
      gemm_acc<D>(dva, av, Gc, 2 * half);  // dV += (P^T M) dO
      gemm_acc<D>(dka, ak, Qc, 2 * half);  // dK += dS^T Q
      wg_commit();
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    fence_regs(dva[p]);
    fence_regs(dka[p]);
  }
  store_acc<D>(dk, dkv, b, h, k0, seq, dka);
  store_acc<D>(dv, dvv, b, h, k0, seq, dva);
}

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* g, const float* lse,
                  const float* delta, const int* kv_mask, void* dk, void* dv, int B, int H,
                  int seq, View qv, View kvw, View vv, View gv, View dkv, View dvv, float scale,
                  int causal, const uint32_t* keep_bits, float drop_scale, cudaStream_t stream) {
  constexpr int smem = (2 + 2 * kStages) * tc::tile_bytes<D>() + 256 * kStages * 4 + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (seq + 63) / 64);
  flash_bwd_dkv_tc<D><<<grid, tc::kThreadsTC, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)g, lse, delta, kv_mask, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, qv,
      kvw, vv, gv, dkv, dvv, H, seq, scale, causal, keep_bits, drop_scale);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; lse and delta
// are (B, H, T) float32, kv_mask (B, T) int32 or null, keep_bits the
// dropout pre-pass's bits (flash_bwd_keep.cu) or null without dropout, each
// kept score scaled by drop_scale.  bf16 tensors need 16-byte aligned rows.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int dtt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* g, const float* lse,
                                 const float* delta, const int* kv_mask, void* dk, void* dv,
                                 int B, int H, int seq, long long q_sb, long long q_st,
                                 long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh, long long g_sb,
                                 long long g_st, long long g_sh, long long dk_sb,
                                 long long dk_st, long long dk_sh, long long dv_sb,
                                 long long dv_st, long long dv_sh, float scale, int causal,
                                 const unsigned int* keep_bits, float drop_scale, void* stream) {
  using namespace dtt;
  const View qv{q_sb, q_st, q_sh}, kvw{k_sb, k_st, k_sh}, vv{v_sb, v_st, v_sh},
      gv{g_sb, g_st, g_sh}, dkv{dk_sb, dk_st, dk_sh}, dvv{dv_sb, dv_st, dv_sh};
  const cudaStream_t stm = (cudaStream_t)stream;
#define DTT_DKV_FMA(D) launch_dkv_fma<D>(q, k, v, g, lse, delta, kv_mask, dk, dv, B, H, seq, qv, kvw, vv, gv, dkv, dvv, scale, causal, keep_bits, drop_scale, stm)
#define DTT_DKV_TC(D) launch_dkv_tc<D>(q, k, v, g, lse, delta, kv_mask, dk, dv, B, H, seq, qv, kvw, vv, gv, dkv, dvv, scale, causal, keep_bits, drop_scale, stm)
  if (dtype == 0) {
    DTT_HEAD_DIMS(head_dim, DTT_DKV_FMA);
  } else if (dtype == 1) {
    DTT_HEAD_DIMS(head_dim, DTT_DKV_TC);
  }
#undef DTT_DKV_FMA
#undef DTT_DKV_TC
  return (int)cudaErrorInvalidValue;
}
