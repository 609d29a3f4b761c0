// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// the dq kernel and the dk/dv kernel.
//
// Replaces the TPU kernels `multimodal_sequencing_tpu/ops/attention.py::
// _flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (launched by
// `flash_attention_bwd`). Same functions, from the forward's saved lse and
// delta = rowsum(dO * O) (computed outside, as in JAX):
//   s = scale * Q K^T, p = where(key kept, exp(s - lse), 0),
//   dp = dO V^T, dropped by the forward's keep bits and rescaled by 1/keep,
//   ds = p * (dp - delta),
//   dq = scale * ds K                (dq kernel, per q-tile over k-tiles)
//   dv = (dropped p)^T dO, dk = scale * ds^T Q   (dk/dv kernel, per k-tile
//                                                  over q-tiles)
// A key the mask drops, or a column beyond S, gets p = 0: a fully masked row
// gets zero gradient (its lse is ~-1e9, so exp(s - lse) overflows, and the
// select keeps that from reaching the sums). A q row beyond S gets lse = +inf
// and so p = 0. Nothing beyond S is read.
//
// Design, for this card rather than the TPU's sequential grid:
//  * Blocks run in parallel with no carried state, so each kernel owns one
//    64-row tile of its output and loops over the other operand's 64-row
//    tiles staged in shared memory; the two kernels recompute s and p
//    instead of sharing them (no atomics).
//  * bf16 (the training path): 4 warps, each owning 16 rows of the block's
//    tile, run all four products of a tile on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate). The block's own tile (Q and
//    dO for dq; K and V for dk/dv) sits in registers as A operands for the
//    whole loop; the score and dp accumulators are re-packed in registers as
//    the A operand of the products that follow, so p and ds never touch
//    shared memory. An operand read along its rows as B is stored a second
//    time transposed (K^T for dq; Q^T and dO^T for dk/dv) so each B fragment
//    is one conflict-free 32-bit load.
//  * f32 (exact checks): one thread per row, scalar FMA.
//  * The keep bits come from `keep_bits.cuh`, per element, so they equal the
//    forward's whatever the tiling.
//
// Bound on this card at the train shape (B*H = 128, S = 320, D = 64, bf16):
// dq reads q, k, v, dO (4 x 5.24 MB), lse and delta and writes dq, ~26.5 MB,
// and does 3 products of 2*S^2*D per head (plus the recomputed Q K^T),
// ~5.0 GFLOP: ~7.9 us by bytes at the published 3.35 TB/s. dk/dv reads the
// same and writes dk and dv, ~31.8 MB and 4 products, ~6.7 GFLOP: ~9.5 us.
// This first version re-reads the other operand's tiles once per block from
// L2, does not overlap loads with products (no cp.async/TMA, no wgmma) and
// recomputes Q K^T and dO V^T in both kernels; its times are in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "keep_bits.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BLOCK = 64;        // rows of the block's own tile, and of a loop tile
constexpr int F32_Q_TILE = 32;   // q rows per loop tile of the f32 dk/dv kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const int* mask;     // (B, S) int32 key keep-mask
  const float* lse;    // (B*H, S)
  const float* delta;  // (B*H, S)
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int H, S;
  float scale;
  uint32_t seed;     // dropout seed (int32 bits)
  uint32_t thresh;   // keep threshold on the 31-bit hash; 0 = no dropout
  float inv_keep;    // 1 / (1 - p_drop)
};

template <typename T>
__device__ __forceinline__ const T* head(const void* base, long long sb,
                                         long long sh, int b, int h) {
  return static_cast<const T*>(base) + b * sb + h * sh;
}

template <typename T>
__device__ __forceinline__ T* head_out(void* base, long long sb, long long sh,
                                       int b, int h) {
  return static_cast<T*>(base) + b * sb + h * sh;
}

// Rows [r0, r0 + BLOCK) of a (S, D) bf16 matrix with row stride ss into
// shared memory: row-major into `rm` and/or transposed into `tr`; rows at or
// beyond S are zeros.
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* src,
                                           long long ss, int r0, int S,
                                           __nv_bfloat16 (*rm)[D + 8],
                                           __nv_bfloat16 (*tr)[BLOCK + 8]) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BLOCK * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + col);
    if (rm) *reinterpret_cast<uint4*>(&rm[r][col]) = val;
    if (tr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[col + i][r] = e[i];
    }
  }
}

// A-operand fragments of this warp's 16 rows of a row-major staged tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       __nv_bfloat16 (*sm)[D + 8], int r0,
                                       int t) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    a[ks][0] = ld32(&sm[r0][ks * 16 + 2 * t]);
    a[ks][1] = ld32(&sm[r0 + 8][ks * 16 + 2 * t]);
    a[ks][2] = ld32(&sm[r0][ks * 16 + 8 + 2 * t]);
    a[ks][3] = ld32(&sm[r0 + 8][ks * 16 + 8 + 2 * t]);
  }
}

// acc[nt] (16 x 64) = A (16 x D, registers) . B^T, B a row-major staged tile
// (64 x D): the product of this warp's rows with every row of the tile.
template <int D>
__device__ __forceinline__ void rows_dot_tile(float (&acc)[BLOCK / 8][4],
                                              const uint32_t (&a)[D / 16][4],
                                              __nv_bfloat16 (*sm)[D + 8],
                                              int g, int t) {
#pragma unroll
  for (int nt = 0; nt < BLOCK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const __nv_bfloat16* br = &sm[nt * 8 + g][ks * 16 + 2 * t];
      mma_16816(acc[nt], a[ks], ld32(br), ld32(br + 8));
    }
  }
}

// out[dt] (16 x D) += P (16 x 64, accumulators) . M, M (64 x D) staged
// transposed as tr[d][row].
template <int D>
__device__ __forceinline__ void acc_times_tile(float (&out)[D / 8][4],
                                               const float (&pm)[BLOCK / 8][4],
                                               __nv_bfloat16 (*tr)[BLOCK + 8],
                                               int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BLOCK / 16; ++kk) {
    uint32_t pa[4];
    acc_to_a(pa, pm[2 * kk], pm[2 * kk + 1]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* br = &tr[dt * 8 + g][kk * 16 + 2 * t];
      mma_16816(out[dt], pa, ld32(br), ld32(br + 8));
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss,
                                           const float (&acc)[D / 8][4],
                                           int row0, int S, float mul, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + row * ss + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * i] * mul, acc[dt][2 * i + 1] * mul);
  }
}

// ----- dq, bf16 ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int NT = BLOCK / 8, DT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 sK[BLOCK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 sV[BLOCK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 sKt[D][BLOCK + 8];
  __shared__ int sKeep[BLOCK];

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BLOCK, S = p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16 + g;
  using bf = __nv_bfloat16;
  const bf* Q = head<bf>(p.q, p.q_sb, p.q_sh, b, h);
  const bf* K = head<bf>(p.k, p.k_sb, p.k_sh, b, h);
  const bf* V = head<bf>(p.v, p.v_sb, p.v_sh, b, h);
  const bf* dO = head<bf>(p.dO, p.do_sb, p.do_sh, b, h);
  const int* M = p.mask + (long long)b * S;
  const uint32_t seed_bh = seed_for_bh(p.seed, bh);

  // this block's Q and dO rows as A fragments, staged through sK / sV
  stage_bf16<D>(Q, p.q_ss, q0, S, sK, nullptr);
  stage_bf16<D>(dO, p.do_ss, q0, S, sV, nullptr);
  __syncthreads();
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, sK, r0, t);
  load_a<D>(da, sV, r0, t);
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    lse[i] = row < S ? p.lse[(long long)bh * S + row] : INFINITY;
    delta[i] = row < S ? p.delta[(long long)bh * S + row] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int n_kt = (S + BLOCK - 1) / BLOCK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK;
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D>(K, p.k_ss, k0, S, sK, sKt);
    stage_bf16<D>(V, p.v_ss, k0, S, sV, nullptr);
    for (int j = threadIdx.x; j < BLOCK; j += blockDim.x)
      sKeep[j] = k0 + j < S && M[k0 + j] != 0;
    __syncthreads();

    float s[NT][4], dp[NT][4];
    rows_dot_tile<D>(s, qa, sK, g, t);
    rows_dot_tile<D>(dp, da, sV, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1), i = e >> 1;
        const float pv = sKeep[col] ? expf(s[nt][e] * p.scale - lse[i]) : 0.f;
        float dpv = dp[nt][e];
        if (p.thresh)
          dpv = keep_bit(seed_bh, q0 + r0 + 8 * i, k0 + col, S, p.thresh)
                    ? dpv * p.inv_keep : 0.f;
        s[nt][e] = pv * (dpv - delta[i]);  // ds
      }
    acc_times_tile<D>(acc, s, sKt, g, t);
  }
  store_rows<D>(head_out<bf>(p.dq, p.dq_sb, p.dq_sh, b, h), p.dq_ss, acc,
                q0 + r0, S, p.scale, t);
}

// ----- dk / dv, bf16 ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_bf16_kernel(const Params p) {
  constexpr int NT = BLOCK / 8, DT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 sQ[BLOCK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 sDO[BLOCK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 sQt[D][BLOCK + 8];
  __shared__ __align__(16) __nv_bfloat16 sDOt[D][BLOCK + 8];
  __shared__ float sLse[BLOCK], sDelta[BLOCK];

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BLOCK, S = p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16 + g;
  using bf = __nv_bfloat16;
  const bf* Q = head<bf>(p.q, p.q_sb, p.q_sh, b, h);
  const bf* K = head<bf>(p.k, p.k_sb, p.k_sh, b, h);
  const bf* V = head<bf>(p.v, p.v_sb, p.v_sh, b, h);
  const bf* dO = head<bf>(p.dO, p.do_sb, p.do_sh, b, h);
  const int* M = p.mask + (long long)b * S;
  const uint32_t seed_bh = seed_for_bh(p.seed, bh);

  // this block's K and V rows (keys) as A fragments, staged through sQ / sDO
  stage_bf16<D>(K, p.k_ss, k0, S, sQ, nullptr);
  stage_bf16<D>(V, p.v_ss, k0, S, sDO, nullptr);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, sQ, r0, t);
  load_a<D>(va, sDO, r0, t);
  bool kept[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + 8 * i;
    kept[i] = key < S && M[key] != 0;
  }

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  const int n_qt = (S + BLOCK - 1) / BLOCK;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BLOCK;
    __syncthreads();
    stage_bf16<D>(Q, p.q_ss, q0, S, sQ, sQt);
    stage_bf16<D>(dO, p.do_ss, q0, S, sDO, sDOt);
    for (int j = threadIdx.x; j < BLOCK; j += blockDim.x) {
      const bool in = q0 + j < S;
      sLse[j] = in ? p.lse[(long long)bh * S + q0 + j] : INFINITY;
      sDelta[j] = in ? p.delta[(long long)bh * S + q0 + j] : 0.f;
    }
    __syncthreads();

    // s^T and dp^T: rows = this warp's 16 keys, columns = the tile's q rows
    float st[NT][4], dpt[NT][4];
    rows_dot_tile<D>(st, ka, sQ, g, t);
    rows_dot_tile<D>(dpt, va, sDO, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1), i = e >> 1;
        const float pv = kept[i] ? expf(st[nt][e] * p.scale - sLse[col]) : 0.f;
        float pctx = pv, dpv = dpt[nt][e];
        if (p.thresh) {
          const bool kb = keep_bit(seed_bh, q0 + col, k0 + r0 + 8 * i, S, p.thresh);
          pctx = kb ? pv * p.inv_keep : 0.f;
          dpv = kb ? dpv * p.inv_keep : 0.f;
        }
        st[nt][e] = pctx;                         // dropped p^T
        dpt[nt][e] = pv * (dpv - sDelta[col]);    // ds^T
      }
    acc_times_tile<D>(dv, st, sDOt, g, t);
    acc_times_tile<D>(dk, dpt, sQt, g, t);
  }
  store_rows<D>(head_out<bf>(p.dk, p.dk_sb, p.dk_sh, b, h), p.dk_ss, dk,
                k0 + r0, S, p.scale, t);
  store_rows<D>(head_out<bf>(p.dv, p.dv_sb, p.dv_sh, b, h), p.dv_ss, dv,
                k0 + r0, S, 1.f, t);
}

// ----- f32 (exact checks) -------------------------------------------------------

// One thread per q row; K/V tiles read as shared-memory broadcasts.
template <int D>
__global__ void __launch_bounds__(BLOCK)
flash_bwd_dq_f32_kernel(const Params p) {
  __shared__ float sK[BLOCK][D];
  __shared__ float sV[BLOCK][D];
  __shared__ int sKeep[BLOCK];
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int row = blockIdx.x * BLOCK + threadIdx.x, S = p.S;
  const float* Q = head<float>(p.q, p.q_sb, p.q_sh, b, h);
  const float* K = head<float>(p.k, p.k_sb, p.k_sh, b, h);
  const float* V = head<float>(p.v, p.v_sb, p.v_sh, b, h);
  const float* dO = head<float>(p.dO, p.do_sb, p.do_sh, b, h);
  const int* M = p.mask + (long long)b * S;
  const uint32_t seed_bh = seed_for_bh(p.seed, bh);
  const bool in = row < S;

  float q[D], g[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = in ? Q[row * p.q_ss + d] : 0.f;
    g[d] = in ? dO[row * p.do_ss + d] : 0.f;
    acc[d] = 0.f;
  }
  const float lse = in ? p.lse[(long long)bh * S + row] : INFINITY;
  const float delta = in ? p.delta[(long long)bh * S + row] : 0.f;

  const int n_kt = (S + BLOCK - 1) / BLOCK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK;
    __syncthreads();
    for (int c = threadIdx.x; c < BLOCK * D; c += blockDim.x) {
      const int r = c / D, col = c % D;
      const bool ok = k0 + r < S;
      sK[r][col] = ok ? K[(k0 + r) * p.k_ss + col] : 0.f;
      sV[r][col] = ok ? V[(k0 + r) * p.v_ss + col] : 0.f;
    }
    for (int j = threadIdx.x; j < BLOCK; j += blockDim.x)
      sKeep[j] = k0 + j < S && M[k0 + j] != 0;
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < BLOCK; ++j) {
      if (!sKeep[j]) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q[d], sK[j][d], s);
        dp = fmaf(g[d], sV[j][d], dp);
      }
      const float pv = expf(s * p.scale - lse);
      if (p.thresh)
        dp = keep_bit(seed_bh, row, k0 + j, S, p.thresh) ? dp * p.inv_keep : 0.f;
      const float ds = pv * (dp - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, sK[j][d], acc[d]);
    }
  }
  if (in) {
    float* dq = head_out<float>(p.dq, p.dq_sb, p.dq_sh, b, h);
#pragma unroll
    for (int d = 0; d < D; ++d) dq[row * p.dq_ss + d] = acc[d] * p.scale;
  }
}

// One thread per key; its K row in registers, its V row in shared memory
// (padded rows, conflict-free), Q/dO tiles read as broadcasts.
template <int D>
__global__ void __launch_bounds__(BLOCK)
flash_bwd_dkv_f32_kernel(const Params p) {
  __shared__ float sQ[F32_Q_TILE][D];
  __shared__ float sDO[F32_Q_TILE][D];
  __shared__ float sVown[BLOCK][D + 1];
  __shared__ float sLse[F32_Q_TILE], sDelta[F32_Q_TILE];
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int key = blockIdx.x * BLOCK + threadIdx.x, S = p.S;
  const float* Q = head<float>(p.q, p.q_sb, p.q_sh, b, h);
  const float* K = head<float>(p.k, p.k_sb, p.k_sh, b, h);
  const float* V = head<float>(p.v, p.v_sb, p.v_sh, b, h);
  const float* dO = head<float>(p.dO, p.do_sb, p.do_sh, b, h);
  const uint32_t seed_bh = seed_for_bh(p.seed, bh);
  const bool in = key < S;
  const bool kept = in && p.mask[(long long)b * S + key] != 0;

  float k[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    k[d] = in ? K[key * p.k_ss + d] : 0.f;
    sVown[threadIdx.x][d] = in ? V[key * p.v_ss + d] : 0.f;
    dk[d] = dv[d] = 0.f;
  }

  const int n_qt = (S + F32_Q_TILE - 1) / F32_Q_TILE;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * F32_Q_TILE;
    __syncthreads();
    for (int c = threadIdx.x; c < F32_Q_TILE * D; c += blockDim.x) {
      const int r = c / D, col = c % D;
      const bool ok = q0 + r < S;
      sQ[r][col] = ok ? Q[(q0 + r) * p.q_ss + col] : 0.f;
      sDO[r][col] = ok ? dO[(q0 + r) * p.do_ss + col] : 0.f;
    }
    for (int j = threadIdx.x; j < F32_Q_TILE; j += blockDim.x) {
      const bool ok = q0 + j < S;
      sLse[j] = ok ? p.lse[(long long)bh * S + q0 + j] : INFINITY;
      sDelta[j] = ok ? p.delta[(long long)bh * S + q0 + j] : 0.f;
    }
    __syncthreads();
    if (!kept) continue;
#pragma unroll 1
    for (int j = 0; j < F32_Q_TILE; ++j) {
      if (q0 + j >= S) break;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(sQ[j][d], k[d], s);
        dp = fmaf(sDO[j][d], sVown[threadIdx.x][d], dp);
      }
      const float pv = expf(s * p.scale - sLse[j]);
      float pctx = pv;
      if (p.thresh) {
        const bool kb = keep_bit(seed_bh, q0 + j, key, S, p.thresh);
        pctx = kb ? pv * p.inv_keep : 0.f;
        dp = kb ? dp * p.inv_keep : 0.f;
      }
      const float ds = pv * (dp - sDelta[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(pctx, sDO[j][d], dv[d]);
        dk[d] = fmaf(ds, sQ[j][d], dk[d]);
      }
    }
  }
  if (in) {
    float* DK = head_out<float>(p.dk, p.dk_sb, p.dk_sh, b, h);
    float* DV = head_out<float>(p.dv, p.dv_sb, p.dv_sh, b, h);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      DK[key * p.dk_ss + d] = dk[d] * p.scale;
      DV[key * p.dv_ss + d] = dv[d];
    }
  }
}

template <int D>
void launch(bool dkv, int dtype, const Params& p, dim3 grid, cudaStream_t st) {
  if (dtype == 1) {
    if (dkv) flash_bwd_dkv_bf16_kernel<D><<<grid, 128, 0, st>>>(p);
    else flash_bwd_dq_bf16_kernel<D><<<grid, 128, 0, st>>>(p);
  } else {
    if (dkv) flash_bwd_dkv_f32_kernel<D><<<grid, BLOCK, 0, st>>>(p);
    else flash_bwd_dq_f32_kernel<D><<<grid, BLOCK, 0, st>>>(p);
  }
}

int run(bool dkv, int dtype, int head_dim, Params& p, int batch, int heads,
        int seq_len, float scale, uint32_t seed, uint32_t thresh,
        float inv_keep, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (long long)batch * heads > 65535)
    return -1;
  p.H = heads; p.S = seq_len; p.scale = scale;
  p.seed = seed; p.thresh = thresh; p.inv_keep = inv_keep;
  const dim3 grid((seq_len + BLOCK - 1) / BLOCK, batch * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: launch<16>(dkv, dtype, p, grid, st); break;
    case 32: launch<32>(dkv, dtype, p, grid, st); break;
    case 64: launch<64>(dkv, dtype, p, grid, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

void set_strides(long long& sb, long long& sh, long long& ss,
                 const long long* s) {
  sb = s[0]; sh = s[1]; ss = s[2];
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: (batch, head, row) element
// strides of q, k, v, dO and dq in that order; head dims contiguous. lse and
// delta: (B*H, S) f32. seed, thresh, inv_keep: the forward's dropout
// (thresh = 0: none). Returns 0, a CUDA error code from the launch, or -1
// for arguments the kernel does not take.
extern "C" int flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                            const void* v, const void* dO, const int* mask,
                            const float* lse, const float* delta, void* dq,
                            int batch, int heads, int seq_len,
                            const long long* strides, float scale,
                            uint32_t seed, uint32_t thresh, float inv_keep,
                            void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dO = dO; p.mask = mask; p.lse = lse;
  p.delta = delta; p.dq = dq;
  set_strides(p.q_sb, p.q_sh, p.q_ss, strides);
  set_strides(p.k_sb, p.k_sh, p.k_ss, strides + 3);
  set_strides(p.v_sb, p.v_sh, p.v_ss, strides + 6);
  set_strides(p.do_sb, p.do_sh, p.do_ss, strides + 9);
  set_strides(p.dq_sb, p.dq_sh, p.dq_ss, strides + 12);
  return run(false, dtype, head_dim, p, batch, heads, seq_len, scale, seed,
             thresh, inv_keep, stream);
}

// As flash_bwd_dq, with the strides of q, k, v, dO, dk and dv.
extern "C" int flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, const void* dO, const int* mask,
                             const float* lse, const float* delta, void* dk,
                             void* dv, int batch, int heads, int seq_len,
                             const long long* strides, float scale,
                             uint32_t seed, uint32_t thresh, float inv_keep,
                             void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dO = dO; p.mask = mask; p.lse = lse;
  p.delta = delta; p.dk = dk; p.dv = dv;
  set_strides(p.q_sb, p.q_sh, p.q_ss, strides);
  set_strides(p.k_sb, p.k_sh, p.k_ss, strides + 3);
  set_strides(p.v_sb, p.v_sh, p.v_ss, strides + 6);
  set_strides(p.do_sb, p.do_sh, p.do_ss, strides + 9);
  set_strides(p.dk_sb, p.dk_sh, p.dk_ss, strides + 12);
  set_strides(p.dv_sb, p.dv_sh, p.dv_ss, strides + 15);
  return run(true, dtype, head_dim, p, batch, heads, seq_len, scale, seed,
             thresh, inv_keep, stream);
}
