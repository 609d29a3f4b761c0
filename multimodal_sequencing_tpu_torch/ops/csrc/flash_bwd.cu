// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels `multimodal_sequencing_tpu/ops/attention.py::
// _flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (both launched by
// `flash_attention_bwd`, which also computes delta = rowsum(dO * O) in
// XLA). Same function, from the forward's saved O and lse:
//   s = scale * Q K^T, p = where(key kept, exp(s - lse), 0),
//   dp = dO V^T, dropped by the forward's keep bits and rescaled by 1/keep,
//   ds = p * (dp - delta),
//   dq = scale * ds K, dk = scale * ds^T Q, dv = (dropped p)^T dO.
// A key the mask drops, or a key beyond S, gets p = 0 by select: a fully
// masked batch row gets zero gradient (its lse is ~-1e9, so exp(s - lse)
// overflows, and the select keeps that from reaching the sums). A q row
// beyond S gets lse = +inf and so p = 0.
//
// bf16 (the training path): three launches.
//  * Pre-pass `flash_bwd_prep_kernel`: delta = rowsum(dO * O) in f32 from
//    bf16 O and dO, lse * log2(e), both padded to S_pad (a multiple of 64;
//    lse +inf and delta 0 past S), and a zeroed (B*H, S_pad, D) f32 dq
//    accumulator with its B*H*S_pad/64 int32 turn counters after it.
//  * Main `flash_bwd_main_kernel`: one warpgroup (128 threads) per
//    (batch*head, 64-key tile). Its K and V tiles arrive once by TMA; then
//    it walks over the 64-row q tiles, whose Q, dO, lse and delta TMA brings
//    into a ring of two stages under mbarriers, so tile i+1 loads while
//    tile i computes. A tile is one TMA box, swizzled by TMA in the pattern
//    that wgmma reads (128-byte swizzle at D = 64), so neither the copy nor
//    the products pay for bank conflicts or for many small requests. Per q tile, five `wgmma` products with f32
//    accumulators: S^T = K Q^T and dP^T = V dO^T (shared-memory operands as
//    stored); p, the dropped p and dS from one exp2 and one keep bit per
//    element; dV += P~^T dO and dK += dS^T Q with the re-packed
//    accumulators as register A operands and dO, Q read MN-major from the
//    same tiles (no transposed copy); dS^T goes once to shared memory in
//    bf16 for dQ_partial = dS K, which goes through shared memory into the
//    f32 accumulator as one TMA bulk reduce-add per q tile
//    (`cp.reduce.async.bulk .add.f32`), overlapped with the next tile. The
//    blocks of one head add their partials to a q tile in a fixed order,
//    so dq is the same in every run: block kt takes the q tiles in the
//    order kt, kt+1, ... (mod n), so at step i its partial goes to tile
//    (kt + i) mod n as that tile's i-th add. It waits until the tile's
//    turn counter reads i, and once the add is complete (checked at the
//    next step's dS store, so the wait is hidden) it sets the counter to
//    i + 1; the tile's last add sets it back to 0 for the next launch. The
//    add that a block waits for is the one block kt+1 made a step before,
//    so the blocks of a head do not queue behind each other. dK
//    and dV stay in registers until the end. S^T and dP^T are taken in two
//    passes of 32 q columns, which keeps a thread at <= 168 registers with
//    no spills, so three blocks share an SM and hide part of each other's
//    latency: a block runs its phases in turn (products, the exp and hash
//    work, the dS store, the next three products), which is what holds the
//    kernel above its bound.
//  * Post-pass `flash_bwd_post_kernel`: dq = scale * accumulator in bf16,
//    laid out as the caller asks (the accumulator's rows are chunk-swizzled
//    so that the main kernel's shared-memory stores of its partials are
//    free of bank conflicts; the post-pass undoes it).
// dq, dk and dv are summed in a fixed order, so equal inputs give equal
// bits in every run.
//
// f32 (exact checks): `flash_bwd_dq_f32_kernel` and
// `flash_bwd_dkv_f32_kernel`, one thread per row, scalar FMA, with delta
// computed outside. They are bit-equal to the plain backward on the card.
//
// Bound on this card at the train shape (B*H = 128, S = 320, D = 64, bf16):
// the backward reads Q, K, V, O, dO and writes dQ, dK, dV, 8 x 5.24 MB,
// plus lse and the mask, ~42.3 MB: 12.6 us at the published 3.35 TB/s;
// five products of 2*S^2*D per head, 8.4 GFLOP: 8.5 us at 989 TFLOP/s. So
// bytes bound it. Beside that bound, the keep-bit hash costs ~13 integer
// operations per element of the B*H*S^2 = 13.1 M, ~0.17 G operations,
// ~12 us at 132 SMs x 64 integer operations per clock x ~1.75 GHz; this
// design hashes each element once (the earlier dq and dk/dv kernels hashed
// it twice). Its times are in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "keep_bits.cuh"
#include "sm90.cuh"
#include "tensor_map.cuh"  // head_map, kmajor_at, mnmajor_at

namespace {

constexpr int BLOCK = 64;        // rows of a key tile and of a q tile
constexpr int F32_Q_TILE = 32;   // q rows per loop tile of the f32 dk/dv kernel
constexpr int STAGES = 2;        // q tiles in flight in the bf16 main kernel
constexpr float LOG2E = 1.4426950408889634f;
// main kernel: blocks an SM holds (registers <= 168 a thread, no spills),
// and the passes over a q tile's 64 columns for S^T and dP^T (two passes of
// 32 keep half of their accumulators live, 32 registers fewer than one pass
// of 64, which is what lets three blocks fit)
constexpr int MIN_BLOCKS = 3;
constexpr int HALVES = 2;

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
  BhIndex gbh;       // the heads' global index (keep_bits.cuh)
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
  const uint32_t seed_bh = seed_for_head(p.seed, p.gbh, b, h);
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
  const uint32_t seed_bh = seed_for_head(p.seed, p.gbh, b, h);
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

// ----- bf16: pre-pass -------------------------------------------------------------

struct PrepParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dO;
  const float* lse;   // (B*H, S)
  float* lse2;        // (B*H, S_pad): lse * log2(e), +inf past S
  float* delta;       // (B*H, S_pad): rowsum(dO * O), 0 past S
  float* acc;         // (B*H, S_pad, D), zeroed
  int* turn;          // (B*H, S_pad / 64), zeroed
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  int H, S, S_pad;
};

// D / 8 consecutive threads per padded row, 16 bytes of O and dO each.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_prep_kernel(const PrepParams p) {
  constexpr int G = D / 8;
  const long long gid = blockIdx.x * 128ll + threadIdx.x;
  const long long row = gid / G;  // over B*H*S_pad; the grid covers it exactly
  const int c = static_cast<int>(gid % G);
  const int bh = static_cast<int>(row / p.S_pad);
  const int s = static_cast<int>(row % p.S_pad), b = bh / p.H, h = bh % p.H;
  float sum = 0.f;
  if (s < p.S) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        p.o + b * p.o_sb + h * p.o_sh + s * p.o_ss + c * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        p.dO + b * p.do_sb + h * p.do_sh + s * p.do_ss + c * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]), gf = __bfloat1622float2(g2[i]);
      sum = fmaf(gf.x, of.x, sum);
      sum = fmaf(gf.y, of.y, sum);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (c == 0) {
    p.delta[row] = sum;
    p.lse2[row] = s < p.S ? p.lse[(long long)bh * p.S + s] * LOG2E : INFINITY;
  }
  float4* a = reinterpret_cast<float4*>(p.acc + row * D + c * 8);
  a[0] = a[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c == 0 && s % BLOCK == 0) p.turn[row / BLOCK] = 0;
}

// ----- bf16: main -----------------------------------------------------------------

struct MainParams {
  const int* mask;      // (B, S)
  const float* lse2;    // (B*H, S_pad)
  const float* delta;   // (B*H, S_pad)
  float* acc;           // (B*H, S_pad, D): dq / scale, accumulated
  int* turn;            // (B*H, S_pad / 64): adds made to each q tile
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int H, S, S_pad;
  float scale, scale_log2;
  uint32_t seed, thresh;
  float inv_keep;
  BhIndex gbh;
};

// The dq accumulator holds rows of D f32 with their 16-byte chunks
// swizzled: chunk c of row r sits at chunk c ^ (r & dq_swizzle<D>()).
template <int D>
__host__ __device__ constexpr int dq_swizzle() { return (D / 4 < 8 ? D / 4 : 8) - 1; }

// Q, K, V and dO tiles: tensor_map.cuh's swizzled 64-row tiles, each on a
// 1 KB boundary. dS^T: the slab layout of sm90.cuh.
template <int D>
struct MainSmem {
  __nv_bfloat16 k[BLOCK * D];
  __nv_bfloat16 v[BLOCK * D];
  __nv_bfloat16 q[STAGES][BLOCK * D];
  __nv_bfloat16 dO[STAGES][BLOCK * D];
  __nv_bfloat16 ds[BLOCK * BLOCK];  // dS^T (key, q) at ((q/8)*64 + key)*8 + q%8
  float dqs[BLOCK * D];  // dQ partial, rows of D f32 in swizzled 16-byte chunks
  float lse2[STAGES][BLOCK];
  float delta[STAGES][BLOCK];
  uint64_t full[STAGES];
  uint64_t kv;
};

// Rows [row0, row0 + 64) of one head of a (B, S, H, D)-indexed tensor map
// (tensor_map.cuh's tile).
template <int D>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          __nv_bfloat16* dst, int row0, int h,
                                          int b, uint64_t* bar) {
  tma_load_4d(dst, map, bar, 0, row0, h, b);
}
// dS^T in the slab layout, MN-major (q runs along a slab)
__device__ __forceinline__ uint64_t ds_desc(const __nv_bfloat16* t, int kk) {
  return wgmma_desc(t + kk * 16 * 8, 128, BLOCK * 16);
}

template <int D>
__global__ void __launch_bounds__(128, MIN_BLOCKS)
flash_bwd_main_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const MainParams p) {
  constexpr int TILE_BYTES = BLOCK * D * 2;
  constexpr uint32_t STAGE_TX = 2 * TILE_BYTES + 2 * BLOCK * 4;
  constexpr int DH = D / 2;  // accumulator floats a thread of a 64 x D product
  constexpr int SWZ = dq_swizzle<D>();
  constexpr int NQ = BLOCK / HALVES;  // q columns of S^T and dP^T a pass
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzled tiles start on 1 KB boundaries
  MainSmem<D>& sm = *reinterpret_cast<MainSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kt = blockIdx.x, k0 = kt * BLOCK, S = p.S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (S + BLOCK - 1) / BLOCK;  // = gridDim.x
  const float* lse2 = p.lse2 + (long long)bh * p.S_pad;
  const float* delta = p.delta + (long long)bh * p.S_pad;
  int* turn = p.turn + (long long)bh * n_qt;
  // the q tile of step i, whose i-th add this block makes
  auto q_tile = [&](int i) { return kt + i < n_qt ? kt + i : kt + i - n_qt; };

  auto issue_q_tile = [&](int i) {
    const int st = i % STAGES, row0 = q_tile(i) * BLOCK;
    mbar_expect_tx(&sm.full[st], STAGE_TX);
    load_tile<D>(&map_q, sm.q[st], row0, h, b, &sm.full[st]);
    load_tile<D>(&map_do, sm.dO[st], row0, h, b, &sm.full[st]);
    bulk_load(sm.lse2[st], lse2 + row0, BLOCK * 4, &sm.full[st]);
    bulk_load(sm.delta[st], delta + row0, BLOCK * 4, &sm.full[st]);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&sm.full[s], 1);
    mbar_init(&sm.kv, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.kv, 2 * TILE_BYTES);
    load_tile<D>(&map_k, sm.k, k0, h, b, &sm.kv);
    load_tile<D>(&map_v, sm.v, k0, h, b, &sm.kv);
    for (int i = 0; i < STAGES && i < n_qt; ++i) issue_q_tile(i);
  }

  // this thread's two accumulator rows are keys k0 + 16 warp + g (+ 8)
  const int key0 = k0 + warp * 16 + g;
  bool kept[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kept[i] = key0 + 8 * i < S && p.mask[(long long)b * S + key0 + 8 * i] != 0;
  const uint32_t seed_bh = seed_for_head(p.seed, p.gbh, b, h);

  float dk[DH], dv[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&sm.kv, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int st = it % STAGES, q0 = q_tile(it) * BLOCK;
    mbar_wait(&sm.full[st], (it / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T (rows = keys, columns = q rows), in
    // HALVES passes of NQ q columns, so fewer accumulators are live at once
    uint32_t pa[4][4], da[4][4];  // P~^T and dS^T as A operands, 16 q a step
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
      float s[NQ / 2], dp[NQ / 2];
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) s[i] = dp[i] = 0.f;
      const int n0 = hf * NQ;  // first q row of the pass
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        Wgmma<NQ>::template ss<0, 0>(s, kmajor_at<D>(sm.k, 0, ks),
                                     kmajor_at<D>(sm.q[st], n0, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        Wgmma<NQ>::template ss<0, 0>(dp, kmajor_at<D>(sm.v, 0, ks),
                                     kmajor_at<D>(sm.dO[st], n0, ks), ks > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // p, the dropped p (into s) and dS (into dp): one exp2, one keep bit
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = hf * NQ + 8 * j + 2 * t + (e & 1), i = e >> 1;
          const float pv = kept[i] ? fast_exp2(fmaf(s[4 * j + e], p.scale_log2,
                                                    -sm.lse2[st][col]))
                                   : 0.f;
          float pd = pv, dpv = dp[4 * j + e];
          if (p.thresh) {
            const bool kb = keep_bit(seed_bh, q0 + col, key0 + 8 * i, S, p.thresh);
            pd = kb ? pv * p.inv_keep : 0.f;
            dpv = kb ? dpv * p.inv_keep : 0.f;
          }
          s[4 * j + e] = pd;
          dp[4 * j + e] = pv * (dpv - sm.delta[st][col]);
        }
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        pack_a(pa[hf * NQ / 16 + kk], s + 8 * kk);
        pack_a(da[hf * NQ / 16 + kk], dp + 8 * kk);
      }
    }
    // dS^T to shared memory, MN-major for dQ = dS K (q runs along a slab)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(
            &sm.ds[(j * BLOCK + warp * 16 + g + 8 * i) * 8 + 2 * t]) =
            da[j / 2][(j & 1) * 2 + i];
    fence_proxy_async();
    if (tid == 0 && it > 0) {
      // the last dQ partial has left dqs and is in acc: its tile's next
      // add may go
      bulk_wait_all();
      fence_proxy_async_global();
      set_flag(turn + q_tile(it - 1), it);
    }
    __syncthreads();

    // dV += P~^T dO, dK += dS^T Q, dQ_partial = dS K
    float dq[DH];  // overwritten: not live across the loop
#pragma unroll
    for (int i = 0; i < DH; ++i) dq[i] = 0.f;
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<D>::template rs<1>(dv, pa[kk], mnmajor_at<D>(sm.dO[st], kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<D>::template rs<1>(dk, da[kk], mnmajor_at<D>(sm.q[st], kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<D>::template ss<1, 1>(dq, ds_desc(sm.ds, kk), mnmajor_at<D>(sm.k, kk),
                                  kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
    // dQ partial to dqs (row-major, 16-byte chunk c of row r stored at
    // chunk c ^ (r & SWZ), so these stores are free of bank conflicts)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i, col = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(
            &sm.dqs[r * D + (((col >> 2) ^ (r & SWZ)) << 2) + (col & 3)]) =
            make_float2(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
      }
    fence_proxy_async();
    __syncthreads();  // stage st and dS are free again
    if (tid == 0) {
      if (it + STAGES < n_qt) {
        fence_proxy_async();
        issue_q_tile(it + STAGES);
      }
      // one bulk reduce-add of the 64 x D partial into the accumulator, as
      // the tile's it-th add
      wait_flag(turn + q_tile(it), it);
      fence_proxy_async_global();
      bulk_reduce_add_f32(p.acc + ((long long)bh * p.S_pad + q0) * D, sm.dqs,
                          BLOCK * D * 4);
      bulk_commit();
    }
  }
  if (tid == 0) {
    // the tile's last add: its counter back to 0 for the next launch
    bulk_wait_all();
    fence_proxy_async_global();
    set_flag(turn + q_tile(n_qt - 1), 0);
  }

  __nv_bfloat16* DK = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* DV = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(DK + key * p.dk_ss + col) =
          pack_bf16(dk[4 * j + 2 * i] * p.scale, dk[4 * j + 2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(DV + key * p.dv_ss + col) =
          pack_bf16(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// ----- bf16: post-pass ------------------------------------------------------------

struct PostParams {
  const float* acc;      // (B*H, S_pad, D)
  __nv_bfloat16* dq;
  long long dq_sb, dq_sh, dq_ss;
  int H, S, S_pad;
  float scale;
};

// One thread per 8 elements of dq.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_post_kernel(const PostParams p, long long total) {
  constexpr int G = D / 8;
  const long long gid = blockIdx.x * 256ll + threadIdx.x;
  if (gid >= total) return;
  const long long row = gid / G;  // over B*H*S
  const int c = static_cast<int>(gid % G);
  const int bh = static_cast<int>(row / p.S), s = static_cast<int>(row % p.S);
  const int b = bh / p.H, h = bh % p.H;
  const float* a = p.acc + ((long long)bh * p.S_pad + s) * D;
  const int sw = s & dq_swizzle<D>();
  const float4 x = *reinterpret_cast<const float4*>(a + (((2 * c) ^ sw) << 2));
  const float4 y = *reinterpret_cast<const float4*>(a + (((2 * c + 1) ^ sw) << 2));
  uint4 out;
  out.x = pack_bf16(x.x * p.scale, x.y * p.scale);
  out.y = pack_bf16(x.z * p.scale, x.w * p.scale);
  out.z = pack_bf16(y.x * p.scale, y.y * p.scale);
  out.w = pack_bf16(y.z * p.scale, y.w * p.scale);
  *reinterpret_cast<uint4*>(p.dq + b * p.dq_sb + h * p.dq_sh + s * p.dq_ss + c * 8) = out;
}

// ----- host ------------------------------------------------------------------------

template <int D>
void launch_f32(bool dkv, const Params& p, dim3 grid, cudaStream_t st) {
  if (dkv) flash_bwd_dkv_f32_kernel<D><<<grid, BLOCK, 0, st>>>(p);
  else flash_bwd_dq_f32_kernel<D><<<grid, BLOCK, 0, st>>>(p);
}

int run_f32(bool dkv, int head_dim, Params& p, int batch, int heads,
            int seq_len, float scale, uint32_t seed, uint32_t thresh,
            float inv_keep, const uint32_t* gbh, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (long long)batch * heads > 65535)
    return -1;
  p.H = heads; p.S = seq_len; p.scale = scale;
  p.seed = seed; p.thresh = thresh; p.inv_keep = inv_keep;
  p.gbh = bh_index(gbh);
  const dim3 grid((seq_len + BLOCK - 1) / BLOCK, batch * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: launch_f32<16>(dkv, p, grid, st); break;
    case 32: launch_f32<32>(dkv, p, grid, st); break;
    case 64: launch_f32<64>(dkv, p, grid, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

void set_strides(long long& sb, long long& sh, long long& ss,
                 const long long* s) {
  sb = s[0]; sh = s[1]; ss = s[2];
}

bool bf16_shape_ok(int head_dim, int batch, int heads, int seq_len,
                   int s_pad) {
  return (head_dim == 16 || head_dim == 32 || head_dim == 64) && batch > 0 &&
         heads > 0 && seq_len > 0 && (long long)batch * heads <= 65535 &&
         s_pad % BLOCK == 0 && s_pad >= seq_len && s_pad < seq_len + BLOCK;
}

// The main kernel's turn counters, which follow the accumulator.
int* turn_counters(float* acc, int bh, int s_pad, int head_dim) {
  return reinterpret_cast<int*>(acc + (long long)bh * s_pad * head_dim);
}

template <int D>
int launch_prep(const PrepParams& p, int bh, cudaStream_t st) {
  const long long threads = (long long)bh * p.S_pad * (D / 8);  // a multiple of 128
  flash_bwd_prep_kernel<D><<<(unsigned)(threads / 128), 128, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_main(const CUtensorMap (&maps)[4], const MainParams& p, int bh,
                cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(MainSmem<D>)) + 1024;
  cudaError_t err = allow_smem<flash_bwd_main_kernel<D>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + BLOCK - 1) / BLOCK, bh);
  flash_bwd_main_kernel<D><<<grid, 128, smem, st>>>(maps[0], maps[1], maps[2],
                                                    maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_post(const PostParams& p, int bh, cudaStream_t st) {
  const long long total = (long long)bh * p.S * (D / 8);
  flash_bwd_post_kernel<D><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 dq kernel. strides: (batch, head, row) element strides of q, k,
// v, dO and dq in that order; head dims contiguous. lse and delta: (B*H, S) f32. seed, thresh, inv_keep: the
// forward's dropout (thresh = 0: none). Returns 0, a CUDA error code from
// the launch, or -1 for arguments the kernel does not take.
extern "C" int flash_bwd_dq(int head_dim, const void* q, const void* k,
                            const void* v, const void* dO, const int* mask,
                            const float* lse, const float* delta, void* dq,
                            int batch, int heads, int seq_len,
                            const long long* strides, float scale,
                            uint32_t seed, uint32_t thresh, float inv_keep,
                            const uint32_t* gbh, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dO = dO; p.mask = mask; p.lse = lse;
  p.delta = delta; p.dq = dq;
  set_strides(p.q_sb, p.q_sh, p.q_ss, strides);
  set_strides(p.k_sb, p.k_sh, p.k_ss, strides + 3);
  set_strides(p.v_sb, p.v_sh, p.v_ss, strides + 6);
  set_strides(p.do_sb, p.do_sh, p.do_ss, strides + 9);
  set_strides(p.dq_sb, p.dq_sh, p.dq_ss, strides + 12);
  return run_f32(false, head_dim, p, batch, heads, seq_len, scale, seed,
                 thresh, inv_keep, gbh, stream);
}

// The f32 dk/dv kernels: as flash_bwd_dq, with the strides of q, k, v, dO,
// dk and dv.
extern "C" int flash_bwd_dkv(int head_dim, const void* q, const void* k,
                             const void* v, const void* dO, const int* mask,
                             const float* lse, const float* delta, void* dk,
                             void* dv, int batch, int heads, int seq_len,
                             const long long* strides, float scale,
                             uint32_t seed, uint32_t thresh, float inv_keep,
                             const uint32_t* gbh, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dO = dO; p.mask = mask; p.lse = lse;
  p.delta = delta; p.dk = dk; p.dv = dv;
  set_strides(p.q_sb, p.q_sh, p.q_ss, strides);
  set_strides(p.k_sb, p.k_sh, p.k_ss, strides + 3);
  set_strides(p.v_sb, p.v_sh, p.v_ss, strides + 6);
  set_strides(p.do_sb, p.do_sh, p.do_ss, strides + 9);
  set_strides(p.dk_sb, p.dk_sh, p.dk_ss, strides + 12);
  set_strides(p.dv_sb, p.dv_sh, p.dv_ss, strides + 15);
  return run_f32(true, head_dim, p, batch, heads, seq_len, scale, seed,
                 thresh, inv_keep, gbh, stream);
}

// bf16 pre-pass. o, dO: bf16 with (batch, head, row) element strides
// `strides` (o's three, then dO's). lse: (B*H, S) f32. Writes delta and
// lse2 ((B*H, s_pad) f32) and zeroes acc ((B*H, s_pad, D) f32, followed in
// memory by B*H*s_pad/64 int32 turn counters, which it zeroes too); s_pad
// is S rounded up to a multiple of 64.
extern "C" int flash_bwd_prep(int head_dim, const void* o, const void* dO,
                              const float* lse, float* delta, float* lse2,
                              float* acc, int batch, int heads, int seq_len,
                              int s_pad, const long long* strides, void* stream) {
  if (!bf16_shape_ok(head_dim, batch, heads, seq_len, s_pad)) return -1;
  PrepParams p = {};
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.lse = lse; p.lse2 = lse2; p.delta = delta; p.acc = acc;
  p.turn = turn_counters(acc, batch * heads, s_pad, head_dim);
  set_strides(p.o_sb, p.o_sh, p.o_ss, strides);
  set_strides(p.do_sb, p.do_sh, p.do_ss, strides + 3);
  p.H = heads; p.S = seq_len; p.S_pad = s_pad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (head_dim) {
    case 16: return launch_prep<16>(p, bh, st);
    case 32: return launch_prep<32>(p, bh, st);
    default: return launch_prep<64>(p, bh, st);
  }
}

// bf16 main kernel: dk and dv, and dq / scale added into acc. strides: the
// (batch, head, row) element strides of q, k, v, dO, dk and dv; q, k, v and
// dO 16-byte aligned with row, head and batch strides that are multiples of
// 8 elements (what the tensor maps take). lse2, delta, acc and its turn
// counters: from flash_bwd_prep; the counters are 0 again when it ends.
// Returns 0, a CUDA error code, -1 for arguments it does
// not take, or -2 when a tensor map cannot be made.
extern "C" int flash_bwd_main(int head_dim, const void* q, const void* k,
                              const void* v, const void* dO, const int* mask,
                              const float* lse2, const float* delta, float* acc,
                              void* dk, void* dv, int batch, int heads,
                              int seq_len, int s_pad, const long long* strides,
                              float scale, uint32_t seed, uint32_t thresh,
                              float inv_keep, const uint32_t* gbh,
                              void* stream) {
  if (!bf16_shape_ok(head_dim, batch, heads, seq_len, s_pad)) return -1;
  CUtensorMap maps[4];
  const void* srcs[4] = {q, k, v, dO};
  for (int i = 0; i < 4; ++i)
    if (!head_map(&maps[i], srcs[i], batch, heads, seq_len, head_dim,
                  strides + 3 * i))
      return -2;
  MainParams p = {};
  p.mask = mask; p.lse2 = lse2; p.delta = delta; p.acc = acc;
  p.turn = turn_counters(acc, batch * heads, s_pad, head_dim);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  set_strides(p.dk_sb, p.dk_sh, p.dk_ss, strides + 12);
  set_strides(p.dv_sb, p.dv_sh, p.dv_ss, strides + 15);
  p.H = heads; p.S = seq_len; p.S_pad = s_pad;
  p.scale = scale; p.scale_log2 = scale * LOG2E;
  p.seed = seed; p.thresh = thresh; p.inv_keep = inv_keep;
  p.gbh = bh_index(gbh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (head_dim) {
    case 16: return launch_main<16>(maps, p, bh, st);
    case 32: return launch_main<32>(maps, p, bh, st);
    default: return launch_main<64>(maps, p, bh, st);
  }
}

// bf16 post-pass: dq = scale * acc in bf16, with dq's (batch, head, row)
// element strides.
extern "C" int flash_bwd_post(int head_dim, const float* acc, void* dq,
                              int batch, int heads, int seq_len, int s_pad,
                              const long long* strides, float scale,
                              void* stream) {
  if (!bf16_shape_ok(head_dim, batch, heads, seq_len, s_pad)) return -1;
  PostParams p = {};
  p.acc = acc;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  set_strides(p.dq_sb, p.dq_sh, p.dq_ss, strides);
  p.H = heads; p.S = seq_len; p.S_pad = s_pad; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (head_dim) {
    case 16: return launch_post<16>(p, bh, st);
    case 32: return launch_post<32>(p, bh, st);
    default: return launch_post<64>(p, bh, st);
  }
}
