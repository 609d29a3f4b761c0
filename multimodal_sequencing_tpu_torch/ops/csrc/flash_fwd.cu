// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `multimodal_sequencing_tpu/ops/attention.py::
// _flash_fwd_kernel` (launched by `_fwd_pallas`). Same function: for each
// (batch*head) row block, an online softmax over K/V tiles with the key
// keep-mask applied by `where` (masked real keys score NEG_INF = -1e9, so a
// row whose keys are all masked comes out uniform over the S real keys), the
// context O in the input dtype and the per-row logsumexp
// lse = m + log(max(l, 1e-30)) in f32, natural log, which the backward reads.
// With dropout (thresh > 0) the HF "probs" dropout is fused in as in the
// TPU kernel: the normaliser l sums the undropped p, the context sums the
// p that `keep_bits.cuh` keeps, and O is rescaled by 1 / (1 - p_drop). The
// bits are per element, so these tiles regenerate exactly the bits of the
// TPU kernel's whole-row block and of the backward kernels.
//
// bf16 (the product), `flash_fwd_bf16_kernel`: one warpgroup (128 threads)
// a block, for one 64-row q tile of one batch*head; block x = bh * n_qt +
// q tile (batch*heads on the grid's x, which takes 2^31 - 1 blocks).
// Head dims 16, 32, 64 and 128 (ops/attention.py pads other widths up to
// the next of them with zero columns, which leave Q K^T unchanged).
//  * Loads: the Q tile once by TMA; K and V tiles by TMA into
//    a ring of two stages under mbarriers, so key tile j+1 is in flight
//    while tile j computes. Each tile is one TMA box of a 4-d tensor map over
//    the head-split (B, S, H, D) view (`tensor_map.cuh`), swizzled as wgmma
//    reads it (at D = 128 a tile is two boxes of 64 columns); rows past S
//    arrive as zeros. The block packs its batch row's
//    key mask into bits in shared memory once (2 words a key tile), since a
//    mask row of S int32 is not 16-byte aligned for TMA at S = 566.
//  * Products on `wgmma`: S = Q K^T with both operands K-major as stored
//    (SS); O += P V with the S accumulator re-packed in registers as bf16 P
//    (the RS A operand) and V read MN-major through wgmma's transpose, as
//    stored: no transposed copy of V (at D = 128 in two products of N = 64,
//    one a 64-column sub-tile of V and of the O accumulator).
//  * Softmax: online max and sum in registers, in log2 units with
//    scale * log2(e) folded into one multiply, and the hardware ex2.approx.
//    A masked real key scores MASKED2 (finite, far below any real score:
//    exp2 of its gap to a real row max is 0, and a row of masked keys has
//    max MASKED2 and weights exp2(0) = 1, whose lse is written as -1e9 +
//    log l); a key past S scores -inf (weight 0). A tile whose 64 keys are
//    all real and kept skips the selects.
//  * Epilogue: O scaled by 1/l in bf16 into the Q buffer in the map's
//    swizzle, then one TMA store into the (B, S, H, D) layout (rows past S
//    are not written); lse by the threads that own it.
//  A block of two warpgroups that share the K/V ring (FA3's shape) was
//  slower at both measured shapes (PERF.md), so a block takes one q tile.
//  Four blocks share an SM at D <= 64 (<= 128 registers a thread); at
//  D = 128 the O accumulator alone is 64 registers a thread and a block's
//  tiles 81 KB, so two.
//
// f32 (exact checks), `flash_fwd_f32_kernel`: one thread per q row (two at
// D = 128, each with half the columns and the dot products summed across
// the pair, so a thread's arrays stay in registers), scalar FMA, K/V tiles
// read as shared-memory broadcasts, the online softmax 8 keys a step.
//
// Bound on this card: at the eval shape (B*H = 512, S = 320, D = 64, bf16)
// the function moves 4*B*H*S*D*2 B (q, k, v read once, o written once) plus
// the f32 lse and the mask, ~84.6 MB, and does 4*B*H*S^2*D ~ 13.4 GFLOP. Its
// intensity, S/2 = 160 FLOP/B, is below the H100's ~295 bf16 FLOP/B ridge,
// so bytes bound it: ~25 us at the published 3.35 TB/s. At the train shape
// (B*H = 128, dropout 0.1) the bound is ~6.3 us, but the keep-bit hash, ~13
// integer operations per element of B*H*S^2 = 13.1 M, is ~10 us of integer
// work at 132 SMs x 64 operations per clock x ~1.98 GHz: a floor above the
// byte bound until the hash overlaps the products. Measured times are in
// PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "keep_bits.cuh"
#include "sm90.cuh"
#include "tensor_map.cuh"  // head_map, kmajor_at, mnmajor_at, tile_offset

namespace {

constexpr int BLOCK_M = 64;   // q rows per tile (f32: per block)
constexpr int BLOCK_N = 64;   // keys per tile
constexpr int STAGES = 2;     // K/V tiles in flight in the bf16 kernel
constexpr float MASKED = -1e9f;
constexpr float MASKED2 = -1e30f;  // a masked real key, in the log2 units
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// blocks of the bf16 kernel an SM holds: 4 at D <= 64, 2 at D = 128
template <int D>
__host__ __device__ constexpr int fwd_min_blocks() { return D > 64 ? 2 : 4; }
// f32: threads a row (a row of 128 floats in two halves), keys a tile (K
// and V tiles within 48 KB of static shared memory), and keys a step of the
// online softmax (a short unrolled body, which ptxas compiles in seconds
// where a whole tile's took minutes)
template <int D>
__host__ __device__ constexpr int f32_tpr() { return D > 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int f32_keys() { return D > 64 ? 32 : 64; }
constexpr int F32_CHUNK = 8;

// The sum of x over the two threads of a row's pair (lanes 2r, 2r + 1): both
// get the same bits (a + b == b + a). Only the pair need take part.
__device__ __forceinline__ float pair_sum(float x) {
  const unsigned lane = threadIdx.x & 31;
  return x + __shfl_xor_sync(3u << (lane & ~1u), x, 1);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;   // (B, S) int32 key keep-mask
  void* o;
  float* lse;        // (B*H, S) f32
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, S;
  float scale;
  uint32_t seed;     // dropout seed (int32 bits)
  uint32_t thresh;   // keep threshold on the 31-bit hash; 0 = no dropout
  float inv_keep;    // 1 / (1 - p_drop), 1 without dropout
  BhIndex gbh;       // the heads' global index (keep_bits.cuh)
};

// Score of one key column after the mask: 1 = keep, 0 = masked real key,
// -1 = beyond S (excluded).
__device__ __forceinline__ float masked_score(float s, int keep) {
  return keep > 0 ? s : (keep == 0 ? MASKED : -INFINITY);
}

// ----- bf16 ------------------------------------------------------------------------

struct Bf16Params {
  const int* mask;   // (B, S)
  float* lse;        // (B*H, S)
  int H, S, n_kt;    // n_kt: 64-row tiles of S (key tiles, and q tiles)
  float scale_log2;  // scale * log2(e)
  uint32_t seed, thresh;
  float inv_keep;
  BhIndex gbh;
};

template <int D>
struct Bf16Smem {
  __nv_bfloat16 q[BLOCK_M * D];  // the Q tile, then the O tile
  __nv_bfloat16 k[STAGES][BLOCK_N * D];
  __nv_bfloat16 v[STAGES][BLOCK_N * D];
  uint64_t full[STAGES];
  uint64_t qbar;
  // followed by the key mask bits: word 2 kt + c / 32, bit c % 32, is key
  // kt * 64 + c (1 = real and kept)
};

template <int D>
__global__ void __launch_bounds__(128, fwd_min_blocks<D>())
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_o,
                      const Bf16Params p) {
  constexpr int TILE_BYTES = BLOCK_N * D * 2;
  constexpr int DH = D / 2;  // O accumulator floats a thread
  constexpr int SUB = sub_cols<D>();  // columns of a sub-tile of V and O
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzled tiles start on 1 KB boundaries
  Bf16Smem<D>& sm = *reinterpret_cast<Bf16Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint32_t* keep_words = reinterpret_cast<uint32_t*>(&sm + 1);

  const int n_kt = p.n_kt;
  const int bh = blockIdx.x / n_kt, b = bh / p.H, h = bh % p.H, S = p.S;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x % n_kt) * BLOCK_M;  // the block's first q row

  auto issue_kv = [&](int i) {
    const int st = i % STAGES;
    mbar_expect_tx(&sm.full[st], 2 * TILE_BYTES);
    load_tile<D>(&map_k, sm.k[st], i * BLOCK_N, h, b, &sm.full[st]);
    load_tile<D>(&map_v, sm.v[st], i * BLOCK_N, h, b, &sm.full[st]);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&sm.full[s], 1);
    mbar_init(&sm.qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.qbar, TILE_BYTES);
    load_tile<D>(&map_q, sm.q, q0, h, b, &sm.qbar);
    for (int i = 0; i < STAGES && i < n_kt; ++i) issue_kv(i);
  }
  // the batch row's key mask as bits, 32 keys a warp at a time
  const int* M = p.mask + (long long)b * S;
  for (int base = (tid >> 5) * 32; base < n_kt * BLOCK_N; base += 128) {
    const int key = base + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, key < S && M[key] != 0);
    if (lane == 0) keep_words[base >> 5] = bits;
  }
  __syncthreads();

  const uint32_t seed_bh = seed_for_head(p.seed, p.gbh, b, h);
  // this thread's accumulator rows: q rows r0 and r0 + 8
  const int row_in_tile = frag_row0(warp, g), r0 = q0 + row_in_tile;
  float o[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(&sm.qbar, 0);

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % STAGES, k0 = it * BLOCK_N;
    mbar_wait(&sm.full[st], (it / STAGES) & 1);
    float s[BLOCK_N / 2];  // S = Q K^T, 64 q rows x 64 keys
#pragma unroll
    for (int i = 0; i < BLOCK_N / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      Wgmma<BLOCK_N>::template ss<0, 0>(s, kmajor_at<D>(sm.q, 0, ks),
                                        kmajor_at<D>(sm.k[st], 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scores in log2 units, masked; the row max over the tile and before
    const uint32_t w0 = keep_words[2 * it], w1 = keep_words[2 * it + 1];
    const bool plain = (w0 & w1) == 0xffffffffu;  // every key real and kept
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = s[4 * j + e] * p.scale_log2;
        if (!plain) {
          const uint32_t word = j < 4 ? w0 : w1;
          x = (word >> (c & 31)) & 1u ? x : (k0 + c < S ? MASKED2 : -INFINITY);
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // tile it holds key k0 < S, so the new max is finite
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = fast_exp2(m[i] - mx[i]);  // 0 on the first tile
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = fast_exp2(s[4 * j + e] - m[e >> 1]);
        rs[e >> 1] += pv;
        s[4 * j + e] = pv;
      }
    if (p.thresh) {  // drop after the undropped p joined the normaliser
#pragma unroll
      for (int j = 0; j < BLOCK_N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const FragPos f = fwd_s_frag(r0, k0, t, j, e);
          if (!keep_bit(seed_bh, f.q, f.key, S, p.thresh)) s[4 * j + e] = 0.f;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int i = 0; i < DH; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[BLOCK_N / 16][4];  // P as the A operand, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) pack_a(pa[kk], s + 8 * kk);

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < D / SUB; ++c) {
      float(&oc)[SUB / 2] = *reinterpret_cast<float(*)[SUB / 2]>(o + c * SUB / 2);
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk)
        Wgmma<SUB>::template rs<1>(oc, pa[kk], mnmajor_at<D>(sm.v[st], kk, c), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // stage st is free again
    if (tid == 0 && it + STAGES < n_kt) issue_kv(it + STAGES);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // O into the Q buffer (the products are done), swizzled as the O map
  // stores it
  unsigned char* out = reinterpret_cast<unsigned char*>(sm.q);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = fmaxf(l[i], 1e-30f);
    const float inv = p.inv_keep / l_safe;
    const int r = row_in_tile + 8 * i;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + tile_offset<D>(r, 16 * j + 4 * t)) =
          pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    if (t == 0 && q0 + r < S)
      p.lse[(long long)bh * S + q0 + r] =
          (m[i] == MASKED2 ? MASKED : m[i] * LN2) + logf(l_safe);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    store_tile<D>(&map_o, sm.q, q0, h, b);
    bulk_commit();
    bulk_wait_read();  // the stores have read shared memory
  }
}

// ----- f32 (exact checks) ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(BLOCK_M * f32_tpr<D>())
flash_fwd_f32_kernel(const Params p, int n_qt) {
  constexpr int TPR = f32_tpr<D>(), DT = D / TPR, KN = f32_keys<D>();
  __shared__ float sK[KN][D];
  __shared__ float sV[KN][D];
  __shared__ int sKeep[KN];

  const int bh = blockIdx.x / n_qt;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, d0 = (tid % TPR) * DT;  // this thread's columns
  const int row = (blockIdx.x % n_qt) * BLOCK_M + tid / TPR;
  const int S = p.S;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* M = p.mask + (long long)b * S;
  const uint32_t seed_bh = seed_for_head(p.seed, p.gbh, b, h);

  float q[DT], acc[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    q[d] = row < S ? Q[row * p.q_ss + d0 + d] : 0.f;
    acc[d] = 0.f;
  }
  float m_row = -INFINITY, l_row = 0.f;

  const int n_kt = (S + KN - 1) / KN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KN;
    __syncthreads();
    for (int c = tid; c < KN * D; c += blockDim.x) {
      const int r = c / D, col = c % D;
      const bool in = k0 + r < S;
      sK[r][col] = in ? K[(k0 + r) * p.k_ss + col] : 0.f;
      sV[r][col] = in ? V[(k0 + r) * p.v_ss + col] : 0.f;
    }
    for (int j = tid; j < KN; j += blockDim.x) {
      const int key = k0 + j;
      sKeep[j] = key < S ? (M[key] != 0 ? 1 : 0) : -1;
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < KN; j0 += F32_CHUNK) {
      float sc[F32_CHUNK], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < F32_CHUNK; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DT; ++d) dot = fmaf(q[d], sK[j0 + j][d0 + d], dot);
        if (TPR > 1) dot = pair_sum(dot);
        sc[j] = masked_score(dot * p.scale, sKeep[j0 + j]);
        mx = fmaxf(mx, sc[j]);
      }
      // key 0 is real, so m_row is finite from the first chunk on
      const float m_new = fmaxf(m_row, mx);
      const float alpha = expf(m_row - m_new);
      m_row = m_new;
      l_row *= alpha;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < F32_CHUNK; ++j) {
        float pj = expf(sc[j] - m_row);
        l_row += pj;
        if (p.thresh && !keep_bit(seed_bh, row, k0 + j0 + j, S, p.thresh))
          pj = 0.f;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          acc[d] = fmaf(pj, sV[j0 + j][d0 + d], acc[d]);
      }
    }
  }

  if (row < S) {
    const float l_safe = fmaxf(l_row, 1e-30f);
    const float inv = p.inv_keep / l_safe;
#pragma unroll
    for (int d = 0; d < DT; ++d) O[row * p.o_ss + d0 + d] = acc[d] * inv;
    if (d0 == 0) p.lse[(long long)bh * S + row] = m_row + logf(l_safe);
  }
}

// ----- host ------------------------------------------------------------------------

template <int D>
int launch_bf16(const CUtensorMap (&maps)[4], const Bf16Params& p, int bh,
                cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(Bf16Smem<D>)) + 1024 + 2 * p.n_kt * 4;
  if (smem > 227 * 1024) return -1;
  cudaError_t err = allow_smem<flash_fwd_bf16_kernel<D>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)bh * p.n_kt;
  if (blocks > 0x7FFFFFFF) return -1;
  flash_fwd_bf16_kernel<D><<<(unsigned)blocks, 128, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Params& p, int bh, cudaStream_t st) {
  const int n_qt = (p.S + BLOCK_M - 1) / BLOCK_M;
  const long long blocks = (long long)bh * n_qt;
  if (blocks > 0x7FFFFFFF) return -1;
  flash_fwd_f32_kernel<D><<<(unsigned)blocks, BLOCK_M * f32_tpr<D>(), 0, st>>>(
      p, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, row) for q, k, v and o in that order; the head dim is contiguous,
// and for bf16 every base is 16-byte aligned with strides that are multiples
// of 8 elements (what the tensor maps take). seed, thresh, inv_keep: the
// dropout (thresh = 0: none). Returns 0, a CUDA error code from the launch,
// -1 for arguments the kernel does not take, or -2 when a tensor map cannot
// be made.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                         const void* v, const int* mask, void* o, float* lse,
                         int batch, int heads, int seq_len,
                         const long long* strides, float scale, uint32_t seed,
                         uint32_t thresh, float inv_keep,
                         const uint32_t* gbh, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (long long)batch * heads > 0x7FFFFFFF ||
      (head_dim != 16 && head_dim != 32 && head_dim != 64 && head_dim != 128))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (dtype == 1) {
    CUtensorMap maps[4];
    const void* srcs[4] = {q, k, v, o};
    for (int i = 0; i < 4; ++i)
      if (!head_map(&maps[i], srcs[i], batch, heads, seq_len, head_dim,
                    strides + 3 * i))
        return -2;
    Bf16Params p = {};
    p.mask = mask; p.lse = lse;
    p.H = heads; p.S = seq_len; p.n_kt = (seq_len + BLOCK_N - 1) / BLOCK_N;
    p.scale_log2 = scale * LOG2E;
    p.seed = seed; p.thresh = thresh; p.inv_keep = inv_keep;
    p.gbh = bh_index(gbh);
    switch (head_dim) {
      case 16: return launch_bf16<16>(maps, p, bh, st);
      case 32: return launch_bf16<32>(maps, p, bh, st);
      case 64: return launch_bf16<64>(maps, p, bh, st);
      default: return launch_bf16<128>(maps, p, bh, st);
    }
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.mask = mask; p.o = o; p.lse = lse;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.H = heads; p.S = seq_len; p.scale = scale;
  p.seed = seed; p.thresh = thresh; p.inv_keep = inv_keep;
  p.gbh = bh_index(gbh);
  switch (head_dim) {
    case 16: return launch_f32<16>(p, bh, st);
    case 32: return launch_f32<32>(p, bh, st);
    case 64: return launch_f32<64>(p, bh, st);
    default: return launch_f32<128>(p, bh, st);
  }
}
