// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `multimodal_sequencing_tpu/ops/attention.py::
// _flash_fwd_kernel` (launched by `_fwd_pallas`). Same function: for each
// (batch*head) row block, an online softmax over K/V tiles with the key
// keep-mask applied by `where` (masked real keys score NEG_INF = -1e9, so a
// row whose keys are all masked comes out uniform over the S real keys), the
// context O in the input dtype and the per-row logsumexp
// lse = m + log(max(l, 1e-30)) in f32, which the backward kernels read.
//
// Design, for this card rather than the TPU's sequential grid:
//  * One block per (64-row q-tile, batch*head); the K/V loop that was the
//    TPU's inner grid dimension is a loop inside the block over 64-key tiles
//    staged in shared memory. Any S works: key columns j >= S are excluded
//    (-inf, weight 0), distinct from masked real keys (-1e9), so padding
//    never joins a fully masked row's uniform average; q rows >= S are
//    computed on zeros and not stored. No S rule of the TPU (block sizes,
//    128-multiples) applies.
//  * bf16 (the product): 4 warps, each owning 16 q rows, run both products
//    on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//    The score accumulator fragments are re-packed in registers as the A
//    operand of P.V, so P never touches shared memory. V is stored
//    transposed in shared memory so each B fragment is one 32-bit load;
//    row padding of 8 elements makes those loads bank-conflict free.
//  * f32 (exact checks): one thread per q row, scalar FMA, K/V tiles read
//    as shared-memory broadcasts.
//
// Bound on this card: at the eval shape (B*H = 512, S = 320, D = 64, bf16)
// the function moves 4*B*H*S*D*2 B (q, k, v read once, o written once) plus
// the f32 lse, ~84.6 MB, and does 4*B*H*S^2*D ~ 13.4 GFLOP. Its intensity,
// S/2 = 160 FLOP/B, is below the H100's ~295 bf16 FLOP/B ridge, so it is
// bound by memory: ~25 us at the published 3.35 TB/s. This first version
// re-reads K/V once per q-tile from L2 and does not overlap loads with the
// products (no cp.async/TMA, no wgmma); its measured time is in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int BLOCK_M = 64;   // q rows per block
constexpr int BLOCK_N = 64;   // keys per shared-memory tile
constexpr float MASKED = -1e9f;

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
};

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Score of one key column after the mask: 1 = keep, 0 = masked real key,
// -1 = beyond S (excluded).
__device__ __forceinline__ float masked_score(float s, int keep) {
  return keep > 0 ? s : (keep == 0 ? MASKED : -INFINITY);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const Params p) {
  constexpr int KSTEPS = D / 16;        // k-steps over the head dim (Q.K^T)
  constexpr int DTILES = D / 8;         // n-tiles over the head dim (P.V)
  constexpr int NTILES = BLOCK_N / 8;   // n-tiles over the keys (Q.K^T)
  constexpr int CH = D / 8;             // 16-byte chunks per row
  constexpr int LDK = D + 8;
  constexpr int LDV = BLOCK_N + 8;
  __shared__ __align__(16) __nv_bfloat16 sQ[BLOCK_M][LDK];
  __shared__ __align__(16) __nv_bfloat16 sK[BLOCK_N][LDK];
  __shared__ __align__(16) __nv_bfloat16 sVt[D][LDV];
  __shared__ int sKeep[BLOCK_N];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BLOCK_M;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = p.S;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* M = p.mask + (long long)b * S;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < BLOCK_M * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = zero;
    if (q0 + r < S) val = *reinterpret_cast<const uint4*>(Q + (q0 + r) * p.q_ss + col);
    *reinterpret_cast<uint4*>(&sQ[r][col]) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    qa[ks][0] = ld32(&sQ[r0][ks * 16 + 2 * t]);
    qa[ks][1] = ld32(&sQ[r0 + 8][ks * 16 + 2 * t]);
    qa[ks][2] = ld32(&sQ[r0][ks * 16 + 8 + 2 * t]);
    qa[ks][3] = ld32(&sQ[r0 + 8][ks * 16 + 8 + 2 * t]);
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  // this thread's two rows: r0 (elements 0,1) and r0 + 8 (elements 2,3)
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};

  const int n_kt = (S + BLOCK_N - 1) / BLOCK_N;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_N;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < BLOCK_N * CH; c += blockDim.x) {
      const int r = c / CH, col = (c % CH) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(K + (k0 + r) * p.k_ss + col);
        vv = *reinterpret_cast<const uint4*>(V + (k0 + r) * p.v_ss + col);
      }
      *reinterpret_cast<uint4*>(&sK[r][col]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[col + i][r] = ve[i];
    }
    for (int j = tid; j < BLOCK_N; j += blockDim.x) {
      const int key = k0 + j;
      sKeep[j] = key < S ? (M[key] != 0 ? 1 : 0) : -1;
    }
    __syncthreads();

    float s[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const __nv_bfloat16* kr = &sK[nt * 8 + g][ks * 16 + 2 * t];
        mma_16816(s[nt], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }

    // Tile kt holds key k0 < S, so each row max below is finite.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = masked_score(s[nt][e] * p.scale, sKeep[nt * 8 + 2 * t + (e & 1)]);
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_row[i], mx[i]);
      alpha[i] = expf(m_row[i] - m_new);
      m_row[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - m_row[e >> 1]);
        s[nt][e] = pe;
        rs[e >> 1] += pe;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_row[i] = l_row[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const __nv_bfloat16* vr = &sVt[dt * 8 + g][kk * 16 + 2 * t];
        mma_16816(acc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= S) continue;
    const float l_safe = fmaxf(l_row[i], 1e-30f);
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      *reinterpret_cast<uint32_t*>(O + row * p.o_ss + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
    }
    if (t == 0) p.lse[(long long)bh * S + row] = m_row[i] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(BLOCK_M)
flash_fwd_f32_kernel(const Params p) {
  __shared__ float sK[BLOCK_N][D];
  __shared__ float sV[BLOCK_N][D];
  __shared__ int sKeep[BLOCK_N];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * BLOCK_M + tid;
  const int S = p.S;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* M = p.mask + (long long)b * S;

  float q[D], acc[D], sc[BLOCK_N];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = row < S ? Q[row * p.q_ss + d] : 0.f;
    acc[d] = 0.f;
  }
  float m_row = -INFINITY, l_row = 0.f;

  const int n_kt = (S + BLOCK_N - 1) / BLOCK_N;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_N;
    __syncthreads();
    for (int c = tid; c < BLOCK_N * D; c += blockDim.x) {
      const int r = c / D, col = c % D;
      const bool in = k0 + r < S;
      sK[r][col] = in ? K[(k0 + r) * p.k_ss + col] : 0.f;
      sV[r][col] = in ? V[(k0 + r) * p.v_ss + col] : 0.f;
    }
    for (int j = tid; j < BLOCK_N; j += blockDim.x) {
      const int key = k0 + j;
      sKeep[j] = key < S ? (M[key] != 0 ? 1 : 0) : -1;
    }
    __syncthreads();

    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(q[d], sK[j][d], dot);
      sc[j] = masked_score(dot * p.scale, sKeep[j]);
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m_row, mx);
    const float alpha = expf(m_row - m_new);
    m_row = m_new;
    l_row *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      const float pj = expf(sc[j] - m_row);
      l_row += pj;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, sV[j][d], acc[d]);
    }
  }

  if (row < S) {
    const float l_safe = fmaxf(l_row, 1e-30f);
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int d = 0; d < D; ++d) O[row * p.o_ss + d] = acc[d] * inv;
    p.lse[(long long)bh * S + row] = m_row + logf(l_safe);
  }
}

template <int D>
void launch(int dtype, const Params& p, dim3 grid, cudaStream_t stream) {
  if (dtype == 1)
    flash_fwd_bf16_kernel<D><<<grid, 128, 0, stream>>>(p);
  else
    flash_fwd_f32_kernel<D><<<grid, BLOCK_M, 0, stream>>>(p);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, row) for q, k, v and o in that order; the head dim is contiguous.
// Returns 0, a CUDA error code from the launch, or -1 for arguments the
// kernel does not take.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                         const void* v, const int* mask, void* o, float* lse,
                         int batch, int heads, int seq_len,
                         const long long* strides, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (long long)batch * heads > 65535)
    return -1;
  Params p;
  p.q = q; p.k = k; p.v = v; p.mask = mask; p.o = o; p.lse = lse;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.H = heads; p.S = seq_len; p.scale = scale;
  const dim3 grid((seq_len + BLOCK_M - 1) / BLOCK_M, batch * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: launch<16>(dtype, p, grid, st); break;
    case 32: launch<32>(dtype, p, grid, st); break;
    case 64: launch<64>(dtype, p, grid, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
