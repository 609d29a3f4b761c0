// Flax LayerNorm (fast variance) forward and backward over rows of N <= 1024
// features, with a plain C interface.
//
// Computes `flax.linen.LayerNorm` as the JAX encoder runs it (Flax 0.12:
// use_fast_variance, force_float32_reductions): per row, f32 mean and
// E[x^2], var = max(0, E[x^2] - mean^2), y = (x - mean) * (rsqrt(var + eps)
// * w) + b with f32 w and b, y in the input's dtype. The JAX package leaves
// this to XLA (no Pallas kernel); the plain PyTorch version
// (ops/layer_norm.py) takes ~10 elementwise and reduction passes forward and
// more backward, this one pass each.
//
// Backward (`layer_norm_bwd_kernel`, one launch yields dx, dw and db):
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),  g = dy * w,
//   dw = sum over rows of dy * xhat,  db = sum over rows of dy,
// with the xhat term dropped in a row whose variance was clamped at 0. The
// row statistics are recomputed from x by the forward's formula (the sums
// in another order).
//  * A warp per row: at N = 1024 a lane holds 32 features as four 16-byte
//    vectors of x and of dy (eight in f32); the row's statistics and its two
//    sums of g and g * xhat are warp shuffles, with no block barrier.
//  * Bytes in flight: one block per SM (16 warps in bf16, 8 in f32), each
//    block an equal contiguous share of the rows (so no SM holds more rows
//    than another but one), its warps taking turns; a warp copies its next
//    row's x and dy into a two-row ring in shared memory with `cp.async`
//    while it computes the current row. Reaching the card's 3.35 TB/s over
//    ~0.7 us of load latency takes ~2.3 MB in flight, ~18 KB per SM; 16
//    warps with a 4 KB bf16 row each in flight hold 64 KB, up to 128 KB
//    with the next rows.
//  * dw and db in the kernel, in a fixed order: each warp sums its rows'
//    dy * xhat and dy in registers; a block sums its warps' in warp order
//    through shared memory and writes one partial; then, past a barrier
//    over the grid (an atomic count after __threadfence; the launch is
//    cooperative, so every block is resident), each block sums 32-column
//    slices over all partials, its warps over fixed contiguous ranges of
//    them and then in warp order. So dw and db are bit-equal on a rerun,
//    and no second launch reduces them. The two counters start at 0 and
//    the last block out resets them, so a buffer serves every call on its
//    stream. The partials (blocks x 2 x N f32) are scratch beyond the
//    function's bytes.
//
// Bound on this card: the forward reads x and writes y, the backward reads
// x and dy and writes dx, in the input dtype (w, dw, db: 12 KB); at the
// train shape (2560 x 1024, bf16) that is 10.5 and 15.7 MB, ~3.1 and ~4.7 us
// at the published 3.35 TB/s. The forward runs one 128-thread block per row,
// each thread owning up to 8 strided columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "sm90.cuh"  // allow_smem

namespace {

constexpr int THREADS = 128;
constexpr int PER_THREAD = 8;             // N <= THREADS * PER_THREAD
constexpr int LANE_FEATURES = THREADS * PER_THREAD / 32;  // of a row, a lane

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Sums of a and b over the block; every thread gets both.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[THREADS / 32], sb[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done
  if (lane == 0) { sa[warp] = a; sb[warp] = b; }
  __syncthreads();
  a = 0.f; b = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) { a += sa[w]; b += sb[w]; }
}

// This thread's columns of one row, and the row's statistics.
template <typename T>
__device__ __forceinline__ void row_stats(const T* x, int N, float (&v)[PER_THREAD],
                                          float& mean, float& rstd,
                                          bool& clamped, float eps) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int c = threadIdx.x + j * THREADS;
    v[j] = c < N ? load(x, c) : 0.f;
    s += v[j];
    s2 += v[j] * v[j];
  }
  block_sum2(s, s2);
  mean = s / N;
  const float var = s2 / N - mean * mean;
  clamped = var < 0.f;
  rstd = rsqrtf(fmaxf(var, 0.f) + eps);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_kernel(const T* x, const float* w, const float* b, T* y, int N,
                      float eps) {
  const long long row = blockIdx.x;
  float v[PER_THREAD], mean, rstd;
  bool clamped;
  row_stats(x + row * N, N, v, mean, rstd, clamped, eps);
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int c = threadIdx.x + j * THREADS;
    if (c < N) store(y, row * N + c, (v[j] - mean) * (rstd * w[c]) + b[c]);
  }
}

// ----- backward --------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// VEC features from p (VEC * sizeof(T) = 16 bytes, 16-byte aligned, or
// VEC = 1) as floats.
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void load_w(const float* w, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldg(w);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(w + i));
      v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
    }
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}

// VEC floats to 16-byte aligned p (VEC = 1: any p).
template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// Warps of a backward block, one block an SM: their two-row rings of x and
// dy fill 128 KB of shared memory in either dtype.
template <typename T>
__host__ __device__ constexpr int bwd_warps() { return sizeof(T) == 2 ? 16 : 8; }

// out[c] = sum over i < k, in order of i, of src[i * stride + c], for
// c < n, by the block's THREADS_ threads, Q columns a thread (Q = 4: n,
// stride and both bases 16-byte aligned). The loads of BATCH rows are
// issued before any is added, with no branch between them (rows past k
// read row k - 1 and are not added), so their latencies overlap.
template <int Q, int BATCH, int THREADS_>
__device__ __forceinline__ void sum_rows(float* out, const float* src,
                                         long long stride, int k, int n) {
  for (int c = threadIdx.x * Q; c < n; c += THREADS_ * Q) {
    float acc[Q] = {};
    for (int i0 = 0; i0 < k; i0 += BATCH) {
      float v[BATCH][Q];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const float* p = src + min(i0 + i, k - 1) * stride + c;
        if constexpr (Q == 4) {
          const float4 x = *reinterpret_cast<const float4*>(p);
          v[i][0] = x.x; v[i][1] = x.y; v[i][2] = x.z; v[i][3] = x.w;
        } else {
          v[i][0] = *p;
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (i0 + i < k) acc[q] += v[i][q];
    }
    store_f32<Q>(out + c, acc);
  }
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// One warp a row. A lane owns chunks lane + 32 j (j < CHUNKS) of VEC
// features; VEC = 16 / sizeof(T) when rows are whole 16-byte vectors, else 1
// (then the ring is filled by plain copies). `ld` is the ring's row pitch
// in elements. part: (blocks, 2, N) f32 partials; dwb: dw then db, (2, N)
// f32; tickets: 2 ints, 0 on entry and on exit. Launched cooperatively.
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * bwd_warps<T>(), 1)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ w, T* __restrict__ dx,
                      float* __restrict__ part, float* __restrict__ dwb,
                      int* __restrict__ tickets, int rows, int N, int ld,
                      float eps) {
  constexpr int CHUNKS = LANE_FEATURES / VEC;
  constexpr int W = bwd_warps<T>(), THREADS_ = 32 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp's ring: [slot][x, dy][ld]
  T* ring = reinterpret_cast<T*>(smem) + warp * 4 * ld;

  auto fetch = [&](long long row, int slot) {
    T* sx = ring + slot * 2 * ld;
    T* sdy = sx + ld;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int f = (lane + 32 * j) * VEC;
      if (f < N) {
        if constexpr (VEC > 1) {
          cp_async16(sx + f, x + row * N + f);
          cp_async16(sdy + f, dy + row * N + f);
        } else {
          sx[f] = x[row * N + f];
          sdy[f] = dy[row * N + f];
        }
      }
    }
    cp_async_commit();
  };

  float dw[LANE_FEATURES], db[LANE_FEATURES];
#pragma unroll
  for (int i = 0; i < LANE_FEATURES; ++i) dw[i] = db[i] = 0.f;
  // the block's rows: an equal contiguous share, its warps taking turns
  const long long end = (long long)(blockIdx.x + 1) * rows / gridDim.x;
  long long row = (long long)blockIdx.x * rows / gridDim.x + warp;
  int slot = 0;
  if (row < end) fetch(row, 0);
  for (; row < end; row += W, slot ^= 1) {
    if (row + W < end) fetch(row + W, slot ^ 1);
    else cp_async_commit();  // an empty group keeps the count
    cp_async_wait<1>();      // this row's copies have landed
    const T* sx = ring + slot * 2 * ld;
    const T* sdy = sx + ld;
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int f = (lane + 32 * j) * VEC;
      if (f < N) {
        float xv[VEC];
        load_vec<VEC>(sx + f, xv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s += xv[e];
          s2 += xv[e] * xv[e];
        }
      }
    }
    warp_sum2(s, s2);
    const float mean = s / N;
    const float var = s2 / N - mean * mean;
    const bool clamped = var < 0.f;
    const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int f = (lane + 32 * j) * VEC;
      if (f < N) {
        float xv[VEC], dv[VEC], wv[VEC];
        load_vec<VEC>(sx + f, xv);
        load_vec<VEC>(sdy + f, dv);
        load_w<VEC>(w + f, wv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = (xv[e] - mean) * rstd, g = dv[e] * wv[e];
          sg += g;
          sgx += g * xh;
          dw[j * VEC + e] += dv[e] * xh;
          db[j * VEC + e] += dv[e];
        }
      }
    }
    warp_sum2(sg, sgx);
    const float mg = sg / N, mgx = clamped ? 0.f : sgx / N;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int f = (lane + 32 * j) * VEC;
      if (f < N) {
        float xv[VEC], dv[VEC], wv[VEC], out[VEC];
        load_vec<VEC>(sx + f, xv);
        load_vec<VEC>(sdy + f, dv);
        load_w<VEC>(w + f, wv);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          out[e] = rstd * (dv[e] * wv[e] - mg - (xv[e] - mean) * rstd * mgx);
        store_vec<VEC>(dx + (long long)row * N + f, out);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: it holds the sums now

  // the block's partial: its warps' sums in warp order
  constexpr int Q = VEC > 1 ? 4 : 1;  // columns a thread reduces at once
  const int n2 = 2 * N;
  float* red = reinterpret_cast<float*>(smem);  // [W][dw, db]
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int f = (lane + 32 * j) * VEC;
    if (f < N) {
      store_f32<VEC>(red + warp * n2 + f, dw + j * VEC);
      store_f32<VEC>(red + warp * n2 + N + f, db + j * VEC);
    }
  }
  __syncthreads();
  sum_rows<Q, W, THREADS_>(part + (long long)blockIdx.x * n2, red, n2, W, n2);

  // every block's partial is out (a barrier over the grid, whose blocks
  // are all resident: the launch is cooperative), then each block sums
  // 32-column slices over all partials: warp w a contiguous range of them
  // in order, then the warps' sums in warp order
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&tickets[0], 1);
    while (load_acquire(&tickets[0]) < (int)gridDim.x) __nanosleep(64);
  }
  __syncthreads();
  const int G = gridDim.x, p0 = warp * G / W, p1 = (warp + 1) * G / W;
  float* wsum = red;  // [W][32], free again
  for (int c0 = blockIdx.x * 32; c0 < n2; c0 += G * 32) {
    const int c = min(c0 + lane, n2 - 1);
    float acc = 0.f;
    for (int i0 = p0; i0 < p1; i0 += 8) {
      float v[8];  // issued before any is added, as in sum_rows
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = __ldcg(part + (long long)min(i0 + i, p1 - 1) * n2 + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i0 + i < p1) acc += v[i];
    }
    wsum[warp * 32 + lane] = acc;
    __syncthreads();
    if (warp == 0 && c0 + lane < n2) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) sum += wsum[i * 32 + lane];
      dwb[c0 + lane] = sum;
    }
    __syncthreads();
  }
  // the last block through the barrier's exit leaves the tickets at 0
  if (threadIdx.x == 0 && atomicAdd(&tickets[1], 1) == G - 1) {
    tickets[0] = 0;
    tickets[1] = 0;
  }
}

template <typename T, int VEC>
int launch_bwd(const void* x, const void* dy, const float* w, void* dx,
               float* part, float* dwb, int* tickets, int rows, int N,
               int blocks, float eps, cudaStream_t st) {
  constexpr int W = bwd_warps<T>();
  int ld = (N + 7) / 8 * 8;  // 16-byte ring rows in either dtype
  const int ring = W * 4 * ld * static_cast<int>(sizeof(T));
  const int red = W * 2 * N * 4;
  const int smem = ring > red ? ring : red;
  cudaError_t err = allow_smem<layer_norm_bwd_kernel<T, VEC>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cooperative: every block is resident at once (or the launch fails),
  // which the kernel's barrier over the grid needs
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  void* args[] = {&xp, &dyp, &w, &dxp, &part, &dwb, &tickets, &rows, &N, &ld,
                  &eps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(layer_norm_bwd_kernel<T, VEC>), dim3(blocks),
      dim3(32 * W), args, smem, st));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, dy and dx); w and b f32;
// contiguous (rows, N) tensors. Returns 0, a CUDA error code from the
// launch, or -1 for arguments the kernel does not take.
extern "C" int layer_norm_fwd(int dtype, const void* x, const float* w,
                              const float* b, void* y, int rows, int N,
                              float eps, void* stream) {
  if ((dtype != 0 && dtype != 1) || rows <= 0 || N <= 0 ||
      N > THREADS * PER_THREAD)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    layer_norm_fwd_kernel<<<rows, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, b,
        static_cast<__nv_bfloat16*>(y), N, eps);
  else
    layer_norm_fwd_kernel<<<rows, THREADS, 0, st>>>(
        static_cast<const float*>(x), w, b, static_cast<float*>(y), N, eps);
  return static_cast<int>(cudaGetLastError());
}

// The backward in one launch: dx in the input dtype, and dwb = dw then db
// ((2, N) f32). blocks: the grid (>= 1; at most one block an SM, so that
// all are resident, and no more than the rows fill); part: blocks * 2 * N
// f32 of scratch; tickets: 2 ints, zero before the first call and left zero
// by every call.
extern "C" int layer_norm_bwd(int dtype, const void* x, const void* dy,
                              const float* w, void* dx, float* part,
                              float* dwb, int* tickets, int rows, int N,
                              int blocks, float eps, void* stream) {
  if ((dtype != 0 && dtype != 1) || rows <= 0 || N <= 0 || blocks <= 0 ||
      N > THREADS * PER_THREAD)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 1 ? 8 : 4;  // features in 16 bytes
  const bool aligned =
      N % vec == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(part) | reinterpret_cast<uintptr_t>(dwb)) % 16 == 0;
  if (dtype == 1)
    return aligned ? launch_bwd<__nv_bfloat16, 8>(x, dy, w, dx, part, dwb, tickets,
                                                  rows, N, blocks, eps, st)
                   : launch_bwd<__nv_bfloat16, 1>(x, dy, w, dx, part, dwb, tickets,
                                                  rows, N, blocks, eps, st);
  return aligned ? launch_bwd<float, 4>(x, dy, w, dx, part, dwb, tickets, rows,
                                        N, blocks, eps, st)
                 : launch_bwd<float, 1>(x, dy, w, dx, part, dwb, tickets, rows,
                                        N, blocks, eps, st);
}
