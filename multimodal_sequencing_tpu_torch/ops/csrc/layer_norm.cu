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
// Backward: the kernel recomputes each row's statistics from x (the same
// reduction as the forward, so the same values), then
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),  g = dy * w,
// with the xhat term dropped in a row whose variance was clamped at 0, and
// writes per-block partial sums of dy * xhat and dy, which one PyTorch sum
// over blocks turns into dw and db.
//
// Bound on this card: the forward reads x and writes y, the backward reads
// x and dy and writes dx, in the input dtype; at the train shape
// (2560 x 1024, bf16) that is 10.5 and 15.7 MB, ~3.1 and ~4.7 us at the
// published 3.35 TB/s. One 128-thread block per row (forward) or per 16
// rows (backward); each thread owns up to 8 strided columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int PER_THREAD = 8;             // N <= THREADS * PER_THREAD
constexpr int BWD_ROWS = 16;              // rows per backward block

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_kernel(const T* x, const T* dy, const float* w, T* dx,
                      float* dw_part, float* db_part, int rows, int N,
                      float eps) {
  float dw[PER_THREAD] = {}, db[PER_THREAD] = {};
  const int r0 = blockIdx.x * BWD_ROWS;
  for (int r = r0; r < r0 + BWD_ROWS && r < rows; ++r) {
    const long long off = (long long)r * N;
    float v[PER_THREAD], mean, rstd;
    bool clamped;
    row_stats(x + off, N, v, mean, rstd, clamped, eps);
    float g[PER_THREAD], sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int c = threadIdx.x + j * THREADS;
      const float d = c < N ? load(dy, off + c) : 0.f;
      v[j] = (v[j] - mean) * rstd;  // xhat
      g[j] = c < N ? d * w[c] : 0.f;
      sg += g[j];
      sgx += g[j] * v[j];
      dw[j] += d * v[j];
      db[j] += d;
    }
    block_sum2(sg, sgx);
    const float mg = sg / N, mgx = clamped ? 0.f : sgx / N;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int c = threadIdx.x + j * THREADS;
      if (c < N) store(dx, off + c, rstd * (g[j] - mg - v[j] * mgx));
    }
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int c = threadIdx.x + j * THREADS;
    if (c < N) {
      dw_part[(long long)blockIdx.x * N + c] = dw[j];
      db_part[(long long)blockIdx.x * N + c] = db[j];
    }
  }
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

// dw_part, db_part: (ceil(rows / 16), N) f32 partial sums.
extern "C" int layer_norm_bwd(int dtype, const void* x, const void* dy,
                              const float* w, void* dx, float* dw_part,
                              float* db_part, int rows, int N, float eps,
                              void* stream) {
  if ((dtype != 0 && dtype != 1) || rows <= 0 || N <= 0 ||
      N > THREADS * PER_THREAD)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + BWD_ROWS - 1) / BWD_ROWS;
  if (dtype == 1)
    layer_norm_bwd_kernel<<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), w,
        static_cast<__nv_bfloat16*>(dx), dw_part, db_part, rows, N, eps);
  else
    layer_norm_bwd_kernel<<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), w,
        static_cast<float*>(dx), dw_part, db_part, rows, N, eps);
  return static_cast<int>(cudaGetLastError());
}
