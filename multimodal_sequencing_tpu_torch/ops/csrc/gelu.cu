// The logit_erf GELU, forward and backward, as one elementwise pass each,
// with a plain C interface.
//
// Computes `multimodal_sequencing_tpu/ops/gelu.py::gelu_logit_erf` and its
// custom backward `_gelu_logit_erf_bwd`, which the JAX package leaves to
// XLA to fuse (no Pallas kernel): gelu(x) = x * sigmoid(u(x)), u = x P(x^2)
// with the package's 12 coefficients on x clipped to [-14.5, 5.7], the
// forward assembled in the half-exponent form, the backward
// sigma + x sigma (1 - sigma) u'(x) recomputed from the saved input. The
// polynomials are evaluated with fused multiply-adds, as XLA contracts them,
// and f32 results below the smallest normal are flushed to signed zero, as
// XLA flushes denormals. The plain PyTorch version (ops/gelu.py) is the
// oracle.
//
// Bound on this card: it reads x (and g) and writes one tensor, all in the
// input dtype; at the train MLP shape (2560 x 4096, bf16) the forward moves
// 42 MB, ~12.5 us at the published 3.35 TB/s, and the backward 63 MB,
// ~18.8 us. A grid-stride loop, one element per thread per iteration.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr float CLIP_LO = -14.5f, CLIP_HI = 5.7f;
constexpr float MIN_NORMAL = 1.17549435e-38f;
constexpr int NC = 12;
// the coefficients rounded from the doubles, as jnp.float32(c) rounds them
__constant__ float C[NC] = {
    1.5896136389400737, 0.07718187553182493, -0.0011652754881688425,
    1.7963775574361492e-05, -1.5475305063924886e-07,
    -1.646850482448538e-10, 2.1211035997926802e-11,
    -2.604158256316201e-13, 1.6714618655303135e-15,
    -6.2150528706248856e-18, 1.2672366766358843e-20,
    -1.0994478291490898e-23};
// i * C[i] for P'(s), rounded from the double products as the JAX package
// rounds them
__constant__ float DC[NC] = {
    0.0, 0.07718187553182493, 2 * -0.0011652754881688425,
    3 * 1.7963775574361492e-05, 4 * -1.5475305063924886e-07,
    5 * -1.646850482448538e-10, 6 * 2.1211035997926802e-11,
    7 * -2.604158256316201e-13, 8 * 1.6714618655303135e-15,
    9 * -6.2150528706248856e-18, 10 * 1.2672366766358843e-20,
    11 * -1.0994478291490898e-23};

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < MIN_NORMAL ? copysignf(0.f, v) : v;
}

// y = gelu(x); sig = sigma(u); du = u'(x)
__device__ __forceinline__ void logit_parts(float x, float& y, float& sig,
                                            float& du) {
  const float xc = fminf(fmaxf(x, CLIP_LO), CLIP_HI);
  const float s = xc * xc;
  float p = C[NC - 1];
#pragma unroll
  for (int i = NC - 2; i >= 0; --i) p = __fmaf_rn(p, s, C[i]);
  float dps = DC[NC - 1];
#pragma unroll
  for (int i = NC - 2; i >= 1; --i) dps = __fmaf_rn(dps, s, DC[i]);
  const float u = p * xc;
  const float t = expf(-0.5f * fabsf(u));
  const float d = 1.f / (1.f + t * t);
  const bool pos = x >= 0.f;
  y = pos ? x * d : (xc * t) * (t * d);
  sig = pos ? d : t * (t * d);
  du = p + 2.f * s * dps;
}

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void gelu_fwd_kernel(const T* x, T* y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v, sig, du;
    logit_parts(load(x, i), v, sig, du);
    store(y, i, ftz(v));
  }
}

template <typename T>
__global__ void gelu_bwd_kernel(const T* x, const T* g, T* dx, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float xf = load(x, i);
    float v, sig, du;
    logit_parts(xf, v, sig, du);
    const float d = sig + xf * sig * (1.f - sig) * du;
    store(dx, i, ftz(d * load(g, i)));
  }
}

dim3 grid_for(long long n) {
  long long blocks = (n + 255) / 256;
  return dim3(static_cast<unsigned>(blocks < 132 * 32 ? blocks : 132 * 32));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; contiguous tensors of n elements.
// Returns 0, a CUDA error code from the launch, or -1 for bad arguments.
extern "C" int gelu_logit_erf_fwd(int dtype, const void* x, void* y,
                                  long long n, void* stream) {
  if ((dtype != 0 && dtype != 1) || n <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    gelu_fwd_kernel<<<grid_for(n), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n);
  else
    gelu_fwd_kernel<<<grid_for(n), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gelu_logit_erf_bwd(int dtype, const void* x, const void* g,
                                  void* dx, long long n, void* stream) {
  if ((dtype != 0 && dtype != 1) || n <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    gelu_bwd_kernel<<<grid_for(n), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), n);
  else
    gelu_bwd_kernel<<<grid_for(n), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(dx), n);
  return static_cast<int>(cudaGetLastError());
}
