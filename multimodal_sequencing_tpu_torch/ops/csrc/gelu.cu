// The logit_erf GELU, forward and backward, as one elementwise pass each,
// with a plain C interface.
//
// Computes `multimodal_sequencing_tpu/ops/gelu.py::gelu_logit_erf` and its
// custom backward `_gelu_logit_erf_bwd`, which the JAX package leaves to
// XLA to fuse (no Pallas kernel): gelu(x) = x * sigmoid(u(x)), u = x P(x^2)
// with the package's 12 coefficients on x clipped to [-14.5, 5.7], the
// forward assembled in the half-exponent form, the backward
// sigma + x sigma (1 - sigma) u'(x) recomputed from the saved input. The
// plain PyTorch version (ops/gelu.py) is the oracle.
//
// Bound on this card: it reads x (and g) and writes one tensor, all in the
// input dtype; at the train MLP shape (2560 x 4096, bf16) the forward moves
// 42 MB, ~12.5 us at the published 3.35 TB/s, and the backward 63 MB,
// ~18.8 us. The arithmetic comes close to that: every instruction takes
// an issue slot of one lane (128 lanes an SM a clock, 132 SMs, ~1.98 GHz),
// so ~40 instructions an element would take as long as the bytes. The
// design cuts both and overlaps them:
//
//  * Bytes. A thread takes one 16-byte vector of each input at a time (8
//    bf16 or 4 f32) and stores a 16-byte vector; it loads its next vector
//    of each input, a grid further on, before it computes the current one.
//    Loads stream past the caches (`ld.global.cs`: each byte is read
//    once); stores are plain, so the output stays in L2 for the matmul that
//    reads it next. The grid is one wave of 256-thread blocks (occupancy
//    API x SMs: 8 blocks an SM at <= 32 registers), or fewer for a small n.
//    That puts 2,048 threads x 16 bytes = 32 KB of loads in flight per SM
//    forward and 64 KB backward while the current vectors compute, against
//    the ~15-30 KB that hide device-memory latency at 3.35 TB/s. Two
//    vectors a thread loaded at once, or one pass of blocks sized to n,
//    measured slower at the train shape (PERF.md). Elements before the
//    first 16-byte boundary and after the last whole vector go through a
//    scalar path in the same launch; so do all elements when the pointers
//    do not share one 16-byte phase (the wrapper allocates the output on
//    the input's phase, so that happens only for a backward whose x and g
//    have different phases).
//  * Instructions. e^{-|u|/2} is one `ex2.approx` of |u| times -log2(e)/2
//    (t >= e^-54.3 ~ 2.6e-24 over the clip range, so t is normal and the
//    .ftz form is exact for it), 1 / (1 + t^2) one `rcp.approx` on [1, 2];
//    bf16 is unpacked by shifts and packed in pairs (`cvt.rn.bf16x2.f32`);
//    the forward's two branches share one product chain whose last
//    multiply flushes; P'(s) is computed only in the backward, its Horner
//    chain beside P's. The polynomials keep the JAX package's coefficients
//    and fused multiply-add Horner order, which the tolerances assume.
//    As built for sm_90a, the bf16 vector loop takes 22 FP32-pipe, 2 MUFU
//    and 27.6 instructions in all an element forward, 37, 2 and 46.75
//    backward: `chip_smoke.py`'s timing phase counts them in the built
//    library (`cuobjdump -sass`) for the instruction floor.
//  * Denormals. As XLA, the plain version flushes only the final f32
//    result to signed zero; intermediates may be denormal: in the backward
//    at x ~ -13, sigma = t (t d) ~ 6e-39 while sigma + x sigma (1 - sigma)
//    u' ~ 1e-36 is normal and kept by bf16. So this source is built
//    without --use_fast_math or -ftz=true, and only ex2 (on t), rcp (on
//    1 + t^2, in [1, 2]) and the final flush take .ftz.
//
// f32, the check path of chip_smoke.py, uses the same approximations: its
// tolerance (1e-5 absolute and relative) allows the few-ulp error of
// ex2.approx and rcp.approx.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float CLIP_LO = -14.5f, CLIP_HI = 5.7f;
constexpr float NEG_HALF_LOG2E = -0.72134752044448170f;  // -log2(e) / 2
constexpr int NC = 12;
// the coefficients rounded from the doubles, as jnp.float32(c) rounds them
__constant__ float C[NC] = {
    1.5896136389400737, 0.07718187553182493, -0.0011652754881688425,
    1.7963775574361492e-05, -1.5475305063924886e-07,
    -1.646850482448538e-10, 2.1211035997926802e-11,
    -2.604158256316201e-13, 1.6714618655303135e-15,
    -6.2150528706248856e-18, 1.2672366766358843e-20,
    -1.0994478291490898e-23};
// 2 i C[i] for 2 P'(s): i C[i] rounded from the double products as the JAX
// package rounds them, then doubled (exact)
#define DC2_(i, c) (2.f * static_cast<float>((i) * (c)))
__constant__ float DC2[NC] = {
    0.f, DC2_(1, 0.07718187553182493), DC2_(2, -0.0011652754881688425),
    DC2_(3, 1.7963775574361492e-05), DC2_(4, -1.5475305063924886e-07),
    DC2_(5, -1.646850482448538e-10), DC2_(6, 2.1211035997926802e-11),
    DC2_(7, -2.604158256316201e-13), DC2_(8, 1.6714618655303135e-15),
    DC2_(9, -6.2150528706248856e-18), DC2_(10, 1.2672366766358843e-20),
    DC2_(11, -1.0994478291490898e-23)};
#undef DC2_

__device__ __forceinline__ float ex2_ftz(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ float rcp_ftz(float a) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// a * b with an f32 denormal result (or operand) flushed to signed zero
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// an f32 denormal to signed zero, anything else unchanged (XLA's flush)
__device__ __forceinline__ float flush(float v) { return mul_ftz(v, 1.f); }

// t = e^{-|u|/2} and d = 1 / (1 + t^2) from the clipped x and P(x_c^2)
__device__ __forceinline__ void half_exp(float xc, float p, float& t, float& d) {
  t = ex2_ftz(fabsf(p * xc) * NEG_HALF_LOG2E);
  d = rcp_ftz(__fmaf_rn(t, t, 1.f));
}

__device__ __forceinline__ float gelu_fwd(float x) {
  const float xl = fmaxf(x, CLIP_LO);  // x_c where x < 0, x where x >= 0
  const float xc = fminf(xl, CLIP_HI);
  const float s = xc * xc;
  float p = C[NC - 1];
#pragma unroll
  for (int i = NC - 2; i >= 0; --i) p = __fmaf_rn(p, s, C[i]);
  float t, d;
  half_exp(xc, p, t, d);
  // x >= 0: x d; x < 0: (x_c t)(t d). With a = 1 or t both are
  // (xl a)(a d), bit for bit. The last product flushes the result: its
  // second factor a d is normal and at most 1, so a denormal first factor,
  // flushed as an operand, could only have given a denormal product
  const float a = x >= 0.f ? 1.f : t;
  return mul_ftz(xl * a, a * d);
}

// (sigma + x sigma (1 - sigma) u'(x)) * g
__device__ __forceinline__ float gelu_bwd(float x, float g) {
  const float xc = fminf(fmaxf(x, CLIP_LO), CLIP_HI);
  const float s = xc * xc;
  // P and 2 P' side by side: the doubled coefficients give exactly twice
  // the Horner value, so u' = P + (2 s) P' is fma(s, 2 P', P)
  float p = C[NC - 1], dps2 = DC2[NC - 1];
#pragma unroll
  for (int i = NC - 2; i >= 1; --i) {
    p = __fmaf_rn(p, s, C[i]);
    dps2 = __fmaf_rn(dps2, s, DC2[i]);
  }
  p = __fmaf_rn(p, s, C[0]);
  float t, d;
  half_exp(xc, p, t, d);
  const float sig = x >= 0.f ? d : t * (t * d);
  const float du = __fmaf_rn(s, dps2, p);
  return flush(__fmaf_rn(x * sig * (1.f - sig), du, sig) * g);
}

// One 16-byte vector as floats: N elements, unpacked and packed
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float (&f)[N]) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the top half of the f32 of the same value
  __device__ __forceinline__ static void unpack(const uint4& v, float (&f)[N]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// How a launch splits n elements: `head` scalar elements up to the first
// 16-byte boundary, `nvec` whole vectors, the rest scalar. With pointers on
// different 16-byte phases every element is scalar (head = n).
struct Split {
  long long head, nvec;
};

// the v-th 16-byte vector, streamed (`ld.global.cs`: each is read once, so
// it is first to leave the caches), or zeros past the end
__device__ __forceinline__ uint4 load16(const uint4* p, long long v, long long nvec) {
  return v < nvec ? __ldcs(p + v) : make_uint4(0, 0, 0, 0);
}

// out[i] = fwd(x[i]), or out[i] = bwd(x[i], g[i]) when g is given. Each
// thread first takes its share of the scalar elements, then walks its
// 16-byte vectors a grid apart, loading the next vector of each input
// before it computes the current one.
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
gelu_kernel(const T* __restrict__ x, const T* __restrict__ g,
            T* __restrict__ out, long long n, Split split) {
  using V = Vec<T>;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long body = split.nvec * V::N;
  for (long long k = blockIdx.x * (long long)THREADS + threadIdx.x;
       k < n - body; k += stride) {
    const long long i = k < split.head ? k : k + body;
    if constexpr (BWD) store(out, i, gelu_bwd(load(x, i), load(g, i)));
    else store(out, i, gelu_fwd(load(x, i)));
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + split.head);
  const uint4* gv = BWD ? reinterpret_cast<const uint4*>(g + split.head) : nullptr;
  uint4* ov = reinterpret_cast<uint4*>(out + split.head);
  long long v = blockIdx.x * (long long)THREADS + threadIdx.x;
  uint4 xin = load16(xv, v, split.nvec), gin;
  if constexpr (BWD) gin = load16(gv, v, split.nvec);
#pragma unroll 1
  for (; v < split.nvec; v += stride) {
    const uint4 xnext = load16(xv, v + stride, split.nvec);
    float f[V::N];
    V::unpack(xin, f);
    if constexpr (BWD) {
      const uint4 gnext = load16(gv, v + stride, split.nvec);
      float gf[V::N];
      V::unpack(gin, gf);
#pragma unroll
      for (int e = 0; e < V::N; ++e) f[e] = gelu_bwd(f[e], gf[e]);
      gin = gnext;
    } else {
#pragma unroll
      for (int e = 0; e < V::N; ++e) f[e] = gelu_fwd(f[e]);
    }
    ov[v] = V::pack(f);
    xin = xnext;
  }
}

Split split_for(long long n, int elem_bytes, const void* const* ptrs, int nptr) {
  const uintptr_t phase = reinterpret_cast<uintptr_t>(ptrs[0]) & 15;
  for (int i = 1; i < nptr; ++i)
    if ((reinterpret_cast<uintptr_t>(ptrs[i]) & 15) != phase) return {n, 0};
  long long head = phase ? static_cast<long long>((16 - phase) / elem_bytes) : 0;
  head = head < n ? head : n;
  return {head, (n - head) * elem_bytes / 16};
}

// the blocks of one kernel instance that fit on the card at once, asked
// once per instance (the port runs on one card)
template <typename T, bool BWD>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gelu_kernel<T, BWD>,
                                                  THREADS, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <typename T, bool BWD>
int launch(const void* x, const void* g, void* out, long long n, void* stream) {
  const void* ptrs[3] = {x, out, g};
  const Split split = split_for(n, sizeof(T), ptrs, BWD ? 3 : 2);
  // a thread for each vector, or for each scalar element when there are
  // more of those, up to one wave of resident blocks
  const long long scalar = n - split.nvec * Vec<T>::N;
  const long long threads = split.nvec > scalar ? split.nvec : scalar;
  const long long want = (threads + THREADS - 1) / THREADS;
  const long long cap = resident_blocks<T, BWD>();
  gelu_kernel<T, BWD><<<static_cast<unsigned>(want < cap ? want : cap), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(out), n,
      split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; contiguous tensors of n elements, each
// aligned to its element size. Returns 0, a CUDA error code from the
// launch, or -1 for bad arguments.
extern "C" int gelu_logit_erf_fwd(int dtype, const void* x, void* y,
                                  long long n, void* stream) {
  if ((dtype != 0 && dtype != 1) || n <= 0) return -1;
  return dtype == 1 ? launch<__nv_bfloat16, false>(x, nullptr, y, n, stream)
                    : launch<float, false>(x, nullptr, y, n, stream);
}

extern "C" int gelu_logit_erf_bwd(int dtype, const void* x, const void* g,
                                  void* dx, long long n, void* stream) {
  if ((dtype != 0 && dtype != 1) || n <= 0) return -1;
  return dtype == 1 ? launch<__nv_bfloat16, true>(x, g, dx, n, stream)
                    : launch<float, true>(x, g, dx, n, stream);
}
