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
// Both kernels give a row to one warp and lay it out alike: lane l holds
// the 16-byte groups l + 32 j (j < CHUNKS) of it, G = 16 / sizeof(T)
// features each (8 bf16 or 4 f32: at N = 1024 a lane holds 32 features).
// `row_stats` sums x and x^2 over a lane's groups in one order and then
// across the warp by shuffles, with no block barrier and no shared memory;
// both kernels call it, so the backward recomputes the forward's mean and
// rstd bit for bit. Rows that are whole 16-byte vectors at 16-byte aligned
// addresses take 16-byte loads and stores (VECTOR); other rows (N % G != 0,
// or a view at an odd storage offset) take the same kernels with scalar
// loads and stores over the same groups, so the order of sums, and the
// statistics, do not depend on the path.
//
// Forward (`layer_norm_fwd_kernel`): a lane loads its row as 16-byte
// vectors and stores y as 16-byte vectors; it reads its w and b once as
// float4 `__ldg`s and holds them in registers across its rows. Reaching
// 3.35 TB/s over ~0.7 us of load latency takes ~2.3 MB in flight, ~18 KB
// per SM. The grid is at most one wave of FWD_WARPS-warp blocks (occupancy
// API x SMs: 4 blocks, 16 warps, an SM at ~122 registers); a warp walks the
// rows a grid of warps apart and loads its next row before it reduces the
// current one. So at the train shape (2,560 rows, 2,112 warps) every row is
// in flight at once, and at the eval shape (10,240 rows) a warp has two
// rows of 2 KB in flight, ~64 KB an SM. Blocks sized to the rows with no
// loop, and 2-, 8- and 16-warp blocks, measured no faster at either shape,
// and reading w and b per row was slower at the eval shape (PERF.md).
//
// Backward (`layer_norm_bwd_kernel`, one launch yields dx, dw and db):
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),  g = dy * w,
//   dw = sum over rows of dy * xhat,  db = sum over rows of dy,
// with the xhat term dropped in a row whose variance was clamped at 0.
//  * Bytes in flight: one block per SM (16 warps in bf16, 8 in f32), each
//    block an equal contiguous share of the rows (so no SM holds more rows
//    than another but one), its warps taking turns; a warp copies its next
//    row's x and dy into a two-row ring in shared memory with `cp.async`
//    while it computes the current row. 16 warps with a 4 KB bf16 row each
//    in flight hold 64 KB, up to 128 KB with the next rows.
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
// x and dy and writes dx, in the input dtype (w, b, dw, db: 8-12 KB); at the
// train shape (2560 x 1024, bf16) that is 10.5 and 15.7 MB, ~3.1 and ~4.7 us
// at the published 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "sm90.cuh"  // allow_smem

namespace {

constexpr int MAX_FEATURES = 1024;
constexpr int LANE_FEATURES = MAX_FEATURES / 32;  // of a row, a lane

// features in one 16-byte group, and a lane's groups of a row
template <typename T>
__host__ __device__ constexpr int group_size() { return 16 / sizeof(T); }
template <typename T>
__host__ __device__ constexpr int chunks() { return LANE_FEATURES / group_size<T>(); }

// ----- one group: 16 bytes of a row, or fewer at its end ----------------------------

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x); v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z); v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return raw;
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A group held in registers as loaded: one 16-byte vector, or (scalar
// path) its n <= G features as floats, zeros past n.
template <typename T, bool VECTOR>
struct Raw {
  uint4 v;
  __device__ __forceinline__ void load(const T* p, int) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&f)[group_size<T>()]) const { unpack(v, f); }
};
template <typename T>
struct Raw<T, false> {
  float e[group_size<T>()];
  __device__ __forceinline__ void load(const T* p, int n) {
#pragma unroll
    for (int i = 0; i < group_size<T>(); ++i) e[i] = i < n ? to_f32(p[i]) : 0.f;
  }
  __device__ __forceinline__ void get(float (&f)[group_size<T>()]) const {
#pragma unroll
    for (int i = 0; i < group_size<T>(); ++i) f[i] = e[i];
  }
};

// The group at p (n features of it valid) as floats, zeros past n.
template <typename T, bool VECTOR>
__device__ __forceinline__ void load_group(const T* p, int n, float (&v)[group_size<T>()]) {
  Raw<T, VECTOR> r;
  r.load(p, n);
  r.get(v);
}
template <typename T, bool VECTOR>
__device__ __forceinline__ void store_group(T* p, int n, const float (&v)[group_size<T>()]) {
  if constexpr (VECTOR) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  } else {
#pragma unroll
    for (int i = 0; i < group_size<T>(); ++i)
      if (i < n) from_f32(p + i, v[i]);
  }
}
// G f32 parameters (w or b) at p through the read-only cache, zeros past n
template <int G, bool VECTOR>
__device__ __forceinline__ void load_param(const float* p, int n, float (&v)[G]) {
  if constexpr (VECTOR) {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) v[i] = i < n ? __ldg(p + i) : 0.f;
  }
}
// G f32 values to p, 16-byte aligned for VECTOR; the first n of them
template <int G, bool VECTOR>
__device__ __forceinline__ void store_f32(float* p, int n, const float* v) {
  if constexpr (VECTOR) {
#pragma unroll
    for (int i = 0; i < G; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < n) p[i] = v[i];
  }
}

// ----- the row statistics, shared by both kernels -------------------------------

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

struct RowStats {
  float mean, rstd;
  bool clamped;  // E[x^2] - mean^2 < 0: the variance was clamped to 0
};

// The statistics of a row laid out across the warp: `group(j, v)` gives
// this lane's group j as floats (zeros past N). The lane adds x and x^2 over
// its groups in order, then the warp's lanes by an xor butterfly; every lane
// gets the result. Both kernels sum through this one function, in this one
// order.
template <typename T, typename Group>
__device__ __forceinline__ RowStats row_stats(Group group, int lane, int N, float eps) {
  constexpr int G = group_size<T>();
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < chunks<T>(); ++j) {
    if ((lane + 32 * j) * G < N) {
      float v[G];
      group(j, v);
#pragma unroll
      for (int e = 0; e < G; ++e) {
        s += v[e];
        s2 += v[e] * v[e];
      }
    }
  }
  warp_sum2(s, s2);
  const float mean = s / N;
  const float var = s2 / N - mean * mean;
  return {mean, rsqrtf(fmaxf(var, 0.f) + eps), var < 0.f};
}

// ----- forward -----------------------------------------------------------------------

// Warps of a forward block
constexpr int FWD_WARPS = 4;

// One warp a row at a time. The grid is at most one wave of blocks, and a
// warp walks the rows a grid of warps apart: it loads its next row before it
// reduces the current one, and holds its lanes' w and b in registers across
// its rows.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(32 * FWD_WARPS)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y, int rows,
                      int N, float eps) {
  constexpr int G = group_size<T>(), CHUNKS = chunks<T>();
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * FWD_WARPS;
  int row = blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  Raw<T, VECTOR> cur[CHUNKS], nxt[CHUNKS];
  auto load_row = [&](Raw<T, VECTOR> (&r)[CHUNKS], int at) {
    const T* xr = x + static_cast<long long>(at) * N;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int f = (lane + 32 * j) * G;
      if (f < N) r[j].load(xr + f, N - f);
    }
  };
  load_row(cur, row);
  float wv[CHUNKS][G], bv[CHUNKS][G];
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int f = (lane + 32 * j) * G;
    if (f < N) {
      load_param<G, VECTOR>(w + f, N - f, wv[j]);
      load_param<G, VECTOR>(b + f, N - f, bv[j]);
    }
  }
  for (;;) {
    const int next = row + stride;
    if (next < rows) load_row(nxt, next);
    const RowStats st = row_stats<T>(
        [&](int j, float (&v)[G]) { cur[j].get(v); }, lane, N, eps);
    T* yr = y + static_cast<long long>(row) * N;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int f = (lane + 32 * j) * G;
      if (f < N) {
        float v[G];
        cur[j].get(v);
#pragma unroll
        for (int e = 0; e < G; ++e)
          v[e] = (v[e] - st.mean) * (st.rstd * wv[j][e]) + bv[j][e];
        store_group<T, VECTOR>(yr + f, N - f, v);
      }
    }
    if (next >= rows) break;
    row = next;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) cur[j] = nxt[j];
  }
}

// the blocks of one forward instance that fit on the card at once, asked
// once per instance (the port runs on one card)
template <typename T, bool VECTOR>
int fwd_resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layer_norm_fwd_kernel<T, VECTOR>, 32 * FWD_WARPS, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <typename T, bool VECTOR>
int launch_fwd(const void* x, const float* w, const float* b, void* y, int rows,
               int N, float eps, cudaStream_t st) {
  // a warp for every row, up to one wave of resident blocks
  const int want = (rows + FWD_WARPS - 1) / FWD_WARPS;
  const int cap = fwd_resident_blocks<T, VECTOR>();
  layer_norm_fwd_kernel<T, VECTOR><<<want < cap ? want : cap, 32 * FWD_WARPS, 0, st>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), rows, N, eps);
  return static_cast<int>(cudaGetLastError());
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
    store_f32<Q, Q == 4>(out + c, Q, acc);
  }
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One warp a row, in the groups of `row_stats`. VECTOR: rows are whole
// 16-byte vectors, copied into the ring by `cp.async`; else by plain
// copies. `ld` is the ring's row pitch in elements. part: (blocks, 2, N)
// f32 partials; dwb: dw then db, (2, N) f32; tickets: 2 ints, 0 on entry
// and on exit. Launched cooperatively.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(32 * bwd_warps<T>(), 1)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ w, T* __restrict__ dx,
                      float* __restrict__ part, float* __restrict__ dwb,
                      int* __restrict__ tickets, int rows, int N, int ld,
                      float eps) {
  constexpr int G = group_size<T>(), CHUNKS = chunks<T>();
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
      const int f = (lane + 32 * j) * G;
      if (f < N) {
        if constexpr (VECTOR) {
          cp_async16(sx + f, x + row * N + f);
          cp_async16(sdy + f, dy + row * N + f);
        } else {
#pragma unroll
          for (int e = 0; e < G; ++e) {
            if (f + e < N) {
              sx[f + e] = x[row * N + f + e];
              sdy[f + e] = dy[row * N + f + e];
            }
          }
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
    const RowStats st = row_stats<T>(
        [&](int j, float (&v)[G]) {
          const int f = (lane + 32 * j) * G;
          load_group<T, VECTOR>(sx + f, N - f, v);
        },
        lane, N, eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int f = (lane + 32 * j) * G;
      if (f < N) {
        float xv[G], dv[G], wv[G];
        load_group<T, VECTOR>(sx + f, N - f, xv);
        load_group<T, VECTOR>(sdy + f, N - f, dv);
        load_param<G, VECTOR>(w + f, N - f, wv);
#pragma unroll
        for (int e = 0; e < G; ++e) {
          const float xh = (xv[e] - st.mean) * st.rstd, g = dv[e] * wv[e];
          sg += g;
          sgx += g * xh;
          dw[j * G + e] += dv[e] * xh;
          db[j * G + e] += dv[e];
        }
      }
    }
    warp_sum2(sg, sgx);
    const float mg = sg / N, mgx = st.clamped ? 0.f : sgx / N;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int f = (lane + 32 * j) * G;
      if (f < N) {
        float xv[G], dv[G], wv[G], out[G];
        load_group<T, VECTOR>(sx + f, N - f, xv);
        load_group<T, VECTOR>(sdy + f, N - f, dv);
        load_param<G, VECTOR>(w + f, N - f, wv);
#pragma unroll
        for (int e = 0; e < G; ++e)
          out[e] = st.rstd * (dv[e] * wv[e] - mg - (xv[e] - st.mean) * st.rstd * mgx);
        store_group<T, VECTOR>(dx + row * N + f, N - f, out);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: it holds the sums now

  // the block's partial: its warps' sums in warp order
  constexpr int Q = VECTOR ? 4 : 1;  // columns a thread reduces at once
  const int n2 = 2 * N;
  float* red = reinterpret_cast<float*>(smem);  // [W][dw, db]
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int f = (lane + 32 * j) * G;
    if (f < N) {
      store_f32<G, VECTOR>(red + warp * n2 + f, N - f, dw + j * G);
      store_f32<G, VECTOR>(red + warp * n2 + N + f, N - f, db + j * G);
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
  const int nb = gridDim.x, p0 = warp * nb / W, p1 = (warp + 1) * nb / W;
  float* wsum = red;  // [W][32], free again
  for (int c0 = blockIdx.x * 32; c0 < n2; c0 += nb * 32) {
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
  if (threadIdx.x == 0 && atomicAdd(&tickets[1], 1) == nb - 1) {
    tickets[0] = 0;
    tickets[1] = 0;
  }
}

template <typename T, bool VECTOR>
int launch_bwd(const void* x, const void* dy, const float* w, void* dx,
               float* part, float* dwb, int* tickets, int rows, int N,
               int blocks, float eps, cudaStream_t st) {
  constexpr int W = bwd_warps<T>();
  int ld = (N + 7) / 8 * 8;  // 16-byte ring rows in either dtype
  const int ring = W * 4 * ld * static_cast<int>(sizeof(T));
  const int red = W * 2 * N * 4;
  const int smem = ring > red ? ring : red;
  cudaError_t err = allow_smem<layer_norm_bwd_kernel<T, VECTOR>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cooperative: every block is resident at once (or the launch fails),
  // which the kernel's barrier over the grid needs
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  void* args[] = {&xp, &dyp, &w, &dxp, &part, &dwb, &tickets, &rows, &N, &ld,
                  &eps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(layer_norm_bwd_kernel<T, VECTOR>), dim3(blocks),
      dim3(32 * W), args, smem, st));
}

// whether every pointer is 16-byte aligned and rows are whole 16-byte groups
bool vector_path(int dtype, int N, const void* const* ptrs, int nptr) {
  uintptr_t bits = 0;
  for (int i = 0; i < nptr; ++i) bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return N % (dtype == 1 ? 8 : 4) == 0 && bits % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y); w and b f32; contiguous
// (rows, N) tensors. Returns 0, a CUDA error code from the launch, or -1
// for arguments the kernel does not take.
extern "C" int layer_norm_fwd(int dtype, const void* x, const float* w,
                              const float* b, void* y, int rows, int N,
                              float eps, void* stream) {
  if ((dtype != 0 && dtype != 1) || rows <= 0 || N <= 0 || N > MAX_FEATURES)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {x, w, b, y};
  const bool vec = vector_path(dtype, N, ptrs, 4);
  if (dtype == 1)
    return vec ? launch_fwd<__nv_bfloat16, true>(x, w, b, y, rows, N, eps, st)
               : launch_fwd<__nv_bfloat16, false>(x, w, b, y, rows, N, eps, st);
  return vec ? launch_fwd<float, true>(x, w, b, y, rows, N, eps, st)
             : launch_fwd<float, false>(x, w, b, y, rows, N, eps, st);
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
      N > MAX_FEATURES)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {x, dy, dx, w, part, dwb};
  if (dtype == 1)
    return vector_path(dtype, N, ptrs, 6)
               ? launch_bwd<__nv_bfloat16, true>(x, dy, w, dx, part, dwb, tickets,
                                                 rows, N, blocks, eps, st)
               : launch_bwd<__nv_bfloat16, false>(x, dy, w, dx, part, dwb, tickets,
                                                  rows, N, blocks, eps, st);
  return vector_path(dtype, N, ptrs, 6)
             ? launch_bwd<float, true>(x, dy, w, dx, part, dwb, tickets, rows, N,
                                       blocks, eps, st)
             : launch_bwd<float, false>(x, dy, w, dx, part, dwb, tickets, rows, N,
                                        blocks, eps, st);
}
