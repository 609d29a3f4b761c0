// Hopper (sm_90a) building blocks for the flash-attention kernels: TMA
// tile loads and stores under mbarriers, and warpgroup products (`wgmma`)
// on bf16 tiles in shared memory or registers with f32 accumulators.
//
// The slab layout, for a tile written by threads rather than TMA: a
// 64-row x C bf16 tile held as C/8 column slabs, each 64 rows x 8 elements
// (16 bytes a row, 1 KB a slab), so element (r, c) sits at
// ((c / 8) * 64 + r) * 8 + c % 8. Every 8 x 8 block of it (a wgmma "core
// matrix") is 128 contiguous bytes, which is wgmma's no-swizzle layout both
// along the rows (K-major operand) and across them (MN-major).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

// ----- host -------------------------------------------------------------------

// Lets `Kernel` take `smem` bytes of dynamic shared memory on the current
// device. The attribute is only ever raised, and only when a launch needs
// more than was set before, so a launch of a size seen before costs no call
// into the driver.
template <auto Kernel>
inline cudaError_t allow_smem(int smem) {
  constexpr int DEVICES = 64;
  static std::mutex mu;
  static int set[DEVICES] = {};  // the size set so far, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set[dev] = smem;
  return err;
}

// ----- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the barrier's current phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA writes, wgmma reads) of the same addresses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----- TMA ----------------------------------------------------------------------

// Box (c0, c1, c2, c3) of a 4-d tensor map into shared memory.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared memory into box (c0, c1, c2, c3) of a 4-d tensor map, as one bulk
// group; elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const void* map, const void* src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) contiguous
// bytes into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Adds `bytes` of f32 from shared memory into global memory (16-byte
// aligned, a multiple of 16 bytes), as one asynchronous bulk operation.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const float* src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
      :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk operations have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Until this thread's bulk operations are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ----- wgmma --------------------------------------------------------------------

// Operand descriptor: `lbo` and `sbo` bytes (see the PTX ISA's matrix
// descriptor), `layout` 0 = no swizzle, 1 = 128-byte, 2 = 64-byte,
// 3 = 32-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo, uint32_t layout = 0) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulator registers in place around wgmma: the compiler may not
// move their other reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator of an m64nNk16 product: N / 2 floats a thread. Thread
// (warp w, lane 4g + t) holds, for each 8-column group j, d[4j], d[4j+1]
// at row 16w + g, columns 8j + 2t, 8j + 2t + 1, and d[4j+2], d[4j+3] at
// row 16w + g + 8, the same columns.
//
// d (64 x N) (+)= A (64 x 16) . B (16 x N). SS: A and B from shared memory
// (TA / TB: 0 = K-major, 1 = MN-major). RS: A from registers, four 32-bit
// registers of bf16 pairs in the accumulator's row/column pattern over 16
// columns (the mma.sync m16n8k16 A fragment of each warp's 16 rows).
// accumulate = 0 overwrites d.

#define WG_D8(o) "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
                 "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

template <int N> struct Wgmma;

template <> struct Wgmma<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : WG_D8(0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, %14;\n}\n"
        : WG_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TB));
  }
};

template <> struct Wgmma<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17,"
        " p, 1, 1, %19, %20;\n}\n"
        : WG_D8(0), WG_D8(8)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15},"
        " {%16,%17,%18,%19}, %20, p, 1, 1, %22;\n}\n"
        : WG_D8(0), WG_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TB));
  }
};

template <> struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
        " %32, %33, p, 1, 1, %35, %36;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
        " {%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TB));
  }
};

#undef WG_D8

// Two floats as a bf16 pair (lo in the low half), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator floats x[0..7] (two 8-column groups) re-packed as the RS A
// operand of 16 columns (see Wgmma above).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* x) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
}

// 2^x by the hardware's approximation (a few ulps; results below 2^-126
// flush to 0). The flash kernels' probabilities only feed bf16 products,
// where such a value is lost anyway, and the exact exp2f's range handling
// lengthens the per-element work that bounds them.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
