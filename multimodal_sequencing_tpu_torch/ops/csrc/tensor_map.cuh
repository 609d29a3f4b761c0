// The 64-row head tile that the flash-attention sources move by TMA: the
// host code that makes its tensor maps over a head-split bf16 tensor,
// indexed (B, H, S, D) but laid out in memory as the caller's strides say
// (the encoder's (B, S, H, D) projections have a row stride of H*D), and
// the wgmma descriptors that read it. A tile is one TMA box of 64 rows of
// D*2 bytes, row-major, its 16-byte chunks swizzled by the map (its
// SWIZZLE_{D*2}B mode, which wgmma reads as its layout of the same name),
// on a 1 KB boundary; rows past S load as zeros, and a store skips them.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int TMA_ROWS = 64;  // rows of a box: a wgmma M tile

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Tensor map of a bf16 (B, H, S, D)-indexed tensor with element strides
// (sb, sh, ss) and a contiguous head dim, in boxes of 64 rows of one head,
// swizzled for wgmma; rows past S read as zeros, and a store skips them.
inline bool head_map(CUtensorMap* map, const void* base, int batch, int heads,
                     int seq_len, int head_dim, const long long* strides) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)seq_len,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2,
                               (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)head_dim, TMA_ROWS, 1, 1};
  const CUtensorMapSwizzle swizzle =  // a row of D bf16 is one swizzle span
      head_dim == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : head_dim == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ----- device: reading a tile -----------------------------------------------

// descriptor layout of a D*2-byte swizzle
template <int D>
__device__ __forceinline__ constexpr uint32_t tile_layout() {
  return D == 64 ? 1 : D == 32 ? 2 : 3;
}
// Operand descriptors of a swizzled tile. K-major (the head dim is K):
// 8-row groups D*16 bytes apart; K steps of 16 move 32 bytes along the row.
// MN-major (the rows are K): K steps of 16 rows.
template <int D>
__device__ __forceinline__ uint64_t kmajor_at(const __nv_bfloat16* t, int row0,
                                              int ks) {
  return wgmma_desc(t + row0 * D + ks * 16, 16, D * 16, tile_layout<D>());
}
template <int D>
__device__ __forceinline__ uint64_t mnmajor_at(const __nv_bfloat16* t, int kk) {
  return wgmma_desc(t + kk * 16 * D, TMA_ROWS * D * 2, D * 16, tile_layout<D>());
}
// Byte offset of (row, byte `col_byte` of the row) in a swizzled tile:
// 16-byte chunk c of row r sits at chunk c ^ (r' & (D/8 - 1)), r' the
// 128-byte line of the row (the 32/64/128-byte swizzle of D = 16/32/64).
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int row, int col_byte) {
  const uint32_t off = row * (D * 2) + col_byte;
  return off ^ (((off >> 7) & (D / 8 - 1)) << 4);
}

}  // namespace
