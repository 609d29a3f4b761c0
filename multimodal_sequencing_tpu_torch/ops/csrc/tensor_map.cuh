// The 64-row head tile that the flash-attention sources move by TMA: the
// host code that makes its tensor maps over a head-split bf16 tensor,
// indexed (B, H, S, D) but laid out in memory as the caller's strides say
// (the encoder's (B, S, H, D) projections have a row stride of H*D), and
// the wgmma descriptors that read it. A tile is D / SUB sub-tiles, one TMA
// box each, of 64 rows of SUB = min(D, 64) columns (SUB*2 bytes), row-major,
// its 16-byte chunks swizzled by the map (its SWIZZLE_{SUB*2}B mode, which
// wgmma reads as its layout of the same name), each on a 1 KB boundary:
// D = 16, 32, 64 is one box; D = 128 is two, columns 0..63 and 64..127 (a
// swizzle span is at most 128 bytes). Rows past S load as zeros, and a
// store skips them.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int TMA_ROWS = 64;  // rows of a box: a wgmma M tile

// columns of a sub-tile (one TMA box) and sub-tiles of a tile
template <int D>
__host__ __device__ constexpr int sub_cols() { return D < 64 ? D : 64; }
template <int D>
__host__ __device__ constexpr int n_sub() { return D / sub_cols<D>(); }

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
// (sb, sh, ss) and a contiguous head dim, in boxes of 64 rows of min(D, 64)
// columns of one head, swizzled for wgmma; rows past S read as zeros, and
// a store skips them.
inline bool head_map(CUtensorMap* map, const void* base, int batch, int heads,
                     int seq_len, int head_dim, const long long* strides) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)seq_len,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2,
                               (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const int cols = head_dim < 64 ? head_dim : 64;
  const cuuint32_t box[4] = {(cuuint32_t)cols, TMA_ROWS, 1, 1};
  const CUtensorMapSwizzle swizzle =  // a box row is one swizzle span
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ----- device: reading a tile -----------------------------------------------

// descriptor layout of a SUB*2-byte swizzle
template <int D>
__device__ __forceinline__ constexpr uint32_t tile_layout() {
  return sub_cols<D>() == 64 ? 1 : sub_cols<D>() == 32 ? 2 : 3;
}
// One 64-row tile as TMA boxes into `dst` (sub-tile c at dst + c * 64 *
// SUB): rows [row0, row0 + 64) of head (b, h), all under `bar`.
template <int D>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          __nv_bfloat16* dst, int row0, int h,
                                          int b, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < n_sub<D>(); ++c)
    tma_load_4d(dst + c * TMA_ROWS * sub_cols<D>(), map, bar,
                c * sub_cols<D>(), row0, h, b);
}
// The tile in shared memory into rows [row0, row0 + 64) of head (b, h), one
// bulk group per sub-tile.
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           const __nv_bfloat16* src, int row0,
                                           int h, int b) {
#pragma unroll
  for (int c = 0; c < n_sub<D>(); ++c)
    tma_store_4d(map, src + c * TMA_ROWS * sub_cols<D>(), c * sub_cols<D>(),
                 row0, h, b);
}
// Operand descriptors of a swizzled tile. K-major (the head dim is K):
// K step ks of 16 columns lies in sub-tile ks*16 / SUB, 32 bytes a step
// along its rows; 8-row groups SUB*16 bytes apart. MN-major (the rows are
// K): K steps of 16 rows, over the SUB columns of sub-tile `c` (an N of at
// most 64, one swizzle atom).
template <int D>
__device__ __forceinline__ uint64_t kmajor_at(const __nv_bfloat16* t, int row0,
                                              int ks) {
  constexpr int SUB = sub_cols<D>(), PER = SUB / 16;  // K steps a sub-tile
  return wgmma_desc(t + (ks / PER) * TMA_ROWS * SUB + row0 * SUB
                        + (ks % PER) * 16,
                    16, SUB * 16, tile_layout<D>());
}
template <int D>
__device__ __forceinline__ uint64_t mnmajor_at(const __nv_bfloat16* t, int kk,
                                               int c = 0) {
  constexpr int SUB = sub_cols<D>();
  return wgmma_desc(t + c * TMA_ROWS * SUB + kk * 16 * SUB,
                    TMA_ROWS * SUB * 2, SUB * 16, tile_layout<D>());
}
// Byte offset of (row, byte `col_byte` of the row) in a swizzled tile: in
// sub-tile col_byte / (SUB*2), 16-byte chunk c of row r sits at chunk
// c ^ (r' & (SUB/8 - 1)), r' the 128-byte line of the row (the
// 32/64/128-byte swizzle of SUB = 16/32/64).
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int row, int col_byte) {
  constexpr int SB = sub_cols<D>() * 2;  // bytes of a sub-tile row
  const uint32_t off = row * SB + col_byte % SB;
  return (col_byte / SB) * (TMA_ROWS * SB)
         + (off ^ (((off >> 7) & (SB / 16 - 1)) << 4));
}

}  // namespace
