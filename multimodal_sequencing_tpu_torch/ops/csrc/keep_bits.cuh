// Keep bits of the fused HF "probs" attention dropout, shared by the
// forward, dq and dk/dv kernels and the bit-dump kernels, so that every
// kernel regenerates one mask.
//
// The same function as `multimodal_sequencing_tpu/ops/attention.py::
// _mix32 / _keep_bits / _seed_for_bh` (the hash bits, bits_hw=False): a
// murmur3 finalizer over the per-element counter row * S + col, seeded per
// batch*head, all in 32-bit wrapping arithmetic. Per element, so any tile
// decomposition gives the same bits. The TPU's hardware-PRNG tile bits
// (`_hw_tile_bits`) have no counterpart here.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// seed: the int32 step/layer seed as uint32; bh = b * H + h.
__device__ __forceinline__ uint32_t seed_for_bh(uint32_t seed, uint32_t bh) {
  return mix32(seed + (bh + 1u) * 668265263u);
}

// Where a call's (B, H) heads sit in a larger batch and head count (a data-
// or tensor-parallel rank's slice): local head h of batch row b draws the
// bits of the global index (b_off + b) * h_tot + h_off + h. {0, 0, H} is
// the call's own index b * H + h.
struct BhIndex {
  uint32_t b_off, h_off, h_tot;
};

// From the host's (b_off, h_off, h_tot) array.
inline BhIndex bh_index(const uint32_t* a) { return {a[0], a[1], a[2]}; }

__device__ __forceinline__ uint32_t seed_for_head(uint32_t seed, BhIndex g,
                                                  int b, int h) {
  return seed_for_bh(seed, (g.b_off + b) * g.h_tot + g.h_off + h);
}

// True when element (row, col) of a (seq_len x seq_len) score matrix is kept.
__device__ __forceinline__ bool keep_bit(uint32_t seed_bh, uint32_t row,
                                         uint32_t col, uint32_t seq_len,
                                         uint32_t thresh) {
  const uint32_t x = mix32((row * seq_len + col) * 0x9E3779B9u + seed_bh);
  return (x & 0x7FFFFFFFu) < thresh;
}

// ----- fragment maps ---------------------------------------------------------
//
// Where the bf16 kernels' score accumulators lie: element e (0..3) of group
// j of a thread of warp `warp` (lane = 4 g + t) of the warpgroup. A wgmma
// m64nNk16 f32 accumulator puts it at tile row 16 warp + g + 8 (e >> 1) and
// column 8 j + 2 t + (e & 1) (PTX ISA, the wgmma D fragment). The kernels
// draw each element's keep bit at the (q row, key column) that these maps
// give, and `keep_bits_dump.cu` replays them. A map takes the thread's
// first row and the element's column, which the kernels compute once and
// use elsewhere too, and each sum is grouped as the kernels group it: so
// the kernels compile to the code they had with the maps written inline.
// Every head width's instance has the same maps: the score tiles are
// 64 x 64 at every D, and the main backward takes MAIN_NQ q columns a pass
// at every D.

struct FragPos {
  int q, key;
};

// A thread's first accumulator row in a 64-row tile.
__device__ __forceinline__ int frag_row0(int warp, int g) {
  return warp * 16 + g;
}

// (a) The bf16 forward's S tile (rows q, columns keys): element e of
// s[4 j + e] in key tile k0, for the thread's first q row r0 = q0 +
// frag_row0(warp, g).
__device__ __forceinline__ FragPos fwd_s_frag(int r0, int k0, int t, int j,
                                              int e) {
  return {r0 + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1)};
}

// q columns of one pass of the bf16 main backward over its S^T tile
// (`flash_bwd.cu`: NQ = BLOCK / HALVES, which it asserts equal to this).
constexpr int MAIN_NQ = 32;

// (b) The bf16 main backward's S^T tile (rows keys, columns q) of key tile
// k0 and q tile q0: the thread's first key row, the column of element e of
// s[4 jj + e] in pass hf of NQ q columns, and the element's place.
__device__ __forceinline__ int bwd_st_key0(int k0, int warp, int g) {
  return k0 + warp * 16 + g;
}
template <int NQ>
__device__ __forceinline__ int bwd_st_col(int t, int hf, int jj, int e) {
  return hf * NQ + 8 * jj + 2 * t + (e & 1);
}
__device__ __forceinline__ FragPos bwd_st_frag(int key0, int q0, int col,
                                               int e) {
  return {q0 + col, key0 + 8 * (e >> 1)};
}
