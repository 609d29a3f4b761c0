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
