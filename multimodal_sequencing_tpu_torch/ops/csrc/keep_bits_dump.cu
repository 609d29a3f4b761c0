// Dump of the attention-dropout keep bits in the kernels' two visit orders.
//
// Replaces the TPU bit-dump kernels `multimodal_sequencing_tpu/ops/
// attention.py::_bits_dump` (its `fwd_kernel` and `dkv_kernel`) and
// `scripts/verify_hw_dropout_bits.py::_bits_dump_kernel` /
// `_bits_dump_kernel_dkv`. Those dump the TPU hardware-PRNG tile bits to
// prove the forward and the dk/dv kernel regenerate one mask. The port has
// one bit source, `keep_bits.cuh`, so these kernels write what it gives over
// the forward's loop (per 64-row q-tile, over the 64-key tiles) and over the
// dk/dv kernel's loop (per 64-key tile, over the q-tiles); the two dumps and
// the plain bits must be equal.
//
// Bound on this card: it writes B*H*S*S bytes (one bool each) and reads
// nothing, ~10 integer operations per element; at (B*H = 128, S = 320) that
// is 13.1 MB, ~4 us at the published 3.35 TB/s. One thread per element of a
// tile row, consecutive threads on consecutive bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keep_bits.cuh"

namespace {

constexpr int TILE = 64;

__device__ __forceinline__ void write_tile(uint8_t* out, uint32_t seed_bh,
                                           int r0, int c0, int S,
                                           uint32_t thresh) {
  for (int e = threadIdx.x; e < TILE * TILE; e += blockDim.x) {
    const int r = r0 + e / TILE, c = c0 + e % TILE;
    if (r < S && c < S)
      out[(long long)r * S + c] = keep_bit(seed_bh, r, c, S, thresh) ? 1 : 0;
  }
}

// grid (q-tiles, B*H): block = one q-tile, loop over the k-tiles
__global__ void dump_fwd_order(uint8_t* out, int S, int H, uint32_t seed,
                               uint32_t thresh, BhIndex gbh) {
  const int bh = blockIdx.y;
  const uint32_t sb = seed_for_head(seed, gbh, bh / H, bh % H);
  uint8_t* o = out + (long long)bh * S * S;
  const int n_t = (S + TILE - 1) / TILE;
  for (int kt = 0; kt < n_t; ++kt)
    write_tile(o, sb, blockIdx.x * TILE, kt * TILE, S, thresh);
}

// grid (k-tiles, B*H): block = one k-tile, loop over the q-tiles
__global__ void dump_dkv_order(uint8_t* out, int S, int H, uint32_t seed,
                               uint32_t thresh, BhIndex gbh) {
  const int bh = blockIdx.y;
  const uint32_t sb = seed_for_head(seed, gbh, bh / H, bh % H);
  uint8_t* o = out + (long long)bh * S * S;
  const int n_t = (S + TILE - 1) / TILE;
  for (int qt = 0; qt < n_t; ++qt)
    write_tile(o, sb, qt * TILE, blockIdx.x * TILE, S, thresh);
}

}  // namespace

// order: 0 = forward order, 1 = dk/dv order. out: (B*H, S, S) bytes. gbh:
// the heads' global index (b_off, h_off, h_tot; keep_bits.cuh).
// Returns 0, a CUDA error code from the launch, or -1 for bad arguments.
extern "C" int keep_bits_dump(int order, void* out, int batch, int heads,
                              int seq_len, uint32_t seed, uint32_t thresh,
                              const uint32_t* gbh, void* stream) {
  const long long bh = (long long)batch * heads;
  if ((order != 0 && order != 1) || batch <= 0 || heads <= 0 || bh > 65535 ||
      seq_len <= 0)
    return -1;
  const BhIndex g = bh_index(gbh);
  const dim3 grid((seq_len + TILE - 1) / TILE, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (order == 0)
    dump_fwd_order<<<grid, 256, 0, st>>>(o, seq_len, heads, seed, thresh, g);
  else
    dump_dkv_order<<<grid, 256, 0, st>>>(o, seq_len, heads, seed, thresh, g);
  return static_cast<int>(cudaGetLastError());
}
