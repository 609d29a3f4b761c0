// Dump of the attention-dropout keep bits in the bf16 kernels' two visit
// orders, through their own fragment maps.
//
// Replaces the TPU bit-dump kernels `multimodal_sequencing_tpu/ops/
// attention.py::_bits_dump` (its `fwd_kernel` and `dkv_kernel`) and
// `scripts/verify_hw_dropout_bits.py::_bits_dump_kernel` /
// `_bits_dump_kernel_dkv`. Those call the TPU's tile-bit generator with the
// forward's and the dk/dv kernel's own tile arguments, to prove that the two
// kernels regenerate one mask.
//
// What the dump proves here. A bf16 flash kernel drops element e of group j
// of a thread's score accumulator by the keep bit of the (q, key) that its
// map in `keep_bits.cuh` gives: map (a) in the forward, map (b) in the main
// backward. These kernels run the same loops (the forward's: a 64-row q
// tile over the key tiles; the main backward's: a 64-key tile over the q
// tiles from its own, `kt + it` mod n_qt), draw each element's bit at the
// position its map gives, hold it where the kernel holds that accumulator
// element, and store those registers with `stmatrix`, which puts each where
// the hardware's fragment layout (that of wgmma's accumulators) says it
// lies; the dk/dv order stores its S^T tile with `.trans`, so that the dump
// is out[bh][q][key] in both orders. A map that names another (q, key) than
// the element it is applied to moves bits, and the dump then differs from
// the plain bits (`ops/attention.py::keep_bits`).
//
// Bound on this card: it writes B*H*S*S bytes (one bool each), reads
// nothing, and hashes each element: at least 10 integer operations
// (keep_bits.cuh: the counter's add, the counter being linear in the
// position; mix32's three shifts, three xors, the last with the mask, and
// two multiplies; the compare), which an SM issues at most 128 a clock (its
// integer ALU and FMA pipes, 64 lanes each). At (B*H = 128, S = 320) both
// orders write 26.2 MB, 7.8 us at the published 3.35 TB/s, and hash 26.2 M
// elements, 0.262 G operations, 7.8 us at 132 SMs x 128 a clock x ~1.98 GHz:
// the two bounds meet. The shifts, xors and byte permutes run only on the
// ALU pipe, which is what the compiled loop waits on. The design spends
// little beyond the hash. The hash input (q * S + key) * C + seed is linear
// in the position, so a thread computes its first element's input once a
// tile and every other element adds a constant of its map (one add); the
// compare is the sign of (hash & 0x7FFFFFFF) - thresh, and one byte permute
// packs two signs into a register of b16 elements (0xFFFF kept). Four
// `stmatrix` a warp stage a 64 x 64 tile in shared memory (swizzled: no bank
// conflicts), and 16-byte loads and stores, consecutive threads on
// consecutive 16 bytes of a row, write it out as bytes; a row that is not
// 16-byte aligned (S % 16 != 0) takes the widest store that S allows. Ragged
// tiles mask rows and columns at or past S. Batch*heads x tiles lie on the
// grid's x, which takes 2^31 - 1 blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keep_bits.cuh"

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 128;            // one warpgroup, as in the kernels
constexpr int ROW_BYTES = TILE * 2;     // a row of the b16 staging tile
constexpr uint32_t KEEP_MUL = 0x9E3779B9u;  // keep_bit's counter multiplier

// keep_bit's hash input of element (row, col)
__device__ __forceinline__ uint32_t hash_in(uint32_t seed_bh, uint32_t row,
                                            uint32_t col, uint32_t seq_len) {
  return (row * seq_len + col) * KEEP_MUL + seed_bh;
}

// x, which the compiler may no longer take apart: an element's hash input
// is then the thread's first element's plus a constant of the map, one
// add, where otherwise the compiler recomputes (q * S + key) * C + seed
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm("" : "+r"(x));
  return x;
}

// Negative (bit 31 set) exactly where keep_bit is true: both operands are
// below 2^31.
__device__ __forceinline__ uint32_t keep_sign(uint32_t in, uint32_t thresh) {
  return (mix32(in) & 0x7FFFFFFFu) - thresh;
}

// Two signs as a register of two b16 elements: lo's in the low half (the
// even column of a fragment pair), 0xFFFF where kept, else 0.
__device__ __forceinline__ uint32_t pack_signs(uint32_t lo, uint32_t hi) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0xFFBB;" : "=r"(r) : "r"(lo), "r"(hi));
  return r;
}

// Byte offset of 16-byte chunk c (8 columns) of row r of the staging tile;
// the XOR keeps an 8 x 8 matrix's rows, and a quarter-warp's readout, on
// distinct banks.
__device__ __forceinline__ uint32_t stage_off(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// Four 8 x 8 b16 matrices of fragments, register i of every lane to matrix
// i, whose row r lies at the address that lane 8 i + r gives.
template <bool TRANS>
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t* r) {
  if (TRANS)
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
        ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
  else
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
        ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// Bytes [p * W, (p + 1) * W) of v to dst.
template <int W>
__device__ __forceinline__ void store_piece(uint8_t* dst, const uint32_t* v,
                                            int p) {
  if (W == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(v[2 * p], v[2 * p + 1]);
  else if (W == 4)
    *reinterpret_cast<uint32_t*>(dst) = v[p];
  else if (W == 2)
    *reinterpret_cast<uint16_t*>(dst) =
        static_cast<uint16_t>(v[p >> 1] >> (16 * (p & 1)));
  else
    *dst = static_cast<uint8_t>(v[p >> 2] >> (8 * (p & 3)));
}

// The staged 64 x 64 tile of q rows q0.. and keys k0.. as bytes 0 / 1 into
// o (one head's S x S), W bytes a store (S % W == 0).
template <int W>
__device__ __forceinline__ void write_tile(uint8_t* o, const uint8_t* st,
                                           int q0, int k0, int S) {
#pragma unroll
  for (int k = 0; k < TILE * TILE / 16 / THREADS; ++k) {
    // 16 keys of row r: chunks 2 cc and 2 cc + 1 of the staged b16 row
    const int c = threadIdx.x + k * THREADS, r = c >> 2, cc = c & 3;
    const int key = k0 + 16 * cc;
    if (q0 + r >= S || key >= S) continue;
    const uint4 a = *reinterpret_cast<const uint4*>(st + stage_off(r, 2 * cc));
    const uint4 b = *reinterpret_cast<const uint4*>(st + stage_off(r, 2 * cc + 1));
    const uint32_t v[4] = {__byte_perm(a.x, a.y, 0x6420) & 0x01010101u,
                           __byte_perm(a.z, a.w, 0x6420) & 0x01010101u,
                           __byte_perm(b.x, b.y, 0x6420) & 0x01010101u,
                           __byte_perm(b.z, b.w, 0x6420) & 0x01010101u};
    uint8_t* dst = o + (long long)(q0 + r) * S + key;
    if (W == 16) {  // S % 16 == 0: the 16 keys are all below S
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int p = 0; p < 16 / W; ++p)
        if (key + p * W < S) store_piece<W>(dst + p * W, v, p);
    }
  }
}

// block = one 64-row q tile of one batch*head (the forward's block), over
// the key tiles through map (a)
template <int W>
__global__ void __launch_bounds__(THREADS)
dump_fwd_order(uint8_t* out, int S, int H, int n_t, uint32_t seed,
               uint32_t thresh, BhIndex gbh) {
  __shared__ __align__(128) uint8_t stage[2][TILE * ROW_BYTES];
  const int bh = blockIdx.x / n_t, q0 = (blockIdx.x % n_t) * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t seed_bh = seed_for_head(seed, gbh, bh / H, bh % H);
  uint8_t* o = out + (long long)bh * S * S;
  // matrix m = lane / 8 of stmatrix i holds the fragments s[4 j + e] of
  // j = 2 i + m / 2, e >> 1 = m & 1: rows 16 warp + 8 (m & 1) + lane % 8,
  // columns 8 j..
  const int m = lane >> 3, st_row = 16 * warp + 8 * (m & 1) + (lane & 7);
  const int r0 = q0 + frag_row0(warp, g);

  for (int kt = 0; kt < n_t; ++kt) {
    const int k0 = kt * TILE;
    const FragPos p0 = fwd_s_frag(r0, k0, t, 0, 0);
    const uint32_t in0 = opaque(hash_in(seed_bh, p0.q, p0.key, S));
    // s[4 j + e]'s bit: half e & 1 of r[2 j + (e >> 1)]
    uint32_t r[TILE / 4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t d[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const FragPos f = fwd_s_frag(r0, k0, t, j, 2 * h + c);
          d[c] = keep_sign(
              in0 + static_cast<uint32_t>((f.q - p0.q) * S + f.key - p0.key) *
                        KEEP_MUL, thresh);
        }
        r[2 * j + h] = pack_signs(d[0], d[1]);
      }
    uint8_t* st = stage[kt & 1];
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(st));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      stmatrix_x4<false>(base + stage_off(st_row, 2 * i + (m >> 1)), r + 4 * i);
    __syncthreads();  // (the other stage's readout, one tile back, is done)
    write_tile<W>(o, st, q0, k0, S);
  }
}

// block = one 64-key tile of one batch*head (the main backward's item), over
// the q tiles in its rotated order through map (b)
template <int W>
__global__ void __launch_bounds__(THREADS)
dump_dkv_order(uint8_t* out, int S, int H, int n_t, uint32_t seed,
               uint32_t thresh, BhIndex gbh) {
  constexpr int NQ = MAIN_NQ;
  __shared__ __align__(128) uint8_t stage[2][TILE * ROW_BYTES];
  const int bh = blockIdx.x / n_t, kt = blockIdx.x % n_t, k0 = kt * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t seed_bh = seed_for_head(seed, gbh, bh / H, bh % H);
  uint8_t* o = out + (long long)bh * S * S;
  // matrix m = lane / 8 of stmatrix i holds the fragments of S^T column
  // block cb = 2 i + m / 2 (q 8 cb.., pass hf = cb / (NQ / 8), jj = cb %
  // (NQ / 8)) and key rows 16 warp + 8 (m & 1)..; transposed, its row
  // lane % 8 is q row 8 cb + lane % 8, keys in chunk 2 warp + (m & 1)
  const int m = lane >> 3, st_chunk = 2 * warp + (m & 1);
  const int key0 = bwd_st_key0(k0, warp, g);

  for (int it = 0; it < n_t; ++it) {
    const int q0 = (kt + it < n_t ? kt + it : kt + it - n_t) * TILE;
    const FragPos p0 = bwd_st_frag(key0, q0, bwd_st_col<NQ>(t, 0, 0, 0), 0);
    const uint32_t in0 = opaque(hash_in(seed_bh, p0.q, p0.key, S));
    // s[4 jj + e]'s bit in pass hf: half e & 1 of r[2 cb + (e >> 1)], with
    // cb = hf NQ / 8 + jj
    uint32_t r[TILE / 4];
#pragma unroll
    for (int hf = 0; hf < TILE / NQ; ++hf)
#pragma unroll
      for (int jj = 0; jj < NQ / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t d[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * h + c;
            const FragPos f =
                bwd_st_frag(key0, q0, bwd_st_col<NQ>(t, hf, jj, e), e);
            d[c] = keep_sign(
                in0 + static_cast<uint32_t>((f.q - p0.q) * S + f.key - p0.key) *
                          KEEP_MUL, thresh);
          }
          r[2 * (hf * NQ / 8 + jj) + h] = pack_signs(d[0], d[1]);
        }
    uint8_t* st = stage[it & 1];
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(st));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      stmatrix_x4<true>(base + stage_off(8 * (2 * i + (m >> 1)) + (lane & 7),
                                         st_chunk), r + 4 * i);
    __syncthreads();
    write_tile<W>(o, st, q0, k0, S);
  }
}

template <int W>
cudaError_t launch(int order, unsigned grid, cudaStream_t st, uint8_t* o,
                   int S, int H, int n_t, uint32_t seed, uint32_t thresh,
                   BhIndex g) {
  if (order == 0)
    dump_fwd_order<W><<<grid, THREADS, 0, st>>>(o, S, H, n_t, seed, thresh, g);
  else
    dump_dkv_order<W><<<grid, THREADS, 0, st>>>(o, S, H, n_t, seed, thresh, g);
  return cudaGetLastError();
}

}  // namespace

// order: 0 = forward order, 1 = dk/dv order. out: (B*H, S, S) bytes. gbh:
// the heads' global index (b_off, h_off, h_tot; keep_bits.cuh).
// Returns 0, a CUDA error code from the launch, or -1 for bad arguments.
extern "C" int keep_bits_dump(int order, void* out, int batch, int heads,
                              int seq_len, uint32_t seed, uint32_t thresh,
                              const uint32_t* gbh, void* stream) {
  const int n_t = (seq_len + TILE - 1) / TILE;
  const long long blocks = (long long)batch * heads * n_t;
  if ((order != 0 && order != 1) || batch <= 0 || heads <= 0 ||
      seq_len <= 0 || blocks > 0x7FFFFFFF)
    return -1;
  // the widest store that every row start allows: the largest power of two
  // that divides S and the address, at most 16
  const uintptr_t x = static_cast<uintptr_t>(seq_len) |
                      reinterpret_cast<uintptr_t>(out) | 16u;
  const int w = static_cast<int>(x & (~x + 1));
  const BhIndex g = bh_index(gbh);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  const auto fn = w == 16 ? launch<16> : w == 8 ? launch<8>
                 : w == 4  ? launch<4>  : w == 2 ? launch<2> : launch<1>;
  return static_cast<int>(fn(order, grid, st, o, seq_len, heads, n_t, seed,
                             thresh, g));
}
