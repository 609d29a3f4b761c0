// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels `multimodal_sequencing_tpu/ops/attention.py::
// _flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (both launched by
// `flash_attention_bwd`, which also computes delta = rowsum(dO * O) in
// XLA). Same function, from the forward's saved O and lse:
//   s = scale * Q K^T, p = where(key kept, exp(s - lse), 0),
//   dp = dO V^T, dropped by the forward's keep bits and rescaled by 1/keep,
//   ds = p * (dp - delta),
//   dq = scale * ds K, dk = scale * ds^T Q, dv = (dropped p)^T dO.
// A key the mask drops, or a key beyond S, gets p = 0 by select: a fully
// masked batch row gets zero gradient (its lse is ~-1e9, so exp(s - lse)
// overflows, and the select keeps that from reaching the sums). A q row
// beyond S gets lse = +inf and so p = 0. Head dims 16, 32, 64 and 128
// (ops/attention.py pads other widths up to the next of them with zero
// columns); any number of batch*heads up to 2^31 - 1 and any S.
//
// bf16 (the training path): three launches.
//  * Pre-pass `flash_bwd_prep_kernel`: delta = rowsum(dO * O) in f32 from
//    bf16 O and dO, lse * log2(e), both padded to S_pad (a multiple of 64;
//    lse +inf and delta 0 past S), a zeroed f32 dq accumulator of `groups`
//    slices of (S_pad, D) a batch*head (groups: below), and zeroed int32
//    turn counters, one a (batch*head, group, 64-row q tile), in a buffer
//    of their own.
//  * Main `flash_bwd_main_kernel`: warp-specialised, one block an SM. An
//    item is one (batch*head, 64-key tile); a block runs L lanes (L = 2 at
//    D <= 64, 1 at D = 128), each a consumer warpgroup (128 threads), a
//    producer warp and a dq-writer warp, with shared memory of its own
//    (the warps of the block's last warpgroup: producers, then writers).
//    The producer (its lane 0) issues every load by TMA: the item's K and
//    V tiles into one of two buffers (the next item's arrive while this
//    one runs), beside the item's key mask as 64 bits that the whole warp
//    gathers, and, per step, a 64-row q tile's Q, dO, lse2 and delta into
//    a ring of two stages that runs on across items. A tile is one TMA box
//    (two of 64 columns at D = 128), swizzled by TMA in the pattern that
//    wgmma reads (128-byte swizzle at D >= 64), so neither the copy nor the
//    products pay for bank conflicts or for many small requests. The
//    consumer walks an item's q tiles; per tile, five `wgmma` products with
//    f32 accumulators: S^T = K Q^T and dP^T = V dO^T (shared-memory
//    operands as stored); p, the dropped p and dS from one exp2 and one
//    keep bit per element; dV += P~^T dO and dK += dS^T Q with the
//    re-packed accumulators as register A operands and dO, Q read MN-major
//    from the same tiles (no transposed copy); dS^T goes once to shared
//    memory in bf16 for dQ_partial = dS K, which the consumer leaves in one
//    of two dQ slots of the lane and goes on. The writer (one thread) adds
//    each partial into its slice of the f32 accumulator as one TMA bulk
//    reduce-add (`cp.reduce.async.bulk .add.f32`), in the turn of its q
//    tile (below), gives the slot back once the add has read it, and
//    passes the turn on once the add is complete. So only the writer ever
//    waits on another block; the consumer waits only on its own lane's
//    barriers (a stage or K/V buffer filled, a slot given back), and its
//    writer may lag it by two partials; the producer, which never waits
//    for a turn, keeps the loads ahead whatever the writer waits for. dK
//    and dV stay in registers until the item ends; then they go out as
//    bf16 tiles through the item's K and V buffers by TMA stores, which
//    run on while the next item starts (the threads' own scattered 4-byte
//    stores would hold the lane for microseconds). S^T and dP^T are taken
//    in two passes of 32 q columns (map (b) of keep_bits.cuh). At D <= 64
//    both passes' products are in flight at once, so the exp2 and keep
//    bits of the first run while the second's products do, and dQ_partial
//    is a product group of its own, stored into the slot while dV and dK
//    run; the last warpgroup gives its registers to the two consumers
//    (setmaxnreg: 232 a consumer thread, 40 a thread of the last
//    warpgroup, the launch's 168 x 384), and each lane's products run
//    while the other lane of its SM works its elements. At D = 128 a
//    lane's buffers are 202 KB, so an SM holds one lane; dK and dV alone
//    are 128 registers a thread, so the passes run one after the other, dV
//    and dK complete before dQ_partial starts, and dQ_partial goes in two
//    halves of 64 columns (<= 192 accumulator registers live at once: 249
//    registers a thread, no spill). The per-element work has one instance
//    with dropout and one without, each free of branches (a branch an
//    element keeps the compiler from interleaving the elements' work), and
//    the lanes are found by an offset from the shared array, so that every
//    access to them compiles to a shared-memory load or store.
//  * Post-pass `flash_bwd_post_kernel`: dq = scale * (the sum of the
//    accumulator's slices, in slice order) in bf16, laid out as the caller
//    asks (the accumulator's rows are chunk-swizzled so that the consumers'
//    shared-memory stores of their partials are free of bank conflicts; the
//    post-pass undoes it).
//
// The main kernel's schedule, and why every wait in it ends. The items of
// one head add their dq partials to a q tile in a fixed order, so dq is
// the same in every run: key tile kt takes the q tiles in the order kt,
// kt+1, ... (mod n_qt), so at step i it adds to tile (kt + i) mod n_qt,
// after the tile's adds from kt+1, kt+2, ... made at steps i-1, i-2, ....
// Its writer waits until the tile's turn counter reads the number of adds
// before its own, and once its add is complete sets the counter one higher
// (back to 0 after the tile's last add, ready for the next launch). An add
// so waits only on adds made at earlier steps of other items of its head.
//  * The launch is cooperative (`cudaLaunchCooperativeKernel`): its grid is
//    the number of blocks the card holds at once (one an SM, from the
//    occupancy calculator), or fewer when the items need fewer, and the
//    launch either makes every block resident at once or fails with an
//    error; nothing waits on a block that was not scheduled. Its G = L x
//    grid lanes are numbered l = w * grid + block (w the lane in its block,
//    so consecutive numbers lie on different SMs), and lane l takes the
//    items j = l, l + G, l + 2G, ... of the head-major order j = bh * n_qt
//    + kt, in that order; the same map in every launch, whatever order the
//    card dispatches in. A lane starts an item once its last item's
//    partials are all in slots and a slot is free.
//  * A head's key tiles are split into `groups` runs of n_g <= G consecutive
//    tiles (groups = ceil(n_qt / G), chosen by the wrapper from G; 1 unless
//    S > 64 G, ~16,900 rows at D = 64), each run adding into its own slice
//    of the accumulator under its own counters. The n_g <= G consecutive
//    items of a run lie on distinct lanes, and the item a lane took before
//    one of them (j - G) lies in an earlier run.
//  * So, by induction over the runs in j order: once every run before R
//    has finished (all its adds complete), each item X of R is on a lane
//    whose earlier items are finished, so its consumer reaches X with both
//    slots free and its writer has no add left before X's. X's add at step
//    0 waits for nothing; its add at step i waits only for adds of other
//    items of R at steps below i, which (by induction over the steps) all
//    complete; a consumer that finds both slots full waits for its own
//    older adds, which complete likewise; and an item the lane takes after
//    X lies in a later run, which X never waits for, and takes a slot only
//    when one is free. So every add of R completes, and R finishes.
//  * The producer waits only on its own consumer, which waits only on its
//    producer and writer, so no wait of theirs outlasts the writer's. A
//    wait for a turn traps after ~2^28 polls, and a wait on a barrier after
//    ten seconds, which only a fault can reach: the launch then fails
//    instead of hanging the card.
// dq, dk and dv are summed in a fixed order, so equal inputs give equal
// bits in every run.
//
// f32 (exact checks): `flash_bwd_dq_f32_kernel` and
// `flash_bwd_dkv_f32_kernel`, one thread per row (two at D = 128, each
// with half the columns, the dot products summed across the pair), scalar
// FMA, with delta computed outside.
//
// Bound on this card at the train shape (B*H = 128, S = 320, D = 64, bf16):
// the backward reads Q, K, V, O, dO and writes dQ, dK, dV, 8 x 5.24 MB,
// plus lse and the mask, ~42.3 MB: 12.6 us at the published 3.35 TB/s;
// five products of 2*S^2*D per head, 8.4 GFLOP: 8.5 us at 989 TFLOP/s. So
// bytes bound it. Beside that bound, the keep-bit hash costs ~13 integer
// operations per element of the B*H*S^2 = 13.1 M, ~0.17 G operations,
// ~12 us at 132 SMs x 64 integer operations per clock x ~1.75 GHz; this
// design hashes each element once (the earlier dq and dk/dv kernels hashed
// it twice). Its times are in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include <mutex>

#include "keep_bits.cuh"
#include "sm90.cuh"
#include "tensor_map.cuh"  // head_map, load_tile, kmajor_at, mnmajor_at

namespace {

// ----- building blocks of the warp-specialised main kernel ------------------

// One arrival (release, CTA scope).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// mbar_wait that gives up after ten seconds, where the awaited work takes
// microseconds: only a fault can get there, and it traps, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  auto done = [&] {
    uint32_t ok;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    return ok != 0;
  };
  if (done()) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!done()) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}

// Barrier `id` (1..15; 0 is __syncthreads') over `count` threads, whole
// warps.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Moves registers between the warpgroups of a warp-specialised block: a
// warpgroup gives up registers down to N a thread, or takes them up to N.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Until at most N of this warpgroup's committed product groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// ----- shapes and parameters ---------------------------------------------------

constexpr int BLOCK = 64;        // rows of a key tile and of a q tile
constexpr float LOG2E = 1.4426950408889634f;
// main kernel: lanes a block (one block an SM; a lane's shared memory is
// 106 KB at D = 64, 202 KB at D = 128)
template <int D>
__host__ __device__ constexpr int main_lanes() { return D > 64 ? 1 : 2; }
constexpr int STAGES = 2;    // q tiles in flight in a lane's ring
constexpr int DQ_SLOTS = 2;  // dQ partials a lane's writer may hold
// registers a thread after setmaxnreg at D <= 64: two consumer warpgroups
// and the producer and writer warpgroup share the 168 x 384 of the launch
constexpr int CONSUMER_REGS = 232, MOVER_REGS = 40;
static_assert(2 * CONSUMER_REGS + MOVER_REGS == 3 * 168, "the launch's registers");
// main kernel: the passes over a q tile's 64 columns for S^T and dP^T (two
// of 32, the fragment map (b) that keep_bits_dump.cu replays at every
// width; at D <= 64 both are in flight at once, at D = 128 one at a time)
constexpr int HALVES = 2;
// f32 kernels: threads a row (a row of 128 floats in two halves), the dq
// kernel's keys a tile and the dk/dv kernel's q rows a tile (tiles within
// 48 KB of static shared memory)
template <int D>
__host__ __device__ constexpr int f32_tpr() { return D > 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int f32_keys() { return D > 64 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int f32_q_tile() { return D > 64 ? 8 : 32; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const int* mask;     // (B, S) int32 key keep-mask
  const float* lse;    // (B*H, S)
  const float* delta;  // (B*H, S)
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int H, S, n_t;       // n_t: 64-row tiles of S (blocks a head)
  float scale;
  uint32_t seed;     // dropout seed (int32 bits)
  uint32_t thresh;   // keep threshold on the 31-bit hash; 0 = no dropout
  float inv_keep;    // 1 / (1 - p_drop)
  BhIndex gbh;       // the heads' global index (keep_bits.cuh)
};

template <typename T>
__device__ __forceinline__ const T* head(const void* base, long long sb,
                                         long long sh, int b, int h) {
  return static_cast<const T*>(base) + b * sb + h * sh;
}

template <typename T>
__device__ __forceinline__ T* head_out(void* base, long long sb, long long sh,
                                       int b, int h) {
  return static_cast<T*>(base) + b * sb + h * sh;
}

// The sum of x over the two threads of a row's pair (lanes 2r, 2r + 1): both
// get the same bits (a + b == b + a). Only the pair need take part.
__device__ __forceinline__ float pair_sum(float x) {
  const unsigned lane = threadIdx.x & 31;
  return x + __shfl_xor_sync(3u << (lane & ~1u), x, 1);
}

// ----- f32 (exact checks) -------------------------------------------------------
// One thread (pair) per q row; K/V tiles read as shared-memory broadcasts.
// Block x = bh * n_t + q tile.
template <int D>
__global__ void __launch_bounds__(BLOCK * f32_tpr<D>())
flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int TPR = f32_tpr<D>(), DT = D / TPR, KN = f32_keys<D>();
  __shared__ float sK[KN][D];
  __shared__ float sV[KN][D];
  __shared__ int sKeep[KN];
  const int bh = blockIdx.x / p.n_t, b = bh / p.H, h = bh % p.H;
  const int d0 = (threadIdx.x % TPR) * DT;  // this thread's columns
  const int row = (blockIdx.x % p.n_t) * BLOCK + threadIdx.x / TPR, S = p.S;
  const float* Q = head<float>(p.q, p.q_sb, p.q_sh, b, h);
  const float* K = head<float>(p.k, p.k_sb, p.k_sh, b, h);
  const float* V = head<float>(p.v, p.v_sb, p.v_sh, b, h);
  const float* dO = head<float>(p.dO, p.do_sb, p.do_sh, b, h);
  const int* M = p.mask + (long long)b * S;
  const uint32_t seed_bh = seed_for_head(p.seed, p.gbh, b, h);
  const bool in = row < S;

  float q[DT], g[DT], acc[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    q[d] = in ? Q[row * p.q_ss + d0 + d] : 0.f;
    g[d] = in ? dO[row * p.do_ss + d0 + d] : 0.f;
    acc[d] = 0.f;
  }
  const float lse = in ? p.lse[(long long)bh * S + row] : INFINITY;
  const float delta = in ? p.delta[(long long)bh * S + row] : 0.f;

  const int n_kt = (S + KN - 1) / KN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KN;
    __syncthreads();
    for (int c = threadIdx.x; c < KN * D; c += blockDim.x) {
      const int r = c / D, col = c % D;
      const bool ok = k0 + r < S;
      sK[r][col] = ok ? K[(k0 + r) * p.k_ss + col] : 0.f;
      sV[r][col] = ok ? V[(k0 + r) * p.v_ss + col] : 0.f;
    }
    for (int j = threadIdx.x; j < KN; j += blockDim.x)
      sKeep[j] = k0 + j < S && M[k0 + j] != 0;
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < KN; ++j) {
      if (!sKeep[j]) continue;  // the same j for every thread
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        s = fmaf(q[d], sK[j][d0 + d], s);
        dp = fmaf(g[d], sV[j][d0 + d], dp);
      }
      if (TPR > 1) {
        s = pair_sum(s);
        dp = pair_sum(dp);
      }
      const float pv = expf(s * p.scale - lse);
      if (p.thresh)
        dp = keep_bit(seed_bh, row, k0 + j, S, p.thresh) ? dp * p.inv_keep : 0.f;
      const float ds = pv * (dp - delta);
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] = fmaf(ds, sK[j][d0 + d], acc[d]);
    }
  }
  if (in) {
    float* dq = head_out<float>(p.dq, p.dq_sb, p.dq_sh, b, h);
#pragma unroll
    for (int d = 0; d < DT; ++d) dq[row * p.dq_ss + d0 + d] = acc[d] * p.scale;
  }
}

// One thread (pair) per key; its K row in registers, its V row in shared
// memory (padded rows, conflict-free), Q/dO tiles read as broadcasts.
// Block x = bh * n_t + key tile.
template <int D>
__global__ void __launch_bounds__(BLOCK * f32_tpr<D>())
flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int TPR = f32_tpr<D>(), DT = D / TPR, QT = f32_q_tile<D>();
  __shared__ float sQ[QT][D];
  __shared__ float sDO[QT][D];
  __shared__ float sVown[BLOCK][D + 1];
  __shared__ float sLse[QT], sDelta[QT];
  const int bh = blockIdx.x / p.n_t, b = bh / p.H, h = bh % p.H;
  const int own = threadIdx.x / TPR, d0 = (threadIdx.x % TPR) * DT;
  const int key = (blockIdx.x % p.n_t) * BLOCK + own, S = p.S;
  const float* Q = head<float>(p.q, p.q_sb, p.q_sh, b, h);
  const float* K = head<float>(p.k, p.k_sb, p.k_sh, b, h);
  const float* V = head<float>(p.v, p.v_sb, p.v_sh, b, h);
  const float* dO = head<float>(p.dO, p.do_sb, p.do_sh, b, h);
  const uint32_t seed_bh = seed_for_head(p.seed, p.gbh, b, h);
  const bool in = key < S;
  const bool kept = in && p.mask[(long long)b * S + key] != 0;

  float k[DT], dk[DT], dv[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    k[d] = in ? K[key * p.k_ss + d0 + d] : 0.f;
    sVown[own][d0 + d] = in ? V[key * p.v_ss + d0 + d] : 0.f;
    dk[d] = dv[d] = 0.f;
  }

  const int n_qt = (S + QT - 1) / QT;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * QT;
    __syncthreads();
    for (int c = threadIdx.x; c < QT * D; c += blockDim.x) {
      const int r = c / D, col = c % D;
      const bool ok = q0 + r < S;
      sQ[r][col] = ok ? Q[(q0 + r) * p.q_ss + col] : 0.f;
      sDO[r][col] = ok ? dO[(q0 + r) * p.do_ss + col] : 0.f;
    }
    for (int j = threadIdx.x; j < QT; j += blockDim.x) {
      const bool ok = q0 + j < S;
      sLse[j] = ok ? p.lse[(long long)bh * S + q0 + j] : INFINITY;
      sDelta[j] = ok ? p.delta[(long long)bh * S + q0 + j] : 0.f;
    }
    __syncthreads();
    if (!kept) continue;  // both threads of a key's pair
#pragma unroll 1
    for (int j = 0; j < QT; ++j) {
      if (q0 + j >= S) break;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        s = fmaf(sQ[j][d0 + d], k[d], s);
        dp = fmaf(sDO[j][d0 + d], sVown[own][d0 + d], dp);
      }
      if (TPR > 1) {
        s = pair_sum(s);
        dp = pair_sum(dp);
      }
      const float pv = expf(s * p.scale - sLse[j]);
      float pctx = pv;
      if (p.thresh) {
        const bool kb = keep_bit(seed_bh, q0 + j, key, S, p.thresh);
        pctx = kb ? pv * p.inv_keep : 0.f;
        dp = kb ? dp * p.inv_keep : 0.f;
      }
      const float ds = pv * (dp - sDelta[j]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        dv[d] = fmaf(pctx, sDO[j][d0 + d], dv[d]);
        dk[d] = fmaf(ds, sQ[j][d0 + d], dk[d]);
      }
    }
  }
  if (in) {
    float* DK = head_out<float>(p.dk, p.dk_sb, p.dk_sh, b, h);
    float* DV = head_out<float>(p.dv, p.dv_sb, p.dv_sh, b, h);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      DK[key * p.dk_ss + d0 + d] = dk[d] * p.scale;
      DV[key * p.dv_ss + d0 + d] = dv[d];
    }
  }
}

// ----- bf16: pre-pass -------------------------------------------------------------

struct PrepParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dO;
  const float* lse;   // (B*H, S)
  float* lse2;        // (B*H, S_pad): lse * log2(e), +inf past S
  float* delta;       // (B*H, S_pad): rowsum(dO * O), 0 past S
  float* acc;         // (B*H, groups * S_pad, D), zeroed
  int* turn;          // (B*H, groups, S_pad / 64), zeroed
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  int H, S, S_pad, groups;
};

// D / 8 consecutive threads per padded row, 16 bytes of O and dO each.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_prep_kernel(const PrepParams p) {
  constexpr int G = D / 8;
  const long long gid = blockIdx.x * 128ll + threadIdx.x;
  const long long row = gid / G;  // over B*H*S_pad; the grid covers it exactly
  const int c = static_cast<int>(gid % G);
  const int bh = static_cast<int>(row / p.S_pad);
  const int s = static_cast<int>(row % p.S_pad), b = bh / p.H, h = bh % p.H;
  float sum = 0.f;
  if (s < p.S) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        p.o + b * p.o_sb + h * p.o_sh + s * p.o_ss + c * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        p.dO + b * p.do_sb + h * p.do_sh + s * p.do_ss + c * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]), gf = __bfloat1622float2(g2[i]);
      sum = fmaf(gf.x, of.x, sum);
      sum = fmaf(gf.y, of.y, sum);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (c == 0) {
    p.delta[row] = sum;
    p.lse2[row] = s < p.S ? p.lse[(long long)bh * p.S + s] * LOG2E : INFINITY;
  }
  const int n_qt = p.S_pad / BLOCK;
  for (int grp = 0; grp < p.groups; ++grp) {
    const long long slice = (long long)bh * p.groups + grp;
    float4* a = reinterpret_cast<float4*>(
        p.acc + (slice * p.S_pad + s) * D + c * 8);
    a[0] = a[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c == 0 && s % BLOCK == 0) p.turn[slice * n_qt + s / BLOCK] = 0;
  }
}

// ----- bf16: main -----------------------------------------------------------------

struct MainParams {
  const int* mask;      // (B, S)
  const float* lse2;    // (B*H, S_pad)
  const float* delta;   // (B*H, S_pad)
  float* acc;           // (B*H, groups * S_pad, D): dq / scale, accumulated
  int* turn;            // (B*H, groups, n_qt): adds made to each q tile
  int n_items;          // B*H*n_qt: (batch*head, key tile), <= 2^30
  int H, S, S_pad, n_qt, groups, n_g;  // n_g: key tiles of a group (<= lanes)
  float scale, scale_log2;
  uint32_t seed, thresh;
  float inv_keep;
  BhIndex gbh;
};

// The dq accumulator holds rows of D f32 with their 16-byte chunks
// swizzled: chunk c of row r sits at chunk c ^ (r & dq_swizzle<D>()).
template <int D>
__host__ __device__ constexpr int dq_swizzle() { return (D / 4 < 8 ? D / 4 : 8) - 1; }

// A compile-time flag, for a generic lambda's instances.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Item j = bh * n_qt + kt of the main kernel: key tile kt of head bh.
struct MainItem {
  int bh, b, h, kt;
};
__device__ __forceinline__ MainItem main_item(const MainParams& p, int j) {
  MainItem it;
  it.bh = j / p.n_qt;
  it.kt = j - it.bh * p.n_qt;
  it.b = it.bh / p.H;
  it.h = it.bh - it.b * p.H;
  return it;
}

// A lane's shared memory. Q, K, V and dO tiles: tensor_map.cuh's swizzled
// 64-row tiles, each on a 1 KB boundary (the struct's alignment keeps the
// next lane's on one too). dS^T: the slab layout of sm90.cuh. Every barrier
// counts one arrival (and, where TMA fills the buffer, its bytes).
template <int D>
struct alignas(1024) MainLane {
  __nv_bfloat16 k[2][BLOCK * D];  // K and V of the lane's items, by item parity
  __nv_bfloat16 v[2][BLOCK * D];
  __nv_bfloat16 q[STAGES][BLOCK * D];
  __nv_bfloat16 dO[STAGES][BLOCK * D];
  __nv_bfloat16 ds[BLOCK * BLOCK];  // dS^T (key, q) at ((q/8)*64 + key)*8 + q%8
  float dqs[DQ_SLOTS][BLOCK * D];   // dQ partials: rows of D f32, chunks swizzled
  float lse2[STAGES][BLOCK];
  float delta[STAGES][BLOCK];
  uint64_t full[STAGES], empty[STAGES];            // the q-tile ring
  uint64_t keys[2];  // the items' key masks, by item parity: bit k for key k0 + k
  uint64_t kv_full[2], kv_empty[2];                // the K/V buffers
  uint64_t dq_full[DQ_SLOTS], dq_empty[DQ_SLOTS];  // the dQ slots
};

// dS^T in the slab layout, MN-major (q runs along a slab)
__device__ __forceinline__ uint64_t ds_desc(const __nv_bfloat16* t, int kk) {
  return wgmma_desc(t + kk * 16 * 8, 128, BLOCK * 16);
}

// The add that key tile kt makes at step i: into q tile `tile`, after
// `count` earlier adds to that tile from its group (n_g consecutive key
// tiles: [a, a + m), a = kt - kt % n_g), which the tile's turn counter must
// read first; once it is complete the counter takes `next` (0 after the
// tile's m-th add). Key tile kt' reaches the tile at step (tile - kt') mod
// n_qt, so the adds before kt's are those of kt+1, ..., kt+i (mod n_qt)
// that lie in the group. ops/attention.py::bwd_turn is the same function.
struct Turn {
  int tile, count, next;
};
__host__ __device__ __forceinline__ Turn bwd_turn(int kt, int i, int n_qt,
                                                  int a, int m) {
  const int l = kt - a;
  const int before_wrap = i < m - 1 - l ? i : m - 1 - l;
  const int after_wrap = i + 1 - (n_qt - l) > 0 ? i + 1 - (n_qt - l) : 0;
  Turn t;
  t.tile = kt + i < n_qt ? kt + i : kt + i - n_qt;
  t.count = before_wrap + after_wrap;
  t.next = t.count + 1 == m ? 0 : t.count + 1;
  return t;
}

// The first row of the q tile that key tile kt takes at step i.
__device__ __forceinline__ int step_row0(int kt, int i, int n_qt) {
  return (kt + i < n_qt ? kt + i : kt + i - n_qt) * BLOCK;
}

// The items of lane w, in its order: j = first + n * G, n < count.
struct LaneItems {
  int first, G, count;
};
template <int D>
__device__ __forceinline__ LaneItems lane_items(const MainParams& p, int w) {
  LaneItems l;
  l.G = main_lanes<D>() * gridDim.x;
  l.first = w * gridDim.x + blockIdx.x;
  l.count = l.first < p.n_items ? (p.n_items - 1 - l.first) / l.G + 1 : 0;
  return l;
}

// The producer of lane w (a warp; its lane 0 issues): every tile its
// consumer reads, by TMA. Per item, once the consumer is done with the item
// two back, the item's key mask (which keys the mask keeps and S holds, a
// bit each, gathered by the warp) and its K and V into the item's buffer;
// then per step its q tile's Q, dO, lse2 and delta into the ring, once the
// consumer is done with the stage's last tile. It waits only on its own
// consumer.
template <int D>
__device__ __forceinline__ void main_producer(const CUtensorMap* map_q,
                                              const CUtensorMap* map_k,
                                              const CUtensorMap* map_v,
                                              const CUtensorMap* map_do,
                                              const MainParams& p,
                                              MainLane<D>& sm, int w) {
  constexpr int TILE_BYTES = BLOCK * D * 2;
  constexpr uint32_t STAGE_TX = 2 * TILE_BYTES + 2 * BLOCK * 4;
  const int n_qt = p.n_qt, lane = threadIdx.x & 31;
  const LaneItems l = lane_items<D>(p, w);
  int c = 0;  // the lane's step
  for (int n = 0; n < l.count; ++n) {
    const MainItem it = main_item(p, l.first + n * l.G);
    uint64_t* kv = &sm.kv_full[n & 1];
    mbar_wait_or_trap(&sm.kv_empty[n & 1], ((n >> 1) & 1) ^ 1);
    const int key = it.kt * BLOCK + lane;
    const int* mask = p.mask + (long long)it.b * p.S;
    const unsigned lo = __ballot_sync(~0u, key < p.S && mask[key] != 0);
    const unsigned hi = __ballot_sync(~0u, key + 32 < p.S && mask[key + 32] != 0);
    if (lane != 0) continue;
    sm.keys[n & 1] = static_cast<uint64_t>(hi) << 32 | lo;
    mbar_expect_tx(kv, 2 * TILE_BYTES);  // (also releases the key mask)
    load_tile<D>(map_k, sm.k[n & 1], it.kt * BLOCK, it.h, it.b, kv);
    load_tile<D>(map_v, sm.v[n & 1], it.kt * BLOCK, it.h, it.b, kv);
    for (int i = 0; i < n_qt; ++i, ++c) {
      const int st = c % STAGES, row0 = step_row0(it.kt, i, n_qt);
      const long long rows = (long long)it.bh * p.S_pad + row0;
      mbar_wait_or_trap(&sm.empty[st], ((c / STAGES) & 1) ^ 1);
      mbar_expect_tx(&sm.full[st], STAGE_TX);
      load_tile<D>(map_q, sm.q[st], row0, it.h, it.b, &sm.full[st]);
      load_tile<D>(map_do, sm.dO[st], row0, it.h, it.b, &sm.full[st]);
      bulk_load(sm.lse2[st], p.lse2 + rows, BLOCK * 4, &sm.full[st]);
      bulk_load(sm.delta[st], p.delta + rows, BLOCK * 4, &sm.full[st]);
    }
  }
}

// The dq writer of lane w (one thread): each dQ partial its consumer
// leaves in a slot, in the consumer's order of steps, added into the
// partial's slice of the accumulator in the turn of its q tile, as one
// bulk reduce-add. The slot goes back once the add has read it; the turn
// passes on once the add is complete. Only this thread waits for turns.
template <int D>
__device__ __forceinline__ void main_writer(const MainParams& p,
                                            MainLane<D>& sm, int w) {
  const int n_qt = p.n_qt;
  const LaneItems l = lane_items<D>(p, w);
  int c = 0;  // the lane's step
  for (int n = 0; n < l.count; ++n) {
    const MainItem it = main_item(p, l.first + n * l.G);
    const int grp = it.kt / p.n_g, a = grp * p.n_g, m = min(p.n_g, n_qt - a);
    const long long slice = (long long)it.bh * p.groups + grp;
    int* turn = p.turn + slice * n_qt;
    float* acc = p.acc + slice * p.S_pad * D;
    for (int i = 0; i < n_qt; ++i, ++c) {
      const int slot = c % DQ_SLOTS;
      const Turn t = bwd_turn(it.kt, i, n_qt, a, m);
      mbar_wait_or_trap(&sm.dq_full[slot], (c / DQ_SLOTS) & 1);
      wait_flag(turn + t.tile, t.count);
      fence_proxy_async_global();
      bulk_reduce_add_f32(acc + t.tile * BLOCK * D, sm.dqs[slot], BLOCK * D * 4);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(&sm.dq_empty[slot]);
      bulk_wait_all();
      fence_proxy_async_global();
      set_flag(turn + t.tile, t.next);
    }
  }
}

// The consumer warpgroup of lane w: the products and the per-element work
// of each item the lane takes, step by step. It waits only on its own
// lane's barriers: a ring stage filled, a K/V buffer filled, a dQ slot
// given back.
template <int D>
__device__ __forceinline__ void main_consumer(const CUtensorMap* map_dk,
                                              const CUtensorMap* map_dv,
                                              const MainParams& p,
                                              MainLane<D>& sm, int w) {
  constexpr int DH = D / 2;  // accumulator floats a thread of a 64 x D product
  constexpr int SUB = sub_cols<D>(), NS = D / SUB;  // N of a product; products
  constexpr int SWZ = dq_swizzle<D>();
  constexpr int NQ = BLOCK / HALVES;  // q columns of S^T and dP^T a pass
  static_assert(NQ == MAIN_NQ, "keep_bits_dump.cu replays map (b) at MAIN_NQ");
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = p.n_qt, S = p.S;
  const int bar = 1 + w;  // the warpgroup's named barrier
  const LaneItems l = lane_items<D>(p, w);
  int c = 0;  // the lane's steps so far: stage c % STAGES, slot c % DQ_SLOTS
  for (int n = 0; n < l.count; ++n) {
    const MainItem it = main_item(p, l.first + n * l.G);
    const __nv_bfloat16* sk = sm.k[n & 1];
    const __nv_bfloat16* sv = sm.v[n & 1];
    // this thread's two accumulator rows are keys k0 + 16 warp + g (+ 8)
    const int key0 = bwd_st_key0(it.kt * BLOCK, warp, g);
    bool kept[2];  // (from the key mask, once the item's K and V are in)
    const uint32_t seed_bh = seed_for_head(p.seed, p.gbh, it.b, it.h);

    // S^T = K Q^T and dP^T = V dO^T (rows = keys, columns = q rows) of pass
    // hf over stage st: NQ q columns from hf * NQ
    auto products = [&](float(&s)[NQ / 2], float(&dp)[NQ / 2], int st, int hf) {
      const int n0 = hf * NQ;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        Wgmma<NQ>::template ss<0, 0>(s, kmajor_at<D>(sk, 0, ks),
                                     kmajor_at<D>(sm.q[st], n0, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        Wgmma<NQ>::template ss<0, 0>(dp, kmajor_at<D>(sv, 0, ks),
                                     kmajor_at<D>(sm.dO[st], n0, ks), ks > 0);
    };
    // p, the dropped p (into s) and dS (into dp) of pass hf: one exp2 and,
    // with dropout, one keep bit an element (m = 1 / keep where kept, else
    // 0: the dropped p is p m and dS is p (dp m - delta)); then both as A
    // operands of 16 q a step. One instance with dropout and one without,
    // each free of branches, so that the elements' work interleaves.
    uint32_t pa[4][4], da[4][4];  // P~^T and dS^T
    auto soften_as = [&](auto drop, float(&s)[NQ / 2], float(&dp)[NQ / 2],
                         int st, int q0, int hf) {
#pragma unroll
      for (int jj = 0; jj < NQ / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = bwd_st_col<NQ>(t, hf, jj, e), i = e >> 1;
          const float pv = kept[i] ? fast_exp2(fmaf(s[4 * jj + e], p.scale_log2,
                                                    -sm.lse2[st][col]))
                                   : 0.f;
          float m = 1.f;
          if constexpr (decltype(drop)::value) {
            const FragPos f = bwd_st_frag(key0, q0, col, e);
            m = keep_bit(seed_bh, f.q, f.key, S, p.thresh) ? p.inv_keep : 0.f;
          }
          s[4 * jj + e] = pv * m;
          dp[4 * jj + e] = pv * fmaf(dp[4 * jj + e], m, -sm.delta[st][col]);
        }
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
        pack_a(pa[hf * NQ / 16 + kk], s + 8 * kk);
        pack_a(da[hf * NQ / 16 + kk], dp + 8 * kk);
      }
    };
    auto soften = [&](float(&s)[NQ / 2], float(&dp)[NQ / 2], int st, int q0,
                      int hf) {
      if (p.thresh) soften_as(Flag<true>(), s, dp, st, q0, hf);
      else soften_as(Flag<false>(), s, dp, st, q0, hf);
    };
    // dS^T to shared memory, MN-major for dQ = dS K (q runs along a slab),
    // for the whole warpgroup's products
    auto store_ds = [&]() {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(
              &sm.ds[(jj * BLOCK + warp * 16 + g + 8 * i) * 8 + 2 * t]) =
              da[jj / 2][(jj & 1) * 2 + i];
      fence_proxy_async();
      named_bar_sync(bar, 128);
    };
    // columns cc * SUB.. of the dQ partial into a slot (row-major, 16-byte
    // chunk x of row r stored at chunk x ^ (r & SWZ), so these stores are
    // free of bank conflicts)
    auto store_dq = [&](const float(&dq)[SUB / 2], int slot, int cc) {
#pragma unroll
      for (int jj = 0; jj < SUB / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp * 16 + g + 8 * i, col = cc * SUB + 8 * jj + 2 * t;
          *reinterpret_cast<float2*>(
              &sm.dqs[slot][r * D + (((col >> 2) ^ (r & SWZ)) << 2) + (col & 3)]) =
              make_float2(dq[4 * jj + 2 * i], dq[4 * jj + 2 * i + 1]);
        }
    };
    // the step's products are complete (its stage and dS are free) and its
    // partial is in the slot: hand both on
    auto end_step = [&](int st, int slot) {
      fence_proxy_async();
      named_bar_sync(bar, 128);
      if (tid == 0) {
        mbar_arrive(&sm.dq_full[slot]);
        mbar_arrive(&sm.empty[st]);
      }
    };

    float dk[DH], dv[DH];
#pragma unroll
    for (int i = 0; i < DH; ++i) dk[i] = dv[i] = 0.f;
    if (tid == 0 && n > 0) {  // the last item's dK and dV have left its buffers
      bulk_wait_read();
      mbar_arrive(&sm.kv_empty[(n - 1) & 1]);
    }
    mbar_wait_or_trap(&sm.kv_full[n & 1], (n >> 1) & 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      kept[i] = (sm.keys[n & 1] >> (key0 - it.kt * BLOCK + 8 * i)) & 1;

    if constexpr (NS == 1) {
      // D <= 64: both passes' products in flight at once, so pass 0's exp
      // and keep bits run while pass 1's products do; then dQ_partial = dS
      // K in a product group of its own, stored into the slot while dV +=
      // P~^T dO and dK += dS^T Q run. (Groups complete in order: a wait for
      // all but the newest n is a wait for every older one.)
      for (int step = 0; step < n_qt; ++step, ++c) {
        const int st = c % STAGES, slot = c % DQ_SLOTS;
        const int q0 = step_row0(it.kt, step, n_qt);
        mbar_wait_or_trap(&sm.full[st], (c / STAGES) & 1);
        float s0[NQ / 2], dp0[NQ / 2], s1[NQ / 2], dp1[NQ / 2];
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) s0[i] = dp0[i] = s1[i] = dp1[i] = 0.f;
        wgmma_fence();
        products(s0, dp0, st, 0);
        wgmma_commit();
        products(s1, dp1, st, 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s0);
        fence_regs(dp0);
        soften(s0, dp0, st, q0, 0);
        wgmma_wait<0>();
        fence_regs(s1);
        fence_regs(dp1);
        soften(s1, dp1, st, q0, 1);
        store_ds();
        float dq[SUB / 2];
#pragma unroll
        for (int i = 0; i < SUB / 2; ++i) dq[i] = 0.f;
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<SUB>::template ss<1, 1>(dq, ds_desc(sm.ds, kk),
                                        mnmajor_at<D>(sk, kk, 0), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<SUB>::template rs<1>(dv, pa[kk], mnmajor_at<D>(sm.dO[st], kk, 0), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<SUB>::template rs<1>(dk, da[kk], mnmajor_at<D>(sm.q[st], kk, 0), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dq);
        mbar_wait_or_trap(&sm.dq_empty[slot], ((c / DQ_SLOTS) & 1) ^ 1);
        store_dq(dq, slot, 0);
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        end_step(st, slot);
      }
    } else {
      // D = 128: dK and dV hold 128 registers a thread, so one product
      // group at a time: the passes one after the other, dV and dK
      // complete before dQ_partial starts, and dQ_partial in halves of SUB
      // columns, each stored as it completes
      for (int step = 0; step < n_qt; ++step, ++c) {
        const int st = c % STAGES, slot = c % DQ_SLOTS;
        const int q0 = step_row0(it.kt, step, n_qt);
        mbar_wait_or_trap(&sm.full[st], (c / STAGES) & 1);
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf) {
          float s[NQ / 2], dp[NQ / 2];
#pragma unroll
          for (int i = 0; i < NQ / 2; ++i) s[i] = dp[i] = 0.f;
          wgmma_fence();
          products(s, dp, st, hf);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(s);
          fence_regs(dp);
          soften(s, dp, st, q0, hf);
        }
        store_ds();
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int cc = 0; cc < NS; ++cc) {
          float(&dvc)[SUB / 2] = *reinterpret_cast<float(*)[SUB / 2]>(dv + cc * SUB / 2);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<SUB>::template rs<1>(dvc, pa[kk], mnmajor_at<D>(sm.dO[st], kk, cc), 1);
        }
#pragma unroll
        for (int cc = 0; cc < NS; ++cc) {
          float(&dkc)[SUB / 2] = *reinterpret_cast<float(*)[SUB / 2]>(dk + cc * SUB / 2);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<SUB>::template rs<1>(dkc, da[kk], mnmajor_at<D>(sm.q[st], kk, cc), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
        mbar_wait_or_trap(&sm.dq_empty[slot], ((c / DQ_SLOTS) & 1) ^ 1);
#pragma unroll
        for (int cc = 0; cc < NS; ++cc) {
          float dq[SUB / 2];
#pragma unroll
          for (int i = 0; i < SUB / 2; ++i) dq[i] = 0.f;
          fence_regs(dq);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<SUB>::template ss<1, 1>(dq, ds_desc(sm.ds, kk),
                                          mnmajor_at<D>(sk, kk, cc), kk > 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(dq);
          store_dq(dq, slot, cc);
        }
        end_step(st, slot);
      }
    }
    // dK (scaled) and dV as bf16 tiles into the item's K and V buffers,
    // whose last readers are complete (the last step's barrier), laid out
    // as TMA stores them; one thread stores both (rows past S are not
    // written) and gives the buffers back once the stores have read them,
    // at the next item's start, so that the stores run on meanwhile
    unsigned char* tk = reinterpret_cast<unsigned char*>(sm.k[n & 1]);
    unsigned char* tv = reinterpret_cast<unsigned char*>(sm.v[n & 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const uint32_t off = tile_offset<D>(r, 16 * jj + 4 * t);
        *reinterpret_cast<uint32_t*>(tk + off) =
            pack_bf16(dk[4 * jj + 2 * i] * p.scale, dk[4 * jj + 2 * i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(tv + off) =
            pack_bf16(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
      }
    }
    fence_proxy_async();
    named_bar_sync(bar, 128);
    if (tid == 0) {
      store_tile<D>(map_dk, sm.k[n & 1], it.kt * BLOCK, it.h, it.b);
      store_tile<D>(map_dv, sm.v[n & 1], it.kt * BLOCK, it.h, it.b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();  // the last item's stores are complete
}

// One block a card's SM: main_lanes<D>() = L consumer warpgroups, then a
// warpgroup whose warp w < L is lane w's producer and warp L + w its
// writer (thread 0 of a writer works; the rest, and the warps past 2 L,
// end at once). At D <= 64 that warpgroup gives its registers to the consumers
// (setmaxnreg).
template <int D>
__global__ void __launch_bounds__(128 * (main_lanes<D>() + 1), 1)
flash_bwd_main_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_dk,
                      const __grid_constant__ CUtensorMap map_dv,
                      const MainParams p) {
  constexpr int L = main_lanes<D>();
  // the buffer is aligned here, in the 1 KB it is given beyond the lanes,
  // by an offset from the shared array itself, so that the compiler knows
  // every access through `lanes` for a shared-memory one (LDS/STS, not
  // generic loads and stores with 64-bit addresses)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MainLane<D>* lanes = reinterpret_cast<MainLane<D>*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  if (threadIdx.x == 0) {
    for (int l = 0; l < L; ++l) {
      MainLane<D>& sm = lanes[l];
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&sm.full[s], 1);
        mbar_init(&sm.empty[s], 1);
      }
      for (int s = 0; s < 2; ++s) {
        mbar_init(&sm.kv_full[s], 1);
        mbar_init(&sm.kv_empty[s], 1);
      }
      for (int s = 0; s < DQ_SLOTS; ++s) {
        mbar_init(&sm.dq_full[s], 1);
        mbar_init(&sm.dq_empty[s], 1);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == L) {
    if constexpr (L > 1) setmaxnreg_dec<MOVER_REGS>();
    const int warp = (threadIdx.x / 32) & 3;
    if (warp < L)
      main_producer<D>(&map_q, &map_k, &map_v, &map_do, p, lanes[warp], warp);
    else if (warp < 2 * L && (threadIdx.x & 31) == 0)
      main_writer<D>(p, lanes[warp - L], warp - L);
  } else {
    if constexpr (L > 1) setmaxnreg_inc<CONSUMER_REGS>();
    main_consumer<D>(&map_dk, &map_dv, p, lanes[wg], wg);
  }
}

// ----- bf16: post-pass ------------------------------------------------------------

struct PostParams {
  const float* acc;      // (B*H, groups * S_pad, D)
  __nv_bfloat16* dq;
  long long dq_sb, dq_sh, dq_ss;
  int H, S, S_pad, groups;
  float scale;
};

// One thread per 8 elements of dq.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_post_kernel(const PostParams p, long long total) {
  constexpr int G = D / 8;
  const long long gid = blockIdx.x * 256ll + threadIdx.x;
  if (gid >= total) return;
  const long long row = gid / G;  // over B*H*S
  const int c = static_cast<int>(gid % G);
  const int bh = static_cast<int>(row / p.S), s = static_cast<int>(row % p.S);
  const int b = bh / p.H, h = bh % p.H;
  const int sw = s & dq_swizzle<D>();
  const int c0 = ((2 * c) ^ sw) << 2, c1 = ((2 * c + 1) ^ sw) << 2;
  const float* a = p.acc + ((long long)bh * p.groups * p.S_pad + s) * D;
  float4 x = *reinterpret_cast<const float4*>(a + c0);
  float4 y = *reinterpret_cast<const float4*>(a + c1);
  for (int grp = 1; grp < p.groups; ++grp) {  // the slices, in order
    const float* ag = a + (long long)grp * p.S_pad * D;
    const float4 xg = *reinterpret_cast<const float4*>(ag + c0);
    const float4 yg = *reinterpret_cast<const float4*>(ag + c1);
    x = make_float4(x.x + xg.x, x.y + xg.y, x.z + xg.z, x.w + xg.w);
    y = make_float4(y.x + yg.x, y.y + yg.y, y.z + yg.z, y.w + yg.w);
  }
  uint4 out;
  out.x = pack_bf16(x.x * p.scale, x.y * p.scale);
  out.y = pack_bf16(x.z * p.scale, x.w * p.scale);
  out.z = pack_bf16(y.x * p.scale, y.y * p.scale);
  out.w = pack_bf16(y.z * p.scale, y.w * p.scale);
  *reinterpret_cast<uint4*>(p.dq + b * p.dq_sb + h * p.dq_sh + s * p.dq_ss + c * 8) = out;
}

// ----- host ------------------------------------------------------------------------

constexpr long long MAX_BLOCKS = 0x7FFFFFFF;  // the grid's x

template <int D>
int launch_f32(bool dkv, const Params& p, int bh, cudaStream_t st) {
  const long long blocks = (long long)bh * p.n_t;
  if (blocks > MAX_BLOCKS) return -1;
  const int threads = BLOCK * f32_tpr<D>();
  if (dkv) flash_bwd_dkv_f32_kernel<D><<<(unsigned)blocks, threads, 0, st>>>(p);
  else flash_bwd_dq_f32_kernel<D><<<(unsigned)blocks, threads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int run_f32(bool dkv, int head_dim, Params& p, int batch, int heads,
            int seq_len, float scale, uint32_t seed, uint32_t thresh,
            float inv_keep, const uint32_t* gbh, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (long long)batch * heads > MAX_BLOCKS)
    return -1;
  p.H = heads; p.S = seq_len; p.n_t = (seq_len + BLOCK - 1) / BLOCK;
  p.scale = scale; p.seed = seed; p.thresh = thresh; p.inv_keep = inv_keep;
  p.gbh = bh_index(gbh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (head_dim) {
    case 16: return launch_f32<16>(dkv, p, bh, st);
    case 32: return launch_f32<32>(dkv, p, bh, st);
    case 64: return launch_f32<64>(dkv, p, bh, st);
    case 128: return launch_f32<128>(dkv, p, bh, st);
    default: return -1;
  }
}

void set_strides(long long& sb, long long& sh, long long& ss,
                 const long long* s) {
  sb = s[0]; sh = s[1]; ss = s[2];
}

bool bf16_shape_ok(int head_dim, int batch, int heads, int seq_len,
                   int s_pad, int groups) {
  return (head_dim == 16 || head_dim == 32 || head_dim == 64 ||
          head_dim == 128) && batch > 0 && heads > 0 && seq_len > 0 &&
         (long long)batch * heads <= MAX_BLOCKS && s_pad % BLOCK == 0 &&
         s_pad >= seq_len && s_pad < seq_len + BLOCK && groups >= 1 &&
         groups <= s_pad / BLOCK;
}

template <int D>
int launch_prep(const PrepParams& p, int bh, cudaStream_t st) {
  const long long threads = (long long)bh * p.S_pad * (D / 8);  // a multiple of 128
  if (threads / 128 > MAX_BLOCKS) return -1;
  flash_bwd_prep_kernel<D><<<(unsigned)(threads / 128), 128, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
constexpr int main_smem() {
  return static_cast<int>(main_lanes<D>() * sizeof(MainLane<D>)) + 1024;
}
template <int D>
constexpr int main_threads() { return 128 * (main_lanes<D>() + 1); }

// The blocks of the main kernel at head dim D that the current card holds
// at once (blocks an SM x SMs: one an SM), which a cooperative launch may
// not exceed; found once per card and width. Returns a CUDA error code, or
// -4 when the card cannot launch cooperatively.
template <int D>
int main_blocks(int* blocks) {
  constexpr int DEVICES = 64;
  static std::mutex mu;
  static int known[DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  if (known[dev] == 0) {
    err = allow_smem<flash_bwd_main_kernel<D>>(main_smem<D>());
    int per_sm = 0, sms = 0, coop = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_bwd_main_kernel<D>, main_threads<D>(), main_smem<D>());
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop || per_sm * sms <= 0) return -4;
    known[dev] = per_sm * sms;
  }
  *blocks = known[dev];
  return 0;
}

template <int D>
int launch_main(const CUtensorMap (&maps)[6], const MainParams& p,
                cudaStream_t st) {
  constexpr int L = main_lanes<D>();
  int blocks = 0;
  const int rc = main_blocks<D>(&blocks);
  if (rc != 0) return rc;
  if (p.n_g > L * blocks) return -3;  // too few groups for this card
  // enough blocks for a lane an item, up to what the card holds
  const int want = (p.n_items + L - 1) / L;
  const int grid = want < blocks ? want : blocks;
  void* args[] = {const_cast<CUtensorMap*>(&maps[0]),
                  const_cast<CUtensorMap*>(&maps[1]),
                  const_cast<CUtensorMap*>(&maps[2]),
                  const_cast<CUtensorMap*>(&maps[3]),
                  const_cast<CUtensorMap*>(&maps[4]),
                  const_cast<CUtensorMap*>(&maps[5]),
                  const_cast<MainParams*>(&p)};
  // every block resident at once, or an error: never a partial grid
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(flash_bwd_main_kernel<D>),
      dim3(static_cast<unsigned>(grid)), dim3(main_threads<D>()), args,
      main_smem<D>(), st));
}

template <int D>
int launch_post(const PostParams& p, int bh, cudaStream_t st) {
  const long long total = (long long)bh * p.S * (D / 8);
  if ((total + 255) / 256 > MAX_BLOCKS) return -1;
  flash_bwd_post_kernel<D><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 dq kernel. strides: (batch, head, row) element strides of q, k,
// v, dO and dq in that order; head dims contiguous. lse and delta: (B*H, S) f32. seed, thresh, inv_keep: the
// forward's dropout (thresh = 0: none). Returns 0, a CUDA error code from
// the launch, or -1 for arguments the kernel does not take.
extern "C" int flash_bwd_dq(int head_dim, const void* q, const void* k,
                            const void* v, const void* dO, const int* mask,
                            const float* lse, const float* delta, void* dq,
                            int batch, int heads, int seq_len,
                            const long long* strides, float scale,
                            uint32_t seed, uint32_t thresh, float inv_keep,
                            const uint32_t* gbh, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dO = dO; p.mask = mask; p.lse = lse;
  p.delta = delta; p.dq = dq;
  set_strides(p.q_sb, p.q_sh, p.q_ss, strides);
  set_strides(p.k_sb, p.k_sh, p.k_ss, strides + 3);
  set_strides(p.v_sb, p.v_sh, p.v_ss, strides + 6);
  set_strides(p.do_sb, p.do_sh, p.do_ss, strides + 9);
  set_strides(p.dq_sb, p.dq_sh, p.dq_ss, strides + 12);
  return run_f32(false, head_dim, p, batch, heads, seq_len, scale, seed,
                 thresh, inv_keep, gbh, stream);
}

// The f32 dk/dv kernels: as flash_bwd_dq, with the strides of q, k, v, dO,
// dk and dv.
extern "C" int flash_bwd_dkv(int head_dim, const void* q, const void* k,
                             const void* v, const void* dO, const int* mask,
                             const float* lse, const float* delta, void* dk,
                             void* dv, int batch, int heads, int seq_len,
                             const long long* strides, float scale,
                             uint32_t seed, uint32_t thresh, float inv_keep,
                             const uint32_t* gbh, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dO = dO; p.mask = mask; p.lse = lse;
  p.delta = delta; p.dk = dk; p.dv = dv;
  set_strides(p.q_sb, p.q_sh, p.q_ss, strides);
  set_strides(p.k_sb, p.k_sh, p.k_ss, strides + 3);
  set_strides(p.v_sb, p.v_sh, p.v_ss, strides + 6);
  set_strides(p.do_sb, p.do_sh, p.do_ss, strides + 9);
  set_strides(p.dk_sb, p.dk_sh, p.dk_ss, strides + 12);
  set_strides(p.dv_sb, p.dv_sh, p.dv_ss, strides + 15);
  return run_f32(true, head_dim, p, batch, heads, seq_len, scale, seed,
                 thresh, inv_keep, gbh, stream);
}

// The lanes of the bf16 main kernel at `head_dim` that the current card
// holds at once (its cooperative grid's blocks x main_lanes): a caller
// takes groups = ceil(n_qt / lanes) accumulator slices. Returns lanes > 0,
// or <= 0: -1 for a head dim the kernel does not take, -4 when the card
// cannot launch cooperatively, else minus a CUDA error code.
extern "C" int flash_bwd_main_lanes(int head_dim) {
  int blocks = 0, rc = -1, lanes = 0;
  switch (head_dim) {
    case 16: rc = main_blocks<16>(&blocks); lanes = main_lanes<16>(); break;
    case 32: rc = main_blocks<32>(&blocks); lanes = main_lanes<32>(); break;
    case 64: rc = main_blocks<64>(&blocks); lanes = main_lanes<64>(); break;
    case 128: rc = main_blocks<128>(&blocks); lanes = main_lanes<128>(); break;
  }
  return rc == 0 ? blocks * lanes : (rc > 0 ? -rc : rc);
}

// bf16 pre-pass. o, dO: bf16 with (batch, head, row) element strides
// `strides` (o's three, then dO's). lse: (B*H, S) f32. Writes delta and
// lse2 ((B*H, s_pad) f32) and zeroes acc ((B*H, groups * s_pad, D) f32) and
// `turns`, the main kernel's B*H*groups*(s_pad / 64) int32 turn counters;
// s_pad is S rounded up to a multiple of 64.
extern "C" int flash_bwd_prep(int head_dim, const void* o, const void* dO,
                              const float* lse, float* delta, float* lse2,
                              float* acc, int* turns, int batch, int heads,
                              int seq_len, int s_pad, int groups,
                              const long long* strides, void* stream) {
  if (!bf16_shape_ok(head_dim, batch, heads, seq_len, s_pad, groups)) return -1;
  PrepParams p = {};
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dO = static_cast<const __nv_bfloat16*>(dO);
  p.lse = lse; p.lse2 = lse2; p.delta = delta; p.acc = acc; p.turn = turns;
  set_strides(p.o_sb, p.o_sh, p.o_ss, strides);
  set_strides(p.do_sb, p.do_sh, p.do_ss, strides + 3);
  p.H = heads; p.S = seq_len; p.S_pad = s_pad; p.groups = groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (head_dim) {
    case 16: return launch_prep<16>(p, bh, st);
    case 32: return launch_prep<32>(p, bh, st);
    case 64: return launch_prep<64>(p, bh, st);
    default: return launch_prep<128>(p, bh, st);
  }
}

// bf16 main kernel: dk and dv, and dq / scale added into acc. strides: the
// (batch, head, row) element strides of q, k, v, dO, dk and dv; all six
// 16-byte aligned with row, head and batch strides that are multiples of 8
// elements (what the tensor maps take). lse2, delta, acc (its `groups`
// slices) and the turn counters: from flash_bwd_prep; the counters are 0
// again when it ends. Returns 0, a CUDA error code (a refused cooperative
// launch among them), -1 for arguments it does not take, -2 when a tensor
// map cannot be made, -3 when `groups` leaves more key tiles to a group
// than the card holds lanes, -4 when the card cannot launch cooperatively.
extern "C" int flash_bwd_main(int head_dim, const void* q, const void* k,
                              const void* v, const void* dO, const int* mask,
                              const float* lse2, const float* delta, float* acc,
                              int* turns, void* dk, void* dv, int batch,
                              int heads, int seq_len, int s_pad, int groups,
                              const long long* strides, float scale,
                              uint32_t seed, uint32_t thresh, float inv_keep,
                              const uint32_t* gbh, void* stream) {
  if (!bf16_shape_ok(head_dim, batch, heads, seq_len, s_pad, groups)) return -1;
  CUtensorMap maps[6];
  const void* srcs[6] = {q, k, v, dO, dk, dv};
  for (int i = 0; i < 6; ++i)
    if (!head_map(&maps[i], srcs[i], batch, heads, seq_len, head_dim,
                  strides + 3 * i))
      return -2;
  MainParams p = {};
  p.mask = mask; p.lse2 = lse2; p.delta = delta; p.acc = acc; p.turn = turns;
  p.H = heads; p.S = seq_len; p.S_pad = s_pad; p.n_qt = s_pad / BLOCK;
  p.groups = groups;
  p.n_g = (p.n_qt + groups - 1) / groups;
  // items, and an item index plus the lanes, stay within an int
  const long long items = (long long)batch * heads * p.n_qt;
  if (items > (1ll << 30)) return -1;
  p.n_items = static_cast<int>(items);
  p.scale = scale; p.scale_log2 = scale * LOG2E;
  p.seed = seed; p.thresh = thresh; p.inv_keep = inv_keep;
  p.gbh = bh_index(gbh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_main<16>(maps, p, st);
    case 32: return launch_main<32>(maps, p, st);
    case 64: return launch_main<64>(maps, p, st);
    default: return launch_main<128>(maps, p, st);
  }
}

// bf16 post-pass: dq = scale * (the sum of acc's `groups` slices) in bf16,
// with dq's (batch, head, row) element strides.
extern "C" int flash_bwd_post(int head_dim, const float* acc, void* dq,
                              int batch, int heads, int seq_len, int s_pad,
                              int groups, const long long* strides,
                              float scale, void* stream) {
  if (!bf16_shape_ok(head_dim, batch, heads, seq_len, s_pad, groups)) return -1;
  PostParams p = {};
  p.acc = acc;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  set_strides(p.dq_sb, p.dq_sh, p.dq_ss, strides);
  p.H = heads; p.S = seq_len; p.S_pad = s_pad; p.groups = groups;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (head_dim) {
    case 16: return launch_post<16>(p, bh, st);
    case 32: return launch_post<32>(p, bh, st);
    case 64: return launch_post<64>(p, bh, st);
    default: return launch_post<128>(p, bh, st);
  }
}
