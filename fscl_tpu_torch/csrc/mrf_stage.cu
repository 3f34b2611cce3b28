// One HiFiGAN multi-receptive-field (MRF) stage for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the TPU kernel fscl_tpu/ops/hifigan_fused.py:_stage_kernel
// (launched by _stage_call through fused_mrf_stage). On x (B, C, T) the stage
// runs, for each resblock j with kernel k_j and dilations d:
//     x_j <- x_j + conv_{k,1}(leaky(conv_{k,d}(leaky(x_j))))    for each d
// and returns the mean of the x_j over the resblocks. With a `post` conv it
// then applies leaky -> conv_post (k = 7, C -> 1) -> tanh and returns only
// the wav (B, T). Every conv is SAME with zero padding at the true sequence
// edges: rows outside [0, T) read as zero, exactly as the TPU kernel zeroes
// them after every conv. Leaky ReLU has slope 0.1. Element-wise math and
// every sum are f32; with bf16 compute the conv operands (the activations
// after leaky, and the weights) are rounded to bf16 and their products
// accumulated in f32, as the TPU kernel does with preferred_element_type.
//
// What bounds it on the card: one stage is 2 * B * T * taps * C^2 operations
// (taps = sum over resblocks of 2 * k * |d|, 126 for HiFiGAN V1) against
// 2 * B * T * C values moved, so a few hundred to a thousand operations per
// byte: it is bound by operations, by route:
// - bf16: bf16 x bf16 -> f32 products on the tensor cores (989 TFLOP/s).
// - f32, by split TF32 ("3xTF32"): one TF32 product keeps 11 significant
//   bits, and one TF32 pass misses the stage's f32 bar (mean |d| 1e-5 against
//   the plain version) by 6-9x. Each f32 operand x is split into big =
//   tf32(x) and small = tf32(x - big), rounded to nearest with ties away from
//   zero by two integer operations (the rounding of cvt.rna.tf32.f32, which
//   issues more slowly), and each product is taken as small*big + big*small +
//   big*big on the TF32 tensor cores, accumulated in f32. Three TF32 products
//   per f32 product bound it at 3 * ops over 495 TFLOP/s, 2.5x below the f32
//   FMA units (67 TFLOP/s).
// The kernel is not bit-identical to the plain version (cuDNN sums in
// another order, and the tensor cores' f32 accumulation rounds differently):
// f32 mean |d| is 2e-7 to 3.5e-6 at the V1 stages.
//
// What the design does:
// - The stage is a chain of launches of one fused conv kernel (18 for V1),
//   plus a small conv_post + tanh kernel: the TPU kernel keeps the whole
//   haloed window and the stage's intermediates in VMEM, several 200 KB
//   buffers at C = 256, more than a block's 227 KB of shared memory. Bias,
//   residual and the running mean of the resblocks are added in the
//   epilogue, scaled by 1 / n_resblocks on the last conv.
// - Each conv is an implicit GEMM on mma.sync (m16n8k8 TF32, m16n8k16 bf16):
//   M = output channels, N = time rows, K = taps x input channels. The
//   weights are the A operand and the activations the B operand, so a lane's
//   accumulator pair is two consecutive time rows. A tile is 64 output
//   channels x 512 rows (32 x 512 where C is not a multiple of 64), 8 warps
//   of 32 x 128 (32 x 64) each, 128 (64) f32 accumulators a thread. One
//   block per SM walks the tiles, channel block fastest, so that the blocks
//   running at once read the same input window from L2.
// - Input channels stream through a ring of shared-memory stages, as many
//   as fit (3 at k = 11, up to 5 at k = 3), one mma k-step (8 channels f32,
//   16 bf16) each. The ring runs on across a block's tiles, so it never
//   drains between them. A stage holds the chunk's haloed window once (the
//   tile's rows plus the reach rounded up to 4 on each side) and its weights
//   for every tap: tap i reads the window at a row offset of i * dilation,
//   so the conv is a GEMM without an unfold in memory.
// - Copies go through Hopper's bulk copy engine (cp.async.bulk, completing on
//   one mbarrier per stage): one copy per window row (the tensor's own
//   layout, time contiguous) and per m16 tile of weights, issued by one
//   warp: with per-thread 16-byte cp.async instead, the copies, not the
//   products, bound the kernel (PERF.md). Rows outside
//   [0, T) are zero-filled by plain stores; T not a multiple of 4 (or an
//   unaligned tensor) takes 4-byte cp.async for the window instead.
// - Once a stage has landed, each thread applies leaky to 4 rows of a window
//   row and, in f32, writes their TF32 big parts in place and small parts
//   LDP words on; in bf16 it rounds and packs channels 2p and 2p + 1 into the
//   bf16x2 words m16n8k16's B operand wants. Each activation is thus split
//   or rounded once per block, not once per warp. A tap's shift of i * d
//   rows breaks 16-byte alignment, so B fragments are read with 32-bit loads;
//   the row pitch (2 * LDP = 8 mod 32 words) keeps them free of bank
//   conflicts for any shift.
// - The weights are packed once on the host (ops/mrf_stage.py:_pack_weight)
//   in fragment order, so a lane reads a tap's A fragment with one 16-byte
//   load. In f32 they stay raw and are split in registers per tap: host-split
//   big + small parts doubled the weight bytes of every stage, which at
//   k = 11 would leave no room for a 3-stage ring of 512-row tiles.
// - The three TF32 products accumulate into the same fragment (no second
//   accumulator), issued small*big for 4 n8 tiles, then big*small, then
//   big*big, so a product's three mma are 8 apart.
// - res, accin and out may alias, so the epilogue issues all of a tile's
//   loads before any store: a load behind a store would wait for it.
// The chain's traffic stays: each (B, C, T) tensor goes through device
// memory once per conv, which bounds the C = 32 stage (T = 256000 at
// T_mel = 1000) by memory, not operations.
// - Every global offset is 64-bit (size_t): a sample's C * T and a launch's
//   B * C * T may pass 2^31 (a sample at C = 64, T = 2^25 is 8 GiB of f32).
//   T, B, the channel and the time of a row, and the tile index stay int: T
//   up to INT_MAX - 1024 (so that a window's last row, T plus the halo and a
//   tile, still fits), B up to 65535 (the wrapper splits larger batches),
//   and a launch's tiles below 2^31 (checked at launch: about 2^40 f32
//   elements at C = 512, more than any card holds).

// Build: its 12 conv instances take ptxas about 28-40 s in one nvcc, so
// ops/cuda_lib.py compiles them in four parts at once, each one set of
// (kernel size, type) families (FSCL_PART, below).
// build parts: 4

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RMAX = 32;            // largest reach (k - 1) / 2 * dilation taken
constexpr int MAX_SMEM = 232448;    // a block's shared memory on sm_90
constexpr int MAX_STAGES = 8;
constexpr int MAX_T = INT_MAX - 1024;   // T + halo + a tile's rows fit an int
constexpr float SLOPE = 0.1f;

// A block owns BM output channels and BT = 512 time rows; each warp a 32 x
// (8 NT) tile of them (MT = 2 m16 tiles by NT n8 tiles).
template <int K, bool BF16, int BM>
struct Cfg {
  static constexpr int MT = 2, NT = BM == 64 ? 16 : 8;
  static constexpr int CO = BM;                       // output channels per block
  static constexpr int WM = BM / 32;                  // warps along the channels
  static constexpr int WN = WARPS / WM;               // warps along time
  static constexpr int BT = WN * 8 * NT;              // time rows per block
  static constexpr int KC = BF16 ? 16 : 8;            // input channels per ring stage
  // Window: 8 rows of 2 * LDP words, one per B row k = 0..7 of the mma
  // (f32: an input channel; bf16: a channel pair). f32: TF32 big parts in
  // the first LDP words, small parts in the second. bf16: bf16x2 words in
  // the first LDP words. The raw f32 rows land in place: f32 at the row's
  // start, bf16's even channel there and its odd channel at LDP.
  static constexpr int LDP = BT + 2 * RMAX + 4;
  static constexpr int WIN_WORDS = 8 * 2 * LDP;
  static constexpr int FRAG_WORDS = 128;               // one tap's A fragments, 32 lanes x 4
  static constexpr int SEG_WORDS = K * FRAG_WORDS;     // an m16 tile's weights per stage
  static constexpr int STAGE_WORDS = WIN_WORDS + (BM / 16) * SEG_WORDS;
  static constexpr int STAGE_BYTES = STAGE_WORDS * 4;
  // as deep a ring as shared memory holds, with one mbarrier per stage
  static constexpr int STAGES = (MAX_SMEM - 8 * MAX_STAGES) / STAGE_BYTES < MAX_STAGES
                                    ? (MAX_SMEM - 8 * MAX_STAGES) / STAGE_BYTES : MAX_STAGES;
  static constexpr int BYTES = STAGES * STAGE_BYTES + 8 * STAGES;
  static_assert(WM * 32 == BM && WM * WN == WARPS && BT == 512, "warps tile the block");
  static_assert(LDP % 16 == 4, "B fragment loads free of bank conflicts (and LDP % 4 == 0)");
  static_assert(STAGE_WORDS % 4 == 0, "16-byte aligned copies");
  static_assert(STAGES >= 3, "a ring of at least 3 stages");
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : v * SLOPE; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src-size 0 zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of bulk copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               " selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of `bar` with this parity to complete; a copy that
// never lands ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n > (1 << 24)) __trap();
}

// Hopper's bulk copy engine (TMA): `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// this thread's shared-memory writes are ordered before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// f32 -> TF32 bits, to nearest with ties away from zero: cvt.rna.tf32.f32's
// result for finite x (the carry of the add rounds the magnitude up).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32, |small| <= 2^-11 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A tile of the conv: BM output channels from m16 tile `m16` on, BT time
// rows from t0, sample b. Tiles are numbered with the channel block fastest,
// so that blocks running at once share input windows in L2.
struct Tile {
  int m16, t0, b;
};

template <class G>
__device__ __forceinline__ Tile tile_of(int tile, int C, int T) {
  const int co_blocks = C / G::CO;
  const int t_blocks = (T + G::BT - 1) / G::BT;
  const int rest = tile / co_blocks;
  return {(tile - rest * co_blocks) * (G::CO / 16), (rest % t_blocks) * G::BT, rest / t_blocks};
}

// out = ((conv(leaky(in)) + bias) + res + accin) * scale, tile by tile.
// in, res, accin, out: (B, C, T) f32; wp: weights in fragment order
// (ops/mrf_stage.py:_pack_weight), (C / 16, C / KC, K, 128) words;
// res and accin may be null and may alias out (each element is read and
// then written by the same thread). vec: T is a multiple of 4 and every
// tensor 16-byte aligned, so window rows go by bulk copy; else by 4-byte
// cp.async. A block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...;
// its ring runs on from one tile's channel chunks into the next tile's, so
// it never drains between tiles.
template <int K, bool BF16, int BM>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const float* __restrict__ in, const uint32_t* __restrict__ wp,
            const float* __restrict__ bias, const float* res, const float* accin,
            float* out, int B, int C, int T, int dil, float scale, int vec) {
  using G = Cfg<K, BF16, BM>;
  constexpr int MT = G::MT, NT = G::NT, LDP = G::LDP, STAGES = G::STAGES;
  constexpr int SRC_ROWS = BF16 ? 16 : 8;      // input channels a stage copies
  extern __shared__ __align__(16) uint32_t ring[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE_WORDS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / G::WN, wn = warp % G::WN;
  const int reach = (K - 1) / 2 * dil;
  const int r4 = (reach + 3) & ~3;             // window rows before t0, a multiple of 4
  const int rows = G::BT + 2 * r4;             // window rows staged
  const int n_chunks = C / G::KC;
  const int n_tiles = (C / BM) * ((T + G::BT - 1) / G::BT) * B;   // < 2^31, checked at launch
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int n_steps = my_tiles * n_chunks;     // (tile, chunk) steps of this block

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Start the copies of step s (this block's tile s / n_chunks, channel
  // chunk s % n_chunks) into its ring stage: the weights always, and the
  // window rows with vec, by bulk copy; the window rows otherwise by
  // cp.async, zero outside [0, T).
  auto load_step = [&](int s) {
    uint32_t* st = ring + (s % STAGES) * G::STAGE_WORDS;
    uint64_t* bar = bars + s % STAGES;
    const int chunk = s % n_chunks;
    const Tile tl = tile_of<G>(blockIdx.x + (s / n_chunks) * gridDim.x, C, T);
    const float* src = in + ((size_t)tl.b * C + chunk * G::KC) * T;   // the chunk's first channel
    const int w0 = tl.t0 - r4;                                         // time of window row 0
    const int lo = max(w0, 0), hi = min(w0 + rows, T);                 // rows inside [0, T)
    constexpr uint32_t W_BYTES = (BM / 16) * G::SEG_WORDS * 4;
    // source channel c lands at (c / 2) * 2 LDP + (c % 2) LDP in bf16, c * 2 LDP in f32
    auto dst_row = [&](int c) { return st + (BF16 ? (c / 2) * 2 * LDP + (c % 2) * LDP : c * 2 * LDP); };
    if (warp == 0) {
      if (lane == 0) mbar_expect_tx(bar, W_BYTES + (vec ? SRC_ROWS * (hi - lo) * 4 : 0));
      __syncwarp();
      if (lane < BM / 16)
        bulk_copy(st + G::WIN_WORDS + lane * G::SEG_WORDS,
                  wp + ((size_t)(tl.m16 + lane) * n_chunks + chunk) * G::SEG_WORDS,
                  G::SEG_WORDS * 4, bar);
      else if (vec && lane - BM / 16 < SRC_ROWS) {
        const int c = lane - BM / 16;
        bulk_copy(dst_row(c) + (lo - w0), src + (size_t)c * T + lo, (hi - lo) * 4, bar);
      }
    }
    if (vec) {
      // edge tiles: zero the rows outside [0, T) (plain stores)
      if (lo > w0 || hi < w0 + rows)
        for (int e = threadIdx.x; e < SRC_ROWS * rows; e += THREADS) {
          const int c = e / rows, r = e - c * rows;
          if (w0 + r < lo || w0 + r >= hi) dst_row(c)[r] = 0u;
        }
    } else {
      // by the 4-row units convert_stage gives each thread, so that the
      // thread that converts a unit issued its copies
      const int quads = rows / 4;
      for (int u = threadIdx.x; u < 8 * quads; u += THREADS) {
        const int row = u / quads, r = 4 * (u - row * quads);
#pragma unroll
        for (int h = 0; h < (BF16 ? 2 : 1); ++h) {
          const int c = BF16 ? 2 * row + h : row;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tt = w0 + r + e;
            const bool ok = tt >= 0 && tt < T;
            cp_async4(dst_row(c) + r + e, ok ? src + (size_t)c * T + tt : src, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  // Once the stage has landed: leaky, then split (f32: big parts in place,
  // small parts LDP further) or round and pack channel pairs (bf16), four
  // rows at a time.
  auto convert_stage = [&](uint32_t* st) {
    const int quads = rows / 4;
    for (int u = threadIdx.x; u < 8 * quads; u += THREADS) {
      const int row = u / quads;
      uint32_t* p = st + row * 2 * LDP + 4 * (u - row * quads);
      const float4 a = *reinterpret_cast<const float4*>(p);
      if (BF16) {
        const float4 c = *reinterpret_cast<const float4*>(p + LDP);    // the odd channel
        *reinterpret_cast<uint4*>(p) = make_uint4(
            pack_bf16(leaky(a.x), leaky(c.x)), pack_bf16(leaky(a.y), leaky(c.y)),
            pack_bf16(leaky(a.z), leaky(c.z)), pack_bf16(leaky(a.w), leaky(c.w)));
      } else {
        uint4 big, small;
        split_tf32(leaky(a.x), big.x, small.x);
        split_tf32(leaky(a.y), big.y, small.y);
        split_tf32(leaky(a.z), big.z, small.z);
        split_tf32(leaky(a.w), big.w, small.w);
        *reinterpret_cast<uint4*>(p) = big;
        *reinterpret_cast<uint4*>(p + LDP) = small;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < n_steps) load_step(s);
    else cp_async_commit();
  const int row0 = wn * 8 * NT + g + (r4 - reach);   // window row of this lane's n at tap 0
  for (int s = 0; s < n_steps; ++s) {
    uint32_t* st = ring + (s % STAGES) * G::STAGE_WORDS;
    if (!vec) cp_async_wait<STAGES - 2>();   // this thread's window copies of step s
    mbar_wait(bars + s % STAGES, (s / STAGES) & 1);
    convert_stage(st);
    fence_proxy_async();           // the stage is refilled by bulk copies later
    __syncthreads();               // everyone's, converted; and everyone is done with step s - 1
    if (s + STAGES - 1 < n_steps) load_step(s + STAGES - 1);   // into the stage s - 1 used
    else cp_async_commit();

    const uint32_t* ws = st + G::WIN_WORDS + 2 * wm * G::SEG_WORDS;   // this warp's m16 tiles
    const uint32_t* xw = st + t * 2 * LDP;    // B rows k = t and (+ 8 LDP) t + 4
    // One tap at a time: its A fragments (f32: split here, in registers),
    // then its B fragments four n8 tiles at a time.
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int r = row0 + i * dil;     // window row of the lane's n at tap i
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint4 v = *reinterpret_cast<const uint4*>(ws + m * G::SEG_WORDS + i * 128 + 4 * lane);
        a[m][0] = v.x; a[m][1] = v.y; a[m][2] = v.z; a[m][3] = v.w;
      }
      if constexpr (BF16) {
#pragma unroll
        for (int j0 = 0; j0 < NT; j0 += 4) {
          uint32_t b[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j][0] = xw[r + 8 * (j0 + j)];               // channels 2t, 2t + 1
            b[j][1] = xw[8 * LDP + r + 8 * (j0 + j)];     // channels 2t + 8, 2t + 9
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j0 + j], a[m], b[j]);
        }
      } else {
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[m][e]), ab[m][e], as[m][e]);
#pragma unroll
        for (int j0 = 0; j0 < NT; j0 += 4) {
          uint32_t bb[4][2], bs[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t* p = xw + r + 8 * (j0 + j);
            bb[j][0] = p[0];                // channel t
            bb[j][1] = p[8 * LDP];          // channel t + 4
            bs[j][0] = p[LDP];
            bs[j][1] = p[9 * LDP];
          }
          // small*big, then big*small, then big*big into the same
          // accumulator; a product's three mma are 4 * MT = 8 apart
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j0 + j], as[m], bb[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j0 + j], ab[m], bs[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j0 + j], ab[m], bb[j]);
        }
      }
    }
    if (s % n_chunks != n_chunks - 1) continue;

    // The tile's last chunk: the epilogue. Accumulator element e is channel
    // 16m + g + 8 (e / 2), time 8j + 2t + e % 2 of the warp's tile. res,
    // accin and out may alias, so a load placed after a store would wait for
    // it: every load of the tile is issued first (no store between them),
    // then every store.
    const Tile tl = tile_of<G>(blockIdx.x + (s / n_chunks) * gridDim.x, C, T);
    const int tw = tl.t0 + wn * 8 * NT + 2 * t;     // time of the lane's first pair
    auto row_of = [&](int m, int hh) {
      return ((size_t)tl.b * C + 16 * (tl.m16 + 2 * wm + m) + 8 * hh + g) * T;
    };
    // ((acc + bias) + res) + accin, in that order
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float bb = bias[16 * (tl.m16 + 2 * wm + m) + 8 * hh + g];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[m][j][2 * hh] += bb;
          acc[m][j][2 * hh + 1] += bb;
        }
      }
    auto add = [&](const float* src) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* p = src + row_of(m, hh);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int tt = tw + 8 * j;
            if (vec) {                                 // T even: tt + 1 < T too
              if (tt < T) {
                const float2 x = *reinterpret_cast<const float2*>(p + tt);
                acc[m][j][2 * hh] += x.x;
                acc[m][j][2 * hh + 1] += x.y;
              }
            } else {
              if (tt < T) acc[m][j][2 * hh] += p[tt];
              if (tt + 1 < T) acc[m][j][2 * hh + 1] += p[tt + 1];
            }
          }
        }
    };
    if (res) add(res);
    if (accin) add(accin);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* p = out + row_of(m, hh);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int tt = tw + 8 * j;
          const float v0 = acc[m][j][2 * hh] * scale, v1 = acc[m][j][2 * hh + 1] * scale;
          acc[m][j][2 * hh] = acc[m][j][2 * hh + 1] = 0.f;
          if (vec) {
            if (tt < T) *reinterpret_cast<float2*>(p + tt) = make_float2(v0, v1);
          } else {
            if (tt < T) p[tt] = v0;
            if (tt + 1 < T) p[tt + 1] = v1;
          }
        }
      }
  }
}

constexpr int POST_K = 7;       // conv_post's kernel in HiFiGAN (and the TPU kernel)

__device__ __forceinline__ float activate(float v, int round_bf16) {
  v = leaky(v);
  if (round_bf16) v = __bfloat162float(__float2bfloat16(v));
  return v;
}

// wav[b, t] = tanh(bias + sum_{i, c} w[i, c] * act(y[b, c, t + i - 3])) with w
// packed as (7, C); one thread per output sample, f32 FMAs (2 * 7 * C
// operations per sample, under 1 % of a stage's). Every thread of a warp
// reads the same weight at once, a broadcast from L1.
__global__ void post_kernel(const float* __restrict__ y, const float* __restrict__ wp,
                            const float* __restrict__ pb, float* __restrict__ wav,
                            int C, int T, int round_bf16) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float* yb = y + (size_t)b * C * T;
  constexpr int reach = (POST_K - 1) / 2;
  float s = 0.f;
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < POST_K; ++i) {
      const int tt = t + i - reach;
      if (tt >= 0 && tt < T) s = fmaf(activate(yb[(size_t)c * T + tt], round_bf16), wp[i * C + c], s);
    }
  }
  wav[(size_t)b * T + t] = tanhf(s + pb[0]);
}

cudaError_t post(const float* y, const float* wp, const float* pb, float* wav, int B, int C, int T,
                 int round_bf16, cudaStream_t s) {
  const int threads = 256;
  const dim3 grid((T + threads - 1) / threads, B);
  post_kernel<<<grid, threads, 0, s>>>(y, wp, pb, wav, C, T, round_bf16);
  return cudaGetLastError();
}

template <int K, bool BF16, int BM>
cudaError_t launch_conv(const float* in, const uint32_t* wp, const float* bias, const float* res,
                        const float* accin, float* out, int B, int C, int T, int dil,
                        float scale, int vec, cudaStream_t s) {
  using G = Cfg<K, BF16, BM>;
  auto kernel = conv_kernel<K, BF16, BM>;
  // The shared-memory allowance and the resident blocks (SMs x blocks per
  // SM) are looked up once per instance and device.
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int slots = dev < MAX_DEVICES ? resident[dev] : 0;
  if (slots == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, G::BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
    if (dev < MAX_DEVICES) resident[dev] = slots;
  }
  const long long tiles = (long long)(C / BM) * (((long long)T + G::BT - 1) / G::BT) * B;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const int grid = tiles < slots ? (int)tiles : slots;
  kernel<<<grid, THREADS, G::BYTES, s>>>(in, wp, bias, res, accin, out, B, C, T, dil, scale, vec);
  return cudaGetLastError();
}

template <int K, bool BF16>
cudaError_t conv_k(const float* in, const uint32_t* wp, const float* bias, const float* res,
                   const float* accin, float* out, int B, int C, int T, int dil, float scale,
                   int vec, cudaStream_t s) {
  if (C % 64 == 0)
    return launch_conv<K, BF16, 64>(in, wp, bias, res, accin, out, B, C, T, dil, scale, vec, s);
  return launch_conv<K, BF16, 32>(in, wp, bias, res, accin, out, B, C, T, dil, scale, vec, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// The (kernel size, type) families, each compiled in one build part; without
// FSCL_PART (one nvcc for the whole file) every family and the entry points.
#ifndef FSCL_PART
#define FSCL_PART -1
#endif
#define FSCL_OWNS(part) (FSCL_PART < 0 || FSCL_PART == (part))
#define FSCL_CONV_ARGS                                                                        \
  const float *in, const uint32_t *wp, const float *bias, const float *res, const float *accin, \
      float *out, int B, int C, int T, int dil, float scale, int vec, cudaStream_t s
#define FSCL_CONV_CALL in, wp, bias, res, accin, out, B, C, T, dil, scale, vec, s

cudaError_t fscl_mrf_conv_3_f32(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_7_f32(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_11_f32(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_3_bf16(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_7_bf16(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_11_bf16(FSCL_CONV_ARGS);

#if FSCL_OWNS(0)
cudaError_t fscl_mrf_conv_11_f32(FSCL_CONV_ARGS) { return conv_k<11, false>(FSCL_CONV_CALL); }
#endif
#if FSCL_OWNS(1)
cudaError_t fscl_mrf_conv_11_bf16(FSCL_CONV_ARGS) { return conv_k<11, true>(FSCL_CONV_CALL); }
#endif
#if FSCL_OWNS(2)
cudaError_t fscl_mrf_conv_3_f32(FSCL_CONV_ARGS) { return conv_k<3, false>(FSCL_CONV_CALL); }
cudaError_t fscl_mrf_conv_7_f32(FSCL_CONV_ARGS) { return conv_k<7, false>(FSCL_CONV_CALL); }
#endif
#if FSCL_OWNS(3)
cudaError_t fscl_mrf_conv_3_bf16(FSCL_CONV_ARGS) { return conv_k<3, true>(FSCL_CONV_CALL); }
cudaError_t fscl_mrf_conv_7_bf16(FSCL_CONV_ARGS) { return conv_k<7, true>(FSCL_CONV_CALL); }
#endif

#if FSCL_OWNS(0)
static cudaError_t conv_f32(int k, FSCL_CONV_ARGS) {
  return k == 3 ? fscl_mrf_conv_3_f32(FSCL_CONV_CALL) : k == 7 ? fscl_mrf_conv_7_f32(FSCL_CONV_CALL)
       : k == 11 ? fscl_mrf_conv_11_f32(FSCL_CONV_CALL) : cudaErrorInvalidValue;
}

static cudaError_t conv_bf16(int k, FSCL_CONV_ARGS) {
  return k == 3 ? fscl_mrf_conv_3_bf16(FSCL_CONV_CALL) : k == 7 ? fscl_mrf_conv_7_bf16(FSCL_CONV_CALL)
       : k == 11 ? fscl_mrf_conv_11_bf16(FSCL_CONV_CALL) : cudaErrorInvalidValue;
}

// The whole stage on `stream`. x, out, h, r: (B, C, T) f32 on the device
// (h and r are work buffers; out holds the stage output, or the mean before
// conv_post when post_w, packed as (7, C), is given, and then wav (B, T)
// receives the wav).
// Resblock j has kernel ks[j] and n_dil[j] dilations, read in order from
// dils; weights/biases are host arrays of device pointers, two convs (convs1,
// convs2) per dilation in resblock order, weights packed by
// ops/mrf_stage.py:_pack_weight for the compute type (f32: TF32 big and
// small parts; round_bf16: bf16). Returns 0 or the first CUDA error.
extern "C" int fscl_mrf_stage(const void* x, void* out, void* h, void* r, void* wav, int B,
                              int C, int T, int n_res, const int* ks, const int* n_dil,
                              const int* dils, const void* const* weights,
                              const void* const* biases, const void* post_w,
                              const void* post_b, int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || T > MAX_T || C < 32 || C % 32 || n_res < 1 || B > 65535 || C / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  for (int j = 0, di = 0; j < n_res; ++j) {
    if ((ks[j] != 3 && ks[j] != 7 && ks[j] != 11) || n_dil[j] < 1) return (int)cudaErrorInvalidValue;
    for (int q = 0; q < n_dil[j]; ++q, ++di)
      if (dils[di] < 1 || (ks[j] - 1) / 2 * dils[di] > RMAX) return (int)cudaErrorInvalidValue;
  }
  const float* xin = static_cast<const float*>(x);
  float* fout = static_cast<float*>(out);
  float* fh = static_cast<float*>(h);
  float* fr = static_cast<float*>(r);
  const int vec = T % 4 == 0 && aligned16(x) && aligned16(out) && aligned16(h) && aligned16(r);
  const float inv_n = 1.0f / (float)n_res;
  auto conv = round_bf16 ? conv_bf16 : conv_f32;
  int ci = 0, di = 0;
  for (int j = 0; j < n_res; ++j) {
    for (int q = 0; q < n_dil[j]; ++q, ++di, ci += 2) {
      const bool first = q == 0;
      const bool last = q == n_dil[j] - 1;
      const float* src = first ? xin : fr;
      cudaError_t err = conv(ks[j], src, static_cast<const uint32_t*>(weights[ci]),
                             static_cast<const float*>(biases[ci]), nullptr, nullptr, fh, B, C, T,
                             dils[di], 1.0f, vec, s);
      if (err != cudaSuccess) return (int)err;
      err = conv(ks[j], fh, static_cast<const uint32_t*>(weights[ci + 1]),
                 static_cast<const float*>(biases[ci + 1]), src,
                 (last && j > 0) ? fout : nullptr, last ? fout : fr, B, C, T, 1,
                 (last && j == n_res - 1) ? inv_n : 1.0f, vec, s);
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (post_w != nullptr)
    return (int)post(fout, static_cast<const float*>(post_w), static_cast<const float*>(post_b),
                     static_cast<float*>(wav), B, C, T, round_bf16, s);
  return 0;
}

// conv_post + tanh alone on y (B, C, T) f32, into wav (B, T): the last
// kernel of a stage with `post`, launched by itself to time it apart.
extern "C" int fscl_mrf_post(const void* y, const void* post_w, const void* post_b, void* wav,
                             int B, int C, int T, int round_bf16, void* stream) {
  if (B < 1 || T < 1 || T > MAX_T || C < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  return (int)post(static_cast<const float*>(y), static_cast<const float*>(post_w),
                   static_cast<const float*>(post_b), static_cast<float*>(wav), B, C, T,
                   round_bf16, static_cast<cudaStream_t>(stream));
}
#endif
