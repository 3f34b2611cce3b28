// Masked attention backward for Hopper (sm_90a): wgmma, TMA, producer and
// consumer warpgroups.
//
// Replaces no Pallas kernel: fscl_tpu's backward of its attention kernel is
// _pallas_attention_bwd (fscl_tpu/ops/attention.py:120-127), jax.vjp of
// xla_attention, which XLA compiles and fuses into a few ops outside any
// Pallas call. Its counterpart here was ops/attention.py:attention_bwd, about
// 16 launches a call (5 cuBLAS products, f32 (Lq, Lk) temporaries written and
// read again, softmax and element-wise passes); this file computes the same
// gradients in two launches. Per (batch, head), with S = Q K^T / temp in f32,
// keys with key_valid == 0 filled with the finite -1e9 (a row with no valid
// key has uniform weights), P = softmax(S):
//     dV = P^T g,  dS = P * (dP - D) (0 at invalid keys), dP = g V^T,
//     D = rowsum(P * dP),  dQ = dS K / temp,  dK = dS^T Q / temp.
//
// The least time on the card: 5 products of 2 Lq Lk Dh operations each per
// (batch, head), in f32 by split TF32 (3 TF32 passes each: 30 Lq Lk Dh over
// 495 TFLOP/s), against q, k, v, g, dq, dk, dv moved once. At the training
// shapes (L >= 128, Dh = 128) operations bound it.
//
// What bounds this design on the card. Split TF32 needs every operand tile
// in shared memory twice (its big and small TF32 parts), and products that
// contract over the rows of a tile (dQ = dS K, dK = dS^T Q) need that tile
// transposed as well, since a 32-bit wgmma reads both operands K-major only.
// So the work besides the tensor cores is splitting: each streamed f32 tile
// is read from its TMA stage and written out as 4 planes (2 row-major, 2
// transposed; a bf16 tile only as its transposed plane), and by the bytes a tile moves, shared memory's bandwidth,
// which wgmma's B operands also use, is a limit of the same order as the
// tensor cores. The products
// S, dP, (P * dP) K, P K, S^T, dP^T and dS^T Q (7 instead of 5: D is known
// only after the last key, below) run at wgmma's TF32 rate; dV runs on the
// FMA units (below). What the design does about it:
// - A block is 3 warpgroups: a producer (one warp issues the TMA copies of
//   each streamed tile into a ring guarded by full / empty mbarriers;
//   setmaxnreg gives its registers away) and two consumer warpgroups of 232
//   (launch 1) or 240 (launch 2) registers a thread that share each tile:
//   one holds the block's 64 rows of Q (launch 1) or K (launch 2) in
//   registers, the other those of g or V, and each computes its own
//   products, so the two overlap each other's splits, waits and element-wise
//   work.
// - Every A operand comes from registers (the resident rows, split into
//   TF32 parts at use; P, P * dP and dS from the accumulators), so only B
//   operands take shared memory: a streamed tile's planes, written by the
//   consumer warpgroup that reads them, but for launch 1's K^T, which
//   warpgroup 1 writes and both read (a barrier tells it warpgroup 2 is done
//   with the last tile's).
// - A stage is released as soon as its tile is split (launch 1, whose ring
//   has one stage: the copy of the next tile overlaps the tile's products;
//   in bf16 once S and dP have read it), or once its g rows have fed dV
//   (launch 2, two stages). Launch 1 has one stage because shared memory
//   holds no second: at f32 and head dim 128 its block takes 202 KB, and a
//   second 33 KB stage would take it to 235 KB, past the 227 KB a block
//   may have.
// - TMA stores each 128-byte column block of a streamed tile with the
//   128-byte swizzle and the planes use the matching swizzled K-major
//   layout, so the splitting threads read and write shared memory free of
//   bank conflicts (but for the transposed planes' reads).
// - Registers: dQ's and dK's sums (64 a thread at head dim 128) live in
//   shared memory, each thread adding its own tile sums to its own slots
//   (in bf16, where shared memory has room, dV's between tiles too); the
//   resident rows (64), a tile's scores and gradients (16 each), the split
//   A operands of a gradient product (32) and a fresh sum (16) stay in
//   registers. Descriptors and copy offsets are recomputed at each use
//   from values the compiler cannot hoist, and each fresh sum is added
//   before the next group of wgmma is issued. 0 spill in every instance
//   (chip_smoke.py phase 2).
//
// Launches:
// 1. dQ and D: a block per (64 query rows, batch * head). Tiles of 32 keys
//    of K and V stream with their key flags, once. Warpgroup 1 (Q) computes
//    S and P, hands P over and sums P K; warpgroup 2 (g) computes dP, P *
//    dP and D, and sums (P * dP) K. D is known only after the last key, so
//    dQ = ((P * dP) K - D (P K)) / temp at the end, with P K handed over.
//    Each row's (m, 1 / l, D) goes out for launch 2.
// 2. dK and dV: a block per (64 keys, batch * head). Tiles of 32 query rows
//    of Q and g stream with their (m, 1 / l, D). Warpgroup 1 (K) computes
//    S^T, takes dP^T, forms P and dS^T, hands P over and sums dS^T Q;
//    warpgroup 2 (V) computes dP^T, hands it over and sums dV = P^T g.
// Grids of 64-row blocks: (16, 2, 512) gives 256 blocks a launch, about two
// waves of one block per SM (shared memory holds one); (16, 2, 128) gives
// 64, a half-filled card, and (4, 2, 128), the tune adaptation's, 16 on the
// 132 SMs: both are left under-filled, as a 64-row wgmma tile cannot be cut
// smaller and nothing else of the backward runs beside them.
//
// Exactness contracts (the card's tests hold each one):
// - The forward's scores. The weights come from the forward (csrc/
//   attention.cu, narrow route), which stores each query row's max m (f32,
//   log2 units) and sum l. This file recomputes its scores bit for bit (f32
//   below; bf16 under Arithmetic): the same TF32 splits (to nearest, ties away from zero), k-steps (the head
//   dim permuted within each 16 in the planes and the A fragments so that a
//   wgmma k-step holds the 8 columns of the forward's mma.sync k-step: 16j +
//   4t + 2h and + 1), passes and a fresh accumulator every 16 columns added
//   to the sum rounded to nearest; the scale and the subtraction unfused in
//   both. A wgmma k-step adds the same products to the same bits as
//   mma.sync does, in both orientations (S with Q as A, S^T with K as A and
//   the first two passes swapped): chip_smoke.py phase 8 probes that with
//   fscl_attention_bwd_score_probe on random split operands. The probe
//   holds wgmma to a copy of the forward's mma.sync arithmetic kept in this
//   file, not to csrc/attention.cu itself; so P = exp2(S log2(e) / temp -
//   m) / l are the forward's weights exactly: a row with one valid key gets
//   the weight 1 there and 0 elsewhere, a row with none 1 / Lk, as the
//   plain version's softmax gives them. The witness against the forward
//   kernel itself is a row with one valid key, whose dk is exactly 0 only
//   where its weight is exactly 1: chip_smoke.py's check_backward at every
//   backward shape it holds, and the card tests.
// - The row stats. m and l are kept apart, never folded into m + log2 l: a
//   row whose keys are all invalid has m = -1e9 log2(e), where the f32 ulp
//   is 128, so the fold would lose log2 Lk and give every key the weight 1
//   instead of 1 / Lk (dV of that row wrong by a factor Lk).
// - D is summed from this file's own P * dP (dP^T in launch 2 is dP's bits:
//   the transposed product adds the same partial products in the same
//   order), so where a row's weight is all on one key its dS there is
//   exactly 0 and so is dK, as the plain version's are. D from rowsum(g *
//   O) would differ from that key's dP by the products' rounding.
// - dV = P^T g is summed on the FMA units, one query row after the other in
//   ascending order, as the plain version's f32 product does: with one valid
//   key, dV of that key sums g over every query row (tens at L = 512), where
//   any other order of f32 adds lands several 1e-5 away from cuBLAS's
//   sequential sum. Its floor, 2 B H L^2 Dh over 67 TFLOP/s, is 0.032 ms at
//   (16, 2, 512, 128).
// - Independence from B * H: no atomics; dK and dV are owned by their key
//   block, dQ and D by their query block, and tiles do not depend on B * H,
//   so from the same row stats a sample's gradients are the same bits alone
//   and with tasks folded into the batch (the vmapped adaptation).
//
// Arithmetic: f32 for both input types. f32 operands are split into big =
// tf32(x) and small = tf32(x - big); a product is small*big + big*small +
// big*big (a bf16 value is exact in TF32, so its small part is 0 and its
// passes are skipped: the products with P, P * dP or dS take three passes in
// f32 and two in bf16). In bf16, S and dP (and S^T, dP^T) are the bf16
// tensor cores' (wgmma m64n32k16, B the tile as TMA stored it), every k-step
// into one sum as the forward's bf16 scores are, so that there too the
// weights are the forward's exactly (the probe checks bf16 as well). The tensor cores add into
// their accumulator with truncation, so sums go through fresh accumulators
// added in f32 (round to nearest): S and dP every 16 columns of the head
// dim, dK and dQ's two products every tile of 32 rows (32 columns of the
// head dim at a time). Gradients are stored in the input type; P and dS get
// no rounding to bf16.
//
// Shapes: head dims 64 and 128 (the wrapper pads smaller ones, as the
// forward's does), any Lq and Lk >= 1, any B * H up to INT_MAX blocks. Rows
// past Lq or Lk come in as zeros (TMA fills them).

// Build: ops/cuda_lib.py compiles its 4 (type, head dim) families in four
// parts at once (FSCL_PART, below); part 0 also holds the entry points.
// build parts: 4

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

// Without FSCL_PART (one nvcc for the whole file) every part.
#ifndef FSCL_PART
#define FSCL_PART -1
#endif
#define FSCL_OWNS(part) (FSCL_PART < 0 || FSCL_PART == (part))

namespace {

constexpr int TILE = 32;             // rows of a streamed tile (keys in launch 1, queries in 2)
constexpr int RES = 64;              // a block's resident rows: one wgmma M
constexpr int THREADS = 384;         // the producer warpgroup, then two consumer warpgroups
constexpr int MAX_SMEM = 227 * 1024; // sm_90's dynamic shared memory per block
constexpr float MASK_FILL_LOG2 = -1e9f * 1.4426950408889634f;   // the forward's

// Named barriers (0 is __syncthreads): each consumer warpgroup's own, and
// the hand-overs between the two (READY: the data is there, FREE: read).
constexpr int BAR_WG1 = 1, BAR_WG2 = 2, BAR_X_READY = 3, BAR_X_FREE = 4, BAR_Y_READY = 5,
              BAR_Y_FREE = 6, BAR_END = 7, BAR_KT_FREE = 8;

template <typename T, int DH>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int HD = DH;
  static constexpr int KS = DH / 8;                  // k-steps over the head dim
  static constexpr int NQ = DH / 32;                 // 32-column quarters of dQ, dK
  static constexpr int ES = (int)sizeof(T);
  static constexpr int BOX = 128 / ES;               // columns of a 128-byte TMA box
  static constexpr int BOXES = DH / BOX;
  static constexpr int RAW = TILE * DH * ES;         // a streamed tile as it came
  static constexpr int STAGE = 2 * RAW + 1024;       // two tiles, then flags or row stats
  static constexpr int PLANE = TILE * DH * 4;        // one TF32 part of a tile, either way round
  static constexpr int NPL = F32 ? 2 : 1;            // parts: big, small (bf16: big only)
  static constexpr int OPERAND = NPL * PLANE;
  static constexpr int ROWS = F32 ? OPERAND : 0;     // row planes (bf16 reads the tile as it came)
  static constexpr int XCH = RES * TILE * 4;         // a tile's 64 x 32 accumulator, by thread
  static constexpr int LDY = RES + 4;                // P for dV: queries x keys (floats)
  static constexpr int YBUF = TILE * LDY * 4;
  static constexpr int ACC = RES * DH * 4;           // a warpgroup's dQ product or dK, by thread
  static constexpr int CW = DH / 8;                  // dV columns a thread sums, per key
  // launch 1: a 1-stage ring (released once its tile is split), warpgroup
  // 1's K rows (f32) and K^T (which warpgroup 2 reads too), warpgroup 2's V
  // rows (f32), the P exchange, P K, (P * dP) K, the barriers
  static constexpr int Q_STAGES = 1;
  static constexpr int Q_WG1 = Q_STAGES * STAGE, Q_WG2 = Q_WG1 + ROWS + OPERAND;
  static constexpr int Q_XCH = Q_WG2 + ROWS, Q_ACC = Q_XCH + XCH, Q_ACC2 = Q_ACC + ACC;
  static constexpr int Q_BARS = Q_ACC2 + ACC;
  // launch 2: a 2-stage ring, warpgroup 1's Q rows (f32) and Q^T, warpgroup
  // 2's g rows (f32), the dP^T exchange, P for dV, dK, in bf16 dV between tiles (there
  // the registers that hold it through a tile's scores spilled), the
  // barriers
  static constexpr int KV_STAGES = 2;
  static constexpr int KV_WG1 = KV_STAGES * STAGE, KV_WG2 = KV_WG1 + ROWS + OPERAND;
  static constexpr int KV_XCH = KV_WG2 + ROWS, KV_Y = KV_XCH + XCH, KV_ACC = KV_Y + YBUF;
  static constexpr int KV_DV = KV_ACC + ACC, KV_BARS = KV_DV + (F32 ? 0 : ACC);
  // registers a thread of the producer and of a consumer warpgroup holds
  // after setmaxnreg (128 P + 256 C <= 65536)
  static constexpr int Q_PRODUCER_REGS = 40, Q_CONSUMER_REGS = 232;
  static constexpr int KV_PRODUCER_REGS = 24, KV_CONSUMER_REGS = 240;
  static constexpr int Q_BYTES = Q_BARS + 64 + 1024;      // + alignment of the base to 1024
  static constexpr int KV_BYTES = KV_BARS + 64 + 1024;
  static_assert(RAW % 1024 == 0 && PLANE % 1024 == 0 && STAGE % 1024 == 0,
                "swizzled regions start on 1024-byte boundaries");
  static_assert(Q_BYTES <= MAX_SMEM && KV_BYTES <= MAX_SMEM, "shared memory fits");
  static_assert(DH == 64 || DH == 128, "head dims 64 and 128");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// -- mbarriers, named barriers, TMA -------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// An arrival that also expects `bytes` of TMA copies before the phase ends.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void st_shared_u8(uint32_t addr, uint8_t x) {
  asm volatile("st.shared.u8 [%0], %1;\n" :: "r"(addr), "h"((unsigned short)x) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// The box at (c0 columns, c1 rows, c2 batch * head) of a 3-d tensor map into
// shared memory at dst; completion counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A ring of NST stages of streamed tiles: tile it in stage it % NST, with
// its full barrier (the producer warp's 32 lanes arrive, one of them
// expecting the TMA bytes) and its empty one (each of the 8 consumer warps
// arrives once done with the stage) at bars: full[NST], then empty[NST].
template <int NST>
struct Ring {
  uint32_t bars;
  __device__ __forceinline__ uint32_t full(int it) const { return bars + 8 * (it % NST); }
  __device__ __forceinline__ uint32_t empty(int it) const { return bars + 8 * (NST + it % NST); }
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < NST; ++s) {
      mbar_init(bars + 8 * s, 32);
      mbar_init(bars + 8 * (NST + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the producer, before filling tile it's stage: its previous tile released
  __device__ __forceinline__ void wait_empty(int it) const {
    if (it >= NST) mbar_wait(empty(it), ((it / NST) + 1) & 1);
  }
  __device__ __forceinline__ void wait_full(int it) const { mbar_wait(full(it), (it / NST) & 1); }
  // a consumer warp, done with tile it's stage
  __device__ __forceinline__ void release(int it, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(it));
  }
};

// -- wgmma ---------------------------------------------------------------------

// Descriptor of a K-major operand with the 128-byte swizzle: rows 128 bytes
// apart, 8-row groups 1024 bytes apart; `addr` is where its first row's
// current k-step starts (k-steps advance 32 bytes within a 128-byte row).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until the warpgroup's committed groups are done.
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties accumulator registers to the wgmma waits around them, so that the
// compiler moves no read or write of them across.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// x, opaque to the compiler: a shared-memory address or offset read anew
// where it is used, so that what is computed from it (descriptors, copy
// offsets) is not hoisted out of the tile loop, where it would hold
// registers the whole loop long.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// d (64 x 32) += A (64 x 8, registers: rows g and g + 8 of each warp's 16,
// k = t and t + 4) B^T (B: 32 rows x 8, K-major at desc), TF32.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 32) += A (64 x 16 bf16, registers: rows g and g + 8 of each
// warp's 16, two columns a register at k = 2t and 2t + 8) B^T (B: 32 rows x
// 16 bf16, K-major at desc).
__device__ __forceinline__ void wgmma_n32_bf16(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// -- the streamed tiles: as they came, and split into planes -------------------

// 4 consecutive columns c (c % 4 == 0) of row r of a tile as TMA stored it:
// 128-byte column boxes of TILE rows, 16-byte chunks swizzled by row; bf16
// widened (exact).
template <class C>
__device__ __forceinline__ float4 raw4(const uint8_t* raw, int r, int c) {
  if constexpr (C::F32) {
    return *reinterpret_cast<const float4*>(raw + (c >> 5) * TILE * 128 + r * 128
                                            + ((((c >> 2) & 7) ^ (r & 7)) << 4));
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(raw + (c >> 6) * TILE * 128 + r * 128
                                                    + ((((c >> 3) & 7) ^ (r & 7)) << 4)
                                                    + ((c & 4) << 1));
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  }
}

__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Four values as one 16-byte chunk of each plane at `dst` (the small part
// PLANE bytes on; bf16: the values, exact in TF32).
template <class C>
__device__ __forceinline__ void put_chunk(uint8_t* dst, float v0, float v1, float v2, float v3) {
  if constexpr (C::F32) {
    uint4 b, s;
    split_tf32(v0, b.x, s.x);
    split_tf32(v1, b.y, s.y);
    split_tf32(v2, b.z, s.z);
    split_tf32(v3, b.w, s.w);
    *reinterpret_cast<uint4*>(dst) = b;
    *reinterpret_cast<uint4*>(dst + C::PLANE) = s;
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(__float_as_uint(v0), __float_as_uint(v1),
                                                __float_as_uint(v2), __float_as_uint(v3));
  }
}

// The row planes of a tile: B of S = Q K^T (launch 1: K, V) or of S^T = K
// Q^T (launch 2: Q, g): TILE rows x DH, K-major, 32-column atoms of TILE x
// 128 bytes, swizzled. The head dim is permuted within each 16: column 16j
// + 4a + 2h + b sits at 16j + 8h + 4b + a, so that k-step 2j + h holds the
// forward's columns 16j + 4t + 2h (k = t) and + 1 (k = t + 4). Thread tid
// of a warpgroup: rows tid % 32, 16-column groups tid / 32 + 4u.
template <class C>
__device__ __forceinline__ void split_rows(uint8_t* planes, const uint8_t* raw, int tid) {
  tid = opaque(tid);
#pragma unroll
  for (int u = 0; u < TILE * C::HD / 16 / 128; ++u) {
    const int r = tid % TILE, j = tid / TILE + 4 * u;
    float4 x[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = raw4<C>(raw, r, 16 * j + 4 * a);
#pragma unroll
    for (int m = 0; m < 4; ++m) {   // chunk 4j + m: columns 16j + 4a + m for a = 0..3
      const int cc = 4 * j + m;
      put_chunk<C>(planes + (cc >> 3) * TILE * 128 + r * 128 + (((cc & 7) ^ (r & 7)) << 4),
                   comp(x[0], m), comp(x[1], m), comp(x[2], m), comp(x[3], m));
    }
  }
}

// The transposed planes of a tile: B of dQ = dS K (launch 1: K) or of dK =
// dS^T Q (launch 2: Q): DH rows x TILE, K-major, one swizzled atom. The
// tile's rows are permuted within each 8: row 8i + 2a + b sits at 8i + 4b +
// a, so that k-step i takes a thread's accumulator columns 8i + 2t (k = t)
// and + 1 (k = t + 4) as its A fragment. Thread tid of a warpgroup: chunks
// (4 rows of the tile) tid % 8, 4-column groups tid / 8 + 16u.
template <class C>
__device__ __forceinline__ void split_cols(uint8_t* planes, const uint8_t* raw, int tid) {
  tid = opaque(tid);
#pragma unroll
  for (int u = 0; u < 8 * C::HD / 4 / 128; ++u) {
    const int cc = tid % 8, n4 = tid / 8 + 16 * u;
    const int r0 = 8 * (cc >> 1) + (cc & 1);   // rows r0 + 2a
    float4 y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) y[a] = raw4<C>(raw, r0 + 2 * a, 4 * n4);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = 4 * n4 + s;
      put_chunk<C>(planes + n * 128 + ((cc ^ (n & 7)) << 4), comp(y[0], s), comp(y[1], s),
                   comp(y[2], s), comp(y[3], s));
    }
  }
}

// -- the resident rows and the products ----------------------------------------

// A warp's 16 rows (r and r + 8 from row0) of a (rows, DH) input as raw
// wgmma A elements for every k-step, kept in registers for the whole block:
// k-step 2j + h holds (X[r][c], X[r + 8][c], X[r][c + 1], X[r + 8][c + 1])
// at c = 16j + 4t + 2h (the forward's k-steps), f32 as they are, bf16
// packed two to a register. Rows past `rows` are 0.
// bits() hands an element over opaque to the compiler, so that the split
// (or the widening) of an element at each use is not hoisted out of the
// tile loop, where the split parts of all of them would take twice the
// registers.
template <class C, typename T>
struct RowFrags {
  float a[C::KS][4];
  __device__ __forceinline__ void load(const T* src, int row0, int rows, int g, int t) {
    const T* r0 = src + (size_t)(row0 + g) * C::HD + 4 * t;
    const T* r1 = r0 + 8 * C::HD;
    const bool ok0 = row0 + g < rows, ok1 = row0 + g + 8 < rows;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < C::KS / 2; ++j) {
      const float4 x = ok0 ? *reinterpret_cast<const float4*>(r0 + 16 * j) : zero;
      const float4 y = ok1 ? *reinterpret_cast<const float4*>(r1 + 16 * j) : zero;
      a[2 * j][0] = x.x; a[2 * j][1] = y.x; a[2 * j][2] = x.y; a[2 * j][3] = y.y;
      a[2 * j + 1][0] = x.z; a[2 * j + 1][1] = y.z; a[2 * j + 1][2] = x.w; a[2 * j + 1][3] = y.w;
    }
  }
  __device__ __forceinline__ uint32_t bits(int ks, int e) const {
    uint32_t x = __float_as_uint(a[ks][e]);
    asm volatile("" : "+r"(x));
    return x;
  }
};

// bf16: the forward's own A fragments (its QFrag), k16 step ks: (X[r][c],
// X[r][c + 1]), the same of row r + 8, then both at c + 8, c = 16 ks + 2t;
// bf16 scores are the products of the bf16 tensor cores, summed as the
// forward sums them.
template <class C>
struct RowFrags<C, __nv_bfloat16> {
  uint32_t a[C::HD / 16][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* src, int row0, int rows, int g, int t) {
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(src + (size_t)(row0 + g) * C::HD);
    const uint32_t* r1 = r0 + 4 * C::HD;
    const bool ok0 = row0 + g < rows, ok1 = row0 + g + 8 < rows;
#pragma unroll
    for (int ks = 0; ks < C::HD / 16; ++ks) {
      a[ks][0] = ok0 ? r0[8 * ks + t] : 0u;
      a[ks][1] = ok1 ? r1[8 * ks + t] : 0u;
      a[ks][2] = ok0 ? r0[8 * ks + t + 4] : 0u;
      a[ks][3] = ok1 ? r1[8 * ks + t + 4] : 0u;
    }
  }
};

// s = (the warpgroup's 64 resident rows) (the tile's TILE rows)^T over the
// head dim: S, dP, S^T or dP^T; `plane` is the tile's big row plane (bf16:
// the tile as it came). Each 16 columns' passes go into a fresh
// accumulator, added to s rounded to nearest: with Q and K, the forward's
// f32 scores bit for bit. SWAP runs the
// first two passes as big(A) small(B), small(A) big(B): with K (or V) as A,
// the same partial products in the same order as with Q (or g) as A.
// Element 4i + 2v + c of s: resident row 16 warp + g + 8v, tile row 8i + 2t
// + c.
template <class C, bool SWAP, class RF>
__device__ __forceinline__ void scores(float (&s)[16], const RF& rf, uint32_t plane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
  if constexpr (!C::F32) {
    // bf16: the tile as TMA stored it (128-byte swizzled boxes of 64
    // columns, k16 steps of 32 bytes) is B; every k-step into s, as the
    // forward's mma.sync m16n8k16 sums them
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < C::HD / 16; ++ks)
      wgmma_n32_bf16(s, rf.a[ks], desc_sw128(plane + (ks >> 2) * TILE * 128 + (ks & 3) * 32));
    wg_commit();
    wg_wait();
    fence_regs(s);
  } else {
#pragma unroll
    for (int j = 0; j < C::KS / 2; ++j) {
      const uint32_t pl = opaque(plane);
      const uint64_t big = desc_sw128(pl), small = desc_sw128(pl + C::PLANE);
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(rf.bits(2 * j + h, e)), ab[h][e], as[h][e]);
      float f[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) f[i] = 0.f;
      fence_regs(f);
      wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = 2 * j + h;
        const uint32_t off = ((ks >> 2) * TILE * 128 + (ks & 3) * 32) >> 4;
        if constexpr (SWAP) {
          wgmma_n32(f, ab[h], small + off);
          wgmma_n32(f, as[h], big + off);
        } else {
          wgmma_n32(f, as[h], big + off);
          wgmma_n32(f, ab[h], small + off);
        }
        wgmma_n32(f, ab[h], big + off);
      }
      wg_commit();
      wg_wait();
      fence_regs(f);
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += f[i];
      fence_regs(s);   // added before the next group is issued: one f live at a time
    }
  }
}

// A B over one tile: A (64 resident rows x the tile's TILE rows) in
// accumulator layout (P, P * dP or dS^T; split here), B the tile's big
// transposed plane `plane` (DH rows). Per 32 columns qq of the head dim, the
// tile's passes (small(A) big(B), big(A) small(B), big big; the small(B)
// one skipped in bf16) go into a fresh accumulator f, which add(qq, f)
// adds to the sum rounded to nearest. Element 4i + 2v + c of f: row 16 warp
// + g + 8v, column 32 qq + 8i + 2t + c.
template <class C, class Add>
__device__ __forceinline__ void grad_product(const float (&a)[16], uint32_t plane, Add& add) {
  // k-step i: A (row g, k = t) is accumulator column 8i + 2t, (g, t + 4) 8i + 2t + 1
  uint32_t ab[4][4], as[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split_tf32(a[4 * i], ab[i][0], as[i][0]);
    split_tf32(a[4 * i + 2], ab[i][1], as[i][1]);
    split_tf32(a[4 * i + 1], ab[i][2], as[i][2]);
    split_tf32(a[4 * i + 3], ab[i][3], as[i][3]);
  }
#pragma unroll
  for (int qq = 0; qq < C::NQ; ++qq) {
    const uint32_t pl = opaque(plane);
    const uint64_t big = desc_sw128(pl), small = desc_sw128(pl + C::PLANE);
    float f[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = 0.f;
    fence_regs(f);
    wg_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = (qq * 32 * 128 + 32 * i) >> 4;
      wgmma_n32(f, as[i], big + off);
      if constexpr (C::F32) wgmma_n32(f, ab[i], small + off);
      wgmma_n32(f, ab[i], big + off);
    }
    wg_commit();
    wg_wait();
    fence_regs(f);
    add(qq, f);
  }
}

// A warpgroup's sum of grad_product's quarters, in shared memory (the
// registers hold the resident rows and the tile's scores, weights and
// their gradients): element 4u + k of quarter qq at float4 (4 qq + u) * 128
// + tid, k.
template <class C>
struct SmemAcc {
  float4* base;                   // + tid
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int u = 0; u < 4 * C::NQ; ++u) base[u * 128] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void operator()(int qq, const float (&f)[16]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 x = base[(4 * qq + u) * 128];
      x.x += f[4 * u];
      x.y += f[4 * u + 1];
      x.z += f[4 * u + 2];
      x.w += f[4 * u + 3];
      base[(4 * qq + u) * 128] = x;
    }
  }
  __device__ __forceinline__ void get(int qq, float (&x)[16]) const {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 y = base[(4 * qq + u) * 128];
      x[4 * u] = y.x;
      x[4 * u + 1] = y.y;
      x[4 * u + 2] = y.z;
      x[4 * u + 3] = y.w;
    }
  }
};

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Store a warpgroup's rows (row_base + 16 warp + g + 8v, below `rows`) of
// get(qq, x)'s quarters times `scale` at dst (row pitch DH).
template <class C, typename T, class Get>
__device__ __forceinline__ void store_rows(T* dst, Get get, int row_base, int rows, float scale,
                                           int warp, int g, int t) {
#pragma unroll
  for (int qq = 0; qq < C::NQ; ++qq) {
    float x[16];
    get(qq, x);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int row = row_base + 16 * warp + g + 8 * v;
      if (row >= rows) continue;
      T* d = dst + (size_t)row * C::HD + 32 * qq + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store2(d + 8 * i, x[4 * i + 2 * v] * scale, x[4 * i + 2 * v + 1] * scale);
    }
  }
}

// The weight of one (query, key) from the recomputed s (Q K^T, unscaled),
// masked, scaled and offset as the forward's softmax_tile does (unfused):
// exp2(s log2(e) / temp - m) / l, 0 where `in` is false (past Lq or Lk).
__device__ __forceinline__ float weight(float s, float m, float inv_l, bool in, bool ok,
                                        float scale_log2) {
  const float x = ok ? __fmul_rn(s, scale_log2) : MASK_FILL_LOG2;
  return in ? exp2f(__fsub_rn(x, m)) * inv_l : 0.f;
}

// The block's shared memory, aligned to 1024 bytes for the swizzled tiles.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t s = smem_u32(raw);
  return raw + (((s + 1023) & ~1023u) - s);
}

// -- launch 1: dQ and D ----------------------------------------------------------

// dQ and D of RES query rows of one (batch, head), and their (m, 1 / l, D)
// for launch 2: blocks in x order, the query tile fastest.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_q_kernel(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const T* __restrict__ q,
                       const T* __restrict__ g, const uint8_t* __restrict__ key_valid,
                       const float* __restrict__ stats, float* __restrict__ rowstats,
                       T* __restrict__ dq, int H, int Lq, int Lk, int q_tiles, float scale_log2,
                       float inv_temp) {
  using C = Cfg<T, DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const Ring<C::Q_STAGES> ring{smem_u32(smem + C::Q_BARS)};
  const int bh = blockIdx.x / q_tiles, row0 = (blockIdx.x % q_tiles) * RES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = threadIdx.x % 32, gl = lane / 4, t = lane % 4;
  const int n_tiles = (Lk + TILE - 1) / TILE;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (wg == 0) {   // producer: warp 0 streams K, V and the key flags
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::Q_PRODUCER_REGS));
    if (warp != 0) return;
    // (32-bit shared addresses: the producer holds 24 registers)
    const uint8_t* kv = key_valid + (size_t)(bh / H) * Lk;
    const uint32_t st0 = smem_u32(smem);
    for (int it = 0; it < n_tiles; ++it) {
      ring.wait_empty(it);
      const uint32_t st = st0 + (it % C::Q_STAGES) * C::STAGE;
      const int key = it * TILE + lane;
      st_shared_u8(st + 2 * C::RAW + lane, key < Lk ? kv[key] : 0);
      if (lane == 0) {
        mbar_expect(ring.full(it), 2 * C::RAW);
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b) {
          tma_load(st + b * TILE * 128, &k_map, ring.full(it), b * C::BOX, it * TILE, bh);
          tma_load(st + C::RAW + b * TILE * 128, &v_map, ring.full(it), b * C::BOX, it * TILE,
                   bh);
        }
      } else {
        mbar_arrive(ring.full(it));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::Q_CONSUMER_REGS));

  const size_t q_base = (size_t)bh * Lq * DH;
  float m[2], inv_l[2];           // the forward's row stats; past Lq 0: weights 0
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int row = row0 + 16 * warp + gl + 8 * v;
    m[v] = inv_l[v] = 0.f;
    if (row < Lq) {
      const float2 ml = *reinterpret_cast<const float2*>(stats + ((size_t)bh * Lq + row) * 2);
      m[v] = ml.x;
      inv_l[v] = 1.f / ml.y;
    }
  }
  float* xch = reinterpret_cast<float*>(smem + C::Q_XCH);
  SmemAcc<C> pk{reinterpret_cast<float4*>(smem + C::Q_ACC) + tid};   // P K, warpgroup 1's

  if (wg == 1) {   // Q: S, P, P K
    RowFrags<C, T> qf;
    qf.load(q + q_base, row0 + 16 * warp, Lq, gl, t);
    pk.zero();
    uint8_t* rows = smem + C::Q_WG1;
    uint8_t* cols = rows + C::ROWS;
    for (int it = 0; it < n_tiles; ++it) {
      const uint8_t* st = smem + (it % C::Q_STAGES) * C::STAGE;
      ring.wait_full(it);
      if constexpr (C::F32) split_rows<C>(rows, st, tid);
      if (it > 0) bar_sync(BAR_KT_FREE, 256);   // warpgroup 2 done with K^T
      split_cols<C>(cols, st, tid);
      uint32_t flags[4];          // keys 8i + 2t and + 1: two bytes
#pragma unroll
      for (int i = 0; i < 4; ++i)
        flags[i] = *reinterpret_cast<const uint16_t*>(st + 2 * C::RAW + 8 * i + 2 * t);
      fence_async_smem();
      bar_sync(BAR_WG1, 128);     // the warpgroup's planes whole
      float p[16];
      if constexpr (C::F32) {
        ring.release(it, lane);
        scores<C, false>(p, qf, smem_u32(rows));
      } else {                    // S from the tile as it came
        scores<C, false>(p, qf, smem_u32(st));
        ring.release(it, lane);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // dS is 0 at an invalid key (and past Lk): there P counts for
            // nothing (a row with no valid key gets dQ = 0, its D unused)
            const bool ok = (flags[i] >> (8 * c) & 0xffu) != 0;
            float& x = p[4 * i + 2 * v + c];
            x = ok ? weight(x, m[v], inv_l[v], true, true, scale_log2) : 0.f;
          }
      if (it > 0) bar_sync(BAR_X_FREE, 256);
#pragma unroll
      for (int e = 0; e < 16; ++e) xch[e * 128 + tid] = p[e];
      bar_arrive(BAR_X_READY, 256);
      grad_product<C>(p, smem_u32(cols), pk);
    }
    bar_arrive(BAR_END, 256);     // P K whole
    return;
  }

  // g: dP, P * dP, D, (P * dP) K; then dQ
  RowFrags<C, T> gf;
  gf.load(g + q_base, row0 + 16 * warp, Lq, gl, t);
  SmemAcc<C> acc{reinterpret_cast<float4*>(smem + C::Q_ACC2) + tid};
  acc.zero();
  uint8_t* rows = smem + C::Q_WG2;
  const uint8_t* cols = smem + C::Q_WG1 + C::ROWS;   // warpgroup 1's K^T
  float d_part[2] = {0.f, 0.f};   // D of rows g, g + 8 over this thread's keys
  for (int it = 0; it < n_tiles; ++it) {
    const uint8_t* st = smem + (it % C::Q_STAGES) * C::STAGE;
    ring.wait_full(it);
    float e[16];
    if constexpr (C::F32) {
      split_rows<C>(rows, st + C::RAW, tid);
      fence_async_smem();
      bar_sync(BAR_WG2, 128);
      ring.release(it, lane);
      scores<C, false>(e, gf, smem_u32(rows));
    } else {                      // dP from the tile as it came
      scores<C, false>(e, gf, smem_u32(st + C::RAW));
      ring.release(it, lane);
    }
    bar_sync(BAR_X_READY, 256);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      e[i] *= xch[i * 128 + tid];
      d_part[(i >> 1) & 1] += e[i];
    }
    if (it + 1 < n_tiles) bar_arrive(BAR_X_FREE, 256);
    grad_product<C>(e, smem_u32(cols), acc);   // K^T written before X_READY
    if (it + 1 < n_tiles) bar_arrive(BAR_KT_FREE, 256);
  }
  float D[2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    D[v] = d_part[v] + __shfl_xor_sync(0xffffffffu, d_part[v], 1);
    D[v] += __shfl_xor_sync(0xffffffffu, D[v], 2);
  }
  bar_sync(BAR_END, 256);         // P K from warpgroup 1
  store_rows<C>(dq + q_base, [&](int qq, float (&x)[16]) {
    float y[16];
    acc.get(qq, x);
    pk.get(qq, y);
#pragma unroll
    for (int e = 0; e < 16; ++e) x[e] = fmaf(-D[(e >> 1) & 1], y[e], x[e]);
  }, row0, Lq, inv_temp, warp, gl, t);
  if (t == 0) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int row = row0 + 16 * warp + gl + 8 * v;
      if (row < Lq)
        *reinterpret_cast<float4*>(rowstats + ((size_t)bh * Lq + row) * 4) =
            make_float4(m[v], inv_l[v], D[v], 0.f);
    }
  }
}

// -- launch 2: dK and dV ---------------------------------------------------------

// dK and dV of RES keys of one (batch, head): blocks in x order, the key
// tile fastest.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_kv_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap g_map,
                        const __grid_constant__ CUtensorMap rs_map, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ key_valid,
                        T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk,
                        int key_tiles, float scale_log2, float inv_temp) {
  using C = Cfg<T, DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const Ring<C::KV_STAGES> ring{smem_u32(smem + C::KV_BARS)};
  const int bh = blockIdx.x / key_tiles, key0 = (blockIdx.x % key_tiles) * RES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = threadIdx.x % 32, gl = lane / 4, t = lane % 4;
  const int n_tiles = (Lq + TILE - 1) / TILE;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (wg == 0) {   // producer: warp 0 streams Q, g and the rows' (m, 1 / l, D, 0)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::KV_PRODUCER_REGS));
    if (warp != 0) return;
    const uint32_t st0 = smem_u32(smem);
    for (int it = 0; it < n_tiles; ++it) {
      ring.wait_empty(it);
      if (lane == 0) {
        const uint32_t st = st0 + (it % C::KV_STAGES) * C::STAGE;
        mbar_expect(ring.full(it), 2 * C::RAW + TILE * 16);
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b) {
          tma_load(st + b * TILE * 128, &q_map, ring.full(it), b * C::BOX, it * TILE, bh);
          tma_load(st + C::RAW + b * TILE * 128, &g_map, ring.full(it), b * C::BOX, it * TILE,
                   bh);
        }
        tma_load(st + 2 * C::RAW, &rs_map, ring.full(it), 0, it * TILE, bh);
      } else {
        mbar_arrive(ring.full(it));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::KV_CONSUMER_REGS));

  const size_t kv_base = (size_t)bh * Lk * DH;
  float* xch = reinterpret_cast<float*>(smem + C::KV_XCH);
  float* ybuf = reinterpret_cast<float*>(smem + C::KV_Y);

  if (wg == 1) {   // K: S^T, P, dS^T, dS^T Q
    RowFrags<C, T> kf;
    kf.load(k + kv_base, key0 + 16 * warp, Lk, gl, t);
    bool k_in[2], k_ok[2];        // the thread's keys 16 warp + g + 8v
    const uint8_t* kv = key_valid + (size_t)(bh / H) * Lk;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int key = key0 + 16 * warp + gl + 8 * v;
      k_in[v] = key < Lk;
      k_ok[v] = k_in[v] && kv[key] != 0;
    }
    SmemAcc<C> acc{reinterpret_cast<float4*>(smem + C::KV_ACC) + tid};
    acc.zero();
    uint8_t* rows = smem + C::KV_WG1;
    uint8_t* cols = rows + C::ROWS;
    for (int it = 0; it < n_tiles; ++it) {
      const uint8_t* st = smem + (it % C::KV_STAGES) * C::STAGE;
      ring.wait_full(it);
      if constexpr (C::F32) split_rows<C>(rows, st, tid);
      split_cols<C>(cols, st, tid);
      fence_async_smem();
      bar_sync(BAR_WG1, 128);
      float ds[16];
      scores<C, true>(ds, kf, smem_u32(C::F32 ? rows : st));   // S^T
      bar_sync(BAR_X_READY, 256);
      float dp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) dp[e] = xch[e * 128 + tid];
      if (it + 1 < n_tiles) bar_arrive(BAR_X_FREE, 256);
      if (it > 0) bar_sync(BAR_Y_FREE, 256);
      const float4* rs = reinterpret_cast<const float4*>(st + 2 * C::RAW);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = 8 * i + 2 * t + c;
          const float4 r = rs[qi];          // (m, 1 / l, D, 0); zeros past Lq
          const bool q_in = it * TILE + qi < Lq;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int e = 4 * i + 2 * v + c;
            const float p = weight(ds[e], r.x, r.y, q_in && k_in[v], k_ok[v], scale_log2);
            ybuf[qi * C::LDY + 16 * warp + gl + 8 * v] = p;
            ds[e] = q_in && k_ok[v] ? p * (dp[e] - r.z) : 0.f;
          }
        }
      ring.release(it, lane);     // done with the row stats
      bar_arrive(BAR_Y_READY, 256);
      grad_product<C>(ds, smem_u32(cols), acc);
    }
    store_rows<C>(dk + kv_base, [&](int qq, float (&x)[16]) { acc.get(qq, x); }, key0, Lk,
                  inv_temp, warp, gl, t);
    return;
  }

  // V: dP^T, then dV = P^T g on the FMA units
  RowFrags<C, T> vf;
  vf.load(v + kv_base, key0 + 16 * warp, Lk, gl, t);
  uint8_t* rows = smem + C::KV_WG2;
  // dV: the thread's keys 16 warp + 4 (lane / 8) + i, its columns: f32 4
  // at 4 (lane % 8) + 32 u, bf16 8 at 8 (lane % 8) + 64 u (a 16-byte chunk
  // of g's row each)
  constexpr int PER = C::F32 ? 4 : 8, CHUNKS = C::CW / PER;
  float acc[4][C::CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::CW; ++c) acc[i][c] = 0.f;
  const int kl = 16 * warp + 4 * (lane >> 3);
  // bf16: the sum goes to shared memory after each tile and comes back
  // before the next one's rows (element n = 4u + k at float4 u * 128 + tid)
  float4* dv_sum = reinterpret_cast<float4*>(smem + C::KV_DV) + tid;
  if constexpr (!C::F32) {
#pragma unroll
    for (int u = 0; u < C::CW; ++u) dv_sum[u * 128] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const uint8_t* st = smem + (it % C::KV_STAGES) * C::STAGE;
    ring.wait_full(it);
    if constexpr (C::F32) {
      split_rows<C>(rows, st + C::RAW, tid);
      fence_async_smem();
      bar_sync(BAR_WG2, 128);
    }
    float dp[16];
    scores<C, true>(dp, vf, smem_u32(C::F32 ? rows : st + C::RAW));    // dP^T
    if (it > 0) bar_sync(BAR_X_FREE, 256);
#pragma unroll
    for (int e = 0; e < 16; ++e) xch[e * 128 + tid] = dp[e];
    bar_arrive(BAR_X_READY, 256);
    bar_sync(BAR_Y_READY, 256);
    if constexpr (!C::F32) {
#pragma unroll
      for (int u = 0; u < C::CW; ++u) {
        const float4 x = dv_sum[u * 128];
        float* a = &acc[4 * u / C::CW][4 * u % C::CW];
        a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
      }
    }
    // the tile's query rows one after the other, in ascending order
    const uint8_t* graw = st + C::RAW;
#pragma unroll 2
    for (int qi = 0; qi < TILE; ++qi) {
      const float4 p = *reinterpret_cast<const float4*>(ybuf + qi * C::LDY + kl);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int u = 0; u < CHUNKS; ++u) {
        float x[PER];
        const uint8_t* chunk = graw + u * TILE * 128 + qi * 128 + (((lane & 7) ^ (qi & 7)) << 4);
        if constexpr (C::F32) {
          const float4 y = *reinterpret_cast<const float4*>(chunk);
          x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
        } else {
          const uint4 w = *reinterpret_cast<const uint4*>(chunk);
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            x[2 * h] = __uint_as_float(ws[h] << 16);
            x[2 * h + 1] = __uint_as_float(ws[h] & 0xffff0000u);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PER; ++c)
            acc[i][PER * u + c] = fmaf(pv[i], x[c], acc[i][PER * u + c]);
      }
    }
    if (it + 1 < n_tiles) bar_arrive(BAR_Y_FREE, 256);
    ring.release(it, lane);       // done with g
    if constexpr (!C::F32) {
#pragma unroll
      for (int u = 0; u < C::CW; ++u) {
        const float* a = &acc[4 * u / C::CW][4 * u % C::CW];
        dv_sum[u * 128] = make_float4(a[0], a[1], a[2], a[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + kl + i;
    if (key >= Lk) continue;
    T* d = dv + kv_base + (size_t)key * DH;
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u)
#pragma unroll
      for (int c = 0; c < PER; c += 2)
        store2(d + PER * (lane & 7) + (C::F32 ? 32 : 64) * u + c, acc[i][PER * u + c],
               acc[i][PER * u + c + 1]);
  }
}

// -- host side -------------------------------------------------------------------

// Dynamic shared memory above 48 KB is allowed once per kernel and device.
cudaError_t allow_smem(const void* kernel, int bytes, bool* allowed) {
  constexpr int MAX_DEVICES = 64;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = true;
  return err;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (the
// library links no driver library of its own).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found)
            == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a contiguous (bh, rows, cols) tensor in boxes of `box` columns
// x TILE rows of one (batch, head); rows past `rows` read as zeros. swizzle:
// the 128-byte swizzle (box * itemsize == 128).
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int itemsize,
                       long long bh, int rows, int cols, int box, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * itemsize, (cuuint64_t)rows * cols * itemsize};
  const cuuint32_t boxes[3] = {(cuuint32_t)box, (cuuint32_t)TILE, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides, boxes, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The two launches on `s`: dQ with each row's (m, 1 / l, D) into `rowstats`
// (B * H * Lq * 4 floats of scratch), then dK and dV. Grids of up to INT_MAX
// blocks, or cudaErrorInvalidValue.
template <typename T, int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* key_valid,
                       const void* g, const void* stats, void* rowstats, void* dq,
                       void* dk, void* dv, int B, int H, int Lq, int Lk, float scale_log2,
                       float inv_temp, cudaStream_t s) {
  using C = Cfg<T, DH>;
  auto q_kernel = attention_bwd_q_kernel<T, DH>;
  auto kv_kernel = attention_bwd_kv_kernel<T, DH>;
  static bool q_allowed[64] = {}, kv_allowed[64] = {};
  cudaError_t err = allow_smem((const void*)q_kernel, C::Q_BYTES, q_allowed);
  if (err != cudaSuccess) return err;
  err = allow_smem((const void*)kv_kernel, C::KV_BYTES, kv_allowed);
  if (err != cudaSuccess) return err;
  const long long bh = (long long)B * H;
  const long long q_tiles = (Lq + RES - 1) / RES, k_tiles = (Lk + RES - 1) / RES;
  if (bh * q_tiles > INT_MAX || bh * k_tiles > INT_MAX) return cudaErrorInvalidValue;
  const CUtensorMapDataType type = C::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap k_map, v_map, q_map, g_map, rs_map;
  if ((err = tensor_map(&k_map, k, type, C::ES, bh, Lk, DH, C::BOX, true)) != cudaSuccess
      || (err = tensor_map(&v_map, v, type, C::ES, bh, Lk, DH, C::BOX, true)) != cudaSuccess
      || (err = tensor_map(&q_map, q, type, C::ES, bh, Lq, DH, C::BOX, true)) != cudaSuccess
      || (err = tensor_map(&g_map, g, type, C::ES, bh, Lq, DH, C::BOX, true)) != cudaSuccess
      || (err = tensor_map(&rs_map, rowstats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bh, Lq, 4, 4,
                           false)) != cudaSuccess)
    return err;
  float* rstats = static_cast<float*>(rowstats);
  q_kernel<<<(int)(bh * q_tiles), THREADS, C::Q_BYTES, s>>>(
      k_map, v_map, static_cast<const T*>(q), static_cast<const T*>(g),
      static_cast<const uint8_t*>(key_valid), static_cast<const float*>(stats), rstats,
      static_cast<T*>(dq), H, Lq, Lk, (int)q_tiles, scale_log2, inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_kernel<<<(int)(bh * k_tiles), THREADS, C::KV_BYTES, s>>>(
      q_map, g_map, rs_map, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk,
      (int)k_tiles, scale_log2, inv_temp);
  return cudaGetLastError();
}

// -- the score-bits probe ----------------------------------------------------------

#if FSCL_OWNS(0)

// 64 rows of q against 64 rows of k (head dim PROBE_DH) three ways: s_mma
// by mma.sync as the forward sums them (f32: m16n8k8 split TF32 with a
// fresh sum every 16 columns, scores_tf32; bf16: m16n8k16, every k-step
// into the sum, `scores`), s_wg by this file's `scores` with q as A, st_wg
// with k as A (S^T; f32: the passes swapped). chip_smoke.py holds the three
// to the same bits. s_mma is a copy of the forward's arithmetic, not
// csrc/attention.cu's code: a change to the forward's k-step order or
// fresh-sum span shows in the one-valid-key rows' dk (see the header), not
// here.
constexpr int PROBE_DH = 128;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows x 128 f32 at src into the row planes' layout at dst (TILE-row
// halves), split
__device__ void probe_planes(uint8_t* dst, const float* src) {
  using C = Cfg<float, PROBE_DH>;
  for (int i = threadIdx.x; i < RES * PROBE_DH; i += 128) {
    const int r = i / PROBE_DH, c = i % PROBE_DH;
    const int pc = (c & ~15) | (((c >> 1) & 1) << 3) | ((c & 1) << 2) | ((c >> 2) & 3);
    uint8_t* half = dst + (r / TILE) * C::OPERAND;
    const int rr = r % TILE;
    const uint32_t off = (pc >> 5) * TILE * 128 + rr * 128 + ((((pc >> 2) & 7) ^ (rr & 7)) << 4)
                         + ((pc & 3) << 2);
    uint32_t b, sm;
    split_tf32(src[i], b, sm);
    *reinterpret_cast<uint32_t*>(half + off) = b;
    *reinterpret_cast<uint32_t*>(half + C::PLANE + off) = sm;
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows x 128 bf16 at src as TMA stores a tile (TILE-row halves of 128-byte
// swizzled boxes of 64 columns)
__device__ void probe_raw(uint8_t* dst, const __nv_bfloat16* src) {
  using C = Cfg<__nv_bfloat16, PROBE_DH>;
  for (int i = threadIdx.x; i < RES * PROBE_DH; i += 128) {
    const int r = i / PROBE_DH, c = i % PROBE_DH, rr = r % TILE;
    *reinterpret_cast<__nv_bfloat16*>(dst + (r / TILE) * C::STAGE + (c >> 6) * TILE * 128
                                      + rr * 128 + ((((c >> 3) & 7) ^ (rr & 7)) << 4)
                                      + 2 * (c & 7)) = src[i];
  }
}

__global__ void __launch_bounds__(128) score_probe_bf16_kernel(const __nv_bfloat16* q,
                                                               const __nv_bfloat16* k,
                                                               float* s_mma, float* s_wg,
                                                               float* st_wg) {
  using C = Cfg<__nv_bfloat16, PROBE_DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  probe_raw(smem, k);
  probe_raw(smem + 2 * C::STAGE, q);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  RowFrags<C, __nv_bfloat16> qf, kf;
  qf.load(q, 16 * warp, RES, g, t);
  kf.load(k, 16 * warp, RES, g, t);
  for (int side = 0; side < 2; ++side)
    for (int half = 0; half < 2; ++half) {
      float s[16];
      if (side) scores<C, true>(s, kf, smem_u32(smem + (2 + half) * C::STAGE));
      else scores<C, false>(s, qf, smem_u32(smem + half * C::STAGE));
      float* out = side ? st_wg : s_wg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            out[(16 * warp + g + 8 * v) * RES + TILE * half + 8 * i + 2 * t + c] =
                s[4 * i + 2 * v + c];
    }
  // the forward's bf16 scores: B (k = 2t, 2t + 1 | + 8; n = g) from row g of k
  for (int nt = 0; nt < RES / 8; ++nt) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t* kr = reinterpret_cast<const uint32_t*>(k + (8 * nt + g) * PROBE_DH);
    for (int ks = 0; ks < PROBE_DH / 16; ++ks)
      mma_bf16(s, qf.a[ks], kr[8 * ks + t], kr[8 * ks + t + 4]);
    for (int e = 0; e < 4; ++e)
      s_mma[(16 * warp + g + 8 * (e >> 1)) * RES + 8 * nt + 2 * t + (e & 1)] = s[e];
  }
}

__global__ void __launch_bounds__(128) score_probe_kernel(const float* q, const float* k,
                                                          float* s_mma, float* s_wg,
                                                          float* st_wg) {
  using C = Cfg<float, PROBE_DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  probe_planes(smem, k);
  probe_planes(smem + 2 * C::OPERAND, q);
  fence_async_smem();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // with q as A, then with k as A (S^T): one RowFrags live at a time
  for (int side = 0; side < 2; ++side) {
    RowFrags<C, float> rf;
    rf.load(side ? k : q, 16 * warp, RES, g, t);
    for (int half = 0; half < 2; ++half) {
      float s[16];
      if (side) scores<C, true>(s, rf, smem_u32(smem + (2 + half) * C::OPERAND));
      else scores<C, false>(s, rf, smem_u32(smem + half * C::OPERAND));
      float* out = side ? st_wg : s_wg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            out[(16 * warp + g + 8 * v) * RES + TILE * half + 8 * i + 2 * t + c] =
                s[4 * i + 2 * v + c];
    }
  }
  const float* r0 = q + (16 * warp + g) * PROBE_DH + 4 * t;
  const float* r1 = r0 + 8 * PROBE_DH;
  for (int nt = 0; nt < RES / 8; ++nt) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float* kr = k + (8 * nt + g) * PROBE_DH + 4 * t;
    for (int j = 0; j < PROBE_DH / 16; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(r0 + 16 * j);
      const float4 y = *reinterpret_cast<const float4*>(r1 + 16 * j);
      const float4 kk = *reinterpret_cast<const float4*>(kr + 16 * j);
      const float a[2][4] = {{x.x, y.x, x.y, y.y}, {x.z, y.z, x.w, y.w}};
      const float b[2][2] = {{kk.x, kk.y}, {kk.z, kk.w}};
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int h = 0; h < 2; ++h) {
        uint32_t ab[4], as[4], bb[2], bs[2];
        for (int e = 0; e < 4; ++e) split_tf32(a[h][e], ab[e], as[e]);
        for (int e = 0; e < 2; ++e) split_tf32(b[h][e], bb[e], bs[e]);
        mma_tf32(d, as, bb[0], bb[1]);
        mma_tf32(d, ab, bs[0], bs[1]);
        mma_tf32(d, ab, bb[0], bb[1]);
      }
      for (int e = 0; e < 4; ++e) s[e] += d[e];
    }
    for (int e = 0; e < 4; ++e)
      s_mma[(16 * warp + g + 8 * (e >> 1)) * RES + 8 * nt + 2 * t + (e & 1)] = s[e];
  }
}
#endif

}  // namespace

// The (type, head dim) families, each compiled in one build part (the
// entry points and the probe in part 0's).
#define FSCL_BWD_ARGS                                                                       \
  const void *q, const void *k, const void *v, const void *key_valid, const void *g,        \
      const void *stats, void *rowstats, void *dq, void *dk, void *dv, int B, int H, int Lq, \
      int Lk, float scale_log2, float inv_temp, cudaStream_t s
#define FSCL_BWD_CALL                                                                         \
  q, k, v, key_valid, g, stats, rowstats, dq, dk, dv, B, H, Lq, Lk, scale_log2, inv_temp, s

cudaError_t fscl_attention_bwd_f32_64(FSCL_BWD_ARGS);
cudaError_t fscl_attention_bwd_f32_128(FSCL_BWD_ARGS);
cudaError_t fscl_attention_bwd_bf16_64(FSCL_BWD_ARGS);
cudaError_t fscl_attention_bwd_bf16_128(FSCL_BWD_ARGS);

#if FSCL_OWNS(0)
cudaError_t fscl_attention_bwd_f32_64(FSCL_BWD_ARGS) {
  return launch_bwd<float, 64>(FSCL_BWD_CALL);
}
#endif
#if FSCL_OWNS(1)
cudaError_t fscl_attention_bwd_f32_128(FSCL_BWD_ARGS) {
  return launch_bwd<float, 128>(FSCL_BWD_CALL);
}
#endif
#if FSCL_OWNS(2)
cudaError_t fscl_attention_bwd_bf16_64(FSCL_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16, 64>(FSCL_BWD_CALL);
}
#endif
#if FSCL_OWNS(3)
cudaError_t fscl_attention_bwd_bf16_128(FSCL_BWD_ARGS) {
  return launch_bwd<__nv_bfloat16, 128>(FSCL_BWD_CALL);
}
#endif

#if FSCL_OWNS(0)
// q, g, dq: contiguous (B, H, Lq, Dh); k, v, dk, dv: contiguous (B, H, Lk,
// Dh); Dh 64 or 128; key_valid: contiguous (B, Lk) bytes; stats: the
// forward's (B, H, Lq, 2) f32 row max (log2 units) and sum, from a forward
// at the same temperature; rowstats: B * H * Lq * 4 f32 of scratch. dtype:
// 0 = float32, 1 = bfloat16 (q, k, v, g and the gradients). Lq, Lk >= 1;
// every pointer 16-byte aligned. Returns a cudaError_t (0 on success).
extern "C" int fscl_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* key_valid, const void* g, const void* stats,
                                  void* rowstats, void* dq, void* dk, void* dv,
                                  int B, int H, int Lq, int Lk, int Dh, int dtype,
                                  float temperature, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq < 1 || Lk < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  // the forward's scale, so that S log2(e) / temp - m is its scores' bits
  const float scale_log2 = (float)(1.4426950408889634 / (double)temperature);
  const float inv_temp = (float)(1.0 / (double)temperature);
  auto fn = dtype == 0 ? (Dh == 64 ? fscl_attention_bwd_f32_64
                          : Dh == 128 ? fscl_attention_bwd_f32_128 : nullptr)
          : dtype == 1 ? (Dh == 64 ? fscl_attention_bwd_bf16_64
                          : Dh == 128 ? fscl_attention_bwd_bf16_128 : nullptr)
          : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, key_valid, g, stats, rowstats, dq, dk, dv, B, H, Lq, Lk, scale_log2,
                 inv_temp, s);
}

// The score-bits probe (see score_probe_kernel): q, k contiguous (64, 128)
// of dtype 0 = float32 or 1 = bfloat16; s_mma, s_wg, st_wg (64, 64) f32 out.
// One block on `stream`.
extern "C" int fscl_attention_bwd_score_probe(const void* q, const void* k, void* s_mma,
                                              void* s_wg, void* st_wg, int dtype,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out[3] = {static_cast<float*>(s_mma), static_cast<float*>(s_wg),
                   static_cast<float*>(st_wg)};
  static bool allowed[64] = {}, allowed_bf16[64] = {};
  cudaError_t err;
  if (dtype == 0) {
    constexpr int bytes = 4 * Cfg<float, PROBE_DH>::OPERAND + 1024;
    if ((err = allow_smem((const void*)score_probe_kernel, bytes, allowed)) != cudaSuccess)
      return (int)err;
    score_probe_kernel<<<1, 128, bytes, st>>>(static_cast<const float*>(q),
                                              static_cast<const float*>(k), out[0], out[1],
                                              out[2]);
  } else if (dtype == 1) {
    constexpr int bytes = 4 * Cfg<__nv_bfloat16, PROBE_DH>::STAGE + 1024;
    if ((err = allow_smem((const void*)score_probe_bf16_kernel, bytes, allowed_bf16))
        != cudaSuccess)
      return (int)err;
    score_probe_bf16_kernel<<<1, 128, bytes, st>>>(static_cast<const __nv_bfloat16*>(q),
                                                   static_cast<const __nv_bfloat16*>(k), out[0],
                                                   out[1], out[2]);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif
