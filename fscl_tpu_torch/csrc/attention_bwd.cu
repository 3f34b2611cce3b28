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
//   log2 units) and sum l. The forward computes those scores with the
//   header's `scores` (csrc/hopper_attention.cuh) from the same Q fragments
//   and K row planes (split_rows) that launch 1 here recomputes them from:
//   the same TF32 splits (to nearest, ties away from zero), k-steps, passes
//   and a fresh accumulator every 16 columns added to the sum rounded to
//   nearest, so the same bits by construction; the scale and the
//   subtraction unfused in both. Launch 2 takes S^T by the same routine with
//   K as A and the first two passes swapped, which adds the same partial
//   products in the same order: chip_smoke.py phase 8 holds the two
//   orientations to the same bits with fscl_attention_bwd_score_probe. So P
//   = exp2(S log2(e) / temp - m) / l are the forward's weights exactly: a
//   row with one valid key gets the weight 1 there and 0 elsewhere, a row
//   with none 1 / Lk, as the plain version's softmax gives them. The
//   witness end to end is a row with one valid key, whose dk is exactly 0
//   only where its weight is exactly 1: chip_smoke.py's check_backward at
//   every backward shape it holds, and the card tests.
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
// into one sum by the same routine as the forward's bf16 scores, so that
// there too the weights are the forward's exactly. The tensor cores add into
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

#include "hopper_attention.cuh"

#include <limits.h>
#include <math.h>

// Without FSCL_PART (one nvcc for the whole file) every part.
#ifndef FSCL_PART
#define FSCL_PART -1
#endif
#define FSCL_OWNS(part) (FSCL_PART < 0 || FSCL_PART == (part))

namespace {

constexpr int RES = 64;              // a block's resident rows: one wgmma M
constexpr int THREADS = 384;         // the producer warpgroup, then two consumer warpgroups

// Named barriers (0 is __syncthreads): each consumer warpgroup's own, and
// the hand-overs between the two (READY: the data is there, FREE: read).
constexpr int BAR_WG1 = 1, BAR_WG2 = 2, BAR_X_READY = 3, BAR_X_FREE = 4, BAR_Y_READY = 5,
              BAR_Y_FREE = 6, BAR_END = 7, BAR_KT_FREE = 8;

template <typename T, int DH>
struct Cfg : Tiles<T, DH> {
  using B = Tiles<T, DH>;
  static constexpr bool F32 = B::F32;
  static constexpr int HD = DH, NQ = B::NQ, RAW = B::RAW, PLANE = B::PLANE, OPERAND = B::OPERAND;
  static constexpr int STAGE = 2 * RAW + 1024;       // two tiles, then flags or row stats
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
};

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

  if (threadIdx.x == 0) ring.init(32, 8);
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

  if (threadIdx.x == 0) ring.init(32, 8);
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

// 64 rows of q against 64 rows of k (head dim PROBE_DH) by the header's
// `scores` in both orientations: s with q as A and k's row planes as B (the
// forward's scores and launch 1's), st with k as A and q's as B (launch 2's
// S^T; f32: the first two passes swapped), each 32-row half laid out as TMA
// stores a tile and (f32) split by split_rows. chip_smoke.py holds st^T to
// s's bits: a weight exactly 1 in launch 1 is then exactly 1 in launch 2.
constexpr int PROBE_DH = 128;

// rows x PROBE_DH of src as TMA stores a tile: TILE-row halves `half` bytes
// apart, 128-byte column boxes, 16-byte chunks swizzled by row
template <class C, typename T>
__device__ void probe_raw(uint8_t* dst, const T* src, int half) {
  for (int i = threadIdx.x; i < RES * PROBE_DH; i += 128) {
    const int r = i / PROBE_DH, c = i % PROBE_DH, rr = r % TILE, byte = c * C::ES;
    *reinterpret_cast<T*>(dst + (r / TILE) * half + (c / C::BOX) * TILE * 128 + rr * 128
                          + ((((byte >> 4) & 7) ^ (rr & 7)) << 4) + byte % 16) = src[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(128) score_probe_kernel(const T* q, const T* k, float* s_wg,
                                                          float* st_wg) {
  using C = Cfg<T, PROBE_DH>;
  constexpr int HALF = C::RAW + (C::F32 ? C::OPERAND : 0);   // a half as it came, its planes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  probe_raw<C>(smem, k, HALF);
  probe_raw<C>(smem + 2 * HALF, q, HALF);
  __syncthreads();
  if constexpr (C::F32) {
    for (int h = 0; h < 4; ++h) split_rows<C>(smem + h * HALF + C::RAW, smem + h * HALF, threadIdx.x);
    fence_async_smem();
    __syncthreads();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // with q as A, then with k as A (S^T): one RowFrags live at a time
  for (int side = 0; side < 2; ++side) {
    RowFrags<C, T> rf;
    rf.load(side ? k : q, 16 * warp, RES, g, t);
    for (int half = 0; half < 2; ++half) {
      const uint32_t plane = smem_u32(smem + ((side ? 2 : 0) + half) * HALF
                                      + (C::F32 ? C::RAW : 0));
      float s[16];
      if (side) scores<C, true>(s, rf, plane);
      else scores<C, false>(s, rf, plane);
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
}

template <typename T>
cudaError_t launch_probe(const void* q, const void* k, void* s_wg, void* st_wg,
                         cudaStream_t stream) {
  using C = Cfg<T, PROBE_DH>;
  constexpr int bytes = 4 * (C::RAW + (C::F32 ? C::OPERAND : 0)) + 1024;
  static bool allowed[64] = {};
  const cudaError_t err = allow_smem((const void*)score_probe_kernel<T>, bytes, allowed);
  if (err != cudaSuccess) return err;
  score_probe_kernel<T><<<1, 128, bytes, stream>>>(static_cast<const T*>(q),
                                                   static_cast<const T*>(k),
                                                   static_cast<float*>(s_wg),
                                                   static_cast<float*>(st_wg));
  return cudaGetLastError();
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
// of dtype 0 = float32 or 1 = bfloat16; s_wg, st_wg (64, 64) f32 out. One
// block on `stream`.
extern "C" int fscl_attention_bwd_score_probe(const void* q, const void* k, void* s_wg,
                                              void* st_wg, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_probe<float>(q, k, s_wg, st_wg, st);
  if (dtype == 1) return (int)launch_probe<__nv_bfloat16>(q, k, s_wg, st_wg, st);
  return (int)cudaErrorInvalidValue;
}
#endif
