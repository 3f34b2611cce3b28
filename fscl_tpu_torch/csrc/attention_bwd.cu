// Masked attention backward for Hopper (sm_90a), on the tensor cores.
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
// The weights come from the forward (csrc/attention.cu, narrow route): it
// stores each query row's max m (f32, in the log2 units it scores in) and
// sum l, and this file recomputes the forward's scores bit for bit (the same
// TF32 splits, k-steps, passes and 16-column fresh sums; the scale and the
// subtraction unfused in both), so P = exp2(S log2(e) / temp - m) / l are
// the forward's weights exactly: at the row max exp2(0) = 1, a row with one
// valid key gets the weight 1 there and 0 elsewhere, and a row with none
// 1 / Lk, as the plain version's softmax gives them. m and l are kept apart,
// never folded into m + log2 l: a row whose keys are all invalid has m =
// -1e9 log2(e), where the f32 ulp is 128, so the fold would lose log2 Lk
// and give every key the weight 1 instead of 1 / Lk (dV of that row wrong
// by a factor Lk). D is summed from this file's own P * dP (dP^T in launch
// 2 is dP's bits: the transposed product adds the same partial products in
// the same order), so where a row's weight is all on one key its dS there
// is exactly 0, as the plain version's is. D from rowsum(g * O) would differ
// from that key's dP by the products' rounding, and dK of a key that many
// rows attend to would sum those differences over the rows (1.4e-5 at L =
// 512 with one valid key).
//
// Launches:
// 1. dQ and D: a block per (32 query rows, batch * head), 8 warps. Tiles of
//    32 keys of K and V stream with their key flags through a 2-stage
//    cp.async ring, once. The block's rows of Q and g sit in shared memory
//    as pair tiles; each warp computes S and dP for 16 rows x 8 of the
//    tile's keys, stores P and P * dP and sums D. D is known only after the
//    last key, so dQ is taken as (P * dP) K - D (P K): each warp sums one of
//    the two products for 16 rows x half the head dim, and the P K warps
//    hand theirs over at the end. Each row's (m, 1 / l, D) goes out for
//    launch 2.
// 2. dK and dV: a block per (32 keys, batch * head), 8 warps, each with its
//    16 rows of K (warps 0-3) or V (warps 4-7) in registers; tiles of 32
//    query rows of Q and g, with their (m, 1 / l, D), stream through the
//    ring. Per query tile the warps compute S^T = K Q^T and dP^T = V g^T (16
//    keys x 16 queries each), the S^T warps turn them into P and dS^T and
//    store those in shared memory; then dV += P^T g and dK += dS^T Q (each
//    warp 16 keys x a quarter of the head dim).
// Design notes (H100):
// - A dK/dV warp holds its rows of K or V in registers (split into TF32
//   parts at each use, as the forward holds Q); the dQ block, whose warps
//   also hold half of dQ's two products, reads its rows of Q and g from
//   shared memory. Both blocks keep 32 rows: with more, or with the dQ
//   block's rows in registers, ptxas spilled at 255 registers a thread
//   (f32, head dim 128). Also for registers: rows read opaque at each use
//   (RowFrags::bits), bf16 rows packed two to a register, the dQ block's
//   key flags in shared memory with each stage, copy offsets recomputed
//   from the thread and block index.
// - What bounds it: the products run at mma.sync's TF32 rate, about the
//   forward's per product; the rest is per tile: the copies, their split
//   into pairs, the weights, and the barriers between the phases, with one
//   block of 8 warps per SM to overlap them.
// No atomics: dK and dV are owned by their key tile's block, dQ and D by
// their query tile's. Tiles do not depend on B * H, so from the same row
// stats a sample's gradients are the same bits alone and with tasks folded
// into the batch (the vmapped adaptation).
//
// Arithmetic: f32 for both input types. Products on the tensor cores
// (mma.sync m16n8k8 TF32): f32 operands are split as the forward splits
// them (big = tf32(x), small = tf32(x - big), both rounded to nearest with
// ties away from zero; a product is small*big + big*small + big*big). A
// streamed tile lands in shared memory as (big, small) pairs, split once per
// block: the thread that copied a chunk splits it (bf16 chunks are widened
// to f32 pairs with a zero small part, since a bf16 value is exact in TF32).
// A dK/dV warp's rows of K or V, which no other warp reads, are split at
// each use. So a product of two inputs (S, dP) takes three TF32 passes in
// f32 and one in bf16; (P * dP) K, P K and dS^T Q take three in f32 and two
// in bf16. The k-steps of S and dP take the head dim as the forward's
// scores do: k-step 2j + h pairs columns 16j + 4t + 2h and + 1 as k = t and
// t + 4. The tensor cores add into their accumulator with truncation, so
// every sum goes through fresh accumulators added in f32 (round to
// nearest): S and dP every 16 columns of the head dim, dK and dQ's two
// products every k-step of 8 rows, summed per tile, then over the tiles.
// dV = P^T g is summed on the FMA units, one query row after the other in
// ascending order, as the plain version's f32 product does: with one valid
// key, dV of that key sums g over every query row (tens at L = 512), where
// any other order of f32 adds lands several 1e-5 away from cuBLAS's
// sequential sum. Gradients are stored in the input type.
//
// Pair tiles have a row pitch of 2 DH + 8 floats (8 mod 32 words), and the
// 16-byte chunks of odd rows are swapped in pairs (chunk c at c ^ 1): a
// lane (g, t) reading the two pairs at (row g, columns 4t + 2h, + 1) as one
// 16-byte load, or the pair at (row t, column g) as an 8-byte load, as the
// fragments of the two orientations do, touches distinct banks.
//
// The least time on the card: 5 products of 2 Lq Lk Dh operations each per
// (batch, head) in f32 (3 TF32 passes each: 30 Lq Lk Dh over 495 TFLOP/s),
// against q, k, v, g, dq, dk, dv moved once; the design computes S and dP
// twice and P K once more (8 products instead of 5), dV on the FMA units.
//
// Shapes: head dims 64 and 128 (the wrapper pads smaller ones, as the
// forward's does), any Lq and Lk >= 1, any B * H up to INT_MAX blocks.

// Build: ops/cuda_lib.py compiles its 4 (type, head dim) families in four
// parts at once (FSCL_PART, below); part 0 also holds the entry point.
// build parts: 4

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int TILE = 32;             // rows of a streamed tile (keys in the dQ kernel, queries in dK/dV)
constexpr int Q_RES = 32;            // a dQ block's query rows: 2 warps of 16 per product
constexpr int KV_RES = 32;           // a dK/dV block's keys: 2 warps of 16 per product
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SMEM = 227 * 1024; // sm_90's dynamic shared memory per block
constexpr float MASK_FILL_LOG2 = -1e9f * 1.4426950408889634f;   // the forward's

template <typename T, int DH>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int HD = DH;
  static constexpr int LDP = 2 * DH + 8;            // pair tile row pitch (floats), 8 mod 32
  static constexpr int TILE_FLOATS = TILE * LDP;
  static constexpr int LDS = 2 * TILE + 8;          // dS / dS^T pair rows, 8 mod 32
  static constexpr int ROWSTATS = 4;                // a query row's (m, 1 / l, D, 0)
  static constexpr int PER_COPY = 16 / (int)sizeof(T);   // elements per 16-byte copy
  static constexpr int ROW_COPIES = DH / PER_COPY;
  static constexpr int COPIES = TILE * ROW_COPIES / THREADS;   // per thread and tile
  static constexpr int KS = DH / 8;                 // k-steps over the head dim
  static constexpr int LDX = TILE + 8;              // dP exchange rows (floats), 8 mod 32
  // dQ kernel: a warp's phase A block is 16 rows x 8 of the tile's keys
  // (S and dP), its phase B block 16 rows x DH / 2 (Q_NB n-tiles) of one of
  // two products. 2 stages of (K, V, key flags); P * dP and P; the block's
  // rows' (m, 1 / l, D, 0) and D's four parts; its rows of Q and g as pair
  // tiles. At the end P K goes through the idle ring (pitch LDB).
  static constexpr int Q_NB = DH / 16, LDB = DH + 8;
  static constexpr int Q_PS = Q_RES * LDS;
  static constexpr int Q_STAGE = 2 * TILE_FLOATS + TILE / 4;
  static constexpr int Q_BYTES =
      4 * (2 * Q_STAGE + 2 * Q_PS + (ROWSTATS + 4) * Q_RES + 2 * TILE_FLOATS);
  // dK/dV kernel: phase A blocks of 16 keys x 16 queries (KV_NT), phase B
  // 16 keys x DH / 4 of dK (KV_NB n-tiles) and of dV (CW columns a lane).
  // 2 stages of (Q pairs, g pairs, g as it came, the rows' stats); P
  // (queries x keys, f32, pitch LDPT); dS^T; the dP^T exchange
  static constexpr int KV_NT = 2, KV_NB = DH / 32, CW = DH / 32;
  static constexpr int LDG = DH + PER_COPY;         // g rows as they came (elements)
  static constexpr int G_FLOATS = TILE * LDG * (int)sizeof(T) / 4;
  static constexpr int LDPT = KV_RES + 4;
  static constexpr int KV_PT = TILE * LDPT, KV_PS = KV_RES * LDS, KV_XCH = KV_RES * LDX;
  static constexpr int KV_STAGE = 2 * TILE_FLOATS + G_FLOATS + ROWSTATS * TILE;
  static constexpr int KV_BYTES = 4 * (2 * KV_STAGE + KV_PT + KV_PS + KV_XCH);
  static_assert(LDP % 32 == 8 && LDS % 32 == 8 && LDX % 32 == 8 && LDPT % 32 == 4,
                "fragment, exchange and P loads free of bank conflicts");
  static_assert(TILE * ROW_COPIES % THREADS == 0, "whole copies per thread");
  static_assert(Q_RES == 32 && KV_RES == 32 && TILE == 32 && WARPS == 8,
                "the warps' blocks tile the block's rows and keys");
  static_assert(TILE % 16 == 0 && TILE_FLOATS % 4 == 0 && G_FLOATS % 4 == 0 && KV_STAGE % 4 == 0
                && Q_STAGE % 4 == 0 && Q_PS % 4 == 0 && KV_PT % 4 == 0 && KV_PS % 4 == 0
                && KV_XCH % 4 == 0, "16-byte aligned regions");
  static_assert(KV_BYTES <= MAX_SMEM && Q_BYTES <= MAX_SMEM && Q_RES * LDB <= 2 * Q_STAGE,
                "shared memory fits");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b from their (big, small) parts; a small part known to be zero
// (a bf16 input) is skipped: SPLIT_A / SPLIT_B say which are not. The
// passes run small(a) big(b), big(a) small(b), big big, as the forward's
// scores run small(Q) big(K), big(Q) small(K); SWAP runs the first two the
// other way round, so that a transposed product (K as a, Q as b) adds the
// same partial products in the same order.
template <bool SPLIT_A, bool SPLIT_B, bool SWAP = false>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2]) {
  if constexpr (SWAP) {
    if constexpr (SPLIT_B) mma_tf32(d, ab, bs[0], bs[1]);
    if constexpr (SPLIT_A) mma_tf32(d, as, bb[0], bb[1]);
  } else {
    if constexpr (SPLIT_A) mma_tf32(d, as, bb[0], bb[1]);
    if constexpr (SPLIT_B) mma_tf32(d, ab, bs[0], bs[1]);
  }
  mma_tf32(d, ab, bb[0], bb[1]);
}

// The block's and the thread's index, read anew where they are used: the
// stores after the tile loop and the copies of each tile compute their
// offsets from them instead of keeping them live through the loop, where
// at 255 registers (f32, head dim 128) ptxas spilled such offsets.
__device__ __forceinline__ int block_index() {
  int b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

__device__ __forceinline__ int thread_index() {
  int i;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(i));
  return i;
}

__device__ __forceinline__ uint2 ld_pair(const float* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// The float offset in a pair tile row of the 16-byte chunk holding the pairs
// of columns 2c and 2c + 1: odd rows swap their chunks in twos.
__device__ __forceinline__ int chunk_at(int row, int c) {
  return 4 * (c ^ (row & 1));
}

// A fragment (m16n8k8, row major) of a dS pair block with pitch LD (not
// swizzled): rows r0 + g and r0 + g + 8, columns k0 + t and k0 + t + 4.
template <int LD>
__device__ __forceinline__ void frag_a(const float* tile, int r0, int k0, int g, int t,
                                       uint32_t (&big)[4], uint32_t (&small)[4]) {
  const float* p = tile + (r0 + g) * LD + 2 * (k0 + t);
  const uint2 x0 = ld_pair(p), x1 = ld_pair(p + 8 * LD);
  const uint2 x2 = ld_pair(p + 8), x3 = ld_pair(p + 8 * LD + 8);
  big[0] = x0.x; big[1] = x1.x; big[2] = x2.x; big[3] = x3.x;
  small[0] = x0.y; small[1] = x1.y; small[2] = x2.y; small[3] = x3.y;
}

// A fragment of k-step 2j + h (the forward's k-steps) of a pair tile's rows
// r0 + g and r0 + g + 8: columns 16j + 4t + 2h and + 1 as k = t and t + 4,
// one 16-byte load a row.
template <int LD>
__device__ __forceinline__ void frag_a_rows(const float* tile, int r0, int j, int h, int g, int t,
                                            uint32_t (&big)[4], uint32_t (&small)[4]) {
  const int ra = r0 + g, rb = ra + 8;
  const uint4 x = *reinterpret_cast<const uint4*>(tile + ra * LD + chunk_at(ra, 8 * j + 2 * t + h));
  const uint4 y = *reinterpret_cast<const uint4*>(tile + rb * LD + chunk_at(rb, 8 * j + 2 * t + h));
  big[0] = x.x; big[1] = y.x; big[2] = x.z; big[3] = y.z;
  small[0] = x.y; small[1] = y.y; small[2] = x.w; small[3] = y.w;
}

// B fragment of k-step 2j + h whose n index runs along the pair tile's rows
// (Q K^T with K as the tile): n = row n0 + g, k = t and t + 4 the columns
// 16j + 4t + 2h and + 1 (the forward's k-steps), one 16-byte load.
template <int LD>
__device__ __forceinline__ void frag_b_rows(const float* tile, int n0, int j, int h, int g, int t,
                                            uint32_t (&big)[2], uint32_t (&small)[2]) {
  const int row = n0 + g;
  const uint4 x = *reinterpret_cast<const uint4*>(tile + row * LD
                                                  + chunk_at(row, 8 * j + 2 * t + h));
  big[0] = x.x; small[0] = x.y;
  big[1] = x.z; small[1] = x.w;
}

// B fragment whose k index runs along the pair tile's rows: k = rows k0 + t
// and k0 + t + 4 (one parity), n = column n0 + g (dS K with K as the tile).
template <int LD>
__device__ __forceinline__ void frag_b_cols(const float* tile, int k0, int n0, int g, int t,
                                            uint32_t (&big)[2], uint32_t (&small)[2]) {
  const int row = k0 + t, col = n0 + g;
  const float* p = tile + row * LD + chunk_at(row, col >> 1) + 2 * (col & 1);
  const uint2 x0 = ld_pair(p), x1 = ld_pair(p + 4 * LD);
  big[0] = x0.x; big[1] = x1.x;
  small[0] = x0.y; small[1] = x1.y;
}

// Two adjacent f32 values as two split pairs, one 16-byte store.
__device__ __forceinline__ void store_pairs(float* dst, float a, float b) {
  uint4 w;
  split_tf32(a, w.x, w.y);
  split_tf32(b, w.z, w.w);
  *reinterpret_cast<uint4*>(dst) = w;
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// n consecutive elements from p as f32 (n = 2 or 4; p aligned to n elements).
template <int N>
__device__ __forceinline__ void load_f32(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 y = *reinterpret_cast<const float4*>(p);
    x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
  } else {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x; x[1] = y.y;
  }
}

template <int N>
__device__ __forceinline__ void load_f32(float (&x)[N], const __nv_bfloat16* p) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    x[i] = y.x;
    x[i + 1] = y.y;
  }
}

// Where thread tid's u-th 16-byte copy of a tile goes: row r, element c.
template <class C>
__device__ __forceinline__ void copy_slot(int tid, int u, int& r, int& c) {
  const int i = tid + u * THREADS;
  r = i / C::ROW_COPIES;
  c = (i % C::ROW_COPIES) * C::PER_COPY;
}

// Start the copies of rows row0 .. row0 + TILE - 1 of a (rows, DH) matrix
// into a pair tile: each 16-byte chunk of elements c .. lands at 2c of its
// row, where its pairs will go; rows past `rows` are zero-filled.
template <class C, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int rows) {
  const int tid = thread_index();
#pragma unroll
  for (int u = 0; u < C::COPIES; ++u) {
    int r, c;
    copy_slot<C>(tid, u, r, c);
    const bool in = row0 + r < rows;
    cp_async16(dst + r * C::LDP + 2 * c, src + (in ? (size_t)(row0 + r) * C::HD + c : 0), in);
  }
}

// The same rows as they came, at pitch LDG elements.
template <class C, typename T>
__device__ __forceinline__ void load_raw(T* dst, const T* src, int row0, int rows) {
  const int tid = thread_index();
#pragma unroll
  for (int u = 0; u < C::COPIES; ++u) {
    int r, c;
    copy_slot<C>(tid, u, r, c);
    const bool in = row0 + r < rows;
    cp_async16(dst + r * C::LDG + c, src + (in ? (size_t)(row0 + r) * C::HD + c : 0), in);
  }
}

// 16 bytes of row r from element c (f32: 4 values, bf16: 8) as (big, small)
// pairs into the pair tile row `dst`, at their swizzled chunks, which lie
// where the 16 bytes landed (load_tile): f32 pairs of columns c, c + 1 and
// c + 2, c + 3; bf16 (value, 0) pairs, since a bf16 value is exact in TF32.
template <class C>
__device__ __forceinline__ void put_pairs(float* dst, int r, int c, uint4 x) {
  if constexpr (C::F32) {
    uint4 p0, p1;
    split_tf32(__uint_as_float(x.x), p0.x, p0.y);
    split_tf32(__uint_as_float(x.y), p0.z, p0.w);
    split_tf32(__uint_as_float(x.z), p1.x, p1.y);
    split_tf32(__uint_as_float(x.w), p1.z, p1.w);
    *reinterpret_cast<uint4*>(dst + chunk_at(r, c / 2)) = p0;
    *reinterpret_cast<uint4*>(dst + chunk_at(r, c / 2 + 1)) = p1;
  } else {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)   // element 2j in the low half, 2j + 1 in the high
      *reinterpret_cast<uint4*>(dst + chunk_at(r, c / 2 + j)) =
          make_uint4(w[j] << 16, 0u, w[j] & 0xffff0000u, 0u);
  }
}

// Once this thread's copies of a tile have landed (load_tile): each chunk
// into pairs in place.
template <class C>
__device__ __forceinline__ void widen_tile(float* tile) {
  const int tid = thread_index();
#pragma unroll
  for (int u = 0; u < C::COPIES; ++u) {
    int r, c;
    copy_slot<C>(tid, u, r, c);
    float* row = tile + r * C::LDP;
    put_pairs<C>(row, r, c, *reinterpret_cast<const uint4*>(row + 2 * c));
  }
}

// The same from rows that came to `raw` (load_raw).
template <class C, typename T>
__device__ __forceinline__ void widen_raw(float* tile, const T* raw) {
  const int tid = thread_index();
#pragma unroll
  for (int u = 0; u < C::COPIES; ++u) {
    int r, c;
    copy_slot<C>(tid, u, r, c);
    put_pairs<C>(tile + r * C::LDP, r, c, *reinterpret_cast<const uint4*>(raw + r * C::LDG + c));
  }
}

// The unnormalised weight of one (query, key) from the recomputed s (Q K^T,
// unscaled), masked, scaled and offset as the forward's softmax_tile does
// (unfused): exp2(s log2(e) / temp - m), 0 past Lq or Lk.
__device__ __forceinline__ float weight(float s, float m, bool q_in, bool k_in, bool k_ok,
                                        float scale_log2) {
  const float x = k_ok ? __fmul_rn(s, scale_log2) : MASK_FILL_LOG2;
  return q_in && k_in ? exp2f(__fsub_rn(x, m)) : 0.f;
}

// The weight P = weight / l and the score gradient dS = P (dp - D), 0 at an
// invalid key, of one (query, key); inv_l = 1 / l (0 past Lq).
__device__ __forceinline__ void weight_and_grad(float s, float dp, float m, float inv_l, float D,
                                                bool q_in, bool k_in, bool k_ok,
                                                float scale_log2, float& p, float& ds) {
  p = weight(s, m, q_in, k_in, k_ok, scale_log2) * inv_l;
  ds = q_in && k_ok ? p * (dp - D) : 0.f;
}

// A warp's 16 rows (r and r + 8 from row0) of a (rows, DH) input as raw
// m16n8k8 A elements for every k-step, kept in registers for the whole
// block: k-step 2j + h holds (X[r][c], X[r + 8][c], X[r][c + 1], X[r + 8][c
// + 1]) at c = 16j + 4t + 2h (the forward's k-steps), f32 as they are,
// bf16 packed two to a register. Rows past `rows` are 0.
// bits() hands an element over opaque to the compiler, so that the split
// (or the widening) of an element at each use is not hoisted out of the
// tile loop: hoisted, the split parts of all of them take twice the
// registers, and ptxas spilled.
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

template <class C>
struct RowFrags<C, __nv_bfloat16> {
  uint32_t a[C::KS][2];           // (row r, row r + 8) at c, then at c + 1
  __device__ __forceinline__ void load(const __nv_bfloat16* src, int row0, int rows, int g, int t) {
    const __nv_bfloat16* r0 = src + (size_t)(row0 + g) * C::HD + 4 * t;
    const __nv_bfloat16* r1 = r0 + 8 * C::HD;
    const bool ok0 = row0 + g < rows, ok1 = row0 + g + 8 < rows;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      const int c = 16 * (ks / 2) + 2 * (ks % 2);
      // (X[r][c], X[r][c + 1]) and the same of row r + 8
      const uint32_t w0 = ok0 ? *reinterpret_cast<const uint32_t*>(r0 + c) : 0u;
      const uint32_t w1 = ok1 ? *reinterpret_cast<const uint32_t*>(r1 + c) : 0u;
      a[ks][0] = (w0 & 0xffffu) | w1 << 16;
      a[ks][1] = w0 >> 16 | (w1 & 0xffff0000u);
    }
  }
  __device__ __forceinline__ uint32_t bits(int ks, int e) const {   // f32 bits of a bf16 value
    uint32_t w = a[ks][e >> 1];
    asm volatile("" : "+r"(w));
    return e & 1 ? w & 0xffff0000u : w << 16;
  }
};

// s[nt] = (the warp's 16 rows, A fragments from `a_frag`) (rows n0 + 8 nt ..
// + 7 of the pair tile b)^T over the DH columns, nt < NT: S, dP or their
// transposes for 16 rows x 8 NT of the tile's rows. a_frag(j, h, big, small)
// gives k-step 2j + h's A fragment (rows_in_registers, rows_in_tile). Each
// 16 columns' products go into fresh accumulators, added to s rounded to
// nearest: with Q and K, the forward's scores bit for bit (SWAP for K Q^T).
template <class C, int NT, bool SWAP, class AF>
__device__ __forceinline__ void product(float (&s)[NT][4], AF a_frag, const float* b, int n0,
                                        int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int j = 0; j < C::KS / 2; ++j) {
    float f[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[nt][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ab[4], as[4];
      a_frag(j, h, ab, as);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bb[2], bs[2];
        frag_b_rows<C::LDP>(b, n0 + 8 * nt, j, h, g, t, bb, bs);
        mma_split<C::F32, C::F32, SWAP>(f[nt], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += f[nt][e];
  }
}

// A warp's 16 x 8 NT accumulator block into the row-major f32 exchange
// block (pitch LDX) at rows r0 + g (+ 8), columns n0 + 8 nt + 2t (+ 1); and
// the n-tile at column n0 of such a block back, as accumulator elements.
// The A fragments of a warp's rows held in registers (RowFrags), split into
// TF32 parts here, at each use (f32; a bf16 value is exact in TF32).
template <class C, typename T>
__device__ __forceinline__ auto rows_in_registers(const RowFrags<C, T>& rf) {
  return [&rf](int j, int h, uint32_t (&ab)[4], uint32_t (&as)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (C::F32) split_tf32(__uint_as_float(rf.bits(2 * j + h, e)), ab[e], as[e]);
      else ab[e] = rf.bits(2 * j + h, e), as[e] = 0u;
    }
  };
}

// The A fragments of rows r0 .. r0 + 15 of a pair tile (split when it landed).
template <class C>
__device__ __forceinline__ auto rows_in_tile(const float* tile, int r0, int g, int t) {
  return [=](int j, int h, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    frag_a_rows<C::LDP>(tile, r0, j, h, g, t, ab, as);
  };
}

template <class C, int NT>
__device__ __forceinline__ void put_block(float* dst, const float (&s)[NT][4], int r0, int n0,
                                          int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      store2(dst + (r0 + g + 8 * r) * C::LDX + n0 + 8 * nt + 2 * t, s[nt][2 * r],
             s[nt][2 * r + 1]);
}

template <class C>
__device__ __forceinline__ void get_tile(float (&s)[4], const float* src, int r0, int n0, int g,
                                         int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 x = *reinterpret_cast<const float2*>(src + (r0 + g + 8 * r) * C::LDX + n0
                                                      + 2 * t);
    s[2 * r] = x.x;
    s[2 * r + 1] = x.y;
  }
}

// acc += A B over one tile: A the pair block a_blk (P * dP, P or dS^T,
// pitch LDS) at rows r0 .. r0 + 15 and its TILE columns, B the pair tile
// b_tile (K or Q) along its rows, the warp's NB 8-column n-tiles from column
// n0. Each k-step's passes go into fresh accumulators, added rounded to
// nearest into the tile's sum, which is added so into acc: a truncating
// accumulator then never holds more than 8 rows' products.
template <class C, int NB>
__device__ __forceinline__ void accumulate(float (&acc)[NB][4], const float* a_blk,
                                           const float* b_tile, int r0, int n0, int g, int t) {
  constexpr int G = 2;            // n-tiles a pass: the registers of their tile sums
  static_assert(NB % G == 0, "whole groups of n-tiles");
#pragma unroll
  for (int nb0 = 0; nb0 < NB; nb0 += G) {
    float d[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TILE / 8; ++kk) {
      uint32_t ab[4], as[4];
      frag_a<C::LDS>(a_blk, r0, 8 * kk, g, t, ab, as);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        uint32_t bb[2], bs[2];
        frag_b_cols<C::LDP>(b_tile, 8 * kk, n0 + 8 * (nb0 + j), g, t, bb, bs);
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        mma_split<true, C::F32>(f, ab, as, bb, bs);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] += f[e];
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb0 + j][e] += d[j][e];
  }
}

// acc[i][c] += P[q][key] g[q][col] over the tile's TILE query rows q, one
// after the other in ascending order, on the FMA units: the lane's keys
// r0 + 4 (lane / 8) + i, its columns col0 + CW (lane % 8) + c. P: queries x
// keys (pitch LDPT); g as it came (pitch LDG).
template <class C, typename T>
__device__ __forceinline__ void values_grad(float (&acc)[4][C::CW], const float* pm, const T* graw,
                                            int r0, int col0, int lane) {
  const float* pr = pm + r0 + 4 * (lane >> 3);
  const T* gr = graw + col0 + C::CW * (lane & 7);
#pragma unroll 8
  for (int q = 0; q < TILE; ++q) {
    float p[4], x[C::CW];
    load_f32<4>(p, pr + q * C::LDPT);
    load_f32<C::CW>(x, gr + q * C::LDG);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C::CW; ++c) acc[i][c] = fmaf(p[i], x[c], acc[i][c]);
  }
}

// Store a warp's accumulator rows (r_base + g, + 8, below `rows`) times
// `scale` at dst (row pitch DH), columns n0 + 8 nb + 2t, + 1.
template <class C, int NB, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[NB][4], int r_base,
                                           int rows, int n0, float scale, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_base + g + 8 * r;
    if (row >= rows) continue;
    T* d = dst + (size_t)row * C::HD + n0 + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      store2(d + 8 * nb, acc[nb][2 * r] * scale, acc[nb][2 * r + 1] * scale);
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
}

// dQ and D of Q_RES query rows of one (batch, head), and their (m, 1 / l,
// D) for the dK/dV kernel: blocks in x order, the query tile fastest. One
// pass over the key tiles. Phase A: warp (wr, wk) computes S = Q K^T and dP
// = g V^T for 16 query rows (16 wr ..) x 8 of the tile's keys (8 wk ..), the
// block's rows of Q and g as pair tiles in shared memory (in registers they
// took the 255 a thread may hold), and stores P * dP and P (0 at invalid
// keys, where dS is 0) and adds P * dP into D. Phase B: warp (wr, wp, wc)
// adds 16 rows x DH / 2 columns of (P * dP) K (wp = 0) or P K (wp = 1). At
// the end the P K warps store theirs in the idle ring and the others take
// dQ = ((P * dP) K - D (P K)) / temp.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const uint8_t* __restrict__ key_valid, const T* __restrict__ g,
                       const float* __restrict__ stats, float* __restrict__ rowstats,
                       T* __restrict__ dq, int H, int Lq, int Lk, int q_tiles, float scale_log2,
                       float inv_temp) {
  using C = Cfg<T, DH>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                         // 2 stages of (K, V) pair tiles, key flags
  float* esm = ring + 2 * C::Q_STAGE;         // P * dP: queries x keys, pairs
  float* psm = esm + C::Q_PS;                 // P
  float* rs = psm + C::Q_PS;                  // the rows' (m, 1 / l, D, 0)
  float* dsum = rs + C::ROWSTATS * Q_RES;     // the rows' D over each warp's 8 keys
  float* qrows = dsum + 4 * Q_RES;            // the block's rows of Q, then of g: pairs

  const int bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * Q_RES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gl = lane / 4, t = lane % 4;
  // 16 rows; phase A's 8 keys; phase B's product and half of DH
  const int wr = warp & 1, wk = warp >> 1, wp = (warp >> 1) & 1, wc = warp >> 2;
  const int r0 = 16 * wr, n0 = 8 * wk;
  const int k_tiles = (Lk + TILE - 1) / TILE;

  // thread i < TILE's key flag of tile `it` (0 past Lk); loaded a tile ahead
  // of the stage it is stored into, so that its latency is hidden
  auto flag_of = [&](int it) -> uint8_t {
    const int i = thread_index(), key = it * TILE + i;
    return i < TILE && key < Lk ? key_valid[(size_t)(block_index() / q_tiles / H) * Lk + key] : 0;
  };
  // a stage: K and V pair tiles (offsets from the block index), the flags
  auto load_stage = [&](int it, uint8_t flag) {
    float* st = ring + (it & 1) * C::Q_STAGE;
    const size_t kv_base = (size_t)(block_index() / q_tiles) * Lk * DH;
    load_tile<C>(st, k + kv_base, it * TILE, Lk);
    load_tile<C>(st + C::TILE_FLOATS, v + kv_base, it * TILE, Lk);
    uint8_t* flags = reinterpret_cast<uint8_t*>(st + 2 * C::TILE_FLOATS);
    if (thread_index() < TILE) flags[thread_index()] = flag;
  };
  load_tile<C>(qrows, q + (size_t)bh * Lq * DH, row0, Lq);
  load_tile<C>(qrows + C::TILE_FLOATS, g + (size_t)bh * Lq * DH, row0, Lq);
  load_stage(0, flag_of(0));
  cp_async_commit();
  uint8_t flag_ahead = flag_of(1);
  if (threadIdx.x < Q_RES) {   // the rows' (m, 1 / l); past Lq 0: weights 0
    const int i = threadIdx.x, row = row0 + i;
    float m = 0.f, inv_l = 0.f;
    if (row < Lq) {
      const float2 ml = *reinterpret_cast<const float2*>(stats + ((size_t)bh * Lq + row) * 2);
      m = ml.x;
      inv_l = 1.f / ml.y;
    }
    rs[4 * i] = m;
    rs[4 * i + 1] = inv_l;
  }
  cp_async_wait_all();
  widen_tile<C>(qrows);
  widen_tile<C>(qrows + C::TILE_FLOATS);   // seen by all after the loop's first barrier
  const auto q_frags = rows_in_tile<C>(qrows, r0, gl, t);
  const auto g_frags = rows_in_tile<C>(qrows + C::TILE_FLOATS, r0, gl, t);

  float d_part[2] = {0.f, 0.f};               // D of rows g, g + 8 over this lane's keys
  float acc[C::Q_NB][4];                      // (P * dP) K or P K
  zero(acc);

  for (int it = 0; it < k_tiles; ++it) {
    float* st = ring + (it & 1) * C::Q_STAGE;
    const float* ks = st;
    const float* vs = st + C::TILE_FLOATS;
    const uint8_t* flags = reinterpret_cast<const uint8_t*>(st + 2 * C::TILE_FLOATS) + n0;
    cp_async_wait_all();        // this thread's copies of tile it
    widen_tile<C>(st);
    widen_tile<C>(st + C::TILE_FLOATS);
    __syncthreads();              // everyone's, widened; everyone is done with tile it - 1
    if (it + 1 < k_tiles) {       // into tile it - 1's stage
      load_stage(it + 1, flag_ahead);
      flag_ahead = flag_of(it + 2);
    }
    cp_async_commit();

    // phase A: S and dP of the warp's 16 rows x 8 keys, then P * dP and P;
    // element x: query row g + 8 (x / 2), key n0 + 2t + x % 2
    float sc[1][4], dp[1][4];
    product<C, 1, false>(sc, q_frags, ks, n0, gl, t);
    product<C, 1, false>(dp, g_frags, vs, n0, gl, t);
    float p[4], e[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = x >> 1;
      const float* rsq = rs + 4 * (r0 + gl + 8 * r);
      const int key = n0 + 2 * t + (x & 1);
      // dS is 0 at an invalid key: there P * dP and P count for nothing (a
      // row with no valid key gets dQ = 0, its D unused); rows past Lq have
      // 1 / l = 0
      p[x] = flags[2 * t + (x & 1)] != 0
          ? weight(sc[0][x], rsq[0], true, it * TILE + key < Lk, true, scale_log2) * rsq[1]
          : 0.f;
      e[x] = p[x] * dp[0][x];
      d_part[r] += e[x];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (r0 + gl + 8 * r) * C::LDS + 2 * (n0 + 2 * t);
      store_pairs(esm + off, e[2 * r], e[2 * r + 1]);
      store_pairs(psm + off, p[2 * r], p[2 * r + 1]);
    }
    __syncthreads();              // P * dP and P whole
    // phase B: the warp's 16 queries x DH / 2 columns of its product
    accumulate<C>(acc, wp ? psm : esm, ks, r0, wc * (DH / 2), gl, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {   // D over the warp's keys: the lanes' sums
    d_part[r] += __shfl_xor_sync(0xffffffffu, d_part[r], 1);
    d_part[r] += __shfl_xor_sync(0xffffffffu, d_part[r], 2);
    if (t == 0) dsum[4 * (r0 + gl + 8 * r) + wk] = d_part[r];
  }
  __syncthreads();                // every warp's D; the ring idle
  float* pk = ring;                           // P K: rows x DH, pitch LDB
  const int col0 = wc * (DH / 2) + 2 * t;
  if (wp) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nb = 0; nb < C::Q_NB; ++nb)
        store2(pk + (r0 + gl + 8 * r) * C::LDB + col0 + 8 * nb, acc[nb][2 * r],
               acc[nb][2 * r + 1]);
  }
  if (threadIdx.x < Q_RES) {      // D; the rows' (m, 1 / l, D) out
    const int i = threadIdx.x;
    const float D = (dsum[4 * i] + dsum[4 * i + 1]) + (dsum[4 * i + 2] + dsum[4 * i + 3]);
    if (row0 + i < Lq)
      *reinterpret_cast<float4*>(rowstats + ((size_t)bh * Lq + row0 + i) * 4) =
          make_float4(rs[4 * i], rs[4 * i + 1], D, 0.f);
    rs[4 * i + 2] = D;
  }
  __syncthreads();                // D and P K whole
  if (wp) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gl + 8 * r;
    const float D = rs[4 * row + 2];
#pragma unroll
    for (int nb = 0; nb < C::Q_NB; ++nb) {
      const float2 b = *reinterpret_cast<const float2*>(pk + row * C::LDB + col0 + 8 * nb);
      acc[nb][2 * r] = fmaf(-D, b.x, acc[nb][2 * r]);
      acc[nb][2 * r + 1] = fmaf(-D, b.y, acc[nb][2 * r + 1]);
    }
  }
  const int b_end = block_index();
  store_rows<C>(dq + (size_t)(b_end / q_tiles) * Lq * DH, acc, (b_end % q_tiles) * Q_RES + r0,
                Lq, wc * (DH / 2), inv_temp, gl, t);
}

// dK and dV of KV_RES keys of one (batch, head): blocks in x order, the key
// tile fastest. Per query tile, phase A: warps 0-3 compute S^T = K Q^T, warps
// 4-7 dP^T = V g^T, each for 16 keys (16 wk ..) x 16 queries (16 qh ..), with
// its rows of K or V in registers; the dP^T warps hand dP^T over, and the S^T
// warps store P and dS^T. Phase B: warp (wk, wd) adds 16 keys x DH / 4
// columns of P^T g into dV (FMA units) and of dS^T Q into dK.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const uint8_t* __restrict__ key_valid, const T* __restrict__ g,
                        const float* __restrict__ rowstats, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Lq, int Lk, int key_tiles,
                        float scale_log2, float inv_temp) {
  using C = Cfg<T, DH>;
  constexpr int NT = C::KV_NT;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                         // 2 stages of (Q, g pairs, g, (m, 1 / l, D))
  float* pm = ring + 2 * C::KV_STAGE;         // P: queries x keys, f32
  float* dst = pm + C::KV_PT;                 // dS^T: keys x queries, pairs
  float* xch = dst + C::KV_PS;                // dP^T: keys x queries, f32

  const int bh = blockIdx.x / key_tiles;
  const int key0 = (blockIdx.x % key_tiles) * KV_RES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gl = lane / 4, t = lane % 4;
  const bool s_warp = warp < 4;               // phase A: S^T (K in registers) or dP^T (V)
  // 16 keys; phase A's 16 queries; phase B's quarter of DH
  const int wk = warp & 1, qh = (warp >> 1) & 1, wd = warp >> 1;
  const int r0 = 16 * wk, n0 = 16 * qh;
  const size_t q_base = (size_t)bh * Lq * DH, kv_base = (size_t)bh * Lk * DH;
  const T* qb = q + q_base;
  const T* gb = g + q_base;
  const float* rb = rowstats + (size_t)bh * Lq * 4;
  const uint8_t* kv = key_valid + (size_t)(bh / H) * Lk;
  const int q_tiles = (Lq + TILE - 1) / TILE;

  auto load_stage = [&](int it) {
    float* st = ring + (it & 1) * C::KV_STAGE;
    load_tile<C>(st, qb, it * TILE, Lq);
    load_raw<C>(reinterpret_cast<T*>(st + 2 * C::TILE_FLOATS), gb, it * TILE, Lq);
    const int i = threadIdx.x, row = it * TILE + i;   // the rows' (m, 1 / l, D, 0)
    if (i < TILE)
      cp_async16(st + 2 * C::TILE_FLOATS + C::G_FLOATS + 4 * i, rb + (row < Lq ? 4 * row : 0),
                 row < Lq);
  };
  load_stage(0);
  cp_async_commit();
  RowFrags<C, T> rows;
  rows.load((s_warp ? k : v) + kv_base, key0 + r0, Lk, gl, t);

  // the lane's keys in phase A: rows g and g + 8 of its warp's 16
  bool k_in[2], k_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r0 + gl + 8 * r;
    k_in[r] = key < Lk;
    k_ok[r] = k_in[r] && kv[key] != 0;
  }
  float acc_k[C::KV_NB][4], acc_v[4][C::CW];
  zero(acc_k);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::CW; ++c) acc_v[i][c] = 0.f;

  for (int it = 0; it < q_tiles; ++it) {
    float* st = ring + (it & 1) * C::KV_STAGE;
    const float* qs = st;
    const float* gs = st + C::TILE_FLOATS;
    const T* graw = reinterpret_cast<const T*>(st + 2 * C::TILE_FLOATS);
    const float* rs = st + 2 * C::TILE_FLOATS + C::G_FLOATS;
    cp_async_wait_all();        // this thread's copies of query tile it
    widen_tile<C>(st);
    widen_raw<C>(st + C::TILE_FLOATS, graw);
    __syncthreads();              // everyone's, widened; everyone is done with tile it - 1
    if (it + 1 < q_tiles) load_stage(it + 1);   // into the stage tile it - 1 used
    cp_async_commit();

    // phase A: S^T or dP^T of the warp's 16 keys x 16 queries; dP^T handed over
    float s[NT][4];
    product<C, NT, true>(s, rows_in_registers(rows), s_warp ? qs : gs, n0, gl, t);
    if (!s_warp) put_block<C, NT>(xch, s, r0, n0, gl, t);
    __syncthreads();              // dP^T whole
    if (s_warp) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float dp[4], p[4], ds[4];
        get_tile<C>(dp, xch, r0, n0 + 8 * nt, gl, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // element e: key row g + 8 (e / 2), query n0 + 8 nt + 2t + e % 2
          const int qi = n0 + 8 * nt + 2 * t + (e & 1);
          weight_and_grad(s[nt][e], dp[e], rs[4 * qi], rs[4 * qi + 1], rs[4 * qi + 2],
                          it * TILE + qi < Lq, k_in[e >> 1], k_ok[e >> 1], scale_log2, p[e],
                          ds[e]);
          pm[qi * C::LDPT + r0 + gl + 8 * (e >> 1)] = p[e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store_pairs(dst + (r0 + gl + 8 * r) * C::LDS + 2 * (n0 + 8 * nt + 2 * t), ds[2 * r],
                      ds[2 * r + 1]);
      }
    }
    __syncthreads();              // P and dS^T whole
    // phase B: the warp's 16 keys x DH / 4 columns
    values_grad<C>(acc_v, pm, graw, r0, wd * (DH / 4), lane);
    accumulate<C>(acc_k, dst, qs, r0, wd * (DH / 4), gl, t);
  }
  const int b_end = block_index();
  const size_t out_base = (size_t)(b_end / key_tiles) * Lk * DH;
  const int out_key0 = (b_end % key_tiles) * KV_RES + r0;
  store_rows<C>(dk + out_base, acc_k, out_key0, Lk, wd * (DH / 4), inv_temp, gl, t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = out_key0 + 4 * (lane >> 3) + i;
    if (key >= Lk) continue;
    T* d = dv + out_base + (size_t)key * DH + wd * (DH / 4) + C::CW * (lane & 7);
#pragma unroll
    for (int c = 0; c < C::CW; c += 2) store2(d + c, acc_v[i][c], acc_v[i][c + 1]);
  }
}

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
  const long long q_tiles = (Lq + Q_RES - 1) / Q_RES, k_tiles = (Lk + KV_RES - 1) / KV_RES;
  if (bh * q_tiles > INT_MAX || bh * k_tiles > INT_MAX) return cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);
  const uint8_t* kvalid = static_cast<const uint8_t*>(key_valid);
  float* rstats = static_cast<float*>(rowstats);
  q_kernel<<<(int)(bh * q_tiles), THREADS, C::Q_BYTES, s>>>(
      tq, tk, tv, kvalid, tg, static_cast<const float*>(stats), rstats,
      static_cast<T*>(dq), H, Lq, Lk, (int)q_tiles, scale_log2, inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_kernel<<<(int)(bh * k_tiles), THREADS, C::KV_BYTES, s>>>(
      tq, tk, tv, kvalid, tg, rstats, static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk,
      (int)k_tiles, scale_log2, inv_temp);
  return cudaGetLastError();
}

}  // namespace

// The (type, head dim) families, each compiled in one build part; without
// FSCL_PART (one nvcc for the whole file) every family and the entry point.
#ifndef FSCL_PART
#define FSCL_PART -1
#endif
#define FSCL_OWNS(part) (FSCL_PART < 0 || FSCL_PART == (part))
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
// 0 = float32, 1 = bfloat16 (q, k, v, g and the gradients). Lq, Lk >= 1.
// Returns a cudaError_t (0 on success).
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
#endif
