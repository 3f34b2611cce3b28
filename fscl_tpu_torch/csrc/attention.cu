// Masked attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel fscl_tpu/ops/attention.py:_attn_kernel (launched by
// pallas_attention). Per (batch, head), Lq query rows against Lk keys (self-
// attention has Lq == Lk; the sequence-parallel upstream attends a rank's
// T / S query frames to all T gathered keys, the shape the JAX package sends
// to XLA): scores = Q K^T / temperature in f32,
// keys with key_valid == 0 filled with the finite -1e9 (so a row with no
// valid key gets uniform weights, the mean of V, never NaN), a row softmax,
// then weights . V accumulated in f32, cast to the input type on store.
//
// What bounds it on the card: 4 * Lq * Lk * Dh operations per (batch, head)
// against (2 Lq + 2 Lk) * Dh elements moved, so at the lengths this model
// serves (L >= 128) operations bound it, by route:
// - bf16: bf16 x bf16 -> f32 products on the tensor cores (989 TFLOP/s).
//   The unnormalised weights P are rounded to bf16 to be the A operand of
//   P V, as xla_attention (fscl_tpu/ops/attention.py:40) rounds its weights
//   to V's type; that is the path the JAX package takes in bf16 (HuBERT's
//   64-wide heads never reach the Pallas kernel). _attn_kernel and the plain
//   version keep the weights in f32, so in bf16 this kernel differs from them
//   by up to a few bf16 ulps of the output, more than the f32-FMA design of
//   this file did; the bf16 bar (atol = rtol = 1e-2) holds it.
// - f32, by split TF32 ("3xTF32"): one TF32 product keeps 11 significant bits,
//   too few for the 2e-5 bar. Each f32 operand x is split into big = tf32(x)
//   and small = tf32(x - big), both rounded to nearest with ties away from
//   zero (the rounding of cvt.rna.tf32.f32, done here with two integer
//   operations, which run faster than the conversion), and each product
//   is taken as small*big + big*small + big*big on the TF32 tensor cores,
//   accumulated in f32; the dropped small*small term is below 2^-22
//   relative. Three TF32 products per f32 product bound it at
//   3 * 4 * Lq * Lk * Dh over 495 TFLOP/s, 2.5x below the f32 FMA units.
//
// Two routes. Head dims 64 and 128 (the wrapper pads smaller ones) take the
// narrow route, the FlashAttention-2 layout on mma.sync:
// - A block of warps owns a tile of query rows; each warp owns 16 of them and
//   keeps its Q fragments in registers for the whole key loop. S = Q K^T and
//   O += P V accumulate in f32 registers with mma.sync (m16n8k16 bf16,
//   m16n8k8 tf32). With `stats` (training) f32 S goes into a fresh
//   accumulator every 16 columns of the head dim (scores_tf32), whose bits
//   the backward kernel recomputes, and each row's max and sum go out for
//   it (`finish`). The online
//   softmax runs on the S accumulator in registers
//   (row max and sum across the 4 lanes of a quad), and P goes from the S
//   accumulator into the A operand of P V without touching shared memory.
//   mma.sync rather than wgmma: its fragments belong to one warp, so all of
//   this needs no warpgroup synchronisation or shared-memory descriptors;
//   wgmma, the road to the full tensor-core rate, is left for later.
// - K and V stream through a ring of STAGES shared-memory stages filled by
//   cp.async: the next tiles land while this one is computed, and one block
//   barrier per tile is the ring's only handshake. Shared-memory rows are
//   padded so that every fragment load is free of bank conflicts. Each stage
//   also holds its keys' flags, so shared memory does not grow with Lk.
// - f32: splitting costs integer and float instructions, not tensor-core
//   time, so each K and V element is split once per block, not once per warp:
//   the thread that copied a chunk splits it in place once it has landed
//   (K into big and small tiles, V into (big, small) pairs), before the
//   tile's barrier. A block has 8 warps (128 query rows) so that each split
//   feeds 8 warps; the ring then fills one block per SM. The head dimension
//   is permuted within each 16 (the same way in Q and K, so the dot product is
//   unchanged) so that a lane's A or B elements of two k-steps are 4 adjacent
//   floats, one 16-byte load; the keys are permuted within each 8 the same
//   way in P and V, so that the tf32 S accumulator is the A operand of P V as
//   it stands.
// - bf16: 4 warps (64 query rows), two blocks per SM; ldmatrix for K,
//   ldmatrix.trans for V, and the standard accumulator-to-A repacking.
//
// Head dims above 128 (the wrapper pads them to a multiple of 64; there is no
// upper one) take the wide route. A warp's Q and O at such widths would not
// fit in the 255 registers a thread may hold (at 256, 1.2-2.4 KB spilled in
// an earlier design), so no warp holds either whole:
// - A block owns a query tile and one 128-wide slice of O's columns (the last
//   slice may hold 64); the slices are blocks of their own.
// - For each key tile, S = Q K^T is accumulated over the head dim in 64-wide
//   chunks: each Q chunk and K chunk streams through the cp.async ring as one
//   stage, Q read by each warp from shared memory for its 16 rows. Then one
//   stage brings the tile's V slice, and the online softmax and O_slice += P
//   V_slice run as on the narrow route, with the same arithmetic (split TF32
//   with K and V split once per block, Q per warp as it is read; bf16 P).
// - Each slice recomputes S: (Dh / 128 + 1) / 2 times the minimal operations
//   (1.5x at 256, 2.5x at 512), and Q is read again for every key tile; the
//   registers a warp holds are those of the narrow route at head dim 128.
//
// Grid (both routes): one block per (batch * head, query tile, slice), in one
// x index with the slice fastest, then the query tile, so that blocks that
// share K and V run together. Where full query tiles give too few blocks for
// the card (short Lq), the block's warps also split
// the key loop (key_split 2 or 4: each warp a slice of every key tile, the
// block 1/2 or 1/4 as many query rows) and merge their softmax states
// through shared memory at the end.
//
// Keys past Lk (the ragged edge of the last tile) get weight 0: score -inf and
// zero-filled K and V rows. Keys inside Lk that are masked take the -1e9 fill,
// exactly as the reference does. Scores are held in log2 units (scaled by
// log2(e) / temperature) for exp2. Query rows past Lq are computed on zeros and
// not stored.

// Build: ops/cuda_lib.py compiles its 18 instances in three parts at once,
// one set of (type, route) families each (FSCL_PART, below).
// build parts: 3

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int STAGES = 3;            // ring depth
constexpr int MAX_SMEM = 227 * 1024; // sm_90's dynamic shared memory per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_FILL_LOG2 = -1e9f * LOG2E;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The narrow route, head dim DH (64 or 128).
template <typename T, int DH, int SPLIT>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int WARPS = F32 ? 8 : 4;         // ops/attention.py QUERY_ROWS = 16 * WARPS
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = F32 ? 1 : 2;      // per SM
  static constexpr int WM = WARPS / SPLIT;            // warps along the queries
  static constexpr int BLOCK_M = 16 * WM;             // query rows per block
  static constexpr int STAGE_KEYS = F32 ? 32 : 64;    // keys per ring stage
  static constexpr int BN = STAGE_KEYS / SPLIT;       // keys per warp per stage
  // Row pitches (elements). f32 K (big and small tiles): 16-byte loads by
  // lanes (g, t) at g * LDK + 4t, conflict-free for LDK = 16 mod 32 words.
  // f32 V, (big, small) pairs: 8-byte loads at rows 2t (+1), pair g,
  // conflict-free for a pitch of 2 mod 8 pairs. bf16: the 8 rows of an
  // ldmatrix 8x8 tile 16 bytes apart modulo 128.
  static constexpr int LDK = F32 ? DH + 16 : DH + 8;
  static constexpr int LDV = F32 ? 2 * (DH + 2) : DH + 8;
  static constexpr int K_ELEMS = STAGE_KEYS * LDK;
  static constexpr int V_OFFSET = (F32 ? 2 : 1) * K_ELEMS;   // after K (and its small parts)
  static constexpr int STAGE_ELEMS = V_OFFSET + STAGE_KEYS * LDV;
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int SMEM_BYTES = RING_BYTES + STAGES * STAGE_KEYS;   // and the key flags
  static constexpr int CHUNKS = DH * (int)sizeof(T) / 16;   // 16-byte chunks per row
  static constexpr int COPIES = STAGE_KEYS * CHUNKS / THREADS;   // per thread, K and V each
  // the key-split merge: o fragments, m and l of each non-leading warp
  static constexpr int MERGE_FLOATS = DH / 2 + 4;
  // f32 P V (weighted_values): key tiles summed into o directly, and past
  // them in fresh accumulators of PV_GROUP 8-column n-tiles at a time
  static constexpr int DIRECT_TILES = 1024 / STAGE_KEYS;
  static constexpr int PV_GROUP = DH == 64 ? 8 : 4;
  static_assert(BN % (F32 ? 8 : 16) == 0, "a warp's key slice is whole k-steps");
  static_assert(STAGE_KEYS * CHUNKS % THREADS == 0, "whole copies per thread");
  static_assert((K_ELEMS * (int)sizeof(T)) % 16 == 0 && (STAGE_ELEMS * (int)sizeof(T)) % 16 == 0,
                "ring stages stay 16-byte aligned");
  static_assert(WARPS * 32 * MERGE_FLOATS * 4 <= RING_BYTES, "merge fits in the ring");
  static_assert(SMEM_BYTES <= MAX_SMEM, "the ring and its key flags fit");
};

// The wide route: any head dim that is a multiple of CHUNK, in slices of O.
template <typename T, int SPLIT>
struct WideCfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int CHUNK = 64;                    // head-dim columns per score stage
  static constexpr int SLICE = 128;                   // O columns per block
  static constexpr int WARPS = F32 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = F32 ? 1 : 2;
  static constexpr int WM = WARPS / SPLIT;
  static constexpr int BLOCK_M = 16 * WM;
  static constexpr int STAGE_KEYS = F32 ? 32 : 64;
  static constexpr int BN = STAGE_KEYS / SPLIT;
  // K and Q chunks share a pitch (the narrow route's at head dim 64), V
  // slices the narrow route's at 128
  static constexpr int LDK = F32 ? CHUNK + 16 : CHUNK + 8;
  static constexpr int LDV = F32 ? 2 * (SLICE + 2) : SLICE + 8;
  static constexpr int K_ELEMS = STAGE_KEYS * LDK;
  static constexpr int Q_OFFSET = (F32 ? 2 : 1) * K_ELEMS;   // after K (and its small parts)
  static constexpr int SCORE_ELEMS = Q_OFFSET + BLOCK_M * LDK;
  static constexpr int STAGE_ELEMS = cmax(SCORE_ELEMS, STAGE_KEYS * LDV);
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int SMEM_BYTES = RING_BYTES + STAGES * STAGE_KEYS;
  static constexpr int PER_COPY = 16 / (int)sizeof(T);           // elements per 16-byte copy
  static constexpr int CHUNK_COPIES = CHUNK / PER_COPY;          // per row of a chunk
  static constexpr int SLICE_COPIES = SLICE / PER_COPY;
  static constexpr int K_COPIES = STAGE_KEYS * CHUNK_COPIES / THREADS;   // per thread
  static constexpr int Q_COPIES = BLOCK_M * CHUNK_COPIES / THREADS;
  static constexpr int V_COPIES = STAGE_KEYS * SLICE_COPIES / THREADS;
  static constexpr int MERGE_FLOATS = SLICE / 2 + 4;
  static constexpr int PV_GROUP = 4;
  static_assert(BN % (F32 ? 8 : 16) == 0, "a warp's key slice is whole k-steps");
  static_assert(STAGE_KEYS * CHUNK_COPIES % THREADS == 0 && BLOCK_M * CHUNK_COPIES % THREADS == 0
                && STAGE_KEYS * SLICE_COPIES % THREADS == 0, "whole copies per thread");
  static_assert((K_ELEMS * (int)sizeof(T)) % 16 == 0 && (Q_OFFSET * (int)sizeof(T)) % 16 == 0
                && (STAGE_ELEMS * (int)sizeof(T)) % 16 == 0, "ring stages stay 16-byte aligned");
  static_assert(WARPS * 32 * MERGE_FLOATS * 4 <= RING_BYTES, "merge fits in the ring");
  static_assert(SMEM_BYTES <= MAX_SMEM, "the ring and its key flags fit");
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b for f32 a, b given as their TF32 splits; small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A warp's 16 query rows as mma A fragments, kept for the whole key loop
// (narrow route). f32 (raw, split per use): for the k-step pair j, lane
// (g, t) holds Q[g][16j + 4t .. +3] in a[j] and Q[g + 8][...] in b[j].
// bf16: the m16n8k16 A fragment of each k-step.
template <typename T, int DH> struct QFrag;

template <int DH>
struct QFrag<float, DH> {
  float a[DH / 16][4], b[DH / 16][4];
  __device__ __forceinline__ void load(const float* q, int row, int Lq, int g, int t) {
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      const float4 x = row + g < Lq ? *reinterpret_cast<const float4*>(q + (size_t)(row + g) * DH + 16 * j + 4 * t)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 y = row + g + 8 < Lq
          ? *reinterpret_cast<const float4*>(q + (size_t)(row + g + 8) * DH + 16 * j + 4 * t)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      a[j][0] = x.x; a[j][1] = x.y; a[j][2] = x.z; a[j][3] = x.w;
      b[j][0] = y.x; b[j][1] = y.y; b[j][2] = y.z; b[j][3] = y.w;
    }
  }
};

template <int DH>
struct QFrag<__nv_bfloat16, DH> {
  uint32_t a[DH / 16][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* q, int row, int Lq, int g, int t) {
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(q + (size_t)(row + g) * DH);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(q + (size_t)(row + g + 8) * DH);
    const bool ok0 = row + g < Lq, ok1 = row + g + 8 < Lq;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      a[ks][0] = ok0 ? r0[8 * ks + t] : 0u;
      a[ks][1] = ok1 ? r1[8 * ks + t] : 0u;
      a[ks][2] = ok0 ? r0[8 * ks + t + 4] : 0u;
      a[ks][3] = ok1 ? r1[8 * ks + t + 4] : 0u;
    }
  }
};

// Where the thread's u-th 16-byte copy of a block of rows `per_row` copies
// wide goes: row r, element c.
template <class C>
__device__ __forceinline__ void copy_slot(int u, int per_row, int& r, int& c) {
  const int i = threadIdx.x + u * C::THREADS;
  r = i / per_row;
  c = (i % per_row) * (16 / (C::F32 ? 4 : 2));
}

// Start the copies of key tile `tile` into the stage at `st`. f32 V lands at
// 2c in its pair row, where its (big, small) pairs will go.
template <class C, typename T>
__device__ __forceinline__ void load_stage(T* st, const T* kb, const T* vb, int tile, int Lk,
                                           int head_dim) {
  const int n0 = tile * C::STAGE_KEYS;
#pragma unroll
  for (int u = 0; u < C::COPIES; ++u) {
    int r, c;
    copy_slot<C>(u, C::CHUNKS, r, c);
    const bool in = n0 + r < Lk;
    const size_t off = in ? (size_t)(n0 + r) * head_dim + c : 0;
    cp_async16(st + r * C::LDK + c, kb + off, in);
    cp_async16(st + C::V_OFFSET + r * C::LDV + (C::F32 ? 2 * c : c), vb + off, in);
  }
}

// f32: split 4 landed floats in place. K: big over the raw floats, small
// K_ELEMS further on.
template <int K_ELEMS>
__device__ __forceinline__ void split_k(float* kp) {
  const float4 x = *reinterpret_cast<const float4*>(kp);
  uint4 big, small;
  split_tf32(x.x, big.x, small.x);
  split_tf32(x.y, big.y, small.y);
  split_tf32(x.z, big.z, small.z);
  split_tf32(x.w, big.w, small.w);
  *reinterpret_cast<uint4*>(kp) = big;
  *reinterpret_cast<uint4*>(kp + K_ELEMS) = small;
}

// V: 4 raw floats at 2c become 4 (big, small) pairs at 2c .. 2c + 7 (no other
// copy lands there).
__device__ __forceinline__ void split_v(float* vp) {
  const float4 y = *reinterpret_cast<const float4*>(vp);
  uint4 p0, p1;
  split_tf32(y.x, p0.x, p0.y);
  split_tf32(y.y, p0.z, p0.w);
  split_tf32(y.z, p1.x, p1.y);
  split_tf32(y.w, p1.z, p1.w);
  *reinterpret_cast<uint4*>(vp) = p0;
  *reinterpret_cast<uint4*>(vp + 4) = p1;
}

// f32: split this thread's landed copies of a narrow stage in place.
template <class C>
__device__ __forceinline__ void split_stage(float* st) {
#pragma unroll
  for (int u = 0; u < C::COPIES; ++u) {
    int r, c;
    copy_slot<C>(u, C::CHUNKS, r, c);
    split_k<C::K_ELEMS>(st + r * C::LDK + c);
    split_v(st + C::V_OFFSET + r * C::LDV + 2 * c);
  }
}

// s[nt] += Q K^T for the warp's key slice, over NJ k-step pairs (16 columns
// each): the big K tile at kt, the small one K_ELEMS on. The A fragments of
// pair j come from `qa(j, x, y)`, which gives row g's and row g + 8's four
// floats. FRESH: each pair's products go into a fresh accumulator, added to
// s[nt] rounded to nearest (the tensor cores' truncating adds then never
// hold more than 16 columns): the wide route, and the narrow route when it
// writes `stats`, whose scores the backward kernel (csrc/attention_bwd.cu)
// recomputes with the same k-steps, passes and sums, so that the row max
// and sum `finish` stores hold for its scores exactly. Without (serving),
// the narrow route adds every pair into s[nt] directly, which is faster at
// a key split of 1 (chip_smoke.py phase 8 times both). ONE_PAIR: the pairs
// in a loop that is not unrolled (the wide route, whose Q comes from shared
// memory).
template <class C, int NJ, bool FRESH, bool ONE_PAIR, class QA>
__device__ __forceinline__ void scores_tf32(float (&s)[C::BN / 8][4], QA qa, const float* kt,
                                            int lane) {
  const int g = lane / 4, t = lane % 4;
  const float* k0 = kt + g * C::LDK + 4 * t;
  auto pair = [&](int j) {
    // k-step 2j: A = (Q[g][d0], Q[g+8][d0], Q[g][d1], Q[g+8][d1]) with d0, d1
    // the first two of this lane's four columns; k-step 2j + 1: the last two
    float4 x, y;
    qa(j, x, y);
    uint32_t ab[2][4], as[2][4];
    split_tf32(x.x, ab[0][0], as[0][0]);
    split_tf32(y.x, ab[0][1], as[0][1]);
    split_tf32(x.y, ab[0][2], as[0][2]);
    split_tf32(y.y, ab[0][3], as[0][3]);
    split_tf32(x.z, ab[1][0], as[1][0]);
    split_tf32(y.z, ab[1][1], as[1][1]);
    split_tf32(x.w, ab[1][2], as[1][2]);
    split_tf32(y.w, ab[1][3], as[1][3]);
#pragma unroll
    for (int nt = 0; nt < C::BN / 8; ++nt) {
      const uint4 kb = *reinterpret_cast<const uint4*>(k0 + nt * 8 * C::LDK + 16 * j);
      const uint4 ks = *reinterpret_cast<const uint4*>(k0 + C::K_ELEMS + nt * 8 * C::LDK + 16 * j);
      const uint32_t bb0[2] = {kb.x, kb.y}, bs0[2] = {ks.x, ks.y};
      const uint32_t bb1[2] = {kb.z, kb.w}, bs1[2] = {ks.z, ks.w};
      if constexpr (FRESH) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(d, ab[0], as[0], bb0, bs0);
        mma_3xtf32(d, ab[1], as[1], bb1, bs1);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += d[e];
      } else {
        mma_3xtf32(s[nt], ab[0], as[0], bb0, bs0);
        mma_3xtf32(s[nt], ab[1], as[1], bb1, bs1);
      }
    }
  };
  if constexpr (ONE_PAIR) {
    // one pair at a time: the registers the fresh accumulators take come
    // from loads the compiler would otherwise hoist from later pairs
#pragma unroll 1
    for (int j = 0; j < NJ; ++j) pair(j);
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j) pair(j);
  }
}

template <class C, int DH, bool FRESH>
__device__ __forceinline__ void scores(float (&s)[C::BN / 8][4], const QFrag<float, DH>& q,
                                       const float* kt, int lane) {
  scores_tf32<C, DH / 16, FRESH, false>(s, [&](int j, float4& x, float4& y) {
    x = make_float4(q.a[j][0], q.a[j][1], q.a[j][2], q.a[j][3]);
    y = make_float4(q.b[j][0], q.b[j][1], q.b[j][2], q.b[j][3]);
  }, kt, lane);
}

template <class C, int DH, bool>
__device__ __forceinline__ void scores(float (&s)[C::BN / 8][4], const QFrag<__nv_bfloat16, DH>& q,
                                       const __nv_bfloat16* kt, int lane) {
  // ldmatrix x4 over 8 keys x 32 columns: B of k-steps 2j and 2j + 1
  const __nv_bfloat16* k0 = kt + (lane & 7) * C::LDK + 8 * (lane >> 3);
#pragma unroll
  for (int j = 0; j < DH / 32; ++j)
#pragma unroll
    for (int nt = 0; nt < C::BN / 8; ++nt) {
      uint32_t b[4];
      ldmatrix_x4(b, k0 + nt * 8 * C::LDK + 32 * j);
      mma_bf16(s[nt], q.a[2 * j], b[0], b[1]);
      mma_bf16(s[nt], q.a[2 * j + 1], b[2], b[3]);
    }
}

// o = o * alpha + P V for the warp's key slice, over the first `width` of
// the DH columns (a multiple of 64; the rest stay 0); p holds the S
// accumulator after exp2, alpha each row's rescale (rows g, g + 8).
// f32: the tensor cores add into their accumulator with truncation, an
// error of up to an ulp of the accumulator per add. Summed over every key
// tile into o (3 adds per 8 keys) it reached 4.5e-4 of a layer's max through
// a 12-layer upstream at 18000 keys whose V has a common part (random V,
// which keeps o small, stays within 1e-6). So past C::DIRECT_TILES key tiles
// (`fresh`) the products of one tile go into fresh accumulators,
// C::PV_GROUP 8-column n-tiles at a time (P split again for each group),
// which are added to the rescaled o rounded to nearest: one add per tile.
// Up to it they go into o directly, 5-8 % faster at head dim 128, the
// truncation then within the f32 bar (tests/test_torch_attention_split.py).
template <class C, int DH>
__device__ __forceinline__ void weighted_values(float (&o)[DH / 8][4], const float (&p)[C::BN / 8][4],
                                                const float (&alpha)[2], const float* vt, int lane,
                                                int width, bool fresh) {
  constexpr int G = C::PV_GROUP;
  static_assert((DH / 8) % G == 0 && 64 % (8 * G) == 0, "whole groups, ending where width may");
  const int g = lane / 4, t = lane % 4;
  const float* v0 = vt + 2 * t * C::LDV + 2 * g;
  if (!fresh) {
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e / 2];
#pragma unroll
    for (int kk = 0; kk < C::BN / 8; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(p[kk][0], ab[0], as[0]);
      split_tf32(p[kk][2], ab[1], as[1]);
      split_tf32(p[kk][1], ab[2], as[2]);
      split_tf32(p[kk][3], ab[3], as[3]);
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        if (8 * dn >= width) continue;
        const float* vk = v0 + 8 * kk * C::LDV + 16 * dn;
        const uint2 x0 = *reinterpret_cast<const uint2*>(vk);
        const uint2 x1 = *reinterpret_cast<const uint2*>(vk + C::LDV);
        const uint32_t bb[2] = {x0.x, x1.x}, bs[2] = {x0.y, x1.y};
        mma_3xtf32(o[dn], ab, as, bb, bs);
      }
    }
    return;
  }
#pragma unroll
  for (int d0 = 0; d0 < DH / 8; d0 += G) {
    if (8 * d0 >= width) continue;
    float d[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::BN / 8; ++kk) {
      // keys 8kk + 2t and 8kk + 2t + 1 play k = t and t + 4: the accumulator
      // (c0, c1 | c2, c3) is A = (c0, c2, c1, c3)
      uint32_t ab[4], as[4];
      split_tf32(p[kk][0], ab[0], as[0]);
      split_tf32(p[kk][2], ab[1], as[1]);
      split_tf32(p[kk][1], ab[2], as[2]);
      split_tf32(p[kk][3], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float* vk = v0 + 8 * kk * C::LDV + 16 * (d0 + j);
        const uint2 x0 = *reinterpret_cast<const uint2*>(vk);            // key 2t
        const uint2 x1 = *reinterpret_cast<const uint2*>(vk + C::LDV);   // key 2t + 1
        const uint32_t bb[2] = {x0.x, x1.x}, bs[2] = {x0.y, x1.y};
        mma_3xtf32(d[j], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d0 + j][e] = fmaf(o[d0 + j][e], alpha[e / 2], d[j][e]);
  }
}

// bf16: P rounded to bf16 bounds it to a few bf16 ulps (the 1e-2 bar), far
// above the truncation of the adds, so o accumulates in place.
template <class C, int DH>
__device__ __forceinline__ void weighted_values(float (&o)[DH / 8][4], const float (&p)[C::BN / 8][4],
                                                const float (&alpha)[2], const __nv_bfloat16* vt,
                                                int lane, int width, bool) {
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e / 2];
  // ldmatrix.trans x4 over 16 keys x 16 columns: B of two 8-column n-tiles
  const __nv_bfloat16* v0 = vt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LDV + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      if (16 * dp >= width) continue;
      uint32_t b[4];
      ldmatrix_x4_trans(b, v0 + 16 * kk * C::LDV + 16 * dp);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Mask and scale the warp's scores of one key tile (flags: the stage's key
// flags from the warp's first key key0), then the online softmax step: the
// running max and (lane-partial) sums, each row's rescale of o in alpha
// (weighted_values applies it), s replaced by the unnormalised weights.
template <class C>
__device__ __forceinline__ void softmax_tile(float (&s)[C::BN / 8][4], float (&alpha)[2],
                                             float (&m_run)[2], float (&l_run)[2],
                                             const uint8_t* flags, int key0, int Lk,
                                             float scale_log2, int t) {
  // accumulator element e is row g + 8 (e / 2), key 2t + e % 2
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < C::BN / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = 8 * nt + 2 * t + c;
      const bool in = key0 + key < Lk;
      const bool ok = in && flags[key] != 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[nt][2 * r + c];
        // unfused, as the backward kernel scales and subtracts
        x = ok ? __fmul_rn(x, scale_log2) : (in ? MASK_FILL_LOG2 : -INFINITY);
        mx[r] = fmaxf(mx[r], x);
      }
    }
  // key0 < Lk is in the slice, so each row max is finite
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
    alpha[r] = exp2f(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < C::BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = exp2f(__fsub_rn(s[nt][e], m_run[e / 2]));
      rs[e / 2] += s[nt][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];   // lane-partial sums
}

// The end of a block: merge the key slices (warps wn > 0 hand (o, m, l) to
// warp wn = 0 of their query rows through the now idle ring, in fragment
// order), normalise, and store the warp's rows from row0 (below Lq) at
// `dst` + row * pitch, the first `width` of the DH columns. With `stats`,
// also each row's max m (log2 units) and sum l at stats[2 row], [2 row + 1]:
// the backward kernel (csrc/attention_bwd.cu) takes its weights from them.
template <class C, int DH, int SPLIT, typename T>
__device__ __forceinline__ void finish(float (&o)[DH / 8][4], float (&m_run)[2], float (&l_run)[2],
                                       unsigned char* smem, int wm, int wn, int lane, T* dst,
                                       int row0, int Lq, int pitch, int width,
                                       float* stats = nullptr) {
  const int g = lane / 4, t = lane % 4;
  if constexpr (SPLIT > 1) {
    cp_async_wait<0>();
    __syncthreads();
    float* merge = reinterpret_cast<float*>(smem);
    auto slot = [&](int w) { return merge + (wm * (SPLIT - 1) + w - 1) * 32 * C::MERGE_FLOATS + lane; };
    if (wn > 0) {
      float* out = slot(wn);
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[(4 * dn + e) * 32] = o[dn][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        out[(DH / 2 + r) * 32] = m_run[r];
        out[(DH / 2 + 2 + r) * 32] = l_run[r];
      }
    }
    __syncthreads();
    if (wn > 0) return;
#pragma unroll
    for (int w = 1; w < SPLIT; ++w) {
      const float* src = slot(w);
      float a_own[2], a_w[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // m_run[r] is finite (warp 0's slice of tile 0 holds key 0); a warp
        // whose slices all lay past Lk left m = -inf, l = 0, o = 0
        const float m_w = src[(DH / 2 + r) * 32];
        const float m_new = fmaxf(m_run[r], m_w);
        a_own[r] = exp2f(m_run[r] - m_new);
        a_w[r] = exp2f(m_w - m_new);
        l_run[r] = l_run[r] * a_own[r] + src[(DH / 2 + 2 + r) * 32] * a_w[r];
        m_run[r] = m_new;
      }
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[dn][e] = o[dn][e] * a_own[e / 2] + src[(4 * dn + e) * 32] * a_w[e / 2];
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = 1.f / l;
    const int row = row0 + g + 8 * r;
    if (stats != nullptr && t == 0 && row < Lq) {
      stats[2 * row] = m_run[r];
      stats[2 * row + 1] = l;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= Lq) continue;
    T* d = dst + (size_t)row * pitch + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
      if (8 * dn >= width) continue;
      store2(d + 8 * dn, o[dn][2 * r] * inv[r], o[dn][2 * r + 1] * inv[r]);
    }
  }
}

// One key's flag (0 past Lk).
__device__ __forceinline__ uint8_t key_flag(const uint8_t* kv, int key, int Lk) {
  return key < Lk ? kv[key] : 0;
}

// A block's place in the grid: blocks run in x order, the slice fastest,
// then the query tile, then batch * head.
struct Place {
  int bh, tile, slice;
  __device__ __forceinline__ Place(int tiles, int slices) {
    const int rest = blockIdx.x / slices;
    slice = blockIdx.x % slices;
    tile = rest % tiles;
    bh = rest / tiles;
  }
};

template <typename T, int DH, int SPLIT>
__global__ void __launch_bounds__(Cfg<T, DH, SPLIT>::THREADS, Cfg<T, DH, SPLIT>::MIN_BLOCKS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ key_valid, T* __restrict__ out,
                     float* __restrict__ stats, int H, int Lq, int Lk, int tiles,
                     float scale_log2) {
  using C = Cfg<T, DH, SPLIT>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint8_t* flags = smem + C::RING_BYTES;    // STAGES x STAGE_KEYS

  const Place place(tiles, 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / SPLIT, wn = warp % SPLIT;
  const int g = lane / 4, t = lane % 4;
  const size_t q_base = (size_t)place.bh * Lq * DH;
  const size_t kv_base = (size_t)place.bh * Lk * DH;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;
  const uint8_t* kv = key_valid + (size_t)(place.bh / H) * Lk;
  const int row0 = place.tile * C::BLOCK_M + 16 * wm;     // this warp's first query row
  const int n_tiles = (Lk + C::STAGE_KEYS - 1) / C::STAGE_KEYS;
  const bool flagger = threadIdx.x < C::STAGE_KEYS;       // copies key flag threadIdx.x of a tile

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_stage<C>(ring + st * C::STAGE_ELEMS, kb, vb, st, Lk, DH);
    cp_async_commit();
  }
  // This thread's key flag of tile it is loaded at tile it - 2, so that two
  // tiles hide its latency, and stored into tile it's stage before tile it's
  // barrier (the stage's last reader, tile it - 3, passed tile it - 2's).
  uint8_t flag_now = 0, flag_next = 0;
  if (flagger) {
    flag_now = key_flag(kv, threadIdx.x, Lk);
    flag_next = key_flag(kv, C::STAGE_KEYS + threadIdx.x, Lk);
  }

  QFrag<T, DH> qf;
  qf.load(q + q_base, row0, Lq, g, t);

  float o[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};   // rows g, g + 8

  for (int it = 0; it < n_tiles; ++it) {
    T* st = ring + (it % STAGES) * C::STAGE_ELEMS;
    if (flagger) {
      flags[(it % STAGES) * C::STAGE_KEYS + threadIdx.x] = flag_now;
      flag_now = flag_next;
      flag_next = key_flag(kv, (it + 2) * C::STAGE_KEYS + threadIdx.x, Lk);
    }
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile `it` have landed
    if constexpr (C::F32) split_stage<C>(st);
    __syncthreads();               // everyone's, split; and everyone is done with tile it - 1
    {
      const int next = it + STAGES - 1;   // refill the stage tile it - 1 used
      if (next < n_tiles) load_stage<C>(ring + (next % STAGES) * C::STAGE_ELEMS, kb, vb, next, Lk, DH);
      cp_async_commit();
    }
    const int key0 = it * C::STAGE_KEYS + wn * C::BN;   // first key of this warp's slice
    if (key0 >= Lk) continue;                           // the whole slice lies past Lk

    float s[C::BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < C::BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    // f32 with `stats`: the fresh sums the backward kernel recomputes
    if (stats != nullptr) scores<C, DH, true>(s, qf, st + wn * C::BN * C::LDK, lane);
    else scores<C, DH, false>(s, qf, st + wn * C::BN * C::LDK, lane);
    float alpha[2];
    softmax_tile<C>(s, alpha, m_run, l_run, flags + (it % STAGES) * C::STAGE_KEYS + wn * C::BN,
                    key0, Lk, scale_log2, t);
    weighted_values<C, DH>(o, s, alpha, st + C::V_OFFSET + wn * C::BN * C::LDV, lane, DH,
                           n_tiles > C::DIRECT_TILES);
  }

  finish<C, DH, SPLIT>(o, m_run, l_run, smem, wm, wn, lane, out + q_base, row0, Lq, DH, DH,
                       stats != nullptr ? stats + (size_t)place.bh * Lq * 2 : nullptr);
}

// Wide route: ring step `step` of a block is, for key tile step / (NC + 1),
// the score chunk step % (NC + 1) (< NC: Q and K columns 64c .. 64c + 63) or
// the tile's V slice (== NC: columns col0 .. col0 + 127, zero past Dh).
template <class C, typename T>
__device__ __forceinline__ void load_wide(T* st, const T* qb, const T* kb, const T* vb, int step,
                                          int NC, int Dh, int row_blk, int col0, int Lq, int Lk) {
  const int part = step % (NC + 1);
  const int n0 = step / (NC + 1) * C::STAGE_KEYS;
  if (part < NC) {
    const int c0 = part * C::CHUNK;
#pragma unroll
    for (int u = 0; u < C::K_COPIES; ++u) {
      int r, c;
      copy_slot<C>(u, C::CHUNK_COPIES, r, c);
      const bool in = n0 + r < Lk;
      cp_async16(st + r * C::LDK + c, kb + (in ? (size_t)(n0 + r) * Dh + c0 + c : 0), in);
    }
#pragma unroll
    for (int u = 0; u < C::Q_COPIES; ++u) {
      int r, c;
      copy_slot<C>(u, C::CHUNK_COPIES, r, c);
      const bool in = row_blk + r < Lq;
      cp_async16(st + C::Q_OFFSET + r * C::LDK + c,
                 qb + (in ? (size_t)(row_blk + r) * Dh + c0 + c : 0), in);
    }
  } else {
#pragma unroll
    for (int u = 0; u < C::V_COPIES; ++u) {
      int r, c;
      copy_slot<C>(u, C::SLICE_COPIES, r, c);
      const bool in = n0 + r < Lk && col0 + c < Dh;
      cp_async16(st + r * C::LDV + (C::F32 ? 2 * c : c),
                 vb + (in ? (size_t)(n0 + r) * Dh + col0 + c : 0), in);
    }
  }
}

// f32: split this thread's landed K chunk or V slice copies in place (Q
// stays raw: each warp splits its own rows as it reads them).
template <class C>
__device__ __forceinline__ void split_wide(float* st, bool values) {
  if (!values) {
#pragma unroll
    for (int u = 0; u < C::K_COPIES; ++u) {
      int r, c;
      copy_slot<C>(u, C::CHUNK_COPIES, r, c);
      split_k<C::K_ELEMS>(st + r * C::LDK + c);
    }
  } else {
#pragma unroll
    for (int u = 0; u < C::V_COPIES; ++u) {
      int r, c;
      copy_slot<C>(u, C::SLICE_COPIES, r, c);
      split_v(st + r * C::LDV + 2 * c);
    }
  }
}

// s += the warp's 16 rows of the Q chunk at qt times its key slice of the K
// chunk at kt, over the chunk's 64 columns. The tensor cores add into their
// accumulator with truncation, an error that grows with the number of
// products added into one accumulator and with its size: accumulated over
// the whole head dim of 1024 it reached 2.3e-5 of the output against the
// plain version, above the f32 bar. So each 16 columns start a fresh
// accumulator, which is added to s rounded to nearest.
template <class C>
__device__ __forceinline__ void scores_chunk(float (&s)[C::BN / 8][4], const float* qt,
                                             const float* kt, int lane) {
  const float* q0 = qt + (lane / 4) * C::LDK + 4 * (lane % 4);
  scores_tf32<C, C::CHUNK / 16, true, true>(s, [&](int j, float4& x, float4& y) {
    x = *reinterpret_cast<const float4*>(q0 + 16 * j);
    y = *reinterpret_cast<const float4*>(q0 + 8 * C::LDK + 16 * j);
  }, kt, lane);
}

template <class C>
__device__ __forceinline__ void scores_chunk(float (&s)[C::BN / 8][4], const __nv_bfloat16* qt,
                                             const __nv_bfloat16* kt, int lane) {
  // A: ldmatrix x4 over the 16 rows x 16 columns of a k-step; B as narrow
  const __nv_bfloat16* qa = qt + (lane & 15) * C::LDK + 8 * (lane >> 4);
  const __nv_bfloat16* k0 = kt + (lane & 7) * C::LDK + 8 * (lane >> 3);
#pragma unroll
  for (int j = 0; j < C::CHUNK / 32; ++j) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, qa + 32 * j);
    ldmatrix_x4(a1, qa + 32 * j + 16);
#pragma unroll
    for (int nt = 0; nt < C::BN / 8; ++nt) {
      uint32_t b[4];
      ldmatrix_x4(b, k0 + nt * 8 * C::LDK + 32 * j);
      mma_bf16(s[nt], a0, b[0], b[1]);
      mma_bf16(s[nt], a1, b[2], b[3]);
    }
  }
}

template <typename T, int SPLIT>
__global__ void __launch_bounds__(WideCfg<T, SPLIT>::THREADS, WideCfg<T, SPLIT>::MIN_BLOCKS)
attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ key_valid, T* __restrict__ out,
                      int H, int Lq, int Lk, int Dh, int tiles, int slices, float scale_log2) {
  using C = WideCfg<T, SPLIT>;
  constexpr int W = C::SLICE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint8_t* flags = smem + C::RING_BYTES;    // STAGES x STAGE_KEYS

  const Place place(tiles, slices);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / SPLIT, wn = warp % SPLIT;
  const size_t q_base = (size_t)place.bh * Lq * Dh;
  const size_t kv_base = (size_t)place.bh * Lk * Dh;
  const T* qb = q + q_base;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;
  const uint8_t* kv = key_valid + (size_t)(place.bh / H) * Lk;
  const int row_blk = place.tile * C::BLOCK_M;
  const int col0 = place.slice * W;
  const int width = min(W, Dh - col0);
  const int NC = Dh / C::CHUNK;
  const int n_steps = (Lk + C::STAGE_KEYS - 1) / C::STAGE_KEYS * (NC + 1);
  const bool flagger = threadIdx.x < C::STAGE_KEYS;
  auto flag_of = [&](int step) {
    return key_flag(kv, step / (NC + 1) * C::STAGE_KEYS + threadIdx.x, Lk);
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {   // n_steps >= NC + 1 >= 3
    load_wide<C>(ring + st * C::STAGE_ELEMS, qb, kb, vb, st, NC, Dh, row_blk, col0, Lq, Lk);
    cp_async_commit();
  }
  // key flags by step as the narrow route's by tile: loaded two steps ahead
  uint8_t flag_now = 0, flag_next = 0;
  if (flagger) {
    flag_now = flag_of(0);
    flag_next = flag_of(1);
  }

  float o[W / 8][4];
#pragma unroll
  for (int dn = 0; dn < W / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float s[C::BN / 8][4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};   // rows g, g + 8

  for (int it = 0; it < n_steps; ++it) {
    T* st = ring + (it % STAGES) * C::STAGE_ELEMS;
    const int part = it % (NC + 1);
    if (flagger) {
      flags[(it % STAGES) * C::STAGE_KEYS + threadIdx.x] = flag_now;
      flag_now = flag_next;
      flag_next = flag_of(it + 2);
    }
    cp_async_wait<STAGES - 2>();
    if constexpr (C::F32) split_wide<C>(st, part == NC);
    __syncthreads();
    {
      const int next = it + STAGES - 1;
      if (next < n_steps)
        load_wide<C>(ring + (next % STAGES) * C::STAGE_ELEMS, qb, kb, vb, next, NC, Dh, row_blk,
                     col0, Lq, Lk);
      cp_async_commit();
    }
    const int key0 = it / (NC + 1) * C::STAGE_KEYS + wn * C::BN;
    if (key0 >= Lk) continue;                           // the whole slice lies past Lk

    if (part < NC) {
      if (part == 0) {
#pragma unroll
        for (int nt = 0; nt < C::BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
      scores_chunk<C>(s, st + C::Q_OFFSET + 16 * wm * C::LDK, st + wn * C::BN * C::LDK, lane);
      continue;
    }
    float alpha[2];
    softmax_tile<C>(s, alpha, m_run, l_run, flags + (it % STAGES) * C::STAGE_KEYS + wn * C::BN,
                    key0, Lk, scale_log2, lane % 4);
    weighted_values<C, W>(o, s, alpha, st + wn * C::BN * C::LDV, lane, width, true);
  }

  finish<C, W, SPLIT>(o, m_run, l_run, smem, wm, wn, lane, out + q_base + col0,
                      row_blk + 16 * wm, Lq, Dh, width);
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

// One grid of B * H * tiles * slices blocks along x (up to INT_MAX: far
// beyond what device memory holds), or cudaErrorInvalidValue.
inline bool grid_fits(int B, int H, int tiles, int slices) {
  return (long long)B * H * tiles * slices <= INT_MAX;
}

template <typename T, int DH, int SPLIT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_valid, void* out,
                   float* stats, int B, int H, int Lq, int Lk, float scale_log2,
                   cudaStream_t stream) {
  using C = Cfg<T, DH, SPLIT>;
  auto kernel = attention_fwd_kernel<T, DH, SPLIT>;
  static bool allowed[64] = {};
  cudaError_t err = allow_smem((const void*)kernel, C::SMEM_BYTES, allowed);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + C::BLOCK_M - 1) / C::BLOCK_M;
  if (!grid_fits(B, H, tiles, 1)) return cudaErrorInvalidValue;
  kernel<<<B * H * tiles, C::THREADS, C::SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(out), stats, H, Lq, Lk, tiles,
      scale_log2);
  return cudaGetLastError();
}

template <typename T, int SPLIT>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* key_valid,
                        void* out, int B, int H, int Lq, int Lk, int Dh, float scale_log2,
                        cudaStream_t stream) {
  using C = WideCfg<T, SPLIT>;
  auto kernel = attention_wide_kernel<T, SPLIT>;
  static bool allowed[64] = {};
  cudaError_t err = allow_smem((const void*)kernel, C::SMEM_BYTES, allowed);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + C::BLOCK_M - 1) / C::BLOCK_M;
  const int slices = (Dh + C::SLICE - 1) / C::SLICE;
  if (!grid_fits(B, H, tiles, slices)) return cudaErrorInvalidValue;
  kernel<<<B * H * tiles * slices, C::THREADS, C::SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(out), H, Lq, Lk, Dh, tiles, slices,
      scale_log2);
  return cudaGetLastError();
}

// One head dim's key splits: `route` is launch<T, DH, SPLIT> or
// launch_wide<T, SPLIT> behind a common signature.
#define FSCL_SPLITS(call)                   \
  switch (key_split) {                      \
    case 1: return call(1);                 \
    case 2: return call(2);                 \
    case 4: return call(4);                 \
    default: return cudaErrorInvalidValue;  \
  }

template <typename T, int DH>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* key_valid,
                         void* out, float* stats, int B, int H, int Lq, int Lk, int Dh,
                         float scale_log2, int key_split, cudaStream_t stream) {
#define FSCL_NARROW(s) \
  launch<T, DH, s>(q, k, v, key_valid, out, stats, B, H, Lq, Lk, scale_log2, stream)
  FSCL_SPLITS(FSCL_NARROW)
#undef FSCL_NARROW
}

template <typename T>
cudaError_t launch_wide_split(const void* q, const void* k, const void* v, const void* key_valid,
                              void* out, float* stats, int B, int H, int Lq, int Lk, int Dh,
                              float scale_log2, int key_split, cudaStream_t stream) {
  if (stats != nullptr) return cudaErrorInvalidValue;   // the narrow route's alone
#define FSCL_WIDE(s) \
  launch_wide<T, s>(q, k, v, key_valid, out, B, H, Lq, Lk, Dh, scale_log2, stream)
  FSCL_SPLITS(FSCL_WIDE)
#undef FSCL_WIDE
}

}  // namespace

// The (type, route) families, each compiled in one build part; without
// FSCL_PART (one nvcc for the whole file) every family and the entry point.
#ifndef FSCL_PART
#define FSCL_PART -1
#endif
#define FSCL_OWNS(part) (FSCL_PART < 0 || FSCL_PART == (part))
#define FSCL_ATTENTION_ARGS                                                                    \
  const void *q, const void *k, const void *v, const void *key_valid, void *out, float *stats, \
      int B, int H, int Lq, int Lk, int Dh, float scale_log2, int key_split, cudaStream_t stream
#define FSCL_ATTENTION_CALL \
  q, k, v, key_valid, out, stats, B, H, Lq, Lk, Dh, scale_log2, key_split, stream

cudaError_t fscl_attention_f32_64(FSCL_ATTENTION_ARGS);
cudaError_t fscl_attention_f32_128(FSCL_ATTENTION_ARGS);
cudaError_t fscl_attention_f32_wide(FSCL_ATTENTION_ARGS);
cudaError_t fscl_attention_bf16_64(FSCL_ATTENTION_ARGS);
cudaError_t fscl_attention_bf16_128(FSCL_ATTENTION_ARGS);
cudaError_t fscl_attention_bf16_wide(FSCL_ATTENTION_ARGS);

#if FSCL_OWNS(0)
cudaError_t fscl_attention_f32_wide(FSCL_ATTENTION_ARGS) {
  return launch_wide_split<float>(FSCL_ATTENTION_CALL);
}
cudaError_t fscl_attention_bf16_wide(FSCL_ATTENTION_ARGS) {
  return launch_wide_split<__nv_bfloat16>(FSCL_ATTENTION_CALL);
}
#endif
#if FSCL_OWNS(1)
cudaError_t fscl_attention_f32_64(FSCL_ATTENTION_ARGS) {
  return launch_split<float, 64>(FSCL_ATTENTION_CALL);
}
cudaError_t fscl_attention_f32_128(FSCL_ATTENTION_ARGS) {
  return launch_split<float, 128>(FSCL_ATTENTION_CALL);
}
#endif
#if FSCL_OWNS(2)
cudaError_t fscl_attention_bf16_64(FSCL_ATTENTION_ARGS) {
  return launch_split<__nv_bfloat16, 64>(FSCL_ATTENTION_CALL);
}
cudaError_t fscl_attention_bf16_128(FSCL_ATTENTION_ARGS) {
  return launch_split<__nv_bfloat16, 128>(FSCL_ATTENTION_CALL);
}
#endif

#if FSCL_OWNS(0)
// q, out: contiguous (B, H, Lq, Dh); k, v: contiguous (B, H, Lk, Dh); Dh 64,
// 128 (the narrow route) or a multiple of 64 above 128 (the wide route);
// key_valid: contiguous (B, Lk) bytes. Lq, Lk >= 1.
// dtype: 0 = float32, 1 = bfloat16. key_split: warps of a block that share
// the key loop (1, 2 or 4); a block owns 128 (f32) or 64 (bf16) query rows
// divided by key_split. stats: null, or (narrow route only) a contiguous
// (B, H, Lq, 2) f32 output for each query row's max (log2 units of the
// scores) and sum, which the backward kernel reads. Returns a cudaError_t (0
// on success).
extern "C" int fscl_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* key_valid, void* out, int B, int H, int Lq,
                                  int Lk, int Dh, int dtype, float temperature, int key_split,
                                  void* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq < 1 || Lk < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(1.4426950408889634 / (double)temperature);
  const bool wide = Dh > 128 && Dh % 64 == 0;
  auto fn = dtype == 0 ? (Dh == 64 ? fscl_attention_f32_64 : Dh == 128 ? fscl_attention_f32_128
                          : wide ? fscl_attention_f32_wide : nullptr)
          : dtype == 1 ? (Dh == 64 ? fscl_attention_bf16_64 : Dh == 128 ? fscl_attention_bf16_128
                          : wide ? fscl_attention_bf16_wide : nullptr)
          : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, key_valid, out, static_cast<float*>(stats), B, H, Lq, Lk, Dh,
                 scale_log2, key_split, s);
}
#endif
