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
// serves (L >= 128) operations bound it, by type:
// - bf16: bf16 x bf16 -> f32 products on the tensor cores (989 TFLOP/s).
//   The unnormalised weights P are rounded to bf16 to be the A operand of
//   P V, as xla_attention (fscl_tpu/ops/attention.py:40) rounds its weights
//   to V's type; that is the path the JAX package takes in bf16 (HuBERT's
//   64-wide heads never reach the Pallas kernel). _attn_kernel and the plain
//   version keep the weights in f32, so in bf16 this kernel differs from them
//   by up to a few bf16 ulps of the output; the bf16 bar (atol = rtol =
//   1e-2) holds it.
// - f32, by split TF32 ("3xTF32"): one TF32 product keeps 11 significant bits,
//   too few for the 2e-5 bar. Each f32 operand x is split into big = tf32(x)
//   and small = tf32(x - big), both rounded to nearest with ties away from
//   zero (the rounding of cvt.rna.tf32.f32, done with two integer
//   operations), and each product is taken as small*big + big*small +
//   big*big on the TF32 tensor cores, accumulated in f32; the dropped
//   small*small term is below 2^-22 relative. Three TF32 products per f32
//   product bound it at 3 * 4 * Lq * Lk * Dh over 495 TFLOP/s.
//
// Two routes. Head dims 64 and 128 (the wrapper pads smaller ones) take the
// narrow route, on Hopper's machinery (csrc/hopper_attention.cuh):
// - A block is 3 warpgroups. The producer streams the key tiles of K and V
//   with TMA (cp.async.bulk.tensor, per-(batch * head) tensor maps: a ragged
//   tile reads zeros past Lk, never the next head's rows) into a ring of
//   stages guarded by full and empty mbarriers, with the tile's key flags
//   (loaded two tiles ahead). Two consumer warpgroups run wgmma on the
//   stages: S = Q K^T (m64n32 per 32 keys, A = Q from registers, B = K),
//   the online softmax on S's accumulators in registers (row max and sum
//   across the 4 lanes of a quad), then O += P V (m64nDh, A = P straight
//   from S's accumulators, B = V), O in registers. setmaxnreg gives the
//   producer's registers to the consumers.
// - f32: a 32-bit wgmma reads B K-major only, and V is MN-major for P V, so
//   V goes to wgmma as transposed TF32 planes (TMA cannot transpose 32-bit
//   elements). The producer warpgroup splits each 32-key tile once for the
//   block (not once per consumer warpgroup): K into its big and small row
//   planes (the big one in place over the tile TMA stored) and V, from a
//   slot of its own, into its transposed big and small planes; then it
//   marks the stage full. The consumers split their A operands (Q's
//   fragments, P) at use. So copies and splits run beside the products, not
//   in line with them. Shared memory at f32 and head dim 128: 3 stages of
//   64 KB and 2 V slots of 16 KB, one block per SM.
// - bf16: a ring tile is 64 keys, two 32-key sub-tiles that the consumers
//   read as TMA stored them (V through the descriptor's transpose bit): a
//   32-key bf16 tile is too little work for its waits and handshakes. Q's
//   fragments are loaded, and O's rows stored, 16 contiguous bytes a lane,
//   put in place by a transpose across each quad (quad_transpose): at short
//   query lengths the 4-byte accesses of the fragment layout were a large
//   part of a launch.
// - With `stats` (training) S is computed by the header's `scores` with a
//   fresh accumulator every 16 columns of the head dim, the routine the
//   backward kernel (csrc/attention_bwd.cu) recomputes S with from the same
//   planes and fragments, so the row max m and sum l stored here hold for
//   its scores exactly. Without (serving), every pass goes into S's one
//   accumulator (the stats instance is 5-7 % slower). f32 P V takes each
//   key tile's products in fresh accumulators at every length (pv_f32): the
//   tensor cores' truncating adds, summed into O directly, took training on
//   the card measurably farther from the CPU's.
// - Work items: one (batch * head, query tile) each. key_split 1: a tile of
//   128 query rows, 64 for each consumer warpgroup, both reading every key
//   tile; 2: a tile of 64 rows whose two consumer warpgroups take alternate
//   key tiles and merge their (o, m, l) at the end (a 64-row wgmma tile
//   cannot be cut smaller, so this doubles the items at short query
//   lengths, at about 1.4x the cost a row in f32, where the producer's
//   split is the limit). The wrapper picks the split from the query length,
//   the caller's head dim and row stats alone (ops/attention.py:
//   narrow_split, its limits from a sweep of both splits), so a sample's
//   output does not depend on B * H: B * H = 16 at L = 64, 128, 256 (the
//   served encoder) gets 16, 32, 64 items, (16, 2, 128) with stats (the
//   train encoder) 64, (4, 2, 128) (the tune adaptation) 16 and (8, 2,
//   199) at head dim 40 or 48 (padded to 64) 64. A
//   block per SM runs items in turn (the producer streams the next item's
//   tiles while the consumers finish the last), but for f32 at head dim
//   128, whose 224 KB of shared memory leave no room for the hand-over
//   outside the ring: a block per item there. No atomics.
// - Registers (0 spill): f32 Q fragments and O take 128 of a consumer's
//   224; each fresh accumulator starts as a subtraction tied to the last
//   sum (ptxas otherwise issues the next group first and holds several);
//   each thread's indices are made after setmaxnreg in its branch (made
//   before, ptxas spilled them); the consumers address shared memory by
//   32-bit addresses.

// Head dims above 128 (the wrapper pads them to a multiple of 64; there is no
// upper one) take the wide route, still the FlashAttention-2 layout on
// mma.sync with cp.async copies. A warp's Q and O at such widths would not
// fit in the 255 registers a thread may hold (at 256, 1.2-2.4 KB spilled in
// an earlier design), so no warp holds either whole:
// - A block owns a query tile and one 128-wide slice of O's columns (the last
//   slice may hold 64); the slices are blocks of their own. Each warp owns
//   16 query rows.
// - For each key tile, S = Q K^T is accumulated over the head dim in 64-wide
//   chunks: each Q chunk and K chunk streams through the cp.async ring as one
//   stage, Q read by each warp from shared memory for its 16 rows. Then one
//   stage brings the tile's V slice, and the online softmax and O_slice += P
//   V_slice run in registers (split TF32 with K and V split once per block by
//   the threads that copied them, Q per warp as it is read; bf16 P).
// - Each slice recomputes S: (Dh / 128 + 1) / 2 times the minimal operations
//   (1.5x at 256, 2.5x at 512), and Q is read again for every key tile.
// - Grid: one block per (batch * head, query tile, slice), in one x index
//   with the slice fastest. Where full query tiles give too few blocks for
//   the card (short Lq), the block's warps also split the key loop
//   (key_split 2 or 4: each warp a slice of every key tile, the block 1/2 or
//   1/4 as many query rows) and merge their softmax states through shared
//   memory at the end.
//
// Keys past Lk (the ragged edge of the last tile) get weight 0: score -inf and
// zero-filled K and V rows. Keys inside Lk that are masked take the -1e9 fill,
// exactly as the reference does. Scores are held in log2 units (scaled by
// log2(e) / temperature) for exp2. Query rows past Lq are computed on zeros and
// not stored.

// Build: ops/cuda_lib.py compiles its instances in four parts at once, one
// set of (type, route) families each (FSCL_PART, below), with the header
// csrc/hopper_attention.cuh in the library's build key.
// build parts: 4

#include "hopper_attention.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int STAGES = 3;            // the wide route's cp.async ring depth

constexpr int cmax(int a, int b) { return a > b ? a : b; }

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
  // Row pitches (elements). f32 K (big and small tiles) and Q: 16-byte
  // loads by lanes (g, t) at g * LDK + 4t, conflict-free for LDK = 16 mod 32
  // words. f32 V, (big, small) pairs: 8-byte loads at rows 2t (+1), pair g,
  // conflict-free for a pitch of 2 mod 8 pairs. bf16: the 8 rows of an
  // ldmatrix 8x8 tile 16 bytes apart modulo 128.
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



__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// d (64 x N) += A (64 x 16 bf16, registers) B (16 rows x N bf16, MN-major at
// desc: the transpose bit): m64nNk16, N = 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_bf16_mn<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16_mn<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
      "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


// Where the thread's u-th 16-byte copy of a block of rows `per_row` copies
// wide goes: row r, element c.
template <class C>
__device__ __forceinline__ void copy_slot(int u, int per_row, int& r, int& c) {
  const int i = threadIdx.x + u * C::THREADS;
  r = i / per_row;
  c = (i % per_row) * (16 / (C::F32 ? 4 : 2));
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

// s[nt] += Q K^T for the warp's key slice, over NJ k-step pairs (16 columns
// each): the big K tile at kt, the small one K_ELEMS on. The A fragments of
// pair j come from `qa(j, x, y)`, which gives row g's and row g + 8's four
// floats. Each pair's products go into a fresh accumulator, added to s[nt]
// rounded to nearest (the tensor cores' truncating adds then never hold
// more than 16 columns). The pairs run in a loop that is not unrolled: the
// registers the fresh accumulators take come from loads the compiler would
// otherwise hoist from later pairs.
template <class C, int NJ, class QA>
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
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(d, ab[0], as[0], bb0, bs0);
      mma_3xtf32(d, ab[1], as[1], bb1, bs1);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += d[e];
    }
  };
#pragma unroll 1
  for (int j = 0; j < NJ; ++j) pair(j);
}

// o = o * alpha + P V for the warp's key slice, over the first `width` of
// the DH columns (a multiple of 64; the rest stay 0); p holds the S
// accumulator after exp2, alpha each row's rescale (rows g, g + 8).
// f32: the tensor cores add into their accumulator with truncation, an
// error of up to an ulp of the accumulator per add. Summed over every key
// tile into o (3 adds per 8 keys) it reached 4.5e-4 of a layer's max through
// a 12-layer upstream at 18000 keys whose V has a common part (random V,
// which keeps o small, stays within 1e-6). So the products of one tile go
// into fresh accumulators, C::PV_GROUP 8-column n-tiles at a time (P split
// again for each group), which are added to the rescaled o rounded to
// nearest: one add per tile.
template <class C, int DH>
__device__ __forceinline__ void weighted_values(float (&o)[DH / 8][4], const float (&p)[C::BN / 8][4],
                                                const float (&alpha)[2], const float* vt, int lane,
                                                int width) {
  constexpr int G = C::PV_GROUP;
  static_assert((DH / 8) % G == 0 && 64 % (8 * G) == 0, "whole groups, ending where width may");
  const int g = lane / 4, t = lane % 4;
  const float* v0 = vt + 2 * t * C::LDV + 2 * g;
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
                                                int lane, int width) {
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

// -- the narrow route ------------------------------------------------------------

constexpr int NARROW_THREADS = 384;  // the producer warpgroup, then two consumer warpgroups
constexpr int WG_ROWS = 64;          // query rows of a consumer warpgroup: one wgmma M
// Named barriers (0 is __syncthreads): the producer warpgroup's own, and the
// consumer warpgroups' end of the key loop and hand-over of a key split
// (DONE: both are done with the ring, MERGE: the hand-over is there, FREE:
// it was read).
constexpr int BAR_SPLIT = 1, BAR_DONE = 2, BAR_MERGE = 3, BAR_FREE = 4;

// The narrow route's shared memory, at head dim DH in type T.
template <typename T, int DH>
struct Narrow : Tiles<T, DH> {
  using B = Tiles<T, DH>;
  // A ring stage holds one key tile of SUB 32-key sub-tiles. f32 (SUB 1): K's
  // row planes (big over the tile as TMA stored it, which split_rows splits
  // in place; small) and V's transposed planes (big, small). bf16 (SUB 2, 64
  // keys: a bf16 sub-tile is little work, and each tile costs its waits and
  // handshakes): K's sub-tiles, then V's, as TMA stored them, which the
  // consumers read as they are.
  static constexpr int SUB = B::F32 ? 1 : 2;
  static constexpr int KEYS = SUB * TILE;                 // keys of a ring tile
  static constexpr int STAGE = B::F32 ? 4 * B::PLANE : 2 * SUB * B::RAW;
  // ring stages: f32 at head dim 128, 3 (with the V slots, 224 KB), else
  // those of 128 KB
  static constexpr int NST = B::F32 && DH == 128 ? 3 : (128 * 1024) / STAGE;
  // f32: V as TMA stored it, in slots of its own that the producer splits
  // from (its transposed planes cannot be written in place)
  static constexpr int VST = B::F32 ? 2 : 0;
  static constexpr int V_RAW = NST * STAGE;
  // PERSIST: a block runs several work items, and a key split's hand-over
  // (o, m and l of each thread of warpgroup 2) has a region of its own, as
  // the ring holds the next item's tiles meanwhile; f32 at head dim 128 has
  // no room for it: one item a block, the hand-over in the idle ring
  static constexpr bool PERSIST = !(B::F32 && DH == 128);
  static constexpr int MERGE = 128 * (DH / 2 + 4) * 4;
  static constexpr int MERGE_AT = PERSIST ? V_RAW + VST * B::RAW : 0;
  static constexpr int FLAGS = PERSIST ? MERGE_AT + MERGE : V_RAW + VST * B::RAW;   // KEYS a stage
  static constexpr int BARS = FLAGS + NST * KEYS;        // full[NST], empty[NST], f32 copies[VST]
  static constexpr int BYTES = BARS + 8 * (2 * NST + VST) + 1024;   // + alignment to 1024
  // registers a thread of the producer and of a consumer warpgroup holds
  // after setmaxnreg: 128 P + 256 C <= 384 x 168, the block's registers at
  // launch (a consumer's setmaxnreg.inc past them never returns); the f32
  // producer splits (at 40 it spilled)
  static constexpr int PRODUCER_REGS = B::F32 ? 56 : 24;
  static constexpr int CONSUMER_REGS = B::F32 ? 224 : 240;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= NARROW_THREADS * 168,
                "setmaxnreg moves registers within the block's");
  static_assert(STAGE % 1024 == 0 && B::RAW % 1024 == 0, "swizzled tiles on 1024-byte bounds");
  static_assert(BYTES <= MAX_SMEM, "the ring, its flags and barriers fit");
  static_assert(PERSIST || MERGE <= NST * STAGE, "the hand-over fits in the idle ring");
};

// Mask and scale a warpgroup's scores of one key tile, NSUB 32-key
// sub-tiles from key0 (flags: two bytes at keys 32h + 8i + 2t and + 1), then
// the online softmax step: the running max m (log2 units) and the
// lane-partial sums l of rows g and g + 8, each row's rescale of o in alpha,
// s replaced by the unnormalised weights. Scaled and offset unfused, as the
// backward's `weight` does.
template <int NSUB>
__device__ __forceinline__ void softmax_wg(float (&s)[NSUB][16], float (&alpha)[2], float (&m)[2],
                                           float (&l)[2], const uint32_t (&flags)[NSUB][4],
                                           int key0, int Lk, float scale_log2, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int h = 0; h < NSUB; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = key0 + TILE * h + 8 * i + 2 * t + c;
        const bool in = key < Lk;
        const bool ok = in && ((flags[h][i] >> (8 * c)) & 0xffu) != 0;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float& x = s[h][4 * i + 2 * v + c];
          x = ok ? __fmul_rn(x, scale_log2) : (in ? MASK_FILL_LOG2 : -INFINITY);
          mx[v] = fmaxf(mx[v], x);
        }
      }
  // key0 < Lk, so each row max is finite
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const float m_new = fmaxf(m[v], quad_max(mx[v]));
    alpha[v] = exp2f(m[v] - m_new);
    m[v] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < NSUB; ++h)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      s[h][e] = exp2f(__fsub_rn(s[h][e], m[(e >> 1) & 1]));
      rs[(e >> 1) & 1] += s[h][e];
    }
#pragma unroll
  for (int v = 0; v < 2; ++v) l[v] = l[v] * alpha[v] + rs[v];
}

// f32: o = o * alpha + P V over one key tile, by split TF32: A = P from the
// scores' accumulator (k-step i: columns 8i + 2t and + 1, split here), B =
// V's transposed planes at vt (DH rows). The tensor cores add into their
// accumulator with truncation, an error of up to an ulp of o per add, all
// in one direction: summed so over 18000 keys whose V has a common part it
// reached 4.5e-4 of a layer's max (an earlier design; random V, which keeps
// o small, hides it), and summed so over the up to 1024 keys of the train
// step (12 adds a tile) it took the card's training twice as far from the
// CPU's in five steps as the earlier mma.sync design (chip_smoke.py's
// card-vs-CPU losses at the bar, 1e-3). So each 32 columns of every tile's
// products go into a fresh accumulator, big*big first, then small*big and
// big*small, added to the rescaled o rounded to nearest: one add a tile.
// Five-step training amplifies any change of rounding here: chip_smoke.py's
// card-vs-CPU losses and its tensor-parallel gradient bound each failed
// with another order of the passes or another final add (PERF.md, §7).
template <class C>
__device__ __forceinline__ void pv_f32(float (&o)[C::HD / 2], const float (&p)[16],
                                       const float (&alpha)[2], uint32_t vt) {
  uint32_t ab[4][4], as[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split_tf32(p[4 * i], ab[i][0], as[i][0]);
    split_tf32(p[4 * i + 2], ab[i][1], as[i][1]);
    split_tf32(p[4 * i + 1], ab[i][2], as[i][2]);
    split_tf32(p[4 * i + 3], ab[i][3], as[i][3]);
  }
#pragma unroll
  for (int qq = 0; qq < C::NQ; ++qq) {
    const uint32_t pl = opaque(vt) + qq * 32 * 128;
    const uint64_t big = desc_sw128(pl), small = desc_sw128(pl + C::PLANE);
    // f starts as +0 tied to the last quarter's result: ptxas would
    // otherwise run the quarters' products at once and hold every f
    float f[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = qq == 0 ? 0.f : __fsub_rn(o[16 * qq - 16 + e], o[16 * qq - 16 + e]);
    fence_regs(f);
    wg_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = (32 * i) >> 4;
      wgmma_n32(f, ab[i], big + off);
      wgmma_n32(f, as[i], big + off);
      wgmma_n32(f, ab[i], small + off);
    }
    wg_commit();
    wg_wait();
    fence_regs(f);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      o[16 * qq + e] = fmaf(o[16 * qq + e], alpha[(e >> 1) & 1], f[e]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fence_regs(ab[i]);
    fence_regs(as[i]);
  }
}

// bf16: o = o * alpha + P V over one key tile of NSUB sub-tiles: A = P
// rounded to bf16 (as xla_attention rounds its weights to V's type) from the
// scores' accumulators, B = V's sub-tile h as TMA stored it at v + h RAW
// (MN-major: the descriptor's transpose bit), one wgmma m64nDHk16 per 16
// keys into o. P rounded to bf16 bounds the error to a few bf16 ulps, far
// above the truncation of the adds.
template <class C, int NSUB>
__device__ __forceinline__ void pv_bf16(float (&o)[C::HD / 2], const float (&p)[NSUB][16],
                                        const float (&alpha)[2], uint32_t v) {
  uint32_t a[NSUB][2][4];
#pragma unroll
  for (int h = 0; h < NSUB; ++h)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[h][j][r] = pack_bf16(p[h][8 * j + 2 * r], p[h][8 * j + 2 * r + 1]);
#pragma unroll
  for (int e = 0; e < C::HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
  const uint32_t pl = opaque(v);
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int h = 0; h < NSUB; ++h)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wgmma_bf16_mn<C::HD>(o, a[h][j], desc_sw128_mn(pl + h * C::RAW + j * 2048, TILE * 128));
  wg_commit();
  wg_wait();
  fence_regs(o);
#pragma unroll
  for (int h = 0; h < NSUB; ++h)
#pragma unroll
    for (int j = 0; j < 2; ++j) fence_regs(a[h][j]);
}

// bf16 scores of a tile's NSUB sub-tiles (K's sub-tile h as TMA stored it at
// k + h RAW): each sub-tile's exactly as `scores` takes them (every k16 step
// into its accumulator, in the same order; the backward's bits), issued as
// one group with one wait.
template <class C, int NSUB>
__device__ __forceinline__ void scores_bf16(float (&s)[NSUB][16],
                                            const RowFrags<C, __nv_bfloat16>& rf, uint32_t k) {
#pragma unroll
  for (int h = 0; h < NSUB; ++h) {
#pragma unroll
    for (int i = 0; i < 16; ++i) s[h][i] = 0.f;
    fence_regs(s[h]);
  }
  wg_fence();
#pragma unroll
  for (int h = 0; h < NSUB; ++h)
#pragma unroll
    for (int ks = 0; ks < C::HD / 16; ++ks)
      wgmma_n32_bf16(s[h], rf.a[ks],
                     desc_sw128(k + h * C::RAW + (ks >> 2) * TILE * 128 + (ks & 3) * 32));
  wg_commit();
  wg_wait();
#pragma unroll
  for (int h = 0; h < NSUB; ++h) fence_regs(s[h]);
}

// Store row v (rows g and g + 8 of a warp's 16) of o times inv at d (the
// row's first element), if `ok`. A quad's lanes hold a row's elements 8i +
// 2t and + 1. bf16: the lanes transpose each four 32-bit words (every lane,
// whether it stores or not) so that each stores 16 contiguous bytes and a
// quad 64, rather than 4 bytes each: at short query lengths the stores
// were a large part of a launch. f32 stores 8 bytes a lane as they lie
// (swapping pairs for 16-byte stores was slower at head dim 128).
template <int DH>
__device__ __forceinline__ void store_row(__nv_bfloat16* d, const float (&o)[DH / 2], int v,
                                          float inv, int t, bool ok) {
#pragma unroll
  for (int j = 0; j < DH / 32; ++j) {
    uint32_t x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = pack_bf16(o[16 * j + 4 * r + 2 * v] * inv, o[16 * j + 4 * r + 2 * v + 1] * inv);
    quad_transpose(x, t);
    if (ok) reinterpret_cast<uint4*>(d)[4 * j + t] = make_uint4(x[0], x[1], x[2], x[3]);
  }
}

template <int DH>
__device__ __forceinline__ void store_row(float* d, const float (&o)[DH / 2], int v, float inv,
                                          int t, bool ok) {
  if (!ok) return;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
    store2(d + 8 * i + 2 * t, o[4 * i + 2 * v] * inv, o[4 * i + 2 * v + 1] * inv);
}

// 32-bit shared-memory loads and stores: the consumers address shared memory
// by its 32-bit address alone (a 64-bit generic pointer is two more
// registers held through their loop, which sits at their budget).
__device__ __forceinline__ uint32_t ld_shared_u16(uint32_t addr) {
  unsigned short x;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(x) : "r"(addr));
  return x;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(x) : "memory");
}

// The generic pointer of shared-memory address `addr`.
__device__ __forceinline__ uint8_t* generic_smem(uint32_t addr) {
  uint64_t p;
  asm("cvta.shared.u64 %0, %1;\n" : "=l"(p) : "l"((uint64_t)addr));
  return reinterpret_cast<uint8_t*>(p);
}

// A position in a block's key tiles: tile `it` of work item `item` of
// (batch * head) `bh`, stepped without dividing (the producer's loop runs a
// step per tile, on one warp in bf16).
struct Cursor {
  int it, item, bh;
  __device__ __forceinline__ void step(int n_tiles, int q_tiles) {
    if (++it == n_tiles) {
      it = 0;
      item += gridDim.x;
      bh = item / q_tiles;
    }
  }
};

// Attention of (batch, head) query tiles against all their keys. A work
// item is one (batch * head, query tile), items in x order with the query
// tile fastest; block b runs items b, b + gridDim.x, ... (PERSIST: a block
// per SM, so the producer streams the next item's tiles while the
// consumers finish the last one; f32 at head dim 128, whose shared memory
// has no room for a separate hand-over, runs one item a block). `split` 1:
// an item is 128 query rows, 64 each of the consumer warpgroups, both of
// which read every key tile; 2: it is 64 rows, and warpgroup c takes the
// key tiles it with it % 2 == c, the two merging their (o, m, l) at the
// end. FRESH (f32 with row stats): the scores by `scores`' fresh sums, whose
// bits the backward recomputes.
template <typename T, int DH, bool FRESH>
__global__ void __launch_bounds__(NARROW_THREADS, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const T* __restrict__ q,
                     const uint8_t* __restrict__ key_valid, T* __restrict__ out,
                     float* __restrict__ stats, int H, int Lq, int Lk, int q_tiles, int n_items,
                     int split, float scale_log2) {
  using C = Narrow<T, DH>;
  extern __shared__ uint8_t smem_raw[];
  // the block's shared memory aligned to 1024 bytes, by its 32-bit address
  // (the producer makes its generic pointer from it in its branch)
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Ring<C::NST> ring{base + C::BARS};
  const int n_tiles = (Lk + C::KEYS - 1) / C::KEYS;
  // this block's items and their key tiles, g = k n_tiles + it for tile it
  // of its k-th item: the ring's stages and phases follow g
  const int n_mine = C::PERSIST ? (n_items - blockIdx.x + gridDim.x - 1) / gridDim.x : 1;
  const int total = n_mine * n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::VST; ++s) mbar_init(base + C::BARS + 8 * (2 * C::NST + s), 1);
    ring.init(C::F32 ? 128 : 32, split == 2 ? 4 : 8);
  }
  __syncthreads();

  // Each thread's indices are made after setmaxnreg in its warpgroup's
  // branch, from threadIdx.x read anew: ptxas spilled values made before
  // the branch and live across it.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::PRODUCER_REGS));
    const int tid = (int)opaque(threadIdx.x), warp = tid / 32, lane = tid % 32;
    uint8_t* smem = generic_smem(opaque(base));
    // the tile being copied, and the one two tiles on whose key flags are
    // loaded (0 past Lk or past the block's tiles), so that the loads'
    // latency is not in the producer's loop
    const int item0 = blockIdx.x;
    Cursor at{0, item0, item0 / q_tiles}, ahead = at;
    ahead.step(n_tiles, q_tiles);
    ahead.step(n_tiles, q_tiles);
    auto flag_of = [&](const Cursor& u, int g, int h) -> uint8_t {
      const int key = (u.it * C::SUB + h) * TILE + lane;
      return g < total && key < Lk ? key_valid[(size_t)(u.bh / H) * Lk + key] : 0;
    };
    if constexpr (C::F32) {
      // the producer warpgroup: thread 0 streams K into tile g's stage and
      // V into its slot; all 128 split them, K in place, V into its
      // transposed planes, and warp 0 writes the tile's key flags
      auto copies = [&](int g) { return base + C::BARS + 8 * (2 * C::NST + g % C::VST); };
      auto issue = [&](int g) {   // thread 0: tile g, at `at`, which it steps on
        ring.wait_empty(g);
        const uint32_t bar = copies(g);
        const uint32_t k_dst = base + (g % C::NST) * C::STAGE;
        const uint32_t v_dst = base + C::V_RAW + (g % C::VST) * C::RAW;
        mbar_expect(bar, 2 * C::RAW);
#pragma unroll
        for (int b = 0; b < C::BOXES; ++b) {
          tma_load(k_dst + b * TILE * 128, &k_map, bar, b * C::BOX, at.it * TILE, at.bh);
          tma_load(v_dst + b * TILE * 128, &v_map, bar, b * C::BOX, at.it * TILE, at.bh);
        }
        at.step(n_tiles, q_tiles);
      };
      if (threadIdx.x == 0)
        for (int g = 0; g < C::VST && g < total; ++g) issue(g);
      uint8_t flag_now = 0, flag_next = 0;
      if (warp == 0) {
        Cursor first{0, item0, item0 / q_tiles}, second = first;
        second.step(n_tiles, q_tiles);
        flag_now = flag_of(first, 0, 0);
        flag_next = flag_of(second, 1, 0);
      }
      for (int g = 0; g < total; ++g) {
        uint8_t flag_after = 0;
        if (warp == 0) {
          flag_after = flag_of(ahead, g + 2, 0);
          ahead.step(n_tiles, q_tiles);
        }
        mbar_wait(copies(g), (g / C::VST) & 1);
        uint8_t* st = smem + (g % C::NST) * C::STAGE;
        split_rows<C, true>(st, st, tid);
        split_cols<C, true>(st + 2 * C::PLANE, smem + C::V_RAW + (g % C::VST) * C::RAW, tid);
        if (warp == 0) smem[C::FLAGS + (g % C::NST) * C::KEYS + lane] = flag_now;
        fence_async_smem();
        mbar_arrive(ring.full(g));
        bar_sync(BAR_SPLIT, 128);   // every thread done with the tile's V slot
        if (threadIdx.x == 0 && g + C::VST < total) issue(g + C::VST);
        flag_now = flag_next;
        flag_next = flag_after;
      }
    } else {
      // warp 0 streams K's and V's sub-tiles and the key flags into the ring
      if (warp != 0) return;
      uint8_t flag_now[C::SUB], flag_next[C::SUB];
      {
        Cursor second = at;
        second.step(n_tiles, q_tiles);
#pragma unroll
        for (int h = 0; h < C::SUB; ++h) {
          flag_now[h] = flag_of(at, 0, h);
          flag_next[h] = flag_of(second, 1, h);
        }
      }
      for (int g = 0; g < total; ++g) {
        uint8_t flag_after[C::SUB];
#pragma unroll
        for (int h = 0; h < C::SUB; ++h) flag_after[h] = flag_of(ahead, g + 2, h);
        ahead.step(n_tiles, q_tiles);
        ring.wait_empty(g);
        const uint32_t st = base + (g % C::NST) * C::STAGE;
        // the copies first, then the flags (whose load may still be on its
        // way: the first tile's was issued just before the loop), then the
        // warp's 32 arrivals
        if (lane == 0) {
          mbar_expect_tx(ring.full(g), 2 * C::SUB * C::RAW);
#pragma unroll
          for (int h = 0; h < C::SUB; ++h) {
            const int row = (at.it * C::SUB + h) * TILE;
#pragma unroll
            for (int b = 0; b < C::BOXES; ++b) {
              tma_load(st + h * C::RAW + b * TILE * 128, &k_map, ring.full(g), b * C::BOX, row,
                       at.bh);
              tma_load(st + (C::SUB + h) * C::RAW + b * TILE * 128, &v_map, ring.full(g),
                       b * C::BOX, row, at.bh);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < C::SUB; ++h)
          st_shared_u8(base + C::FLAGS + (g % C::NST) * C::KEYS + TILE * h + lane, flag_now[h]);
        mbar_arrive(ring.full(g));
        at.step(n_tiles, q_tiles);
#pragma unroll
        for (int h = 0; h < C::SUB; ++h) {
          flag_now[h] = flag_next[h];
          flag_next[h] = flag_after[h];
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
  const int tx = (int)opaque(threadIdx.x), c = tx / 128 - 1, tid = tx % 128;
  const int warp = tid / 32, lane = tx % 32, gl = lane / 4, t = lane % 4;
  // key split 2 over one key tile (up to C::KEYS keys): warpgroup 2 has no
  // tile in any item, and warpgroup 1 nothing to merge
  const bool lone = split == 2 && n_tiles == 1;
  if (lone && c == 1) return;
  for (int k = 0; k < n_mine; ++k) {
    const int item = blockIdx.x + k * gridDim.x;
    const int bh = item / q_tiles, q_tile = item % q_tiles;
    const int row0 = split == 2 ? q_tile * WG_ROWS : q_tile * 2 * WG_ROWS + c * WG_ROWS;
    RowFrags<C, T> qf;
    qf.load(q + (size_t)bh * Lq * DH, row0 + 16 * warp, Lq, gl, t);
    float o[DH / 2];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows g, g + 8
    for (int it = split == 2 ? c : 0; it < n_tiles; it += split) {
      const int g = k * n_tiles + it;
      ring.wait_full(g);
      const uint32_t st = opaque(base + (g % C::NST) * C::STAGE);
      float s[C::SUB][16];
      if constexpr (C::F32) scores<C, false, FRESH>(s[0], qf, st);
      else scores_bf16<C, C::SUB>(s, qf, st);
      const uint32_t fl = base + C::FLAGS + (g % C::NST) * C::KEYS + 2 * t;
      uint32_t flags[C::SUB][4];
#pragma unroll
      for (int h = 0; h < C::SUB; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) flags[h][i] = ld_shared_u16(fl + TILE * h + 8 * i);
      float alpha[2];
      softmax_wg<C::SUB>(s, alpha, m, l, flags, it * C::KEYS, Lk, scale_log2, t);
      if constexpr (C::F32) pv_f32<C>(o, s[0], alpha, st + 2 * C::PLANE);
      else pv_bf16<C, C::SUB>(o, s, alpha, st + C::SUB * C::RAW);
      ring.release(g, lane);
    }

    if (split == 2 && !lone) {   // warpgroup 2 hands (o, m, l) to warpgroup 1
      // in the ring (not PERSIST), once both are done with it; else in a
      // region of its own, once warpgroup 1 has read the last item's.
      // Element e of thread tid at float e * 128 + tid.
      const uint32_t merge = base + C::MERGE_AT + 4 * tid;
      if (!C::PERSIST) bar_sync(BAR_DONE, 256);
      if (c == 1) {
        if (C::PERSIST && k > 0) bar_sync(BAR_FREE, 256);
#pragma unroll
        for (int e = 0; e < DH / 2; ++e) st_shared_f32(merge + e * 512, o[e]);
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          st_shared_f32(merge + (DH / 2 + v) * 512, m[v]);
          st_shared_f32(merge + (DH / 2 + 2 + v) * 512, l[v]);
        }
        bar_arrive(BAR_MERGE, 256);
        continue;
      }
      bar_sync(BAR_MERGE, 256);
      float a_own[2], a_w[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        // m[v] is finite (tile 0 holds key 0); a warpgroup whose tiles all
        // lay past Lk left m = -inf, l = 0, o = 0
        const float m_w = ld_shared_f32(merge + (DH / 2 + v) * 512);
        const float m_new = fmaxf(m[v], m_w);
        a_own[v] = exp2f(m[v] - m_new);
        a_w[v] = exp2f(m_w - m_new);
        l[v] = l[v] * a_own[v] + ld_shared_f32(merge + (DH / 2 + 2 + v) * 512) * a_w[v];
        m[v] = m_new;
      }
#pragma unroll
      for (int e = 0; e < DH / 2; ++e)
        o[e] = o[e] * a_own[(e >> 1) & 1] + ld_shared_f32(merge + e * 512) * a_w[(e >> 1) & 1];
      if (C::PERSIST && k + 1 < n_mine) bar_arrive(BAR_FREE, 256);
    }

    // normalise, store the rows below Lq, and with `stats` each row's max m
    // (log2 units) and sum l, from which the backward kernel takes its
    // weights
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int row = row0 + 16 * warp + gl + 8 * v;
      const bool in = row < Lq;
      const float sum = quad_sum(l[v]);
      const float inv = 1.f / sum;
      if (in && stats != nullptr && t == 0)
        *reinterpret_cast<float2*>(stats + ((size_t)bh * Lq + row) * 2) = make_float2(m[v], sum);
      store_row<DH>(out + ((size_t)bh * Lq + (in ? row : 0)) * DH, o, v, inv, t, in);
    }
  }
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
  scores_tf32<C, C::CHUNK / 16>(s, [&](int j, float4& x, float4& y) {
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
  // This thread's key flag of step it is loaded at step it - 2, so that two
  // steps hide its latency, and stored into step it's stage before step
  // it's barrier (the stage's last reader, step it - 3, passed step it - 2's).
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
    weighted_values<C, W>(o, s, alpha, st + wn * C::BN * C::LDV, lane, width);
  }

  finish<C, W, SPLIT>(o, m_run, l_run, smem, wm, wn, lane, out + q_base + col0,
                      row_blk + 16 * wm, Lq, Dh, width);
}

// One grid of B * H * tiles * slices blocks along x (up to INT_MAX: far
// beyond what device memory holds), or cudaErrorInvalidValue.
inline bool grid_fits(int B, int H, int tiles, int slices) {
  return (long long)B * H * tiles * slices <= INT_MAX;
}

// The current device's SM count, looked up once per device.
cudaError_t sm_count(int* n) {
  constexpr int MAX_DEVICES = 64;
  static int counts[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && counts[dev] > 0) {
    *n = counts[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) counts[dev] = *n;
  return err;
}

// One launch of the narrow route: work items of (batch * head, query tile
// of 64 x (3 - split) rows), up to INT_MAX of them, in one block each or
// (PERSIST) in a block per SM; or cudaErrorInvalidValue.
template <typename T, int DH, bool FRESH>
cudaError_t launch_narrow(const void* q, const void* k, const void* v, const void* key_valid,
                          void* out, float* stats, int B, int H, int Lq, int Lk, float scale_log2,
                          int split, cudaStream_t stream) {
  using C = Narrow<T, DH>;
  auto kernel = attention_fwd_kernel<T, DH, FRESH>;
  static bool allowed[64] = {};
  cudaError_t err = allow_smem((const void*)kernel, C::BYTES, allowed);
  if (err != cudaSuccess) return err;
  const long long bh = (long long)B * H;
  const int rows = split == 2 ? WG_ROWS : 2 * WG_ROWS;
  const long long q_tiles = (Lq + rows - 1) / rows;
  if (bh * q_tiles > INT_MAX) return cudaErrorInvalidValue;
  const CUtensorMapDataType type = C::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap k_map, v_map;
  if ((err = tensor_map(&k_map, k, type, C::ES, bh, Lk, DH, C::BOX, true)) != cudaSuccess
      || (err = tensor_map(&v_map, v, type, C::ES, bh, Lk, DH, C::BOX, true)) != cudaSuccess)
    return err;
  const int items = (int)(bh * q_tiles);
  int blocks = items;
  if (C::PERSIST) {
    if ((err = sm_count(&blocks)) != cudaSuccess) return err;
    blocks = blocks < items ? blocks : items;
  }
  kernel<<<blocks, NARROW_THREADS, C::BYTES, stream>>>(
      k_map, v_map, static_cast<const T*>(q), static_cast<const uint8_t*>(key_valid),
      static_cast<T*>(out), stats, H, Lq, Lk, (int)q_tiles, items, split, scale_log2);
  return cudaGetLastError();
}

// The narrow route at key split 1 or 2: f32 with row stats takes the
// instance whose scores are the backward's.
template <typename T, int DH>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* key_valid,
                         void* out, float* stats, int B, int H, int Lq, int Lk, int Dh,
                         float scale_log2, int key_split, cudaStream_t stream) {
  if (key_split != 1 && key_split != 2) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    if (stats != nullptr)
      return launch_narrow<T, DH, true>(q, k, v, key_valid, out, stats, B, H, Lq, Lk, scale_log2,
                                        key_split, stream);
  }
  return launch_narrow<T, DH, false>(q, k, v, key_valid, out, stats, B, H, Lq, Lk, scale_log2,
                                     key_split, stream);
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

// The wide route at key split 1, 2 or 4.
template <typename T>
cudaError_t launch_wide_split(const void* q, const void* k, const void* v, const void* key_valid,
                              void* out, float* stats, int B, int H, int Lq, int Lk, int Dh,
                              float scale_log2, int key_split, cudaStream_t stream) {
  if (stats != nullptr) return cudaErrorInvalidValue;   // the narrow route's alone
#define FSCL_WIDE(s) \
  launch_wide<T, s>(q, k, v, key_valid, out, B, H, Lq, Lk, Dh, scale_log2, stream)
  switch (key_split) {
    case 1: return FSCL_WIDE(1);
    case 2: return FSCL_WIDE(2);
    case 4: return FSCL_WIDE(4);
    default: return cudaErrorInvalidValue;
  }
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
#endif
#if FSCL_OWNS(2)
cudaError_t fscl_attention_f32_128(FSCL_ATTENTION_ARGS) {
  return launch_split<float, 128>(FSCL_ATTENTION_CALL);
}
#endif
#if FSCL_OWNS(3)
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
// dtype: 0 = float32, 1 = bfloat16. key_split: on the narrow route 1 (a
// block owns 128 query rows) or 2 (64 rows, its two consumer warpgroups
// splitting the key loop); on the wide route the warps of a block that share
// the key loop (1, 2 or 4; a block owns 128 (f32) or 64 (bf16) query rows
// divided by key_split). stats: null, or (narrow route only) a contiguous
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
