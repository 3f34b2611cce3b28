// Hopper building blocks of the attention kernels (csrc/attention.cu's
// narrow route and csrc/attention_bwd.cu), over the generic ones of
// csrc/hopper.cuh: the tiles' layouts, wgmma with swizzled descriptors, the
// split of tiles into TF32 planes, and the score routine both files call,
// so that the forward's scores (the ones its row stats are taken from) and
// the backward's recomputed ones are the same code and the same bits.
//
// Everything here has internal linkage (an unnamed namespace): each build
// part of each file compiles its own copy.

#pragma once

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <type_traits>

namespace {

constexpr int TILE = 32;             // rows of a streamed tile (keys, or query rows in dK / dV)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_FILL_LOG2 = -1e9f * LOG2E;   // the finite fill of an invalid key's score

// The layout of a streamed tile of TILE rows x DH columns of T: as TMA
// stores it (128-byte column boxes of TILE rows, 128-byte swizzle) and as
// its TF32 planes (f32: big and small parts, PLANE bytes each).
template <typename T, int DH>
struct Tiles {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int HD = DH;
  static constexpr int KS = DH / 8;                  // TF32 k-steps over the head dim
  static constexpr int NQ = DH / 32;                 // 32-column quarters of the head dim
  static constexpr int ES = (int)sizeof(T);
  static constexpr int BOX = 128 / ES;               // columns of a 128-byte TMA box
  static constexpr int BOXES = DH / BOX;
  static constexpr int RAW = TILE * DH * ES;         // a streamed tile as it came
  static constexpr int PLANE = TILE * DH * 4;        // one TF32 part of a tile, either way round
  static constexpr int NPL = F32 ? 2 : 1;            // parts: big, small (bf16: big only)
  static constexpr int OPERAND = NPL * PLANE;
  static_assert(DH == 64 || DH == 128, "head dims 64 and 128");
};

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void st_shared_u8(uint32_t addr, uint8_t x) {
  asm volatile("st.shared.u8 [%0], %1;\n" :: "r"(addr), "h"((unsigned short)x) : "memory");
}

// -- wgmma ---------------------------------------------------------------------

// Descriptor of a K-major operand with the 128-byte swizzle: rows 128 bytes
// apart, 8-row groups 1024 bytes apart; `addr` is where its first row's
// current k-step starts (k-steps advance 32 bytes within a 128-byte row).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}

// Descriptor of an MN-major 16-bit operand with the 128-byte swizzle, as
// TMA stores a tile in 128-byte column boxes: 64 columns (N) x 8 rows (K)
// per 1024-byte atom, the next 8 rows 1024 bytes on, the next 64 columns
// `box_bytes` on; `addr` is where the current k-step's first row starts.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr, uint32_t box_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((box_bytes >> 4) & 0x3FFF) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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

// The row planes of a tile: B of S = Q K^T (K rows) or of S^T = K Q^T (Q
// rows): TILE rows x DH, K-major, 32-column atoms of TILE x 128 bytes,
// swizzled. The head dim is permuted within each 16: column 16j + 4a + 2h +
// b sits at 16j + 8h + 4b + a, so that k-step 2j + h holds the columns 16j +
// 4t + 2h (k = t) and + 1 (k = t + 4) of RowFrags. Thread tid of a
// warpgroup: rows tid % 32, 16-column groups tid / 32 + 4u. A thread reads
// the same four 16-byte chunks of the tile as it came that it writes to the
// big plane, so `planes` may be `raw` itself (f32: the forward splits K in
// place). SEQ: one u at a time (a producer with few registers).
template <class C, bool SEQ = false>
__device__ __forceinline__ void split_rows(uint8_t* planes, const uint8_t* raw, int tid) {
  tid = opaque(tid);
#pragma unroll
  for (int u = 0; u < TILE * C::HD / 16 / 128; ++u) {
    if constexpr (SEQ) u = opaque(u);
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

// The transposed planes of a tile: B of a product that contracts over the
// tile's rows (O = P V: V; dQ = dS K: K; dK = dS^T Q: Q): DH rows x TILE,
// K-major, one swizzled atom. The tile's rows are permuted within each 8:
// row 8i + 2a + b sits at 8i + 4b + a, so that k-step i takes a thread's
// accumulator columns 8i + 2t (k = t) and + 1 (k = t + 4) as its A
// fragment. Thread tid of a warpgroup: chunks (4 rows of the tile) tid % 8,
// 4-column groups tid / 8 + 16u. SEQ: one u at a time.
template <class C, bool SEQ = false>
__device__ __forceinline__ void split_cols(uint8_t* planes, const uint8_t* raw, int tid) {
  tid = opaque(tid);
#pragma unroll
  for (int u = 0; u < 8 * C::HD / 4 / 128; ++u) {
    if constexpr (SEQ) u = opaque(u);
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

// -- the resident rows and the scores -------------------------------------------

// A warp's 16 rows (r and r + 8 from row0) of a (rows, DH) input as raw
// wgmma A elements for every k-step, kept in registers for the whole block:
// k-step 2j + h holds (X[r][c], X[r + 8][c], X[r][c + 1], X[r + 8][c + 1])
// at c = 16j + 4t + 2h, f32 as they are. Rows past `rows` are 0.
// bits() hands an element over opaque to the compiler, so that the split
// of an element at each use is not hoisted out of the tile loop, where the
// split parts of all of them would take twice the registers.
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

// A 4 x 4 transpose across the lanes of a quad (t = lane % 4): lane t holds
// column t of M (x[r] = M[r][t]) and ends with row t (x[c] = M[t][c]), or
// the other way round. Two exchanges: with lane t ^ 1 (rows 2k and 2k + 1),
// then with lane t ^ 2 (column pairs b and 2 + b).
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int t) {
  const bool odd = t & 1, high = t & 2;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? x[2 * k] : x[2 * k + 1], 1);
    x[2 * k] = odd ? got : x[2 * k];
    x[2 * k + 1] = odd ? x[2 * k + 1] : got;
  }
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, high ? x[b] : x[2 + b], 2);
    x[b] = high ? got : x[b];
    x[2 + b] = high ? x[2 + b] : got;
  }
}

// bf16: the m64nNk16 A fragments of each k16 step ks: (X[r][c], X[r][c +
// 1]), the same of row r + 8, then both at c + 8, c = 16 ks + 2t. A row's
// 32-bit words 4i + t (i = 2 ks, 2 ks + 1) are lane t's; the quad loads each
// 64-byte span of the row as four 16-byte pieces (lane t the t-th) and
// transposes them into place, rather than each lane loading its words 16
// bytes apart (half of each sector unused by each load).
template <class C>
struct RowFrags<C, __nv_bfloat16> {
  uint32_t a[C::HD / 16][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* src, int row0, int rows, int g, int t) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int row = row0 + g + 8 * v;
      const uint4* r = reinterpret_cast<const uint4*>(src + (size_t)(row < rows ? row : 0) * C::HD);
#pragma unroll
      for (int j = 0; j < C::HD / 32; ++j) {
        const uint4 w = row < rows ? r[4 * j + t] : make_uint4(0u, 0u, 0u, 0u);
        uint32_t x[4] = {w.x, w.y, w.z, w.w};
        quad_transpose(x, t);
#pragma unroll
        for (int q = 0; q < 4; ++q) a[2 * j + q / 2][2 * (q & 1) + v] = x[q];
      }
    }
  }
};

// s = (the warpgroup's 64 resident rows) (the tile's TILE rows)^T over the
// head dim: S, dP, S^T or dP^T; `plane` is the tile's big row plane (bf16:
// the tile as it came). This is the routine of the forward's scores where
// it writes row stats and of the backward's recomputed ones: both call it
// with the same operands, so the backward's weights are the forward's.
// - f32, FRESH: each 16 columns' passes go into a fresh accumulator f, added
//   to s rounded to nearest (the tensor cores add into an accumulator with
//   truncation: never more than 16 columns so). f starts as s - s, exactly
//   +0, which ties it to the last add into s: ptxas would otherwise issue
//   the next group before that add and hold several f at once. SWAP runs the
//   first two passes as big(A) small(B), small(A) big(B): with K (or V) as
//   A, the same partial products in the same order as with Q (or g) as A.
// - f32, not FRESH (the forward without row stats): every pass into s.
// - bf16: every k16 step into s (B the tile as TMA stored it, 128-byte
//   swizzled boxes of 64 columns).
// Element 4i + 2v + c of s: resident row 16 warp + g + 8v, tile row 8i + 2t
// + c.
template <class C, bool SWAP, bool FRESH = true, class RF>
__device__ __forceinline__ void scores(float (&s)[16], const RF& rf, uint32_t plane) {
  static_assert(FRESH || !SWAP, "the transposed scores are the backward's: fresh sums");
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
  if constexpr (!C::F32) {
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
      if constexpr (FRESH) {
#pragma unroll
        for (int i = 0; i < 16; ++i) f[i] = __fsub_rn(s[i], s[i]);
      }
      float(&acc)[16] = FRESH ? f : s;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = 2 * j + h;
        const uint32_t off = ((ks >> 2) * TILE * 128 + (ks & 3) * 32) >> 4;
        if constexpr (SWAP) {
          wgmma_n32(acc, ab[h], small + off);
          wgmma_n32(acc, as[h], big + off);
        } else {
          wgmma_n32(acc, as[h], big + off);
          wgmma_n32(acc, ab[h], small + off);
        }
        wgmma_n32(acc, ab[h], big + off);
      }
      wg_commit();
      wg_wait();
      fence_regs(acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fence_regs(ab[h]);
        fence_regs(as[h]);
      }
      if constexpr (FRESH) {
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] += f[i];
        fence_regs(s);
      }
    }
  }
}

// The block's shared memory, aligned to 1024 bytes for the swizzled tiles.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t s = smem_u32(raw);
  return raw + (((s + 1023) & ~1023u) - s);
}

// -- host side -------------------------------------------------------------------
// The map of a contiguous (bh, rows, cols) tensor in boxes of `box` columns
// x TILE rows of one (batch, head); rows past `rows` read as zeros, never
// the next (batch, head)'s. swizzle: the 128-byte swizzle (box * itemsize ==
// 128).
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

}  // namespace
