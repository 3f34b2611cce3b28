// One HiFiGAN multi-receptive-field (MRF) stage for Hopper (sm_90a), on the
// tensor cores by wgmma.
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
//   zero, and each product is taken as small*big + big*small + big*big on the
//   TF32 tensor cores, accumulated in f32: 3 * ops over 495 TFLOP/s.
// A chain of one launch per conv moves each (B, C, T) tensor through device
// memory about 47 times a V1 stage (chip_smoke.py:chain_floor), more than the
// bf16 products take; the TPU kernel kept the intermediates in VMEM.
//
// What the design does:
// - Each conv pair (conv1 of dilation d, then conv2 of dilation 1) is one
//   launch. A block owns M time rows of a sample: conv1 runs over the tile's
//   BT = M - 2 r2 output rows plus conv2's halo of r2 = (k - 1) / 2 rows on
//   each side; leaky(conv1 + bias), zero outside [0, T), is written to shared
//   memory (h) in the layout conv2's A operand reads; conv2 then runs over the
//   M rows, of which the BT inside the halo are stored, with the bias, the
//   residual (the pair's input, read again from device memory) and the
//   running mean of the resblocks and its scale in the epilogue. Where h for all C channels of M rows does not fit beside the
//   rings (route(): f32 above C = 128, bf16 above C = 256; h's f32 rows are 4
//   bytes a channel, bf16's 2), the pair is two launches of one conv each, h
//   going through device memory: at C = 256 in f32 the stage is bound by its
//   products (0.9 ms of traffic against 6.4 ms of operations). A V1 stage is
//   then 9 launches plus conv_post (18 at C = 256 in f32).
// - The operands: time rows are wgmma's M and output channels its N (N = NP
//   channels a pass: 128, 64 or 32 by C, so that any multiple of 32 is
//   taken and every V1 width fills N; conv1 runs C / NP passes over the same
//   rows, each streaming the window again), K = input channels, one k-step
//   (8 f32, 16 bf16) at a time, for each tap. With channels as M instead, C
//   = 32 would be below wgmma's 64 rows, and a block would not hold every
//   channel of h for its rows. A and B both come from shared memory, K-major
//   (32-bit wgmma takes no other) and without swizzle: a row of the operand
//   is 16 bytes of K, rows 16 bytes apart, so that tap i's shift of i * d
//   rows is i * d added to the A descriptor (a swizzled layout's 1024-byte
//   atoms break under any shift that is not a multiple of 8 rows). The two
//   16-byte halves of a k-step lie a plane of rows apart (the descriptor's
//   leading offset). The weights are B: output channels as rows.
// - A producer warpgroup and two consumer warpgroups (setmaxnreg 40 / 232).
//   Warp 0 streams the weights by bulk copy: each (pass, k-step, tap) is one
//   contiguous chunk, packed once on the host in the operand layout
//   (ops/mrf_stage.py:_pack_weight; f32 as TF32 big and small planes), TG
//   taps a stage of a ring of NW. Warps 1-3 stream conv1's window for each
//   k-step by TMA (a tensor map of the (B, C, T) input; rows outside [0, T)
//   filled with zeros by the copy itself; the window starts on 16 bytes, up
//   to 3 rows early; one window ahead, into a ring of NR) and write it once,
//   leaky and split into TF32 planes (bf16: rounded), transposed into the
//   operand layout of a ring of NA A stages; in f32 they also split h, a
//   k-step of channels at a time, for conv2 (bf16 h is conv2's A operand as
//   it lies). Consumer warpgroup c owns rows c * M / 2.. (MB m64 blocks) and
//   holds their sums (NP / 2 * MB registers a thread); a group of wgmma a
//   tap, one group in flight (wgmma.wait_group 1), each stage released when
//   the last group that read it is done.
// - The tile height M is a template argument: 256, 384 or 512 rows, the most
//   for which h fits (route), so that small C, whose taps are little work,
//   pay their per-tile costs (the halo, the handshakes, the epilogue) over
//   more rows. Where a warpgroup's sums take at most 64 registers, the last
//   conv's residual is loaded into registers before its products.
// - f32 sums over more than 256 input channels (two launches a pair, C > 256)
//   are taken in fresh sums of 256 channels added to a running sum in shared
//   memory, rounded to nearest: the tensor cores' f32 adds truncate, and one
//   sum over C = 512 x 11 taps missed the stage's f32 bar (mean 1.4e-5).
// - Blocks are persistent, one per SM, walking the tiles (sample-major);
//   blocks running at once read the same weights, so they come from L2.
// - TMA needs 16-byte global strides: the wrapper pads a ragged T to a
//   multiple of 4 (ld), reads and writes stop at T.
// - Every global offset is 64-bit (size_t): a sample's C * T and a launch's
//   B * C * T may pass 2^31 (a sample at C = 64, T = 2^25 is 8 GiB of f32).
//   T, B, the channel and the time of a row, and the tile index stay int: T
//   up to INT_MAX - 1024 (so that a window's last row, T plus the halo and a
//   tile, still fits), B up to 65535 (the wrapper splits larger batches),
//   and a launch's tiles below 2^31 (checked at launch).
// - Every instance builds with 0 bytes of spill: 128 x 40 + 256 x 232
//   registers stay within the block's 384 x 168 at launch; the epilogue's
//   offsets are made where they are used.
//
// Build: 9 instances (f32 / bf16 by NP, M and weight stages, route), in four
// parts at once (FSCL_PART, below).
// build parts: 4

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 384;        // a producer warpgroup and two consumer warpgroups
constexpr int PRODUCER_REGS = 40;   // 128 x 40 + 256 x 232 = 384 x 168, the block's at launch
constexpr int CONSUMER_REGS = 232;
constexpr int RMAX = 32;            // largest reach (k - 1) / 2 * dilation taken
constexpr int GUARD = 6;            // h rows beside a tile's M: conv2 reads r2 <= 5 past them
constexpr int MAX_T = INT_MAX - 1024;   // T + halo + a tile's rows fit an int
constexpr int BAR_CONSUMERS = 1;    // named barrier of the two consumer warpgroups
constexpr float SLOPE = 0.1f;

static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= THREADS * 168,
              "setmaxnreg moves registers within the block's");

// One instance: compute type, NP output channels a pass and M time rows a
// tile (route picks the instance: the most rows for which h fits). Consumer
// warpgroup c owns rows c * M / 2.. (MB m64 blocks), their sums NP / 2 * MB
// registers a thread. Shared memory: the A ring (operand planes of a window
// or of an h k-step, WR rows apart), the raw window ring (as TMA lands it:
// KC channel rows of up to RAW_ROWS f32), the weight ring (TG taps of a
// k-step a stage), the barriers, then h (fused pairs only: HR rows of each
// channel).
template <bool BF16, int NP, int M_, int NW_ = 0>
struct Cfg {
  static constexpr int M = M_;                     // rows a block computes
  static constexpr int MB = M / 128;               // m64 blocks of a consumer warpgroup
  static constexpr int KC = BF16 ? 16 : 8;         // input channels a k-step
  static constexpr int CPG = BF16 ? 8 : 4;         // channels of a 16-byte operand row
  static constexpr int NPL = BF16 ? 1 : 2;         // operand planes (f32: TF32 big, small)
  static constexpr int EB = BF16 ? 2 : 4;          // bytes of an h element
  static constexpr int WR = M + 2 * RMAX + 8;      // window rows (and the A planes' pitch)
  static constexpr int HR = M + 2 * GUARD;         // h rows
  static constexpr int RAW_ROWS = WR + 8;          // the boxes round the window up
  static constexpr int CHUNK = NPL * 2 * NP * 16;  // one tap's weights of a k-step and pass
  // taps a weight stage: 8 KB of weights, or one tap (bf16 at NP = 128, so
  // that h at C = 256 fits)
  static constexpr int TG = BF16 && NP == 128 ? 1 : 8192 / CHUNK;
  // ring stages, each depth the faster of those measured where shared
  // memory allows (h at C = 128 f32 and C = 256 bf16 takes most of it): A
  // 3 in bf16 below NP = 128, else 2; raw windows 3 in bf16 at NP = 64
  // (over 512-row tiles with 2), else 2; weights NW_ where the instance
  // names it (bf16 at NP = 128 and C = 128: 16 stages of one tap, the copies
  // in flight to cover a tap's short products), else 6 in bf16 at NP = 128,
  // 3 in f32 there, 4 below
  static constexpr int NA = BF16 && NP < 128 ? 3 : 2, NR = BF16 && NP == 64 ? 3 : 2;
  static constexpr int NW = NW_ ? NW_ : NP == 128 ? (BF16 ? 6 : 3) : 4;
  static constexpr int A_STAGE = NPL * 2 * WR * 16;
  static constexpr int RAW_STAGE = KC * RAW_ROWS * 4;
  static constexpr int W_STAGE = TG * CHUNK;
  static constexpr int RAW_AT = NA * A_STAGE;
  static constexpr int W_AT = RAW_AT + NR * RAW_STAGE;
  static constexpr int BARS = W_AT + NW * W_STAGE;
  static constexpr int H_AT = (BARS + 8 * (2 * (NA + NR + NW) + 1) + 127) / 128 * 128;
  static_assert(M % 128 == 0 && NP % 32 == 0 && TG >= 1 && HR <= WR, "tiles");
  static_assert(A_STAGE % 128 == 0 && RAW_STAGE % 128 == 0 && W_STAGE % 128 == 0, "alignment");
  static_assert(NP / 2 * MB <= 128, "a consumer's sums fit its registers");
  // f32 convs over more than KSPLIT input channels (two launches a pair)
  // sum them in fresh sums of KSPLIT channels, the running sum in shared
  // memory where h lies in a fused pair
  static constexpr int KSPLIT = 256;
  static constexpr long long RUN_BYTES = 256LL * MB * NP / 2 * 4;
  // dynamic shared memory of a launch (with 128 bytes to align the base)
  static constexpr long long bytes(int C, bool fused) {
    return H_AT + (fused ? (long long)HR * C * EB : !BF16 && C > KSPLIT ? RUN_BYTES : 0) + 128;
  }
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : v * SLOPE; }

// The first row of a window that must start at time `first`: rounded down
// to a multiple of 4, as a TMA box's first element must lie on 16 bytes
// (a box starting elsewhere, inside or outside [0, T), is an illegal
// instruction on the card).
__device__ __forceinline__ int window_start(int first) { return first & ~3; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d (64 x N) += A (64 x K) B^T (B: N x K), A and B K-major in shared memory
// at their descriptors (desc_rows), one k-step: K = 8 TF32 or 16 bf16.
// Element r of d: row 16 * warp + g + 8 * ((r / 2) % 2), column 8 * (r / 4)
// + 2 * t + r % 2 (g = lane / 4, t = lane % 4).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void tf32(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void bf16(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void tf32(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void bf16(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void tf32(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void bf16(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// A launch's arguments. The window source (conv1's input, or h between the
// two launches of an unfused pair) is the tensor map beside them.
struct ConvArgs {
  const uint8_t* w0;     // phase 0 (conv1, or the one conv) weights, _pack_weight's layout
  const float* b0;
  const uint8_t* w1;     // phase 1 (conv2 of a fused pair)
  const float* b1;
  const float* res;      // added in the last epilogue, or null: (B, C, ld)
  const float* accin;    // added after res, or null; may alias out
  float* out;            // (B, C, ld): rows [0, T) written
  int B, C, T, ld, k, d; // d: phase 0's dilation
  int fused;             // 1: conv1 -> h in shared memory -> conv2; 0: one conv
  int box_t, nb;         // rows a TMA box, boxes a window
  int kgroup;            // k-steps a fresh sum takes before it is added to the
                         // running sum in shared memory; 0: one sum of all
  float scale;           // the last epilogue's factor
};

// The pair (or one conv) over a block's tiles; see the header. Phase 0 runs
// conv1 on windows of the source into h (fused) or out; phase 1 (fused) runs
// conv2 on h into out.
template <bool BF16, int NP, int M, int NW>
__global__ void __launch_bounds__(THREADS, 1)
pair_kernel(const __grid_constant__ CUtensorMap src, const ConvArgs a) {
  using G = Cfg<BF16, NP, M, NW>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127) & ~127u;
  const Ring<G::NA, true> ring_a{base + G::BARS};
  const Ring<G::NR, true> ring_r{base + G::BARS + 16 * G::NA};
  const Ring<G::NW, true> ring_w{base + G::BARS + 16 * (G::NA + G::NR)};
  const uint32_t h_full = base + G::BARS + 16 * (G::NA + G::NR + G::NW);
  const int r2 = a.fused ? (a.k - 1) / 2 : 0;      // conv2's reach
  const int bt = G::M - 2 * r2;                     // output rows a tile
  const int t_tiles = (a.T + bt - 1) / bt;
  const int n_tiles = t_tiles * a.B;                // < 2^31, checked at launch
  const int n_mine = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nk = a.C / G::KC, passes = a.C / NP;
  const int phases = 1 + a.fused;

  if (threadIdx.x == 0) {
    ring_a.init(3, 8);     // the 3 converter warps fill; the 8 consumer warps release
    ring_r.init(1, 3);     // TMA fills; the converter warps release
    ring_w.init(1, 8);     // bulk copies fill; the consumer warps release
    mbar_init(h_full, 8);  // the consumer warps, once a tile's h is written
  }
  __syncthreads();

  // Each thread's indices are made after setmaxnreg in its warpgroup's
  // branch, from threadIdx.x read anew (values live across the branch spill).
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    const int tid = (int)opaque(threadIdx.x), warp = tid / 32, lane = tid % 32;
    const uint32_t b0 = opaque(base);
    if (warp == 0) {
      // the weights: every (phase, pass, k-step) in the order the consumers
      // take them, TG taps (contiguous chunks) a stage
      if (lane == 0) {
        const int steps = passes * nk;
        int qw = 0;
        for (int n = 0; n < n_mine; ++n)
          for (int ph = 0; ph < phases; ++ph) {
            const uint8_t* w = ph ? a.w1 : a.w0;
            for (int s = 0; s < steps; ++s)
              for (int i0 = 0; i0 < a.k; i0 += G::TG, ++qw) {
                const uint32_t bytes = min(G::TG, a.k - i0) * G::CHUNK;
                ring_w.wait_empty(qw);
                mbar_expect(ring_w.full(qw), bytes);
                bulk_load(b0 + G::W_AT + (qw % G::NW) * G::W_STAGE,
                          w + ((size_t)s * a.k + i0) * G::CHUNK, bytes, ring_w.full(qw));
              }
          }
      }
      return;
    }
    uint8_t* smem = smem_raw + (b0 - smem_u32(smem_raw));
    const int ct = tid - 32;                         // converter thread 0..95
    const int per_tile = passes * nk;                // phase 0 windows a tile
    const int windows = n_mine * per_tile;
    const int W = min(a.nb * a.box_t, G::WR);        // window rows converted
    // window u (this block's tile u / per_tile, k-step u % nk) into its raw
    // stage: nb boxes of box_t rows x KC channels from window_start
    auto issue = [&](int u) {
      ring_r.wait_empty(u);
      const int tile = (int)blockIdx.x + (u / per_tile) * (int)gridDim.x;
      const int b = tile / t_tiles, t0 = (tile % t_tiles) * bt;
      const int w0 = window_start(t0 - r2 - (a.k - 1) / 2 * a.d);
      const uint32_t bar = ring_r.full(u);
      const uint32_t dst = b0 + G::RAW_AT + (u % G::NR) * G::RAW_STAGE;
      mbar_expect(bar, (uint32_t)(a.nb * G::KC * a.box_t * 4));
      for (int i = 0; i < a.nb; ++i)
        tma_load(dst + i * G::KC * a.box_t * 4, &src, bar, w0 + i * a.box_t, (u % nk) * G::KC, b);
    };
    if (ct == 0 && windows > 0) issue(0);
    int qa = 0, u = 0;
    for (int n = 0; n < n_mine; ++n) {
      for (int w = 0; w < per_tile; ++w, ++u, ++qa) {
        if (ct == 0 && u + 1 < windows) issue(u + 1);
        ring_r.wait_full(u);
        ring_a.wait_empty(qa);
        const float* raw = reinterpret_cast<const float*>(smem + G::RAW_AT + (u % G::NR) * G::RAW_STAGE);
        uint8_t* dst = smem + (qa % G::NA) * G::A_STAGE;
        // row r of box bi, 16-byte operand row kg: channels kg * CPG.. of
        // window row bi * box_t + r, leaky, split (bf16: rounded)
        for (int bi = 0; bi < a.nb; ++bi)
          for (int kg = 0; kg < 2; ++kg)
            for (int r = ct; r < a.box_t; r += 96) {
              const int row = bi * a.box_t + r;
              if (row >= W) continue;
              const float* col = raw + (bi * G::KC + kg * G::CPG) * a.box_t + r;
              uint8_t* o = dst + (kg * G::WR + row) * 16;
              if constexpr (BF16) {
                uint32_t v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  v[e] = pack_bf16(leaky(col[2 * e * a.box_t]), leaky(col[(2 * e + 1) * a.box_t]));
                *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
              } else {
                uint4 big, small;
                split_tf32(leaky(col[0]), big.x, small.x);
                split_tf32(leaky(col[a.box_t]), big.y, small.y);
                split_tf32(leaky(col[2 * a.box_t]), big.z, small.z);
                split_tf32(leaky(col[3 * a.box_t]), big.w, small.w);
                *reinterpret_cast<uint4*>(o) = big;
                *reinterpret_cast<uint4*>(o + 2 * G::WR * 16) = small;
              }
            }
        fence_async_smem();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(ring_a.full(qa));
          mbar_arrive(ring_r.empty(u));
        }
      }
      if (!BF16 && a.fused) {
        // conv2's A operand: h's k-steps split into TF32 planes, once the
        // consumers have written this tile's h
        mbar_wait_bounded(h_full, n & 1);
        for (int p = 0; p < passes; ++p)
          for (int s = 0; s < nk; ++s, ++qa) {
            ring_a.wait_empty(qa);
            const uint8_t* hs = smem + G::H_AT + 2 * s * G::HR * 16;
            uint8_t* dst = smem + (qa % G::NA) * G::A_STAGE;
            for (int e = ct; e < 2 * G::HR; e += 96) {
              const int kg = e >= G::HR, row = e - kg * G::HR;
              const float4 v = *reinterpret_cast<const float4*>(hs + (kg * G::HR + row) * 16);
              uint4 big, small;
              split_tf32(v.x, big.x, small.x);
              split_tf32(v.y, big.y, small.y);
              split_tf32(v.z, big.z, small.z);
              split_tf32(v.w, big.w, small.w);
              uint8_t* o = dst + (kg * G::WR + row) * 16;
              *reinterpret_cast<uint4*>(o) = big;
              *reinterpret_cast<uint4*>(o + 2 * G::WR * 16) = small;
            }
            fence_async_smem();
            __syncwarp();
            if (lane == 0) mbar_arrive(ring_a.full(qa));
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int tx = (int)opaque(threadIdx.x), c = tx / 128 - 1, tid = tx % 128;
  const int warp = tid / 32, lane = tx % 32, g = lane / 4, t = lane % 4;
  const uint32_t b0 = opaque(base);
  uint8_t* smem = smem_raw + (b0 - smem_u32(smem_raw));
  const int r1 = (a.k - 1) / 2 * a.d;
  constexpr int mw = G::M / 2;                     // rows of a warpgroup
  constexpr bool PREFETCH = G::MB * NP / 2 <= 64;
  float acc[G::MB][NP / 2];
  int qa = 0, qw = 0;
  for (int n = 0; n < n_mine; ++n) {
    const int tile = (int)blockIdx.x + n * (int)gridDim.x;
    const int b = tile / t_tiles, t0 = (tile % t_tiles) * bt;
    for (int ph = 0; ph < phases; ++ph) {
      const bool ring = ph == 0 || !BF16;              // A from the ring, or bf16 h as it lies
      const int dil = ph == 0 ? a.d : 1;
      // operand row of this warpgroup's first row at tap 0
      const int first = t0 - r2 - r1;                  // time of window row 0's tap 0
      const int row0 = (ph == 0 ? first - window_start(first) : GUARD - r2) + c * mw;
      for (int p = 0; p < passes; ++p) {
        // f(m64 block, sum, channel, offset) on each of this thread's sums
        // of the pass whose row is stored: rows [r2, M - r2) inside [0, T).
        // With PREFETCH the tile's first time is read anew by each call, so
        // that the offsets are made where they are used, not held from the
        // prefetch across the products (they spilled).
        auto each = [&](auto&& f) {
          const int t_first = PREFETCH ? (int)opaque((uint32_t)(t0 - r2)) : t0 - r2;
#pragma unroll
          for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int m = c * mw + 64 * mb + 16 * warp + g + 8 * hh;
              const int tau = t_first + m;
              if (m < r2 || m >= G::M - r2 || tau >= a.T) continue;
#pragma unroll
              for (int q = 0; q < NP / 8; ++q)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int co = p * NP + 8 * q + 2 * t + e;
                  f(mb, 4 * q + 2 * hh + e, co, ((size_t)b * a.C + co) * a.ld + tau);
                }
            }
        };
        // PREFETCH: where the sums take at most 64 registers, the last
        // phase's residual is loaded before its products, so that the
        // loads' latency hides behind them
        float rv[PREFETCH ? G::MB : 1][PREFETCH ? NP / 2 : 1];
        if constexpr (PREFETCH) {
          if (ph == phases - 1 && a.res)
            each([&](int mb, int i, int, size_t o) { rv[mb][i] = a.res[o]; });
        }
#pragma unroll
        for (int mb = 0; mb < G::MB; ++mb) {
#pragma unroll
          for (int e = 0; e < NP / 2; ++e) acc[mb][e] = 0.f;
          fence_regs(acc[mb]);
        }
        wg_fence();
        // The pass's products: a wgmma group a tap (the warpgroup's MB m64
        // blocks, straight-line: a branch among a group's wgmma makes ptxas
        // fence them apart), one group in flight; a weight stage is released
        // once the group of its last tap is done, an A stage once that of its
        // k-step's last tap is.
        {
          // the stages (w, a; -1: none) the group in flight frees once done
          // (one group in flight: two measured slower, holding a stage more)
          int pw = -1, pa = -1;
          auto drain = [&]() {   // every group done: release what it held
            if (pw >= 0) ring_w.release(pw, lane);
            if (pa >= 0) ring_a.release(pa, lane);
            pw = pa = -1;
          };
          for (int s = 0; s < nk; ++s) {
            if (!BF16 && a.kgroup && s > 0 && s % a.kgroup == 0) {
              // the tensor cores' sums truncate each add: a long K is summed
              // in fresh sums of kgroup k-steps, added to the running sum
              // (this thread's own slots after h's offset) rounded to nearest
              wg_wait<0>();
              drain();
              float* run = reinterpret_cast<float*>(smem + G::H_AT) + (tx - 128);
#pragma unroll
              for (int mb = 0; mb < G::MB; ++mb) {
                fence_regs(acc[mb]);
#pragma unroll
                for (int e = 0; e < NP / 2; ++e) {
                  float* slot = run + (mb * NP / 2 + e) * 256;
                  *slot = s == a.kgroup ? acc[mb][e] : *slot + acc[mb][e];
                  acc[mb][e] = 0.f;
                }
                fence_regs(acc[mb]);
              }
              wg_fence();
            }
            uint64_t da;
            if (ring) {
              ring_a.wait_full(qa);
              da = desc_rows(opaque(b0) + (qa % G::NA) * G::A_STAGE, G::WR * 16);
            } else {
              da = desc_rows(opaque(b0) + G::H_AT + 2 * s * G::HR * 16, G::HR * 16);
            }
            da += row0;
            const int a_done = ring ? qa : -1;   // freed by the k-step's last group
            for (int i0 = 0; i0 < a.k; i0 += G::TG, ++qw) {
              ring_w.wait_full(qw);
              const uint64_t dw = desc_rows(opaque(b0) + G::W_AT + (qw % G::NW) * G::W_STAGE, NP * 16);
              // one group: tap i of the stage's weights at db; w_done, a_done:
              // the stages it frees once done
              auto group = [&](int i, uint64_t db, int w_done, int a_last) {
                const uint64_t di = da + i * dil;
#pragma unroll
                for (int mb = 0; mb < G::MB; ++mb) {
                  if constexpr (BF16) {
                    Wgmma<NP>::bf16(acc[mb], di + 64 * mb, db);
                  } else {
                    // small*big, big*small, then big*big into the same sums
                    Wgmma<NP>::tf32(acc[mb], di + 64 * mb + 2 * G::WR, db);
                    Wgmma<NP>::tf32(acc[mb], di + 64 * mb, db + 2 * NP);
                    Wgmma<NP>::tf32(acc[mb], di + 64 * mb, db);
                  }
                }
                wg_commit();
                wg_wait<1>();      // the previous group is done
                drain();
                pw = w_done;
                pa = a_last;
              };
              if constexpr (G::TG == 1) {
                group(i0, dw, qw, i0 == a.k - 1 ? a_done : -1);
              } else {
                const int nt = min(G::TG, a.k - i0);
                for (int j = 0; j < nt; ++j)
                  group(i0 + j, dw + j * (G::CHUNK / 16), j == nt - 1 ? qw : -1,
                        i0 + j == a.k - 1 ? a_done : -1);
              }
            }
            if (ring) ++qa;
          }
          wg_wait<0>();
          drain();
        }
#pragma unroll
        for (int mb = 0; mb < G::MB; ++mb) fence_regs(acc[mb]);
        if (!BF16 && a.kgroup && nk > a.kgroup) {
          const float* run = reinterpret_cast<const float*>(smem + G::H_AT) + (tx - 128);
#pragma unroll
          for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
            for (int e = 0; e < NP / 2; ++e) acc[mb][e] = run[(mb * NP / 2 + e) * 256] + acc[mb][e];
        }

        const float* bias = ph ? a.b1 : a.b0;
        if (ph == 0 && a.fused) {
          // h = leaky(conv1 + bias), 0 outside [0, T), in conv2's operand
          // layout; first, both warpgroups are done with the last tile's h
          if (p == 0) bar_sync(BAR_CONSUMERS, 256);
#pragma unroll
          for (int mb = 0; mb < G::MB; ++mb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int j = c * mw + 64 * mb + 16 * warp + g + 8 * hh;
              const int tau = t0 - r2 + j;
              const bool inside = tau >= 0 && tau < a.T;
#pragma unroll
              for (int q = 0; q < NP / 8; ++q) {
                const int co = p * NP + 8 * q + 2 * t;
                float v0 = acc[mb][4 * q + 2 * hh] + bias[co];
                float v1 = acc[mb][4 * q + 2 * hh + 1] + bias[co + 1];
                v0 = inside ? leaky(v0) : 0.f;
                v1 = inside ? leaky(v1) : 0.f;
                if constexpr (BF16) {
                  *reinterpret_cast<uint32_t*>(smem + G::H_AT + ((co / 8) * G::HR + GUARD + j) * 16
                                               + (co % 8) * 2) = pack_bf16(v0, v1);
                } else {
                  *reinterpret_cast<float2*>(smem + G::H_AT + ((co / 4) * G::HR + GUARD + j) * 16
                                             + (co % 4) * 4) = make_float2(v0, v1);
                }
              }
            }
          continue;
        }
        // out = ((conv + bias) + res + accin) * scale on rows [r2, M - r2)
        // inside [0, T). accin may alias out: every load of the tile first,
        // then every store.
        each([&](int mb, int i, int co, size_t) { acc[mb][i] += bias[co]; });
        if (a.res) {
          if constexpr (PREFETCH) each([&](int mb, int i, int, size_t) { acc[mb][i] += rv[mb][i]; });
          else each([&](int mb, int i, int, size_t o) { acc[mb][i] += a.res[o]; });
        }
        if (a.accin) each([&](int mb, int i, int, size_t o) { acc[mb][i] += a.accin[o]; });
        each([&](int mb, int i, int, size_t o) { a.out[o] = acc[mb][i] * a.scale; });
      }
      if (ph == 0 && a.fused) {
        // h is whole: wgmma (bf16) and the converters (f32) may read it
        fence_async_smem();
        bar_sync(BAR_CONSUMERS, 256);
        if (!BF16) {
          __syncwarp();
          if (lane == 0) mbar_arrive(h_full);
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
// reads the same weight at once, a broadcast from L1. y's rows are ld apart.
__global__ void post_kernel(const float* __restrict__ y, const float* __restrict__ wp,
                            const float* __restrict__ pb, float* __restrict__ wav,
                            int C, int T, int ld, int round_bf16) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float* yb = y + (size_t)b * C * ld;
  constexpr int reach = (POST_K - 1) / 2;
  float s = 0.f;
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < POST_K; ++i) {
      const int tt = t + i - reach;
      if (tt >= 0 && tt < T) s = fmaf(activate(yb[(size_t)c * ld + tt], round_bf16), wp[i * C + c], s);
    }
  }
  wav[(size_t)b * T + t] = tanhf(s + pb[0]);
}

// `launched`, where given, counts the launch once it is queued.
cudaError_t post(const float* y, const float* wp, const float* pb, float* wav, int B, int C, int T,
                 int ld, int round_bf16, cudaStream_t s, int* launched) {
  const int threads = 256;
  const dim3 grid((T + threads - 1) / threads, B);
  post_kernel<<<grid, threads, 0, s>>>(y, wp, pb, wav, C, T, ld, round_bf16);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && launched != nullptr) ++*launched;
  return err;
}

// The map of the window source, a (B, C, ld) f32 tensor of T valid rows, in
// boxes of box_t rows x kc channels of one sample; rows outside [0, T) read
// as zeros.
cudaError_t window_map(CUtensorMap* map, const float* ptr, int B, int C, int T, int ld, int kc,
                       int box_t) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)T, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)C * ld * 4};
  const cuuint32_t boxes[3] = {(cuuint32_t)box_t, (cuuint32_t)kc, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
                        strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The SMs of the current device, looked up once per device.
cudaError_t sm_count(int* sms) {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) cached[dev] = *sms;
  return err;
}

// The route of a stage's convs: NP output channels a pass (the largest of
// 128, 64, 32 dividing C) and M rows a tile, the first of the heights built
// for that NP (Heights) at which h of all C channels fits beside the rings:
// the pairs run fused (f32 up to C = 128, bf16 up to C = 256, HiFiGAN V1's
// widths among them); else two launches of one conv each at the first.
struct Route {
  int np, m, fused, nw;   // nw: the instance's weight stages, 0 for its type's default
};

template <bool BF16, int NP, int M, int NW = 0>
bool fits(int C) {
  return Cfg<BF16, NP, M, NW>::bytes(C, true) <= MAX_SMEM;
}

template <bool BF16, int NP, int M1, int M2 = 0>
Route first_fit(int C) {
  if (fits<BF16, NP, M1>(C)) return {NP, M1, 1, 0};
  if constexpr (M2 > 0) {
    if (fits<BF16, NP, M2>(C)) return {NP, M2, 1, 0};
  }
  return {NP, M1, 0, 0};
}

// The instances: (type, NP) -> the tile heights built, most rows first;
// bf16 at NP = 128 also with 16 weight stages where h leaves them room
// (and for its two-launch pairs).
Route route(int C, int round_bf16) {
  if (round_bf16 && C % 128 == 0) {
    if (fits<true, 128, 256, 16>(C)) return {128, 256, 1, 16};
    const Route r = first_fit<true, 128, 256>(C);
    return r.fused ? r : Route{128, 256, 0, 16};
  }
  if (round_bf16)
    return C % 64 == 0 ? first_fit<true, 64, 256>(C) : first_fit<true, 32, 512, 256>(C);
  return C % 128 == 0 ? first_fit<false, 128, 256>(C) : C % 64 == 0 ? first_fit<false, 64, 384>(C)
                                                                   : first_fit<false, 32, 512, 256>(C);
}

// One launch over src (B, C, ld; T valid rows): a fused pair (w1 != null)
// or one conv of dilation d, counted in *launched once it is queued.
template <bool BF16, int NP, int M, int NW = 0>
cudaError_t launch(const float* src, const uint8_t* w0, const float* b0, const uint8_t* w1,
                   const float* b1, const float* res, const float* accin, float* out, int B, int C,
                   int T, int ld, int k, int d, float scale, cudaStream_t s, int* launched) {
  using G = Cfg<BF16, NP, M, NW>;
  auto kernel = pair_kernel<BF16, NP, M, NW>;
  static bool allowed[64] = {};
  cudaError_t err = allow_smem((const void*)kernel, MAX_SMEM, allowed);
  if (err != cudaSuccess) return err;
  const bool fused = w1 != nullptr;
  const long long bytes = G::bytes(C, fused);
  if (bytes > MAX_SMEM || C % NP) return cudaErrorInvalidValue;
  ConvArgs a{w0, b0, w1, b1, res, accin, out, B, C, T, ld, k, d, fused ? 1 : 0, 0, 0,
             !BF16 && !fused && C > G::KSPLIT ? G::KSPLIT / G::KC : 0, scale};
  // window rows: the tile's rows, the reach on each side, up to 3 more
  // before them (window_start)
  const int W = G::M + (k - 1) * d + 3;
  a.nb = (W + 255) / 256;                      // TMA boxes hold at most 256 rows
  a.box_t = ((W + a.nb - 1) / a.nb + 3) & ~3;  // of 16-byte multiples
  if (a.nb * a.box_t > G::RAW_ROWS) return cudaErrorInvalidValue;
  const int bt = G::M - 2 * (fused ? (k - 1) / 2 : 0);
  const long long tiles = (((long long)T + bt - 1) / bt) * B;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  CUtensorMap map;
  if ((err = window_map(&map, src, B, C, T, ld, G::KC, a.box_t)) != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int grid = tiles < sms ? (int)tiles : sms;
  kernel<<<grid, THREADS, (int)bytes, s>>>(map, a);
  if ((err = cudaGetLastError()) == cudaSuccess) ++*launched;
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// The instances, compiled in four build parts (the NP = 128 ones and the
// entry points, NP = 64, f32 NP = 32, bf16 NP = 32); without FSCL_PART (one
// nvcc for the whole file) every instance and the entry points.
#ifndef FSCL_PART
#define FSCL_PART -1
#endif
#define FSCL_OWNS(part) (FSCL_PART < 0 || FSCL_PART == (part))
#define FSCL_CONV_ARGS                                                                         \
  const float *src, const uint8_t *w0, const float *b0, const uint8_t *w1, const float *b1,     \
      const float *res, const float *accin, float *out, int B, int C, int T, int ld, int k,    \
      int d, float scale, cudaStream_t s, int *launched
#define FSCL_CONV_CALL src, w0, b0, w1, b1, res, accin, out, B, C, T, ld, k, d, scale, s, launched
#define FSCL_INSTANCE(name, bf16, np, m, nw) \
  cudaError_t name(FSCL_CONV_ARGS) { return launch<bf16, np, m, nw>(FSCL_CONV_CALL); }

cudaError_t fscl_mrf_conv_f32_128_256(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_bf16_128_256(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_bf16_128_256_w16(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_f32_64_384(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_bf16_64_256(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_f32_32_512(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_f32_32_256(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_bf16_32_512(FSCL_CONV_ARGS);
cudaError_t fscl_mrf_conv_bf16_32_256(FSCL_CONV_ARGS);

#if FSCL_OWNS(0)
FSCL_INSTANCE(fscl_mrf_conv_f32_128_256, false, 128, 256, 0)
FSCL_INSTANCE(fscl_mrf_conv_bf16_128_256, true, 128, 256, 0)
FSCL_INSTANCE(fscl_mrf_conv_bf16_128_256_w16, true, 128, 256, 16)
#endif
#if FSCL_OWNS(1)
FSCL_INSTANCE(fscl_mrf_conv_f32_64_384, false, 64, 384, 0)
FSCL_INSTANCE(fscl_mrf_conv_bf16_64_256, true, 64, 256, 0)
#endif
#if FSCL_OWNS(2)
FSCL_INSTANCE(fscl_mrf_conv_f32_32_512, false, 32, 512, 0)
FSCL_INSTANCE(fscl_mrf_conv_f32_32_256, false, 32, 256, 0)
#endif
#if FSCL_OWNS(3)
FSCL_INSTANCE(fscl_mrf_conv_bf16_32_512, true, 32, 512, 0)
FSCL_INSTANCE(fscl_mrf_conv_bf16_32_256, true, 32, 256, 0)
#endif

#if FSCL_OWNS(0)
static cudaError_t conv(const Route& rt, int round_bf16, FSCL_CONV_ARGS) {
  if (round_bf16)
    return rt.np == 128 ? (rt.nw == 16 ? fscl_mrf_conv_bf16_128_256_w16(FSCL_CONV_CALL)
                                       : fscl_mrf_conv_bf16_128_256(FSCL_CONV_CALL))
         : rt.np == 64 ? fscl_mrf_conv_bf16_64_256(FSCL_CONV_CALL)
         : rt.m == 512 ? fscl_mrf_conv_bf16_32_512(FSCL_CONV_CALL)
                       : fscl_mrf_conv_bf16_32_256(FSCL_CONV_CALL);
  return rt.np == 128 ? fscl_mrf_conv_f32_128_256(FSCL_CONV_CALL)
       : rt.np == 64 ? fscl_mrf_conv_f32_64_384(FSCL_CONV_CALL)
       : rt.m == 512 ? fscl_mrf_conv_f32_32_512(FSCL_CONV_CALL)
                     : fscl_mrf_conv_f32_32_256(FSCL_CONV_CALL);
}

// The route the stage takes at C channels (see Route): out[0..3] = NP, M,
// fused, weight stages (0: the type's default). ops/mrf_stage.py:route_on_card
// reads it.
extern "C" int fscl_mrf_route(int C, int round_bf16, int* out) {
  if (C < 32 || C % 32) return (int)cudaErrorInvalidValue;
  const Route r = route(C, round_bf16);
  out[0] = r.np;
  out[1] = r.m;
  out[2] = r.fused;
  out[3] = r.nw;
  return 0;
}

// The whole stage on `stream`. x, out, h, r: (B, C, ld) f32 on the device,
// rows [0, T) valid, ld a multiple of 4 and every pointer 16-byte aligned
// (h and r are work buffers; out holds the stage output, or the mean before
// conv_post when post_w, packed as (7, C), is given, and then wav (B, T)
// receives the wav).
// Resblock j has kernel ks[j] and n_dil[j] dilations, read in order from
// dils; weights/biases are host arrays of device pointers, two convs (convs1,
// convs2) per dilation in resblock order, weights packed by
// ops/mrf_stage.py:_pack_weight for the compute type and route(C).
// launched[0] and launched[1] count the conv launches (pair_kernel) and the
// conv_post launches (post_kernel) queued. Returns 0 or the first CUDA error.
extern "C" int fscl_mrf_stage(const void* x, void* out, void* h, void* r, void* wav, int B,
                              int C, int T, int ld, int n_res, const int* ks, const int* n_dil,
                              const int* dils, const void* const* weights,
                              const void* const* biases, const void* post_w,
                              const void* post_b, int round_bf16, void* stream, int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || T > MAX_T || ld < T || ld % 4 || C < 32 || C % 32 || n_res < 1
      || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(out) || !aligned16(h) || !aligned16(r))
    return (int)cudaErrorInvalidValue;
  for (int j = 0, di = 0; j < n_res; ++j) {
    if ((ks[j] != 3 && ks[j] != 7 && ks[j] != 11) || n_dil[j] < 1) return (int)cudaErrorInvalidValue;
    for (int q = 0; q < n_dil[j]; ++q, ++di)
      if (dils[di] < 1 || (ks[j] - 1) / 2 * dils[di] > RMAX) return (int)cudaErrorInvalidValue;
  }
  const Route rt = route(C, round_bf16);
  const float* xin = static_cast<const float*>(x);
  float* fout = static_cast<float*>(out);
  float* bufs[2] = {static_cast<float*>(r), static_cast<float*>(h)};
  const float inv_n = 1.0f / (float)n_res;
  int ci = 0, di = 0;
  for (int j = 0; j < n_res; ++j) {
    for (int q = 0; q < n_dil[j]; ++q, ++di, ci += 2) {
      const bool last = q == n_dil[j] - 1;
      const float* accin = (last && j > 0) ? fout : nullptr;
      const float scale = (last && j == n_res - 1) ? inv_n : 1.0f;
      const uint8_t* w1 = static_cast<const uint8_t*>(weights[ci]);
      const uint8_t* w2 = static_cast<const uint8_t*>(weights[ci + 1]);
      const float* b1 = static_cast<const float*>(biases[ci]);
      const float* b2 = static_cast<const float*>(biases[ci + 1]);
      cudaError_t err;
      if (rt.fused) {
        // ping-pong between the work buffers: a launch's windows reach into
        // its neighbours' rows of src, so src is never written by it
        const float* src = q == 0 ? xin : bufs[(q - 1) % 2];
        float* dst = last ? fout : bufs[q % 2];
        err = conv(rt, round_bf16, src, w1, b1, w2, b2, src, accin, dst, B, C, T, ld, ks[j],
                   dils[di], scale, s, launched);
      } else {
        // h through device memory: conv1 into h, then conv2 from h into r
        // (res and out may alias: each element is read, then written, by
        // the same thread)
        const float* src = q == 0 ? xin : bufs[0];
        float* dst = last ? fout : bufs[0];
        err = conv(rt, round_bf16, src, w1, b1, nullptr, nullptr, nullptr, nullptr, bufs[1], B,
                   C, T, ld, ks[j], dils[di], 1.0f, s, launched);
        if (err == cudaSuccess)
          err = conv(rt, round_bf16, bufs[1], w2, b2, nullptr, nullptr, src, accin, dst, B, C, T,
                     ld, ks[j], 1, scale, s, launched);
      }
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (post_w != nullptr)
    return (int)post(fout, static_cast<const float*>(post_w), static_cast<const float*>(post_b),
                     static_cast<float*>(wav), B, C, T, ld, round_bf16, s, launched + 1);
  return 0;
}

// conv_post + tanh alone on y (B, C, ld; T valid rows) f32, into wav (B,
// T): the last kernel of a stage with `post`, launched by itself to time it
// apart.
extern "C" int fscl_mrf_post(const void* y, const void* post_w, const void* post_b, void* wav,
                             int B, int C, int T, int ld, int round_bf16, void* stream) {
  if (B < 1 || T < 1 || T > MAX_T || ld < T || C < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  return (int)post(static_cast<const float*>(y), static_cast<const float*>(post_w),
                   static_cast<const float*>(post_b), static_cast<float*>(wav), B, C, T, ld,
                   round_bf16, static_cast<cudaStream_t>(stream), nullptr);
}
#endif
