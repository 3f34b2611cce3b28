// One HiFiGAN multi-receptive-field (MRF) stage for Hopper (sm_90a).
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
// after leaky, and the weights) are rounded to bf16 first and their products
// accumulated in f32, as the TPU kernel does with preferred_element_type.
//
// What bounds it on the card: one stage is 2 * B * T * taps * C^2 operations
// (taps = sum over resblocks of 2 * k * |d|, 126 for HiFiGAN V1) against
// 2 * B * T * C values moved, so a few hundred to a thousand operations per
// byte: it is bound by operations. The f32 bar (mean 1e-5, max 5e-3 against
// the plain version) rules out TF32 tensor cores, so every product runs on
// the f32 FMA units (67 TFLOP/s on an H100 SXM).
//
// What the design does about it: the TPU kernel keeps a whole haloed window
// plus the residual, intermediate and accumulator of the stage in VMEM; at
// C = 256 that is several 200 KB buffers, more than a Hopper block's 227 KB
// of shared memory. Here the stage is a chain of launches of one fused conv
// kernel (18 for V1), plus a small conv_post + tanh kernel. Each conv is an
// implicit GEMM: a block owns a (BM time rows x BN output channels) tile and
// streams the input channels through shared memory 8 at a time. For each
// chunk it stages the input window (BM + 2 * reach rows, out-of-range rows
// zero-filled) once, so all k taps read the same window at shifted rows, and
// the chunk's weights for all k taps. The copies are cp.async into two
// shared-memory stages, so the next chunk lands while this one is computed;
// each thread applies leaky (and the bf16 rounding) in place to the values
// it copied before the barrier that hands the stage over. Each thread keeps
// an 8 x 8 register tile (8 consecutive time rows, 8 channels). For dilation
// 1 a thread loads its 8 + k - 1 window rows once per input channel and
// slides over them for all k taps; for other dilations it loads 8 rows per
// tap. The loop body is one input channel: unrolling a whole chunk made
// thousands of FMAs of code, more than the instruction cache holds, and ran
// slower. The epilogue adds the bias, the residual and the
// running sum of the resblocks, scales by 1 / n_resblocks on the last conv,
// and stores. Per-conv launches move each (B, C, T) tensor through device
// memory once per conv (about 9 GB for the largest V1 stage at B = 8,
// T_mel = 1000), a few ms against tens of ms of operations.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 8;          // input channels per shared-memory chunk
constexpr int TM = 8;          // consecutive time rows per thread
constexpr int RMAX = 32;       // largest reach (k - 1) / 2 * dilation taken
constexpr float SLOPE = 0.1f;

__device__ __forceinline__ float activate(float v, int round_bf16) {
  v = v >= 0.f ? v : v * SLOPE;
  if (round_bf16) v = __bfloat162float(__float2bfloat16(v));
  return v;
}

template <int BN>
struct Tile {
  static constexpr int TX = BN / 8;                // threads across channels
  static constexpr int TY = THREADS / TX;          // threads across time
  static constexpr int BM = TY * TM;               // time rows per block
  static constexpr int LDW = BM + 2 * RMAX + 16;   // window pitch: covers the
                                                   // float4 over-read past it
};

// One pipeline stage of shared memory: the input window of a chunk, then its
// weights for every tap. Two stages: one is computed on while the next
// chunk's copies land in the other.
template <int K, int BN>
struct Smem {
  static constexpr int XS = KC * Tile<BN>::LDW;
  static constexpr int STAGE = XS + K * KC * BN;
  static constexpr int BYTES = 2 * STAGE * (int)sizeof(float);
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  // src-size 0 zero-fills the destination and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// out = ((conv(act(in)) + bias) + res + accin) * scale on a (BM x BN) tile.
// in, res, accin, out: (B, C, T) f32; wp: weights packed tap-major as
// (K, C_in, C_out); res and accin may be null and may alias out (each element
// is read and then written by the same thread).
template <int K, int BN, bool D1>
__global__ void __launch_bounds__(THREADS, 2)
conv_kernel(const float* __restrict__ in, const float* __restrict__ wp,
            const float* __restrict__ bias, const float* res, const float* accin,
            float* out, int C, int T, int dil, float scale, int round_bf16) {
  using TL = Tile<BN>;
  using SM = Smem<K, BN>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int tx = tid % TL::TX;
  const int ty = tid / TL::TX;
  const int t0 = blockIdx.x * TL::BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int reach = (K - 1) / 2 * dil;
  const int wrows = TL::BM + 2 * reach;
  const float* inb = in + (size_t)b * C * T;

  // Start the copies of chunk c0 into stage `buf`: the window rows
  // t0 - reach ... t0 + BM + reach (zero outside [0, T)) and the weights of
  // every tap, ws[(i * KC + kk) * BN + n].
  auto load_chunk = [&](int c0, float* buf) {
    for (int e = tid; e < KC * wrows; e += THREADS) {
      const int kk = e / wrows;
      const int r = e - kk * wrows;
      const int t = t0 - reach + r;
      const bool valid = t >= 0 && t < T;
      cp_async4(buf + kk * TL::LDW + r, valid ? inb + (size_t)(c0 + kk) * T + t : inb, valid);
    }
    float* ws = buf + SM::XS;
    for (int e = tid; e < K * KC * (BN / 4); e += THREADS) {
      const int n4 = e % (BN / 4);
      const int ik = e / (BN / 4);
      const int i = ik / KC;
      const int kk = ik - i * KC;
      cp_async16(ws + ik * BN + n4 * 4, wp + ((size_t)i * C + c0 + kk) * C + n0 + n4 * 4);
    }
    cp_async_commit();
  };
  // Once this thread's copies have landed: leaky (and the bf16 rounding) on
  // the window values it copied.
  auto activate_chunk = [&](float* buf) {
    cp_async_wait_all();
    for (int e = tid; e < KC * wrows; e += THREADS) {
      const int kk = e / wrows;
      float* p = buf + kk * TL::LDW + (e - kk * wrows);
      *p = activate(*p, round_bf16);
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[j][n] = 0.f;

  load_chunk(0, smem);
  activate_chunk(smem);
  __syncthreads();
  for (int c0 = 0, stage = 0; c0 < C; c0 += KC, stage ^= 1) {
    const float* xs = smem + stage * SM::STAGE;
    const float* ws = xs + SM::XS;
    float* next = smem + (stage ^ 1) * SM::STAGE;
    const bool more = c0 + KC < C;
    if (more) load_chunk(c0 + KC, next);   // that stage was last read before the barrier
    const float* xrow = xs + ty * TM;

    // One input channel (all k taps) per loop body: a fully unrolled chunk
    // is thousands of FMAs, more code than the instruction cache holds.
    if (D1) {
      constexpr int NA = (TM + K - 1 + 3) / 4;
#pragma unroll 1
      for (int kk = 0; kk < KC; ++kk) {
        float a[NA * 4];
#pragma unroll
        for (int v = 0; v < NA; ++v) {
          const float4 q = *reinterpret_cast<const float4*>(xrow + kk * TL::LDW + 4 * v);
          a[4 * v] = q.x; a[4 * v + 1] = q.y; a[4 * v + 2] = q.z; a[4 * v + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const float* wrow = ws + (i * KC + kk) * BN + tx * 4;
          const float4 b0 = *reinterpret_cast<const float4*>(wrow);
          const float4 b1 = *reinterpret_cast<const float4*>(wrow + BN / 2);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int j = 0; j < TM; ++j)
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[j][n] = fmaf(a[j + i], bv[n], acc[j][n]);
        }
      }
    } else {
#pragma unroll 1
      for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const float* xi = xrow + i * dil;
          float a[TM];
#pragma unroll
          for (int j = 0; j < TM; ++j) a[j] = xi[kk * TL::LDW + j];
          const float* wrow = ws + (i * KC + kk) * BN + tx * 4;
          const float4 b0 = *reinterpret_cast<const float4*>(wrow);
          const float4 b1 = *reinterpret_cast<const float4*>(wrow + BN / 2);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int j = 0; j < TM; ++j)
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[j][n] = fmaf(a[j], bv[n], acc[j][n]);
        }
      }
    }
    if (more) activate_chunk(next);
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int co = n0 + (n < 4 ? tx * 4 + n : BN / 2 + tx * 4 + n - 4);
    const float bb = bias[co];
    const size_t row = ((size_t)b * C + co) * T;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int t = t0 + ty * TM + j;
      if (t < T) {
        float v = acc[j][n] + bb;
        if (res) v = res[row + t] + v;
        if (accin) v = accin[row + t] + v;
        out[row + t] = v * scale;
      }
    }
  }
}

constexpr int POST_K = 7;       // conv_post's kernel in HiFiGAN (and the TPU kernel)

// wav[b, t] = tanh(bias + sum_{i, c} w[i, c] * act(y[b, c, t + i - 3])) with w
// packed as (7, C); one thread per output sample. Every thread of a warp reads
// the same weight at once, a broadcast from L1.
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

template <int K, int BN>
cudaError_t launch_conv(const float* in, const float* wp, const float* bias, const float* res,
                        const float* accin, float* out, int B, int C, int T, int dil,
                        float scale, int round_bf16, cudaStream_t s) {
  using TL = Tile<BN>;
  constexpr int bytes = Smem<K, BN>::BYTES;
  const dim3 grid((T + TL::BM - 1) / TL::BM, C / BN, B);
  auto kernel = dil == 1 ? conv_kernel<K, BN, true> : conv_kernel<K, BN, false>;
  // The shared-memory allowance is set once per instance and device.
  constexpr int MAX_DEVICES = 64;
  static bool allowed[2][MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !allowed[dil == 1][dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) allowed[dil == 1][dev] = true;
  }
  kernel<<<grid, THREADS, bytes, s>>>(in, wp, bias, res, accin, out, C, T, dil, scale, round_bf16);
  return cudaGetLastError();
}

template <int K>
cudaError_t conv_k(const float* in, const float* wp, const float* bias, const float* res,
                   const float* accin, float* out, int B, int C, int T, int dil, float scale,
                   int round_bf16, cudaStream_t s) {
  if (C % 64 == 0)
    return launch_conv<K, 64>(in, wp, bias, res, accin, out, B, C, T, dil, scale, round_bf16, s);
  return launch_conv<K, 32>(in, wp, bias, res, accin, out, B, C, T, dil, scale, round_bf16, s);
}

cudaError_t conv(int k, const float* in, const float* wp, const float* bias, const float* res,
                 const float* accin, float* out, int B, int C, int T, int dil, float scale,
                 int round_bf16, cudaStream_t s) {
  switch (k) {
    case 3: return conv_k<3>(in, wp, bias, res, accin, out, B, C, T, dil, scale, round_bf16, s);
    case 7: return conv_k<7>(in, wp, bias, res, accin, out, B, C, T, dil, scale, round_bf16, s);
    case 11: return conv_k<11>(in, wp, bias, res, accin, out, B, C, T, dil, scale, round_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The whole stage on `stream`. x, out, h, r: (B, C, T) f32 on the device
// (h and r are work buffers; out holds the stage output, or the mean before
// conv_post when post_w, packed as (7, C), is given, and then wav (B, T)
// receives the wav).
// Resblock j has kernel ks[j] and n_dil[j] dilations, read in order from
// dils; weights/biases are host arrays of device pointers, two convs (convs1,
// convs2) per dilation in resblock order, weights packed as (k, C, C).
// Returns 0 or the first CUDA error.
extern "C" int fscl_mrf_stage(const void* x, void* out, void* h, void* r, void* wav, int B,
                              int C, int T, int n_res, const int* ks, const int* n_dil,
                              const int* dils, const void* const* weights,
                              const void* const* biases, const void* post_w,
                              const void* post_b, int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || C < 32 || C % 32 || n_res < 1 || B > 65535 || C / 32 > 65535)
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
  const float inv_n = 1.0f / (float)n_res;
  int ci = 0, di = 0;
  for (int j = 0; j < n_res; ++j) {
    for (int q = 0; q < n_dil[j]; ++q, ++di, ci += 2) {
      const bool first = q == 0;
      const bool last = q == n_dil[j] - 1;
      const float* src = first ? xin : fr;
      cudaError_t err = conv(ks[j], src, static_cast<const float*>(weights[ci]),
                             static_cast<const float*>(biases[ci]), nullptr, nullptr, fh, B, C, T,
                             dils[di], 1.0f, round_bf16, s);
      if (err != cudaSuccess) return (int)err;
      err = conv(ks[j], fh, static_cast<const float*>(weights[ci + 1]),
                 static_cast<const float*>(biases[ci + 1]), src,
                 (last && j > 0) ? fout : nullptr, last ? fout : fr, B, C, T, 1,
                 (last && j == n_res - 1) ? inv_n : 1.0f, round_bf16, s);
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (post_w != nullptr) {
    const int threads = 256;
    const dim3 grid((T + threads - 1) / threads, B);
    post_kernel<<<grid, threads, 0, s>>>(
        fout, static_cast<const float*>(post_w), static_cast<const float*>(post_b),
        static_cast<float*>(wav), C, T, round_bf16);
    return (int)cudaGetLastError();
  }
  return 0;
}
