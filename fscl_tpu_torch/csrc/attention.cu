// Masked self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel fscl_tpu/ops/attention.py:_attn_kernel (launched by
// pallas_attention). Per (batch, head): scores = Q K^T / temperature in f32,
// keys with key_valid == 0 filled with the finite -1e9 (so a row with no
// valid key gets uniform weights, the mean of V, never NaN), a row softmax,
// then weights . V in f32, cast to the input type on store.
//
// What bounds it on the card: the work is 4 * L^2 * Dh operations per
// (batch, head) against 4 * L * Dh elements moved, about L operations per
// element, so at the lengths this model serves (L >= 128) it is bound by
// operations, not bytes. The f32 path must stay within 2e-5 of the plain
// version, which rules out TF32 tensor cores; both input types therefore run
// every product on the f32 FMA units (67 TFLOP/s on an H100 SXM).
//
// What the design does about it: one block of 256 threads per (64-query
// tile, batch * head). The Q tile stays in shared memory; K and V stream
// through shared memory in 64-key tiles, converted to f32 once on load. Each
// thread holds a 4 x 4 register tile of scores and a 4 x (Dh / 16) tile of
// the output, so every shared-memory load feeds 8 (scores) or 4 (P.V) FMAs.
// An online softmax (running max and sum per row, in f32) means the L x L
// score matrix never exists in memory. K rows are padded by 4 floats so the
// 16 different rows a half-warp reads land in different banks. The P tile
// reuses K's buffer, which keeps shared memory at 98 KB for Dh = 128, so two
// blocks fit on one SM.
//
// Keys past L (the ragged edge of the last tile) are excluded outright
// (weight 0); keys inside L that are masked take the -1e9 fill, exactly as
// the reference does. Query rows past L are computed on zeros and not stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;     // queries per block
constexpr int BLOCK_N = 64;     // keys per tile
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr float MASK_FILL = -1e9f;

template <int DH>
struct Smem {
  static constexpr int LDK = DH + 4;          // padded row of Q and K (floats)
  static constexpr int LDV = DH;
  static constexpr int LDP = BLOCK_N + 4;
  static constexpr int Q_FLOATS = BLOCK_M * LDK;
  static constexpr int K_FLOATS = BLOCK_N * LDK;
  static constexpr int V_FLOATS = BLOCK_N * LDV;
  static constexpr size_t BYTES = sizeof(float) * (Q_FLOATS + K_FLOATS + V_FLOATS);
  static_assert(BLOCK_M * LDP <= K_FLOATS, "P tile must fit in the K buffer");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copy a (rows, DH) tile from global memory into f32 shared memory with row
// stride ld; rows at or past `valid_rows` are zero.
template <int DH>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, float* dst,
                                          int valid_rows, int ld) {
  constexpr int PER_ROW = DH / 4;
  for (int i = threadIdx.x; i < BLOCK_N * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid_rows) x = ld4(src + (size_t)r * DH + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

template <int DH>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src, float* dst,
                                          int valid_rows, int ld) {
  constexpr int PER_ROW = DH / 8;
  for (int i = threadIdx.x; i < BLOCK_N * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < valid_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * DH + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 x = __bfloat1622float2(h[t]);
        f[2 * t] = x.x;
        f[2 * t + 1] = x.y;
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(dst + r * ld + c + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(x.x, x.y), __floats2bfloat162_rn(x.z, x.w)};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(pair);
}

// Reductions over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 2)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ key_valid, T* __restrict__ out,
                     int H, int L, float temperature) {
  using S = Smem<DH>;
  constexpr int CG = DH / 64;   // float4 column groups of the output per thread

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + S::Q_FLOATS;
  float* vs = ks + S::K_FLOATS;
  float* ps = ks;               // P reuses K's buffer once the scores are done

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * BLOCK_M;
  const size_t base = (size_t)bh * L * DH;
  const uint8_t* valid = key_valid + (size_t)(bh / H) * L;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<DH>(q + base + (size_t)m0 * DH, qs, min(BLOCK_M, L - m0), S::LDK);

  float m_run[4], l_run[4], acc[4][CG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG * 4; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < L; n0 += BLOCK_N) {
    const int n_rows = min(BLOCK_N, L - n0);
    load_tile<DH>(k + base + (size_t)n0 * DH, ks, n_rows, S::LDK);
    load_tile<DH>(v + base + (size_t)n0 * DH, vs, n_rows, S::LDV);
    __syncthreads();

    // scores for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(qs + (ty + 16 * i) * S::LDK + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ld4(ks + (tx + 16 * j) * S::LDK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = n0 + tx + 16 * j;
      const bool in_range = key < L;
      const bool ok = in_range && valid[key] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = !in_range ? -INFINITY : (ok ? s[i][j] / temperature : MASK_FILL);
    }

    // online softmax; key n0 (< L) is in every tile, so each row max is finite
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m_run[i], row_max(mt));
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l_run[i] = l_run[i] * alpha[i] + row_sum(rs);
    }

    __syncthreads();            // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * S::LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CG * 4; ++c) acc[i][c] *= alpha[i];
    for (int kk = 0; kk < n_rows; ++kk) {   // keys past n_rows carry weight 0
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * S::LDP + kk];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 x = ld4(vs + kk * S::LDV + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(p[i], x.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(p[i], x.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(p[i], x.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(p[i], x.w, acc[i][g * 4 + 3]);
        }
      }
    }
    __syncthreads();            // K, V and P are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= L) continue;
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float4 x = make_float4(acc[i][g * 4] * inv, acc[i][g * 4 + 1] * inv,
                                   acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv);
      store4(out + base + (size_t)row * DH + g * 64 + tx * 4, x);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_valid, void* out,
                   int B, int H, int L, float temperature, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T, DH>;
  const size_t smem = Smem<DH>::BYTES;   // above the 48 KB default for both head dims
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const dim3 grid((L + BLOCK_M - 1) / BLOCK_M, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(out), H, L, temperature);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous (B, H, L, Dh); key_valid: contiguous (B, L) bytes.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int fscl_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* key_valid, void* out, int B, int H, int L,
                                  int Dh, int dtype, float temperature, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 128) return (int)launch<float, 128>(q, k, v, key_valid, out, B, H, L, temperature, s);
  if (dtype == 0 && Dh == 64) return (int)launch<float, 64>(q, k, v, key_valid, out, B, H, L, temperature, s);
  if (dtype == 1 && Dh == 128) return (int)launch<__nv_bfloat16, 128>(q, k, v, key_valid, out, B, H, L, temperature, s);
  if (dtype == 1 && Dh == 64) return (int)launch<__nv_bfloat16, 64>(q, k, v, key_valid, out, B, H, L, temperature, s);
  return (int)cudaErrorInvalidValue;
}
