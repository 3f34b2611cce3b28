// DIO's contour fix on Hopper (sm_90a).
//
// Replaces the `lax.scan` of `fix_step` in
// fscl_tpu/dsp/world_device.py:world_f0_batched (:199-213), an XLA loop, not
// a Pallas kernel: the port's own kernel with no Pallas counterpart.
//
// The scan carries the previous FIXED value p, which is 0 or c[t - 1]. With
// n = c[t + 1] (0 past the end) and
//   keep = n > 0 && |c[t] - n| < 0.2 * max(c[t], 1e-9)
//   d[t] = c[t] > 0 && c[t - 1] > 0 && |c[t] - c[t - 1]| > 0.2 * max(c[t - 1], 1e-9)
//          && !keep                                   (d[0] = false)
// frame t is dropped (set to 0) iff d[t] and frame t - 1 was kept: iff the run
// of d ending at t is odd, t - (the last index <= t where d is false). So the
// pass is not sequential: every d[t] reads the candidates alone, and the
// last false index is a running maximum.
//
// Design: one block per row. Each thread takes a contiguous span of frames,
// finds the last false index in it, a block-wide inclusive max scan in
// shared memory (Hillis-Steele, log2(256) steps) hands each thread the last
// false index before its span, and a second walk over the span writes the
// output. What bounds it is one read and one write of B * F floats. The
// compares are the plain version's in float32, round to nearest, no fused
// multiply-add, so the two agree bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (fscl_tpu_torch/ops/cuda_lib.py); entry point fscl_dio_contour.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool drops(const float* __restrict__ c, int t, int F) {
  if (t == 0) return false;
  const float f = c[t], p = c[t - 1];
  const float n = t + 1 < F ? c[t + 1] : 0.0f;
  const bool keep = n > 0.0f && fabsf(__fsub_rn(f, n)) < __fmul_rn(0.2f, fmaxf(f, 1e-9f));
  const bool jump = f > 0.0f && p > 0.0f &&
                    fabsf(__fsub_rn(f, p)) > __fmul_rn(0.2f, fmaxf(p, 1e-9f));
  return jump && !keep;
}

__global__ void __launch_bounds__(kThreads)
dio_contour_kernel(const float* __restrict__ cand, float* __restrict__ out, int F) {
  __shared__ int scan[kThreads];
  const long long base = (long long)blockIdx.x * F;
  const float* c = cand + base;
  float* o = out + base;
  const int span = (F + kThreads - 1) / kThreads;
  const int lo = min(F, threadIdx.x * span), hi = min(F, lo + span);

  int last = -1;
  for (int t = lo; t < hi; ++t)
    if (!drops(c, t, F)) last = t;
  scan[threadIdx.x] = last;
  __syncthreads();
  for (int step = 1; step < kThreads; step <<= 1) {
    const int other = threadIdx.x >= step ? scan[threadIdx.x - step] : -1;
    __syncthreads();
    scan[threadIdx.x] = max(scan[threadIdx.x], other);
    __syncthreads();
  }
  // d[0] is false, so every span after the first starts with a false index
  // behind it
  last = threadIdx.x > 0 ? scan[threadIdx.x - 1] : -1;
  for (int t = lo; t < hi; ++t) {
    const float f = c[t];
    if (!drops(c, t, F)) {
      last = t;
      o[t] = f;
    } else {
      o[t] = ((t - last) & 1) ? 0.0f : f;
    }
  }
}

}  // namespace

extern "C" int fscl_dio_contour(const void* cand, void* out, int B, int F, void* stream) {
  if (B < 1 || F < 1) return (int)cudaErrorInvalidValue;
  dio_contour_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<float*>(out), F);
  return (int)cudaGetLastError();
}
