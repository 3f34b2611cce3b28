// Hopper building blocks that every kernel of the port shares (the
// attention kernels through csrc/hopper_attention.cuh, and csrc/mrf_stage.cu):
// the split of f32 operands into TF32 parts, mbarriers and named barriers,
// TMA and bulk copies into rings of shared-memory stages, wgmma's fences and
// waits, and the host's shared-memory allowance and tensor-map encoder.
//
// Everything here has internal linkage (an unnamed namespace): each build
// part of each file compiles its own copy.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 227 * 1024; // sm_90's dynamic shared memory per block

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

// `bytes` more of TMA copies before the phase ends, without an arrival.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
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

// mbar_wait, bounded: a phase that has not completed after 2^24 tests (a
// copy that never lands, a count that is never reached) ends the kernel with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) copied as they
// lie from global to shared memory by the bulk copy engine, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A ring of NST stages of streamed tiles: tile it in stage it % NST, with
// its full barrier (the producer's arrivals, one of them expecting the TMA
// bytes where TMA fills the stage) and its empty one (each consumer warp
// that reads the stage arrives once done with it) at bars: full[NST], then
// empty[NST].
template <int NST, bool BOUNDED = false>
struct Ring {
  uint32_t bars;
  __device__ __forceinline__ uint32_t full(int it) const { return bars + 8 * (it % NST); }
  __device__ __forceinline__ uint32_t empty(int it) const { return bars + 8 * (NST + it % NST); }
  __device__ __forceinline__ void init(int full_count, int empty_count) const {
    for (int s = 0; s < NST; ++s) {
      mbar_init(bars + 8 * s, full_count);
      mbar_init(bars + 8 * (NST + s), empty_count);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the producer, before filling tile it's stage: its previous tile released
  __device__ __forceinline__ void wait_empty(int it) const {
    if (it >= NST) wait(empty(it), ((it / NST) + 1) & 1);
  }
  __device__ __forceinline__ void wait_full(int it) const { wait(full(it), (it / NST) & 1); }
  // BOUNDED: waits that end the kernel rather than hang (mbar_wait_bounded)
  static __device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
    if constexpr (BOUNDED) mbar_wait_bounded(bar, parity);
    else mbar_wait(bar, parity);
  }
  // a consumer warp, done with tile it's stage
  __device__ __forceinline__ void release(int it, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(it));
  }
};

// -- wgmma ---------------------------------------------------------------------

// Descriptor of a K-major operand without swizzle: 16-byte rows (4 f32 or 8
// bf16 of K) 16 bytes apart along M or N, so that 8-row core matrices lie
// 128 bytes apart and a shift by n rows is n added to the descriptor; the
// second 16 bytes of a k-step `lbo` bytes on. `addr` is where the first
// row's k-step starts.
__device__ __forceinline__ uint64_t desc_rows(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N of the warpgroup's committed groups are pending.
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Ties registers (accumulators, or the A operands of a wgmma) to the wgmma
// waits around them, so that the compiler moves no read or write of them
// across, and keeps an A operand's registers live until its wgmma is done.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// x, opaque to the compiler: a shared-memory address or offset read anew
// where it is used, so that what is computed from it (descriptors, copy
// offsets) is not hoisted out of the tile loop, where it would hold
// registers the whole loop long.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (the
// libraries link no driver library of their own).
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

}  // namespace
