// Shared plumbing of the port's wgmma kernels fed by TMA (B1's
// `conv2_packed_tc.cu`, K1's `conv2_packed_s8_tc.cu`, K2's
// `upconv_packed_s8.cu`): mbarriers with a watchdog, 2-D and 5-D TMA tile
// loads, wgmma shared-memory descriptors of K-major tiles with the 128-
// and 64-byte swizzles, the wgmma fences, the cuTensorMapEncodeTiled
// lookup, and the host-side checks before a setmaxnreg launch.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mri {
namespace tc {

// A wait on an mbarrier that outlasts ~2^35 cycles (over 10 s) traps, so
// a pipeline fault ends the launch with an error instead of hanging the
// card.
constexpr long long kWatchdogCycles = 1LL << 35;

// 2 consumer warpgroups + 1 producer warpgroup; setmaxnreg moves
// registers from the producer (40) to the consumers (232), which needs
// the launch to hold 65536 / 384 registers a thread, rounded down to 8
constexpr int kThreads = 384;
constexpr int kLaunchRegs = 168;

// host-side refusals, returned in place of a CUDA error code
constexpr int kErrNoEncoder = -1;    // cuTensorMapEncodeTiled not found
constexpr int kErrTensorMap = -2;    // a tensor map was refused
constexpr int kErrRegisters = -3;    // not compiled to kLaunchRegs registers
constexpr int kErrPlan = -4;         // tile plan or shape not served

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: start address >> 4, leading byte offset 16 (unused by this
// layout), stride byte offset 1024 between 8-row groups, layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The same for 64-byte rows with the 64-byte swizzle: 8-row groups 512
// bytes apart, layout B64.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of the accumulators above the
// wgmma wait: it does not know that wgmma writes them asynchronously.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library needs no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// Before a launch of a setmaxnreg kernel: refuse it unless ptxas gave the
// kernel exactly kLaunchRegs registers (setmaxnreg moves registers inside
// the launch's allocation, so the consumers' increase would never return
// otherwise; checked once per instantiation, through `checked`), and set
// its dynamic shared memory (per device, so at every launch).
template <typename Kernel>
static int prepare_launch(Kernel kernel, int smem, bool& checked) {
  if (!checked) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    if (attr.numRegs != kLaunchRegs) return kErrRegisters;
    checked = true;
  }
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace tc
}  // namespace mri
