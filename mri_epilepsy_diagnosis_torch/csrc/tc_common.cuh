// Shared helpers of the port's mma.sync kernels (`conv_axis_tc.cu`,
// `conv_axis_bwd_tc.cu`): the bf16 m16n8k16 MMA, ldmatrix, cp.async with
// zero fill, the XOR swizzle of staged rows, 16-byte staging of a row
// chunk, and division by a per-launch constant.
#pragma once

#include "common.cuh"

namespace mri {
namespace {

typedef unsigned short u16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// XOR swizzle of a row's 16-byte chunks (S chunks per row, S a power of
// two): any 8 consecutive rows put one chunk column in 8 distinct bank
// groups, so an ldmatrix phase of 8 rows is free of bank conflicts
__device__ __forceinline__ int swz(int row, int S) {
  return S >= 8 ? (row & 7) : S == 4 ? ((row >> 1) & 3)
                                     : S == 2 ? ((row >> 2) & 1) : 0;
}

// One 16-byte chunk (8 bf16) of a staged row into shared memory at byte
// address `dst`: src points at its first element, of which `n` exist (n <=
// 0: the chunk lies outside the tensor and reads zeros).  A 16-byte
// cp.async where the chunk is whole and aligned, else element by element.
__device__ __forceinline__ void stage_chunk(uint32_t dst, const u16* src,
                                            int n) {
  if (n >= 8 && ((reinterpret_cast<uintptr_t>(src) & 15) == 0)) {
    cp_async16(dst, src, true);
    return;
  }
  if (n <= 0) {
    cp_async16(dst, src, false);  // zero fill, src unread
    return;
  }
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < n ? src[2 * e] : 0;
    const uint32_t hi = 2 * e + 1 < n ? src[2 * e + 1] : 0;
    v[e] = lo | (hi << 16);
  }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ u16 lds16(uint32_t addr) {
  u16 v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// n / d for 0 <= n < 2^31 as a multiply-high and a shift (Granlund and
// Montgomery), d fixed per launch: the tile walks divide by runtime
// extents in their inner loops
struct FastDiv {
  uint32_t d, m, sh;
};

inline FastDiv make_div(uint32_t d) {
  uint32_t sh = 0;
  while ((1u << sh) < d) ++sh;
  const uint64_t one = 1;
  return {d, (uint32_t)(((one << 32) * ((one << sh) - d)) / d + 1), sh};
}

__device__ __forceinline__ int fdiv(const FastDiv& f, int n) {
  return (int)((__umulhi((uint32_t)n, f.m) + (uint32_t)n) >> f.sh);
}

inline int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
}  // namespace mri
