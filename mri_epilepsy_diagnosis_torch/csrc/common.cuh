// Shared helpers of the port's hand-written Hopper kernels: scalar and
// 4-wide vector loads/stores that widen bf16 to float and narrow it back
// (round to nearest even), and the shifted layout's pad-voxel mask.  Every kernel
// computes in float32 and stores in its input dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mri {

// dtype codes shared with ops/cuda_kernels.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// the same 4-wide loads through the non-coherent (read-only) path, for
// data that no thread writes during the launch
__device__ __forceinline__ float4 load4_nc(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4_nc(const __nv_bfloat16* p) {
  uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// the packed subs (bit s = sub s) that are pad voxels at output cell
// (od, oh, ow) of a (Do, Ho, Wo) shifted tensor: on the last cell of an
// axis the subs with that axis's bit set (D: bit 2, subs 4-7; H: bit 1;
// W: bit 0), on the first cell (if it is not also the last) the others.
// 0 for every interior cell.
__device__ __forceinline__ unsigned shifted_drop(int od, int oh, int ow,
                                                 int Do, int Ho, int Wo) {
  const unsigned d = od == Do - 1 ? 0xF0u : od == 0 ? 0x0Fu : 0u;
  const unsigned h = oh == Ho - 1 ? 0xCCu : oh == 0 ? 0x33u : 0u;
  const unsigned w = ow == Wo - 1 ? 0xAAu : ow == 0 ? 0x55u : 0u;
  return d | h | w;
}

// JAX's `_epilogue` (models/unet_packed_q.py:267) on one int32 sum of an
// int8 conv, in float32, each operation rounded on its own (no FMA
// contraction):
//   y = f32(v) * dq + add + bias;  y = prelu(y, alpha);  0 if drop
//   q = clip(rint(y * rq), -127, 127)
// Returns a word whose low byte is q as int8.  Branch-free: an absent
// addend or bias is 0 and an absent slope 1, which give the same q (an
// add of 0 only turns -0 into +0, and both round to 0).  The clip comes
// first and the rounding is the add of 1.5 x 2^23, which rounds to the
// nearest even integer and leaves it in the low mantissa bits: rint and
// the clip commute (the bounds are integers), and the result equals
// JAX's round-then-clip, NaN and infinities included (both give the
// bound).
__device__ __forceinline__ uint32_t s8_requant(int v, float dq, float add,
                                               float bias, float alpha,
                                               bool drop, float rq) {
  float y = __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn(v), dq), add), bias);
  y = y >= 0.f ? y : __fmul_rn(y, alpha);
  y = drop ? 0.f : y;
  const float t = fminf(fmaxf(__fmul_rn(y, rq), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, 12582912.f));
}

// acc[c] += xv * wr[c] for c < COT: one input value into COT float32
// sums, the weights read 4-wide where COT allows (wr 16-byte aligned)
template <int COT>
__device__ __forceinline__ void fma_row(float (&acc)[COT], float xv,
                                        const float* wr) {
  if constexpr (COT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < COT; c += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(wr + c);
      acc[c] = fmaf(xv, wv.x, acc[c]);
      acc[c + 1] = fmaf(xv, wv.y, acc[c + 1]);
      acc[c + 2] = fmaf(xv, wv.z, acc[c + 2]);
      acc[c + 3] = fmaf(xv, wv.w, acc[c + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < COT; ++c) acc[c] = fmaf(xv, wr[c], acc[c]);
  }
}

}  // namespace mri
