// K1's mma.sync route: the k=2 packed convolution in int8, for the int8
// serving path of the packed UNet3D (`models/unet_packed_q.py`), where
// 8Ci or 8Co is not a multiple of 64: the 8Ci = 8 stem (e0c1).  The other
// sites take `conv2_packed_s8_tc.cu` (wgmma fed by TMA);
// `ops/cuda_kernels.py::_conv2_s8_route` picks one.
//
// Replaces: mri_epilepsy_diagnosis_tpu/models/unet_packed_q.py `conv_int8`
//   (:68, `lax.conv_general_dilated(int8, int8) -> int32` in XLA) and, in
//   the fused mode, its `_epilogue` (:267) and the decoder's dequantized
//   sum (:305-315).  It computes B1's function
//   (ops/pallas_kernels.py::conv2_packed_pallas) in int8:
//     out[n,z,y,x,:] = sum_{q in {0,1}^3} xin[n, z+qd-pad, y+qh-pad,
//                                           x+qw-pad, :] @ w8[q]
//   with int32 sums, xin zero outside its extent; pad 0 is the
//   shifted->aligned conv (S+1 cells to S), pad 1 the aligned->shifted one
//   (S cells to S+1).
//
// Two output modes:
//   - raw: the int32 sums;
//   - fused (dq non-null): JAX's `_epilogue` in float32 on the sums,
//       y = f32(acc) * dq[co]  (+ addend[cell, co])  + b[co]
//       y = prelu(y, alpha[co]); pad voxels of a shifted output zeroed
//       q = clip(rint(y * rq[co]), -127, 127) as int8
//     in JAX's order of operations, each a separately rounded float32
//     operation (__fmul_rn / __fadd_rn: no FMA contraction), rounding
//     half to even as jnp.round and torch.round do (`common.cuh::
//     s8_requant`, shared with the wgmma route).  The addend (float32, shaped like the output) lets the
//     decoder's first conv take the dequantized, face-fixed up branch:
//     (y_s * dq + y_u) + b.
//
// Bound on the H100: the stem's K is 64, so it does fewer than the 590
// int8 operations per byte it must move that the ridge of 1,979 TOP/s
// over 3.35 TB/s needs, and its bound is bytes.  An mma.sync m16n8k32
// implicit GEMM over tiles staged in shared memory (s8_igemm.cuh) serves
// it; the sites bound by operations take the wgmma kernel.
//
// Requires 8Ci % 8 == 0 and 8Co % 8 == 0, contiguous tensors and
// 16-byte-aligned base pointers (checked by the Python wrapper,
// ops/cuda_kernels.py::conv2_packed_s8).
#include "s8_igemm.cuh"

namespace mri {
namespace s8 {

struct Epilogue {
  const float* dq;      // (8Co,) dequantization scale; null: raw int32
  const float* bias;    // (8Co,) or null
  const float* alpha;   // (8Co,) PReLU slope or null
  const float* rq;      // (8Co,) requantization (reciprocal) scale
  const float* addend;  // like the output, float32, or null
};

template <bool FUSED>
__global__ void __launch_bounds__(kThreads)
conv2_packed_s8_kernel(const int8_t* __restrict__ x, const Geometry g,
                       void* __restrict__ out, const Epilogue epi) {
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  int acc[2][4][4];
  mainloop(x, g, m0, n0, acc);

  // the fused epilogue's per-column vectors of the thread's 4 column
  // pairs, loaded once for its 4 rows (absent ones neutral: `s8_requant`)
  float2 dq[4], rq[4], bs[4], al[4];
  if constexpr (FUSED) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int co = min(n0 + acc_col(ni, 0), g.C8o - 2);
      dq[ni] = __ldg(reinterpret_cast<const float2*>(epi.dq + co));
      rq[ni] = __ldg(reinterpret_cast<const float2*>(epi.rq + co));
      bs[ni] = epi.bias != nullptr
                   ? __ldg(reinterpret_cast<const float2*>(epi.bias + co))
                   : make_float2(0.f, 0.f);
      al[ni] = epi.alpha != nullptr
                   ? __ldg(reinterpret_cast<const float2*>(epi.alpha + co))
                   : make_float2(1.f, 1.f);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const Row r = decode_row(g, m0 + acc_row(mi, 2 * half));
      if (!r.ok) continue;
      unsigned drop = 0u;
      if (FUSED && g.pad == 1)
        drop = shifted_drop(r.pz, r.py, r.px, g.Pd, g.Ph, g.Pw);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = n0 + acc_col(ni, 2 * half);
        if (co >= g.C8o) continue;
        const int* v = &acc[mi][ni][2 * half];
        if constexpr (!FUSED) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + r.out * g.C8o +
                                   co) = make_int2(v[0], v[1]);
        } else {
          // JAX's `_epilogue` (`s8_requant`); the pad-drop sub of each
          // column (8Co / 8 may be odd here) only on rows at a face
          const int c_sub = g.C8o >> 3;
          const bool d0 = drop != 0u && ((drop >> (co / c_sub)) & 1u);
          const bool d1 = drop != 0u && ((drop >> ((co + 1) / c_sub)) & 1u);
          const float2 ad =
              epi.addend != nullptr
                  ? __ldg(reinterpret_cast<const float2*>(
                        epi.addend + r.out * g.C8o + co))
                  : make_float2(0.f, 0.f);
          const uint32_t q0 = s8_requant(v[0], dq[ni].x, ad.x, bs[ni].x,
                                         al[ni].x, d0, rq[ni].x);
          const uint32_t q1 = s8_requant(v[1], dq[ni].y, ad.y, bs[ni].y,
                                         al[ni].y, d1, rq[ni].y);
          *reinterpret_cast<unsigned short*>(static_cast<int8_t*>(out) +
                                             r.out * g.C8o + co) =
              (unsigned short)__byte_perm(q0, q1, 0x0040);
        }
      }
    }
  }
}

}  // namespace s8
}  // namespace mri

// K1.  x: (n, di, hi, wi, c8i) int8; w: (c8o, 8 * c8i) int8, K-major with
// k = (4 qd + 2 qh + qw) * c8i + ci; out: (n, do, ho, wo, c8o) with
// do = di - 1 (pad 0) or di + 1 (pad 1), int32 when dq is null, else int8
// through the fused epilogue (rq required).  Launches on `stream`;
// returns cudaGetLastError() after the launch.
extern "C" int mri_conv2_packed_s8(const void* x, const void* w, void* out,
                                   long long n, int di, int hi, int wi,
                                   int c8i, int c8o, int pad, const void* dq,
                                   const void* bias, const void* alpha,
                                   const void* rq, const void* addend,
                                   void* stream) {
  using namespace mri::s8;
  if ((pad != 0 && pad != 1) || c8i % 8 || c8o % 8 ||
      (dq != nullptr && rq == nullptr))
    return (int)cudaErrorInvalidValue;
  const int step = pad ? 1 : -1;
  Geometry g;
  g.Di = di; g.Hi = hi; g.Wi = wi; g.C8i = c8i; g.C8o = c8o;
  g.Pd = di + step; g.Ph = hi + step; g.Pw = wi + step;
  g.M = n * g.Pd * g.Ph * (long long)g.Pw;
  g.td = g.th = g.tw = 2;
  g.pad = pad;
  g.K = 8 * c8i;
  g.w = static_cast<const int8_t*>(w);
  if (g.M <= 0) return (int)cudaSuccess;
  const Epilogue epi{(const float*)dq, (const float*)bias,
                     (const float*)alpha, (const float*)rq,
                     (const float*)addend};
  dim3 grid((unsigned)((g.M + kBM - 1) / kBM), (c8o + kBN - 1) / kBN);
  cudaStream_t s = (cudaStream_t)stream;
  if (dq != nullptr)
    conv2_packed_s8_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(x), g, out, epi);
  else
    conv2_packed_s8_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(x), g, out, epi);
  return (int)cudaGetLastError();
}
