// K1 on Hopper tensor cores: the k=2 packed convolution in int8, for the
// int8 serving path of the packed UNet3D (`models/unet_packed_q.py`), as
// an int8 implicit GEMM with wgmma fed by TMA (`s8_wgmma.cuh`).
//
// Replaces: mri_epilepsy_diagnosis_tpu/models/unet_packed_q.py `conv_int8`
//   (:68, `lax.conv_general_dilated(int8, int8) -> int32` in XLA) and, in
//   the fused mode, its `_epilogue` (:267) and the decoder's dequantized
//   sum (:305-315), for 8Ci and 8Co multiples of 64: every served site
//   but the 8Ci = 8 stem, which stays on `conv2_packed_s8.cu` (mma.sync;
//   `ops/cuda_kernels.py::_conv2_s8_route` picks one).  It computes B1's
//   function (ops/pallas_kernels.py::conv2_packed_pallas) in int8:
//     out[n,z,y,x,:] = sum_{q in {0,1}^3} xin[n, z+qd-pad, y+qh-pad,
//                                           x+qw-pad, :] @ w8[q]
//   with int32 sums, xin zero outside its extent; pad 0 is the
//   shifted->aligned conv (S+1 cells to S), pad 1 the aligned->shifted one
//   (S cells to S+1).  One row class of the shared kernel: taps 2 x 2 x 2,
//   weight tap t = 4 qd + 2 qh + qw, the box and N tile of B1's plan.
//
// Two output modes, bit for bit those of `conv2_packed_s8.cu`:
//   - raw: the int32 sums;
//   - fused (dq non-null): JAX's `_epilogue` in float32 on the sums,
//       y = f32(acc) * dq[co]  (+ addend[cell, co])  + b[co]
//       y = prelu(y, alpha[co]); pad voxels of a shifted output zeroed
//       q = clip(rint(y * rq[co]), -127, 127) as int8
//     each a separately rounded float32 operation (__fmul_rn /
//     __fadd_rn: no FMA contraction), rounding half to even as jnp.round
//     (`common.cuh::s8_requant`, shared with the mma.sync route).
//
// Bound on the H100: operations (1,979 TOP/s dense int8): every site it
// serves does K = 8 x 8Ci >= 512 products per output value.
//
// Requires 8Ci % 64 == 0, 8Co % 64 == 0, contiguous tensors and
// 16-byte-aligned base pointers (checked by the Python wrapper,
// ops/cuda_kernels.py::conv2_packed_s8).
#include "s8_wgmma.cuh"

// x: (n, di, hi, wi, c8i) int8; wk: (8 taps, c8o, c8i) int8, K-major
// (`kmajor_weights`); out: (n, do, ho, wo, c8o) with do = di - 1 (pad 0)
// or di + 1 (pad 1), int32 when dq is null, else int8 through the fused
// epilogue (rq required).  The box (bw, bh, bd), N tile bn and K step kb
// (bytes) come from the wrapper.  Launches on `stream`; returns
// cudaGetLastError() after the launch, or a negative code if the launch
// was refused on the host.
extern "C" int mri_conv2_packed_s8_tc(const void* x, const void* wk,
                                      void* out, long long n, int di, int hi,
                                      int wi, int c8i, int c8o, int pad,
                                      int bw, int bh, int bd, int bn, int kb,
                                      const void* dq, const void* bias,
                                      const void* alpha, const void* rq,
                                      const void* addend, void* stream) {
  using namespace mri::tc;
  if ((pad != 0 && pad != 1) || (dq != nullptr && rq == nullptr) ||
      c8o % 64)
    return kErrPlan;
  const int step = pad ? 1 : -1;
  S8Launch L{};
  L.C8i = c8i;
  L.C8o = c8o;
  L.pad = pad;
  L.so = 1;
  L.Do = di + step;
  L.Ho = hi + step;
  L.Wo = wi + step;
  L.nclasses = 1;
  S8Class& k = L.cls[0];
  k.Pd = L.Do;
  k.Ph = L.Ho;
  k.Pw = L.Wo;
  k.td = k.th = k.tw = 2;
  int rc = s8_plan(L, n, bw, bh, bd, bn, kb);
  if (rc != 0) return rc;
  if (L.items == 0) return (int)cudaSuccess;
  CUtensorMap xm, wm;
  rc = s8_tensor_maps(&xm, &wm, x, n, di, hi, wi, c8i, bw, bh, bd, wk,
                      8 * c8o, bn, kb);
  if (rc != 0) return rc;
  const S8Epi epi{static_cast<const float*>(dq),
                  static_cast<const float*>(bias),
                  static_cast<const float*>(alpha),
                  static_cast<const float*>(rq),
                  static_cast<const float*>(addend)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq != nullptr)
    return s8_launch<true, false>(xm, wm, out, L, epi, bn, kb, s);
  return s8_launch<false, false>(xm, wm, out, L, epi, bn, kb, s);
}
