// B2: fused folded-BN affine + PReLU + shifted-layout pad zeroing.
//
// Replaces: mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py
//   `bn_act_zero_pads` (Pallas kernel `_bn_act_pads_kernel`), the tail of
//   every aligned->shifted ConvBlock (`models/unet_packed.py::_block_as`).
//
// What it computes on a shifted packed tensor x (N, D, H, W, C8):
//   y = x * scale[c] + shift[c]
//   y = y >= 0 ? y : alpha[c] * y
//   out = y * md[d, c] * mh[h, c] * mw[w, c]
// in float32, stored in x's dtype.  The masks zero the pad sub-positions of
// the first and last cell along each axis (`ops/cuda_kernels.py::
// shifted_pad_keep`).  In BN-folded serving scale is 1 and shift the
// tiled conv bias.
//
// Bound on the H100: bytes.  It reads x once and writes it once (about
// 0.9 GB per 192^3 volume over its 5 sites in bf16); the per-channel
// vectors and the three mask planes are tiny and stay in L1/L2.  Design:
// one thread per 8 consecutive channels of one cell (two 4-wide vector
// loads and stores), so neighbouring threads touch neighbouring bytes and
// the cell's (d, h, w) is decoded once per 8 elements.  Requires C8 % 8 == 0
// and 16-byte-aligned contiguous tensors (checked by the Python wrapper).
#include "common.cuh"

namespace mri {

template <typename T>
__global__ void __launch_bounds__(256)
bn_act_zero_pads_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const float* __restrict__ alpha,
                        const float* __restrict__ md,
                        const float* __restrict__ mh,
                        const float* __restrict__ mw, T* __restrict__ out,
                        long long vecs, int D, int H, int W, int C8) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= vecs) return;
  const long long e = v * 8;
  const int c = (int)(e % C8);
  long long cell = e / C8;
  const int wi = (int)(cell % W); cell /= W;
  const int hi = (int)(cell % H); cell /= H;
  const int di = (int)(cell % D);
  const float* rd = md + (long long)di * C8 + c;
  const float* rh = mh + (long long)hi * C8 + c;
  const float* rw = mw + (long long)wi * C8 + c;
#pragma unroll
  for (int h4 = 0; h4 < 8; h4 += 4) {
    const float4 xv = load4(x + e + h4);
    float in[4] = {xv.x, xv.y, xv.z, xv.w};
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = c + h4 + j;
      float y = in[j] * scale[k] + shift[k];
      y = y >= 0.f ? y : y * alpha[k];
      r[j] = y * (rd[h4 + j] * rh[h4 + j] * rw[h4 + j]);
    }
    store4(out + e + h4, make_float4(r[0], r[1], r[2], r[3]));
  }
}

}  // namespace mri

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int mri_bn_act_zero_pads(const void* x, const void* scale,
                                    const void* shift, const void* alpha,
                                    const void* md, const void* mh,
                                    const void* mw, void* out, int dtype,
                                    long long n, int d, int h, int w, int c8,
                                    void* stream) {
  const long long vecs = n * d * h * w * (long long)(c8 / 8);
  if (vecs == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((vecs + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const float* sh = (const float*)shift;
  const float* al = (const float*)alpha;
  const float* a = (const float*)md;
  const float* b = (const float*)mh;
  const float* cc = (const float*)mw;
  if (dtype == mri::kFloat32)
    mri::bn_act_zero_pads_kernel<float><<<blocks, 256, 0, s>>>(
        (const float*)x, sc, sh, al, a, b, cc, (float*)out, vecs, d, h, w,
        c8);
  else if (dtype == mri::kBFloat16)
    mri::bn_act_zero_pads_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        (const __nv_bfloat16*)x, sc, sh, al, a, b, cc, (__nv_bfloat16*)out,
        vecs, d, h, w, c8);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
