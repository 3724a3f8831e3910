// B3: zero-padded strided convolution along one spatial axis of a
// channels-last volume, the building block of the fader family's
// separable (k,1,1) / (1,k,1) / (1,1,k) conv stacks.
//
// Replaces: mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py
//   `conv_axis_last` (Pallas kernel `_conv_axis_kernel`), reached through
//   `conv_one_axis` and `separable_conv3d`: every conv of the fader
//   DownBlock, UpBlock and Classificator/Discriminator head.
//
// What it computes: x (N, D, H, W, Ci) is viewed as (A, L, B, Ci), with L
// the conv axis, A the product of the dims before it and B of the spatial
// dims after it; w is (k, Ci, Co) in float32; then
//   out[a, j, b, co] = bias[co]
//       + sum_{t < k, ci < Ci} x[a, j*stride + t - pad, b, ci] * w[t, ci, co]
// for j < Lo = (L + 2*pad - k) / stride + 1, with x zero outside [0, L).
// The sum and the bias are taken in float32 and rounded once to x's dtype.
// The conv axis is addressed by its stride (B * Ci elements), so the
// TPU path's moveaxis/reshape copies and its padded copy do not exist.
//
// Bound on the H100: bytes.  In bf16 the fader's 192^3 sites do 5 to 16
// FLOP per byte moved, below the 20 FLOP/byte at which the 67 TFLOP/s
// float32 CUDA cores become the limit: one batch of 8 ensemble volumes
// moves 1.65 GB over its 12 sites (0.49 ms at 3.35 TB/s) for 20.8 GFLOP
// (0.31 ms).  Being that close to the ridge, the FMAs must issue densely:
// weights are broadcast from shared memory 4 at a time and every loaded
// input value feeds COT FMAs.
//
// Design: one thread per (output position, group of COT consecutive output
// channels), with the channel group innermost and then B, so that a warp's
// stores are one contiguous run and its loads of x along D or H are
// neighbouring rows of Ci channels.  Each thread reads
// its k input rows once (4-wide when Ci % 4 == 0) and keeps COT float32
// sums in registers; w lives in shared memory (dynamic above 48 KB; read
// from global memory where it exceeds one block's 227 KB) and is read as
// a warp-wide broadcast, 4-wide when COT % 4 == 0.  The taps re-read each input element about
// k / stride times; the re-reads hit L1/L2, not HBM.
//
// Offsets are 64-bit.  Requires contiguous tensors and 16-byte-aligned
// base pointers (checked by the Python wrapper).
#include "common.cuh"

namespace mri {

constexpr int kAxisThreads = 256;
// weights above one block's shared memory are read from global memory
// (through L1/L2) instead: the fader AE's widest stages (k x Ci x Co up to
// 3 x 512 x 512) and the discriminator's 2 x 512 x 1024
constexpr size_t kAxisMaxSmem = 232448;

template <typename T, int COT, bool VEC, bool WSMEM>
__global__ void __launch_bounds__(kAxisThreads)
conv_axis_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out,
                 long long total, int L, int Lo, long long B, int Ci, int Co,
                 int k, int stride, int pad) {
  extern __shared__ __align__(16) float smem_w[];
  const float* ws = w;
  if constexpr (WSMEM) {
    const int nw = k * Ci * Co;
    for (int i = threadIdx.x; i < nw; i += blockDim.x) smem_w[i] = w[i];
    __syncthreads();
    ws = smem_w;
  }

  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= total) return;
  const int groups = Co / COT;
  const int cg = (int)(v % groups);
  long long r = v / groups;
  const long long b = r % B;
  r /= B;
  const int j = (int)(r % Lo);
  const long long a = r / Lo;

  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c)
    acc[c] = bias != nullptr ? bias[cg * COT + c] : 0.f;

  const long long row = B * Ci;  // elements between neighbours along L
  const T* xa = x + a * L * row + b * Ci;
  const float* wg = ws + cg * COT;
  for (int t = 0; t < k; ++t) {
    const int l = j * stride + t - pad;
    if (l < 0 || l >= L) continue;
    const T* xr = xa + (long long)l * row;
    const float* wt = wg + t * Ci * Co;
    if constexpr (VEC) {
#pragma unroll 2
      for (int ci = 0; ci < Ci; ci += 4) {
        const float4 xv = load4(xr + ci);
        fma_row<COT>(acc, xv.x, wt + (ci + 0) * Co);
        fma_row<COT>(acc, xv.y, wt + (ci + 1) * Co);
        fma_row<COT>(acc, xv.z, wt + (ci + 2) * Co);
        fma_row<COT>(acc, xv.w, wt + (ci + 3) * Co);
      }
    } else {
      for (int ci = 0; ci < Ci; ++ci)
        fma_row<COT>(acc, load1(xr + ci), wt + ci * Co);
    }
  }

  T* o = out + ((a * Lo + j) * B + b) * Co + cg * COT;
  if constexpr (COT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < COT; c += 4)
      store4(o + c, make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]));
  } else {
#pragma unroll
    for (int c = 0; c < COT; ++c) store1(o + c, acc[c]);
  }
}

template <typename T, int COT, bool VEC>
static int launch(const void* x, const void* w, const void* bias, void* out,
                  long long A, int L, int Lo, long long B, int Ci, int Co,
                  int k, int stride, int pad, cudaStream_t stream) {
  const long long total = A * Lo * B * (Co / COT);
  if (total == 0) return (int)cudaSuccess;
  const size_t wbytes = (size_t)k * Ci * Co * sizeof(float);
  const bool wsmem = wbytes <= kAxisMaxSmem;
  const size_t smem = wsmem ? wbytes : 0;
  auto kern = wsmem ? conv_axis_kernel<T, COT, VEC, true>
                    : conv_axis_kernel<T, COT, VEC, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks =
      (unsigned)((total + kAxisThreads - 1) / kAxisThreads);
  kern<<<blocks, kAxisThreads, smem, stream>>>(
      (const T*)x, (const float*)w, (const float*)bias, (T*)out, total, L,
      Lo, B, Ci, Co, k, stride, pad);
  return (int)cudaGetLastError();
}

template <typename T, int COT>
static int launch_vec(const void* x, const void* w, const void* bias,
                      void* out, long long A, int L, int Lo, long long B,
                      int Ci, int Co, int k, int stride, int pad,
                      cudaStream_t s) {
  if (Ci % 4 == 0)
    return launch<T, COT, true>(x, w, bias, out, A, L, Lo, B, Ci, Co, k,
                                stride, pad, s);
  return launch<T, COT, false>(x, w, bias, out, A, L, Lo, B, Ci, Co, k,
                               stride, pad, s);
}

template <typename T>
static int launch_cot(const void* x, const void* w, const void* bias,
                      void* out, long long A, int L, int Lo, long long B,
                      int Ci, int Co, int k, int stride, int pad,
                      cudaStream_t s) {
  if (Co % 8 == 0)
    return launch_vec<T, 8>(x, w, bias, out, A, L, Lo, B, Ci, Co, k, stride,
                            pad, s);
  if (Co % 4 == 0)
    return launch_vec<T, 4>(x, w, bias, out, A, L, Lo, B, Ci, Co, k, stride,
                            pad, s);
  if (Co % 2 == 0)
    return launch_vec<T, 2>(x, w, bias, out, A, L, Lo, B, Ci, Co, k, stride,
                            pad, s);
  return launch_vec<T, 1>(x, w, bias, out, A, L, Lo, B, Ci, Co, k, stride,
                          pad, s);
}

}  // namespace mri

// x viewed as (A, L, B, Ci), out as (A, Lo, B, Co); w (k, Ci, Co) and bias
// (Co,) or null in float32.  Launches on `stream`; returns the CUDA error
// of the launch (cudaGetLastError()), 0 on success.
extern "C" int mri_conv_axis(const void* x, const void* w, const void* bias,
                             void* out, int dtype, long long A, int L,
                             int Lo, long long B, int ci, int co, int k,
                             int stride, int pad, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == mri::kFloat32)
    return mri::launch_cot<float>(x, w, bias, out, A, L, Lo, B, ci, co, k,
                                  stride, pad, s);
  if (dtype == mri::kBFloat16)
    return mri::launch_cot<__nv_bfloat16>(x, w, bias, out, A, L, Lo, B, ci,
                                          co, k, stride, pad, s);
  return (int)cudaErrorInvalidValue;
}
