// B1: the k=2 packed convolution of the packed UNet3D, as an implicit GEMM.
//
// Replaces: mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py
//   `conv2_packed_pallas` (Pallas kernel `_conv2_tap_kernel`), the forward
//   of `ops/packed.py::conv3_packed` and, over a one-cell zero-padded
//   input, of `conv3_packed_as`.
//
// What it computes, for pad in {0, 1}:
//   out[n,z,y,x,:] = bias + sum_{qd,qh,qw in {0,1}}
//                    xin[n, z+qd-pad, y+qh-pad, x+qw-pad, :] @ w[qd,qh,qw]
// with xin zero outside its extent.  pad = 0 is the shifted->aligned conv
// (input (N,D+1,H+1,W+1,8Ci) -> (N,D,H,W,8Co)); pad = 1 the
// aligned->shifted one (input (N,D,H,W,8Ci) -> (N,D+1,H+1,W+1,8Co)), whose
// one-cell halo is masked in the loads instead of padded in memory.
//
// GEMM view: M = output cells (N*Do*Ho*Wo), K = 8 taps x 8Ci, N = 8Co.
// Each block owns a 128-cell x BN-channel output tile; per K step of 8 it
// stages the tile's 128 input windows (one tap, 8 channels) and an 8 x BN
// slice of w in shared memory, then each of its 256 threads accumulates an
// 8 x (BN/16) sub-tile in float32 registers.  The next step's global loads
// are issued into registers before the current step's FMAs.
//
// Bound on the H100: at 192^3 every site but the 8Ci = 8 stem has an
// arithmetic intensity far above the ~295 FLOP/byte ridge, so the bound is
// operations (1.69 TFLOP per volume over 12 sites).  This first version
// runs CUDA-core float32 FMAs for bf16 and f32 alike: it is right and
// simple, not fast; tensor cores (mma.sync / wgmma) with TMA-fed shared
// memory are the later step.  The TPU kernel's split into 4 calls of two
// taps each was a Mosaic workaround and is not reproduced: all 8 taps
// accumulate in one pass, in float32, with one rounding at the store.
//
// Offsets are 64-bit: a batch-8 96^3 x 512 bf16 tensor passes 2^31
// elements.  Requires 8Ci % 8 == 0 and 8Co % 4 == 0, contiguous tensors
// and 16-byte-aligned base pointers (checked by the Python wrapper).
#include "common.cuh"

namespace mri {

constexpr int kBM = 128;
constexpr int kBK = 8;
constexpr int kTM = 8;
constexpr int kThreads = 256;

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
conv2_packed_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ out,
                    long long M, int Di, int Hi, int Wi, int Do, int Ho,
                    int Wo, int C8i, int C8o, int pad) {
  constexpr int TN = BN / 16;
  constexpr int kBVec = kBK * BN / 4;  // 4-wide vectors in one w slice
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // this thread's A row (an output cell) and channel quarter
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const long long am = m0 + ar;
  const bool a_row_ok = am < M;
  int az = 0, ay = 0, ax = 0;
  long long an = 0;
  if (a_row_ok) {
    long long t = am;
    ax = (int)(t % Wo); t /= Wo;
    ay = (int)(t % Ho); t /= Ho;
    az = (int)(t % Do); an = t / Do;
  }
  // this thread's B vector (if any) inside the 8 x BN weight slice
  const bool b_loader = tid < kBVec;
  const int bk = tid / (BN / 4), bc = (tid % (BN / 4)) * 4;
  const bool b_col_ok = b_loader && (n0 + bc < C8o);

  const int chunks = C8i / kBK;
  const int steps = 8 * chunks;

  auto load_a = [&](int s) -> float4 {
    const int tap = s / chunks, c0 = (s % chunks) * kBK;
    const int iz = az + (tap >> 2) - pad;
    const int iy = ay + ((tap >> 1) & 1) - pad;
    const int ix = ax + (tap & 1) - pad;
    if (!a_row_ok || iz < 0 || iz >= Di || iy < 0 || iy >= Hi || ix < 0 ||
        ix >= Wi)
      return make_float4(0.f, 0.f, 0.f, 0.f);
    const long long off =
        (((an * Di + iz) * Hi + iy) * (long long)Wi + ix) * C8i + c0 + ak;
    return load4(x + off);
  };
  auto load_b = [&](int s) -> float4 {
    if (!b_col_ok) return make_float4(0.f, 0.f, 0.f, 0.f);
    const int tap = s / chunks, c0 = (s % chunks) * kBK;
    const long long off =
        ((long long)tap * C8i + c0 + bk) * C8o + n0 + bc;
    return load4(w + off);
  };

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float4 ra = load_a(0);
  float4 rb = load_b(0);
  for (int s = 0; s < steps; ++s) {
    As[ak + 0][ar] = ra.x;
    As[ak + 1][ar] = ra.y;
    As[ak + 2][ar] = ra.z;
    As[ak + 3][ar] = ra.w;
    if (b_loader) *reinterpret_cast<float4*>(&Bs[bk][bc]) = rb;
    __syncthreads();
    if (s + 1 < steps) {
      ra = load_a(s + 1);
      rb = load_b(s + 1);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[TN];
#pragma unroll
      for (int i = 0; i < kTM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&As[k][ty * kTM + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[k][tx * TN + j]);
        b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int co = n0 + tx * TN + j;
      if (co >= C8o) continue;
      float4 v = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                             acc[i][j + 3]);
      if (bias != nullptr) {
        v.x += bias[co]; v.y += bias[co + 1];
        v.z += bias[co + 2]; v.w += bias[co + 3];
      }
      store4(out + m * C8o + co, v);
    }
  }
}

template <typename T>
static void launch(const void* x, const void* w, const void* bias, void* out,
                   long long M, int di, int hi, int wi, int do_, int ho,
                   int wo, int c8i, int c8o, int pad, cudaStream_t stream) {
  const unsigned gx = (unsigned)((M + kBM - 1) / kBM);
  if (c8o % 128 == 0) {
    dim3 grid(gx, c8o / 128);
    conv2_packed_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (const float*)bias, (T*)out, M, di, hi,
        wi, do_, ho, wo, c8i, c8o, pad);
  } else {
    dim3 grid(gx, (c8o + 63) / 64);
    conv2_packed_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (const float*)bias, (T*)out, M, di, hi,
        wi, do_, ho, wo, c8i, c8o, pad);
  }
}

}  // namespace mri

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int mri_conv2_packed(const void* x, const void* w,
                                const void* bias, void* out, int dtype,
                                long long n, int di, int hi, int wi, int do_,
                                int ho, int wo, int c8i, int c8o, int pad,
                                void* stream) {
  const long long M = n * do_ * ho * wo;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == mri::kFloat32)
    mri::launch<float>(x, w, bias, out, M, di, hi, wi, do_, ho, wo, c8i,
                       c8o, pad, s);
  else if (dtype == mri::kBFloat16)
    mri::launch<__nv_bfloat16>(x, w, bias, out, M, di, hi, wi, do_, ho, wo,
                               c8i, c8o, pad, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
