// Train-mode BatchNorm + PReLU + shifted pad zeroing of the packed UNet3D
// step: the tail of every ConvBlock, forward and backward, in four passes.
//
// Replaces: no Pallas kernel.  The JAX package leaves this tail to XLA
// (`mri_epilepsy_diagnosis_tpu/models/unet_packed.py::_block_train`:
// `zero_shifted_pads`, `_bn_train_packed`, `prelu`, `zero_shifted_pads`,
// and their autograd).  In the port's plain PyTorch it was about 40
// elementwise and reduction launches per conv forward and as many
// backward, moving some 194 GB per 192^3 batch-2 step; these four passes
// move about 20 GB.
//
// On a packed tensor y (N, D, H, W, 8C), channel k = sub * C + c (fine
// channel c, sub-position sub = 4 sd + 2 sh + sw), with per-fine-channel
// float32 parameters (rows of C in `prm`: mean, rstd, gamma, beta, alpha,
// then for the dx pass p = gamma * rstd, k2 and k3):
//   yh  = (y - mean) * rstd,  z = gamma * yh + beta
//   out = keep * prelu(z, alpha)
// keep is 0 at the pad sub-positions of a shifted tensor (fine voxels -1
// and S, decided by index as in `common.cuh::shifted_drop`; on the D axis
// only at the faces of the volume this tensor holds: a spatial slab's
// inner faces are real voxels) and 1 elsewhere.
//   stats:   S[c] = (sum y, sum y^2) over kept entries of cells d < owned_d
//   apply:   out as above, one rounding to y's dtype
//   reduce:  with gz = keep * g * (z >= 0 ? 1 : alpha), S[c] = (sum gz,
//            sum gz * yh, sum keep * g * z * [z < 0])
//   dx:      dy = keep * (p * gz - [d < owned_d] * (k2 + k3 * yh))
// Sums fold the 8 sub-positions into the fine channel and run in float32.
//
// Bound on the H100: bytes.  stats reads y, apply reads y and writes out,
// reduce reads y and g, dx reads y and g and writes dy: 8 passes over the
// tensor's size.  Design: one thread per 8 consecutive packed channels of
// a cell (one 16-byte load of bf16, two of float32), C threads per cell, so
// neighbouring threads read neighbouring bytes; a grid-stride loop over
// cells keeps each thread on the same 8 channels, whose parameters it
// loads into registers once.  Cells are decoded only where a pad mask or
// an owned slab needs (d, h, w).  The reductions write per-block partials
// in a fixed order, and a second tiny launch sums them block by block and
// sub by sub: no float atomics, so a step repeats bit for bit.
// Requires C <= 256 and 16-byte-aligned contiguous tensors (checked by
// the Python wrapper).
#include "common.cuh"

namespace mri {

constexpr int kBnThreads = 256;

struct BnGeom {
  long long cells;      // N * D * H * W
  int D, H, W, C;       // cells per axis; fine channels (8C packed)
  int shifted;          // skip the pad sub-positions
  int d_first, d_last;  // the tensor holds the volume's first / last D face
  int owned_d;          // cells d < owned_d enter the statistics term
};

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// the packed subs (bit s = sub s) of cell `cell` that are pad voxels, and
// whether the cell lies in the owned slab; the D faces count only where
// the tensor holds them
template <bool INDEXED>
__device__ __forceinline__ unsigned cell_drop(long long cell,
                                              const BnGeom& g, bool* owned) {
  if constexpr (!INDEXED) {
    *owned = true;
    return 0u;
  } else {
    // cells < 2^31 (checked by the wrapper): 32-bit division
    const unsigned cu = (unsigned)cell;
    const int w = (int)(cu % (unsigned)g.W);
    const unsigned t = cu / (unsigned)g.W;
    const int h = (int)(t % (unsigned)g.H);
    const int d = (int)((t / (unsigned)g.H) % (unsigned)g.D);
    *owned = d < g.owned_d;
    if (!g.shifted) return 0u;
    const unsigned dd = (g.d_last && d == g.D - 1)   ? 0xF0u
                        : (g.d_first && d == 0)      ? 0x0Fu
                                                     : 0u;
    const unsigned hh = h == g.H - 1 ? 0xCCu : h == 0 ? 0x33u : 0u;
    const unsigned ww = w == g.W - 1 ? 0xAAu : w == 0 ? 0x55u : 0u;
    return dd | hh | ww;
  }
}

// the thread's channel group j (packed channels 8j .. 8j+7): their fine
// channels and sub-positions
__device__ __forceinline__ void channel_group(int j, int C, int (&ch)[8],
                                              int (&sub)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 8 * j + i;
    sub[i] = k / C;
    ch[i] = k - sub[i] * C;
  }
}

// each thread's S x 8 sums -> the block's (S, 8C) partial, threads of one
// channel group summed in a fixed order
template <int S>
__device__ __forceinline__ void block_partial(const float (&acc)[S][8],
                                              float* partial, int C) {
  __shared__ float red[kBnThreads * 8];
  const int t = threadIdx.x;
  const int cpb = blockDim.x / C;
  const int C8 = 8 * C;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) red[i * kBnThreads + t] = acc[s][i];
    __syncthreads();
    if (t < C) {
      float* dst = partial + ((long long)blockIdx.x * S + s) * C8 + 8 * t;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = 0.f;
        for (int l = 0; l < cpb; ++l) v += red[i * kBnThreads + l * C + t];
        dst[i] = v;
      }
    }
  }
}

template <typename T, bool INDEXED>
__global__ void __launch_bounds__(kBnThreads)
bn_train_stats_kernel(const T* __restrict__ y, float* __restrict__ partial,
                      BnGeom g) {
  const int C = g.C, cpb = blockDim.x / C;
  const int j = threadIdx.x % C, cl = threadIdx.x / C;
  int ch[8], sub[8];
  channel_group(j, C, ch, sub);
  float acc[2][8] = {};
  for (long long cell = (long long)blockIdx.x * cpb + cl; cell < g.cells;
       cell += (long long)gridDim.x * cpb) {
    bool owned;
    const unsigned drop = cell_drop<INDEXED>(cell, g, &owned);
    if (!owned) continue;
    float v[8];
    load8(y + cell * 8 * C + 8 * j, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x = (drop >> sub[i]) & 1u ? 0.f : v[i];
      acc[0][i] += x;
      acc[1][i] = fmaf(x, x, acc[1][i]);
    }
  }
  block_partial<2>(acc, partial, C);
}

template <typename T, bool INDEXED>
__global__ void __launch_bounds__(kBnThreads)
bn_train_apply_kernel(const T* __restrict__ y, const float* __restrict__ prm,
                      T* __restrict__ out, BnGeom g) {
  const int C = g.C, cpb = blockDim.x / C;
  const int j = threadIdx.x % C, cl = threadIdx.x / C;
  int ch[8], sub[8];
  channel_group(j, C, ch, sub);
  float mean[8], rstd[8], gam[8], bet[8], alp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mean[i] = prm[ch[i]];
    rstd[i] = prm[C + ch[i]];
    gam[i] = prm[2 * C + ch[i]];
    bet[i] = prm[3 * C + ch[i]];
    alp[i] = prm[4 * C + ch[i]];
  }
  for (long long cell = (long long)blockIdx.x * cpb + cl; cell < g.cells;
       cell += (long long)gridDim.x * cpb) {
    bool owned;
    const unsigned drop = cell_drop<INDEXED>(cell, g, &owned);
    const long long e = cell * 8 * C + 8 * j;
    float v[8];
    load8(y + e, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float z = fmaf((v[i] - mean[i]) * rstd[i], gam[i], bet[i]);
      const float r = z >= 0.f ? z : z * alp[i];
      v[i] = (drop >> sub[i]) & 1u ? 0.f : r;
    }
    store8(out + e, v);
  }
}

template <typename T, bool INDEXED>
__global__ void __launch_bounds__(kBnThreads)
bn_train_reduce_kernel(const T* __restrict__ y, const T* __restrict__ gr,
                       const float* __restrict__ prm,
                       float* __restrict__ partial, BnGeom g) {
  const int C = g.C, cpb = blockDim.x / C;
  const int j = threadIdx.x % C, cl = threadIdx.x / C;
  int ch[8], sub[8];
  channel_group(j, C, ch, sub);
  float mean[8], rstd[8], gam[8], bet[8], alp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mean[i] = prm[ch[i]];
    rstd[i] = prm[C + ch[i]];
    gam[i] = prm[2 * C + ch[i]];
    bet[i] = prm[3 * C + ch[i]];
    alp[i] = prm[4 * C + ch[i]];
  }
  float acc[3][8] = {};
  for (long long cell = (long long)blockIdx.x * cpb + cl; cell < g.cells;
       cell += (long long)gridDim.x * cpb) {
    bool owned;
    const unsigned drop = cell_drop<INDEXED>(cell, g, &owned);
    const long long e = cell * 8 * C + 8 * j;
    float v[8], gv[8];
    load8(y + e, v);
    load8(gr + e, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float yh = (v[i] - mean[i]) * rstd[i];
      const float z = fmaf(yh, gam[i], bet[i]);
      const float gk = (drop >> sub[i]) & 1u ? 0.f : gv[i];
      const float gz = z >= 0.f ? gk : gk * alp[i];
      acc[0][i] += gz;
      acc[1][i] = fmaf(gz, yh, acc[1][i]);
      acc[2][i] = z < 0.f ? fmaf(gk, z, acc[2][i]) : acc[2][i];
    }
  }
  block_partial<3>(acc, partial, C);
}

template <typename T, bool INDEXED>
__global__ void __launch_bounds__(kBnThreads)
bn_train_dx_kernel(const T* __restrict__ y, const T* __restrict__ gr,
                   const float* __restrict__ prm, T* __restrict__ dy,
                   BnGeom g) {
  const int C = g.C, cpb = blockDim.x / C;
  const int j = threadIdx.x % C, cl = threadIdx.x / C;
  int ch[8], sub[8];
  channel_group(j, C, ch, sub);
  float mean[8], rstd[8], gam[8], bet[8], alp[8], p[8], k2[8], k3[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mean[i] = prm[ch[i]];
    rstd[i] = prm[C + ch[i]];
    gam[i] = prm[2 * C + ch[i]];
    bet[i] = prm[3 * C + ch[i]];
    alp[i] = prm[4 * C + ch[i]];
    p[i] = prm[5 * C + ch[i]];
    k2[i] = prm[6 * C + ch[i]];
    k3[i] = prm[7 * C + ch[i]];
  }
  for (long long cell = (long long)blockIdx.x * cpb + cl; cell < g.cells;
       cell += (long long)gridDim.x * cpb) {
    bool owned;
    const unsigned drop = cell_drop<INDEXED>(cell, g, &owned);
    const long long e = cell * 8 * C + 8 * j;
    float v[8], gv[8];
    load8(y + e, v);
    load8(gr + e, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float yh = (v[i] - mean[i]) * rstd[i];
      const float z = fmaf(yh, gam[i], bet[i]);
      const float gz = z >= 0.f ? gv[i] : gv[i] * alp[i];
      const float stat = owned ? fmaf(yh, k3[i], k2[i]) : 0.f;
      v[i] = (drop >> sub[i]) & 1u ? 0.f : fmaf(p[i], gz, -stat);
    }
    store8(dy + e, v);
  }
}

// out[s, c] = sum over blocks b, then over subs, of partial[b, s, sub*C + c]
// in that order: one block per (s, c), its threads over b, then a tree
__global__ void __launch_bounds__(kBnThreads)
bn_train_fold_kernel(const float* __restrict__ partial,
                     float* __restrict__ out, int blocks, int S, int C) {
  const int s = blockIdx.x / C, c = blockIdx.x % C;
  const int C8 = 8 * C;
  float acc = 0.f;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    const float* row = partial + ((long long)b * S + s) * C8 + c;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc += row[q * C];
  }
  __shared__ float red[kBnThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kBnThreads / 2; half > 0; half /= 2) {
    if ((int)threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

inline BnGeom make_geom(long long n, int d, int h, int w, int c, int shifted,
                        int d_first, int d_last, int owned_d) {
  return BnGeom{n * d * h * w, d, h, w, c, shifted, d_first, d_last,
                owned_d};
}

inline int block_threads(int c) { return (kBnThreads / c) * c; }

// the kernel instantiation for dtype and whether cells are decoded
#define MRI_BN_DISPATCH(KERNEL, GEOM, ...)                                   \
  do {                                                                       \
    const bool idx = (GEOM).shifted || (GEOM).owned_d < (GEOM).D;            \
    if (dtype == mri::kFloat32) {                                            \
      using T = float;                                                       \
      if (idx) KERNEL<T, true><<<grid, threads, 0, s>>>(__VA_ARGS__);        \
      else KERNEL<T, false><<<grid, threads, 0, s>>>(__VA_ARGS__);           \
    } else if (dtype == mri::kBFloat16) {                                    \
      using T = __nv_bfloat16;                                               \
      if (idx) KERNEL<T, true><<<grid, threads, 0, s>>>(__VA_ARGS__);        \
      else KERNEL<T, false><<<grid, threads, 0, s>>>(__VA_ARGS__);           \
    } else {                                                                 \
      return (int)cudaErrorInvalidValue;                                     \
    }                                                                        \
  } while (0)

}  // namespace mri

// Each entry launches on `stream` and returns cudaGetLastError() after
// its launches.  `grid` blocks walk the cells; `partial` holds grid x S x
// 8C floats; `out` the S x C sums.

extern "C" int mri_bn_train_stats(const void* y, void* partial, void* out,
                                  int dtype, long long n, int d, int h, int w,
                                  int c, int shifted, int d_first, int d_last,
                                  int owned_d, int grid, void* stream) {
  const mri::BnGeom g =
      mri::make_geom(n, d, h, w, c, shifted, d_first, d_last, owned_d);
  const int threads = mri::block_threads(c);
  cudaStream_t s = (cudaStream_t)stream;
  MRI_BN_DISPATCH(mri::bn_train_stats_kernel, g, (const T*)y,
                  (float*)partial, g);
  mri::bn_train_fold_kernel<<<2 * c, mri::kBnThreads, 0, s>>>(
      (const float*)partial, (float*)out, grid, 2, c);
  return (int)cudaGetLastError();
}

extern "C" int mri_bn_train_apply(const void* y, const void* prm, void* out,
                                  int dtype, long long n, int d, int h, int w,
                                  int c, int shifted, int d_first, int d_last,
                                  int grid, void* stream) {
  const mri::BnGeom g =
      mri::make_geom(n, d, h, w, c, shifted, d_first, d_last, d);
  const int threads = mri::block_threads(c);
  cudaStream_t s = (cudaStream_t)stream;
  MRI_BN_DISPATCH(mri::bn_train_apply_kernel, g, (const T*)y,
                  (const float*)prm, (T*)out, g);
  return (int)cudaGetLastError();
}

extern "C" int mri_bn_train_reduce(const void* y, const void* gr,
                                   const void* prm, void* partial, void* out,
                                   int dtype, long long n, int d, int h,
                                   int w, int c, int shifted, int d_first,
                                   int d_last, int grid, void* stream) {
  const mri::BnGeom g =
      mri::make_geom(n, d, h, w, c, shifted, d_first, d_last, d);
  const int threads = mri::block_threads(c);
  cudaStream_t s = (cudaStream_t)stream;
  MRI_BN_DISPATCH(mri::bn_train_reduce_kernel, g, (const T*)y,
                  (const T*)gr, (const float*)prm, (float*)partial, g);
  mri::bn_train_fold_kernel<<<3 * c, mri::kBnThreads, 0, s>>>(
      (const float*)partial, (float*)out, grid, 3, c);
  return (int)cudaGetLastError();
}

extern "C" int mri_bn_train_dx(const void* y, const void* gr, const void* prm,
                               void* dy, int dtype, long long n, int d, int h,
                               int w, int c, int shifted, int d_first,
                               int d_last, int owned_d, int grid,
                               void* stream) {
  const mri::BnGeom g =
      mri::make_geom(n, d, h, w, c, shifted, d_first, d_last, owned_d);
  const int threads = mri::block_threads(c);
  cudaStream_t s = (cudaStream_t)stream;
  MRI_BN_DISPATCH(mri::bn_train_dx_kernel, g, (const T*)y, (const T*)gr,
                  (const float*)prm, (T*)dy, g);
  return (int)cudaGetLastError();
}
