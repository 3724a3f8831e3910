// B3's backward: the input gradient (dx) and the weight and bias gradients
// (dw, db) of the one-axis convolution of `conv_axis.cu`, which the fader's
// separable (k,1,1) / (1,k,1) / (1,1,k) stacks chain along D, H and W.
//
// Gradient of: mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py
//   `conv_axis_last` (Pallas kernel `_conv_axis_kernel`), reached through
//   `conv_one_axis` and `separable_conv3d`.  The JAX package trains the
//   fader through XLA convolutions, so these kernels have no Pallas
//   counterpart: they are the gradient that the port's kernel forward
//   needs, as B1's input gradient is for B1.
//
// Layout, as in conv_axis.cu: the channels-last input x is viewed as
// (A, L, B, Ci), with L the conv axis, A the product of the dims before it
// and B of the spatial dims after it; the output's cotangent g as
// (A, Lo, B, Co).  With y[a,j,b,co] = sum_{t,ci} x[a, j*s + t - p, b, ci]
// * w[t,ci,co] (x zero outside [0, L)):
//
//   dx[a,i,b,ci] = sum over taps t with (i + p - t) % s == 0 and
//                  j = (i + p - t) / s in [0, Lo) of
//                  sum_co g[a,j,b,co] * w[t,ci,co]
//   dw[t,ci,co]  = sum_{a,j,b} x[a, j*s + t - p, b, ci] * g[a,j,b,co]
//   db[co]       = sum_{a,j,b} g[a,j,b,co]
//
// dx is a gather: each input position visits only the taps that reach it,
// so the stride acts as a dilation of the cotangent and no zero-stuffed
// tensor is built, and no two threads write one element (no atomics).
// Sums are float32; dx is rounded once to g's dtype, dw and db are float32.
//
// Bound on the H100: bytes.  Both kernels do k*Ci (dx) or k*Ci*Co / (Ci +
// Co) (dw) multiply-adds per element moved, at the fader's sites 8 to 30
// FLOP per byte: under the 20 FLOP/byte at which the 67 TFLOP/s float32
// CUDA cores become the limit at most sites, near it at the rest.
//
// dx design: conv_axis.cu's with the roles of input and output swapped:
// one thread per (input position, group of CIT consecutive input channels),
// the channel group innermost and then B; the transposed weights (k, Co,
// Ci) in shared memory (global memory where they exceed 227 KB), read as
// a warp-wide broadcast 4-wide; the cotangent row read 4-wide.
//
// dw design: the output is small (k*Ci*Co floats) and the reduction huge
// (A*Lo*B rows: 35*96*192*192 for the first encoder stage at batch 35).
// Pass 1 splits the rows into chunks (grid x) and the outputs into tiles
// of up to 256 groups of COT consecutive output channels (grid y); a block
// of og_block x lanes threads gives each thread one (t, ci, channel group)
// and every lanes-th row of the chunk, with COT float32 sums in registers.
// The lanes are summed in shared memory in a fixed order and the block
// writes its chunk's partial sums.  Pass 2 sums the chunks of each output
// in chunk order.  No float atomics: a run repeats bit for bit.  The plan
// (`ops/cuda_kernels.py::conv_axis_dw_plan`) is plain Python.
//
// Offsets are 64-bit.  Requires contiguous tensors and 16-byte-aligned
// base pointers (checked by the Python wrapper).
#include "common.cuh"

namespace mri {

constexpr int kBwdThreads = 256;
constexpr size_t kBwdMaxSmem = 232448;

template <typename T, int CIT, bool VEC, bool WSMEM>
__global__ void __launch_bounds__(kBwdThreads)
conv_axis_dx_kernel(const T* __restrict__ g, const float* __restrict__ wt,
                    T* __restrict__ dx, long long total, int L, int Lo,
                    long long B, int Ci, int Co, int k, int stride,
                    int pad) {
  extern __shared__ __align__(16) float smem_w[];
  const float* ws = wt;
  if constexpr (WSMEM) {
    const int nw = k * Co * Ci;
    for (int i = threadIdx.x; i < nw; i += blockDim.x) smem_w[i] = wt[i];
    __syncthreads();
    ws = smem_w;
  }

  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= total) return;
  const int groups = Ci / CIT;
  const int cg = (int)(v % groups);
  long long r = v / groups;
  const long long b = r % B;
  r /= B;
  const int i = (int)(r % L);
  const long long a = r / L;

  float acc[CIT];
#pragma unroll
  for (int c = 0; c < CIT; ++c) acc[c] = 0.f;

  const long long row = B * Co;  // elements between neighbours along Lo
  const T* ga = g + a * Lo * row + b * Co;
  const float* wg = ws + cg * CIT;
  // the taps that reach i: t = (i + pad) % stride, then every stride-th;
  // j falls as t rises
  for (int t = (i + pad) % stride; t < k; t += stride) {
    const int j = (i + pad - t) / stride;
    if (j < 0) break;
    if (j >= Lo) continue;
    const T* gr = ga + (long long)j * row;
    const float* wtt = wg + t * Co * Ci;
    if constexpr (VEC) {
#pragma unroll 2
      for (int co = 0; co < Co; co += 4) {
        const float4 gv = load4(gr + co);
        fma_row<CIT>(acc, gv.x, wtt + (co + 0) * Ci);
        fma_row<CIT>(acc, gv.y, wtt + (co + 1) * Ci);
        fma_row<CIT>(acc, gv.z, wtt + (co + 2) * Ci);
        fma_row<CIT>(acc, gv.w, wtt + (co + 3) * Ci);
      }
    } else {
      for (int co = 0; co < Co; ++co)
        fma_row<CIT>(acc, load1(gr + co), wtt + co * Ci);
    }
  }

  T* o = dx + ((a * L + i) * B + b) * Ci + cg * CIT;
  if constexpr (CIT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CIT; c += 4)
      store4(o + c, make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]));
  } else {
#pragma unroll
    for (int c = 0; c < CIT; ++c) store1(o + c, acc[c]);
  }
}

template <int COT, typename T>
__device__ __forceinline__ void load_cot(const T* p, float (&v)[COT]) {
  if constexpr (COT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < COT; c += 4) {
      const float4 q = load4(p + c);
      v[c] = q.x;
      v[c + 1] = q.y;
      v[c + 2] = q.z;
      v[c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < COT; ++c) v[c] = load1(p + c);
  }
}

// pass 1: block (chunk, tile) writes partials[chunk][e] for the entries e
// of its tile: e = og * COT + c for the dw entries (og = (t * Ci + ci) *
// (Co / COT) + channel group), k * Ci * Co + co for db (tile 0 only)
template <typename T, int COT>
__global__ void __launch_bounds__(kBwdThreads)
conv_axis_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            float* __restrict__ partials, long long R, int L,
                            int Lo, long long B, int Ci, int Co, int k,
                            int stride, int pad, int og_total, int og_block,
                            int lanes, long long rows_per_chunk,
                            long long nout, int with_bias) {
  extern __shared__ __align__(16) float red[];
  const int tid = threadIdx.x;
  const int nthreads = og_block * lanes;
  const long long chunk = blockIdx.x;
  const int og_local = tid % og_block;
  const int lane = tid / og_block;
  const int og = blockIdx.y * og_block + og_local;
  const int groups = Co / COT;
  const bool active = og < og_total;
  const int cg = og % groups;
  const int tci = og / groups;
  const int ci = tci % Ci;
  const int t = tci / Ci;
  const bool db_owner = with_bias && active && tci == 0;

  float acc[COT], gacc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = gacc[c] = 0.f;

  if (active) {
    const long long r0 = chunk * rows_per_chunk + lane;
    const long long r1 = min(R, (chunk + 1) * rows_per_chunk);
    // (a, j, b) of row r0, then advanced by `lanes` rows per step
    long long b = r0 % B;
    long long q = r0 / B;
    int j = (int)(q % Lo);
    long long a = q / Lo;
    const int tap = t - pad;
    for (long long r = r0; r < r1; r += lanes) {
      float gv[COT];
      load_cot<COT>(g + r * Co + cg * COT, gv);
      if (db_owner) {
#pragma unroll
        for (int c = 0; c < COT; ++c) gacc[c] += gv[c];
      }
      const int l = j * stride + tap;
      if (l >= 0 && l < L) {
        const float xv = load1(x + ((a * L + l) * B + b) * Ci + ci);
#pragma unroll
        for (int c = 0; c < COT; ++c) acc[c] = fmaf(xv, gv[c], acc[c]);
      }
      b += lanes;
      while (b >= B) {
        b -= B;
        if (++j == Lo) {
          j = 0;
          ++a;
        }
      }
    }
  }

  float* red_w = red;
  float* red_b = red + (size_t)nthreads * COT;
#pragma unroll
  for (int c = 0; c < COT; ++c) {
    red_w[tid * COT + c] = acc[c];
    red_b[tid * COT + c] = gacc[c];
  }
  __syncthreads();
  // the lanes of each entry of the tile, summed in lane order
  const int nq = og_block * COT;
  float* part = partials + chunk * nout;
  for (int qi = tid; qi < nq; qi += nthreads) {
    const int og_q = blockIdx.y * og_block + qi / COT;
    if (og_q >= og_total) continue;
    float s = 0.f;
    for (int ln = 0; ln < lanes; ++ln) s += red_w[ln * nq + qi];
    const long long e = (long long)blockIdx.y * nq + qi;
    part[e] = s;
    if (with_bias && og_q < groups) {
      float sb = 0.f;
      for (int ln = 0; ln < lanes; ++ln) sb += red_b[ln * nq + qi];
      part[(long long)k * Ci * Co + e] = sb;
    }
  }
}

// pass 2: each output entry summed over the chunks in chunk order
__global__ void __launch_bounds__(kBwdThreads)
conv_axis_dw_finish_kernel(const float* __restrict__ partials,
                           float* __restrict__ dw, float* __restrict__ db,
                           long long nw, long long n, long long nout,
                           int chunks) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partials[(long long)c * nout + e];
  if (e < nw)
    dw[e] = s;
  else if (db != nullptr)
    db[e - nw] = s;
}

template <typename T, int CIT, bool VEC>
static int launch_dx(const void* g, const void* wt, void* dx, long long A,
                     int L, int Lo, long long B, int Ci, int Co, int k,
                     int stride, int pad, cudaStream_t stream) {
  const long long total = A * L * B * (Ci / CIT);
  if (total == 0) return (int)cudaSuccess;
  const size_t wbytes = (size_t)k * Ci * Co * sizeof(float);
  const bool wsmem = wbytes <= kBwdMaxSmem;
  const size_t smem = wsmem ? wbytes : 0;
  auto kern = wsmem ? conv_axis_dx_kernel<T, CIT, VEC, true>
                    : conv_axis_dx_kernel<T, CIT, VEC, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((total + kBwdThreads - 1) / kBwdThreads);
  kern<<<blocks, kBwdThreads, smem, stream>>>(
      (const T*)g, (const float*)wt, (T*)dx, total, L, Lo, B, Ci, Co, k,
      stride, pad);
  return (int)cudaGetLastError();
}

template <typename T, int CIT>
static int launch_dx_vec(const void* g, const void* wt, void* dx,
                         long long A, int L, int Lo, long long B, int Ci,
                         int Co, int k, int stride, int pad, cudaStream_t s) {
  if (Co % 4 == 0)
    return launch_dx<T, CIT, true>(g, wt, dx, A, L, Lo, B, Ci, Co, k, stride,
                                   pad, s);
  return launch_dx<T, CIT, false>(g, wt, dx, A, L, Lo, B, Ci, Co, k, stride,
                                  pad, s);
}

template <typename T>
static int launch_dx_cit(const void* g, const void* wt, void* dx,
                         long long A, int L, int Lo, long long B, int Ci,
                         int Co, int k, int stride, int pad, cudaStream_t s) {
  if (Ci % 8 == 0)
    return launch_dx_vec<T, 8>(g, wt, dx, A, L, Lo, B, Ci, Co, k, stride,
                               pad, s);
  if (Ci % 4 == 0)
    return launch_dx_vec<T, 4>(g, wt, dx, A, L, Lo, B, Ci, Co, k, stride,
                               pad, s);
  if (Ci % 2 == 0)
    return launch_dx_vec<T, 2>(g, wt, dx, A, L, Lo, B, Ci, Co, k, stride,
                               pad, s);
  return launch_dx_vec<T, 1>(g, wt, dx, A, L, Lo, B, Ci, Co, k, stride, pad,
                             s);
}

template <typename T, int COT>
static int launch_dw_partial(const void* x, const void* g, float* partials,
                             long long R, int L, int Lo, long long B, int Ci,
                             int Co, int k, int stride, int pad,
                             const int* plan, long long nout, int with_bias,
                             cudaStream_t stream) {
  // plan: og_total, og_block, lanes, tiles, chunks, rows_per_chunk
  const int og_total = plan[0], og_block = plan[1], lanes = plan[2];
  const int tiles = plan[3], chunks = plan[4], rows_per_chunk = plan[5];
  const int nthreads = og_block * lanes;
  if (nthreads < 1 || nthreads > kBwdThreads || og_block * tiles < og_total
      || (long long)chunks * rows_per_chunk < R || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)nthreads * COT * sizeof(float);
  dim3 grid((unsigned)chunks, (unsigned)tiles);
  conv_axis_dw_partial_kernel<T, COT><<<grid, nthreads, smem, stream>>>(
      (const T*)x, (const T*)g, partials, R, L, Lo, B, Ci, Co, k, stride,
      pad, og_total, og_block, lanes, rows_per_chunk, nout, with_bias);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dw_cot(int cot, const void* x, const void* g,
                         float* partials, long long R, int L, int Lo,
                         long long B, int Ci, int Co, int k, int stride,
                         int pad, const int* plan, long long nout,
                         int with_bias, cudaStream_t s) {
  switch (cot) {
    case 8:
      return launch_dw_partial<T, 8>(x, g, partials, R, L, Lo, B, Ci, Co, k,
                                     stride, pad, plan, nout, with_bias, s);
    case 4:
      return launch_dw_partial<T, 4>(x, g, partials, R, L, Lo, B, Ci, Co, k,
                                     stride, pad, plan, nout, with_bias, s);
    case 2:
      return launch_dw_partial<T, 2>(x, g, partials, R, L, Lo, B, Ci, Co, k,
                                     stride, pad, plan, nout, with_bias, s);
    case 1:
      return launch_dw_partial<T, 1>(x, g, partials, R, L, Lo, B, Ci, Co, k,
                                     stride, pad, plan, nout, with_bias, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace mri

// g viewed as (A, Lo, B, Co), dx as (A, L, B, Ci); wt the transposed
// weights (k, Co, Ci) in float32.  Launches on `stream`; returns the CUDA
// error of the launch, 0 on success.
extern "C" int mri_conv_axis_dx(const void* g, const void* wt, void* dx,
                                int dtype, long long A, int L, int Lo,
                                long long B, int ci, int co, int k,
                                int stride, int pad, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == mri::kFloat32)
    return mri::launch_dx_cit<float>(g, wt, dx, A, L, Lo, B, ci, co, k,
                                     stride, pad, s);
  if (dtype == mri::kBFloat16)
    return mri::launch_dx_cit<__nv_bfloat16>(g, wt, dx, A, L, Lo, B, ci, co,
                                             k, stride, pad, s);
  return (int)cudaErrorInvalidValue;
}

// x viewed as (A, L, B, Ci), g as (A, Lo, B, Co), both in `dtype`; dw (k,
// Ci, Co) and db (Co,) or null in float32; partials: chunks x nout floats
// of scratch, nout = k * Ci * Co + Co.  plan: cot, og_total, og_block,
// lanes, tiles, chunks, rows_per_chunk (`conv_axis_dw_plan`).  Two
// launches on `stream`; returns the first CUDA error, 0 on success.
extern "C" int mri_conv_axis_dw(const void* x, const void* g, void* dw,
                                void* db, void* partials, int dtype,
                                long long A, int L, int Lo, long long B,
                                int ci, int co, int k, int stride, int pad,
                                const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = A * Lo * B;
  const long long nw = (long long)k * ci * co;
  const long long nout = nw + co;
  const int with_bias = db != nullptr;
  int rc;
  if (dtype == mri::kFloat32)
    rc = mri::launch_dw_cot<float>(plan[0], x, g, (float*)partials, R, L, Lo,
                                   B, ci, co, k, stride, pad, plan + 1, nout,
                                   with_bias, s);
  else if (dtype == mri::kBFloat16)
    rc = mri::launch_dw_cot<__nv_bfloat16>(plan[0], x, g, (float*)partials,
                                           R, L, Lo, B, ci, co, k, stride,
                                           pad, plan + 1, nout, with_bias, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  const long long n = with_bias ? nout : nw;
  const unsigned blocks = (unsigned)((n + mri::kBwdThreads - 1)
                                     / mri::kBwdThreads);
  mri::conv_axis_dw_finish_kernel<<<blocks, mri::kBwdThreads, 0, s>>>(
      (const float*)partials, (float*)dw, (float*)db, nw, n, nout, plan[5]);
  return (int)cudaGetLastError();
}
