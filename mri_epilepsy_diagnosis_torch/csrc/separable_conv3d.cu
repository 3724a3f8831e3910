// B3 fused: the fader family's whole separable conv stack, (k,1,1) then
// (1,k,1) then (1,1,k), in one launch.
//
// Replaces: mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py
//   `separable_conv3d` (three `conv_one_axis` calls of the Pallas kernel
//   `conv_axis_last` / `_conv_axis_kernel`): every stack of the fader
//   DownBlock, UpBlock and Classificator/Discriminator head.
//
// What it computes: with x (N, D, H, W, Ci) and per axis a weight
// w_a[t, ci, co] (k_a taps, read in x's dtype from torch's (Cout, Cin, k)
// layout), a bias b_a (Cout_a,) (f32) or none, a stride s_a and a zero
// pad p_a,
//   y1 = conv_D(x), y2 = conv_H(y1), out = conv_W(y2),
//   conv_a(v)[.., j, .., co] = b_a[co]
//       + sum_{t, ci} v[.., j*s_a + t - p_a, .., ci] * w_a[t, ci, co]
// with v zero outside its extent, each sum in f32 and each result rounded
// once to x's dtype: the same arithmetic as three `conv_axis.cu` launches,
// whose plain version (`conv_axis_plain` three times) is this kernel's.
//
// Bound on the H100: bytes.  Three launches write y1 and y2 to device
// memory and read them back; at the first DownBlock of a 192^3 batch of 8
// that is 1.59 GB of the 1.65 GB that B3 moved.  Here only x, the weights
// and out touch device memory (0.245 GB per batch over the four served
// stacks, 0.073 ms at 3.35 TB/s).  The 20.8 GFLOP per batch would take
// 0.31 ms on f32 CUDA cores, so in bf16 every stage with Cin and Cout
// multiples of 8 runs on tensor cores.
//
// Design: one block per output tile of TD x TH x TW cells of one batch
// item (all Cout channels).  It stages the input tile with its halo,
// L_a = (T_a - 1) s_a + k_a cells per axis, zero-filled outside x, in
// shared memory with cp.async (4-byte copies, all in flight at once, the
// zero fill by a source size of 0); runs the D stage into a shared y1
// tile (TD x LH x LW), the H stage into a shared y2 tile (TD x TH x LW,
// over the dead input), and the W stage to device memory.  A y1 or y2 cell outside the volume
// along an axis still to be convolved is stored as zero: that is the next
// stage's zero padding.  The weights of the running stage sit in shared
// memory, re-loaded between stages.
// - Tensor-core stages (bf16, Cin % 8 == 0, Cout % 8 == 0): an implicit
//   GEMM with M = the stage's output cells, K = k x Cin (zero-padded to a
//   multiple of 16), N = Cout, mma.sync m16n8k16 with f32 accumulators;
//   a warp takes two 16-row blocks per step where Cout <= 32 (they share
//   the B loads).  Each 8-wide K half lies inside one tap, so an A
//   register is one 32-bit shared load of two channels of a cell; B is
//   the stage's weights laid out (Cout, K) in shared memory, rows padded
//   by 8 elements against bank conflicts.
// - Other stages (f32, the Ci = 1 stem, Cout = 1): CUDA-core FMAs, one
//   thread per (4 outputs along the conv axis, group of 8 or 1 output
//   channels), so that each weight vector read from shared memory feeds
//   4 FMA chains.
// Cell coordinates are carried from one work item to the next, not
// divided out, and the K offsets of a tensor-core stage come from a
// table: at e0's 8 channels the stages are bound by instruction
// throughput, not by the tensor cores.
// The tile plan (tile, halo, shared-memory layout) comes from the wrapper
// (`ops/cuda_kernels.py::separable_plan`), which also decides whether a
// stack is fused at all (`_separable_route`).  Offsets into x and out are
// 64-bit; the wrapper checks contiguity and 16-byte alignment.
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace mri {
namespace sep {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;
constexpr int kBig = 1 << 30;
constexpr int kMaxKHalves = 64;   // a tensor-core stage's K <= 512
constexpr int kMinBlocks = 3;     // registers for 3 blocks per SM

// the plan, as the wrapper sends it: 34 ints in this order
struct Geo {
  int D, H, W;                 // input extents
  int Do, Ho, Wo;              // output extents
  int TD, TH, TW;              // output cells per tile
  int LD, LH, LW;              // input cells per tile, halo included
  int tiles_d, tiles_h, tiles_w;
  int ci, c1, c2, c3;          // channels of x, y1, y2, out
  int k[3], s[3], p[3];        // per axis: taps, stride, pad
  int mma[3];                  // per stage: 1 = tensor cores
  int off_y1, off_w, smem;     // shared-memory layout in bytes
};
constexpr int kGeoInts = 34;
static_assert(sizeof(Geo) == kGeoInts * sizeof(int), "Geo must be packed");

// one stage: conv along `axis` of a shared src tile (sdim cells) into dst
// (ddim cells, element strides dst_st); dst cells outside [lo, hi) per
// axis are zero (intermediate) or not stored (final)
struct Stage {
  int axis, k, s, cin, cout;
  int sdim[3], ddim[3], lo[3], hi[3];
  long long dst_st[3];
};

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int kpad_of(int K) { return (K + 15) & ~15; }

__device__ __forceinline__ bool inside(const Stage& a, int i0, int i1,
                                       int i2) {
  return i0 >= a.lo[0] && i0 < a.hi[0] && i1 >= a.lo[1] && i1 < a.hi[1] &&
         i2 >= a.lo[2] && i2 < a.hi[2];
}

// element offset of dst cell (i0, i1, i2)'s first tap in the src tile
__device__ __forceinline__ int src_offset(const Stage& a, int i0, int i1,
                                          int i2) {
  const int st1 = a.sdim[2] * a.cin, st0 = a.sdim[1] * st1;
  if (a.axis == 0) i0 *= a.s;
  else if (a.axis == 1) i1 *= a.s;
  else i2 *= a.s;
  return i0 * st0 + i1 * st1 + i2 * a.cin;
}

__device__ __forceinline__ int tap_stride(const Stage& a) {
  return a.axis == 0 ? a.sdim[1] * a.sdim[2] * a.cin
                     : a.axis == 1 ? a.sdim[2] * a.cin : a.cin;
}

// the stage's weights, (Cout, Cin, k) in x's dtype in device memory, into
// shared memory: (Cout, K + pad) bf16 rows for a tensor-core stage,
// (k, Cin, Cout) f32 otherwise.  Threads walk the source in order
// (coalesced) and start 4 loads before their 4 stores.
template <typename T>
__device__ void load_weights(const T* __restrict__ w, int k, int cin,
                             int cout, bool mma, void* wbuf) {
  const int K = k * cin, n = K * cout;
  const int kpad = kpad_of(K), ws = kpad + 8;
  __nv_bfloat16* wt = static_cast<__nv_bfloat16*>(wbuf);
  float* wf = static_cast<float*>(wbuf);
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < n ? load1(w + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n) break;
      const int co = i / K, rem = i - co * K;
      const int ci = rem / k, t = rem - ci * k;
      if (mma)
        wt[co * ws + t * cin + ci] = __float2bfloat16_rn(v[u]);
      else
        wf[(t * cin + ci) * cout + co] = v[u];
    }
  }
  if (mma)  // the K padding reads zeros
    for (int i = threadIdx.x; i < cout * (kpad - K); i += kThreads) {
      const int co = i / (kpad - K);
      wt[co * ws + K + (i - co * (kpad - K))] = __float2bfloat16_rn(0.f);
    }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// The input tile (LD, LH, LW, Ci) from origin (d0, h0, w0) of item n,
// zero outside x, as rows of `pitch` cells that start `lead` cells before
// w0 (returned).  Where x's rows are whole 16-byte units (W x Ci x element
// size a multiple of 16) and a cell divides or fills them, the copies are
// 16-byte cp.async units aligned to x's rows, so none straddles the
// volume's edge; cells narrower than 16 bytes take a lead (and pitch) that
// aligns the tile's rows to those units.  Otherwise 4-byte units where
// cells are 4-byte multiples, else element by element.  cp.async copies
// stay in flight until the caller's cp.async.wait_all.
template <typename T>
__device__ void load_input(const T* __restrict__ x, T* xs, const Geo& g,
                           long long n, int d0, int h0, int w0, int& lead,
                           int& pitch) {
  constexpr int kE = sizeof(T);
  const int cell = g.ci * kE, rows = g.LD * g.LH;
  const long long row_stride = (long long)g.W * g.ci;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  lead = 0;
  pitch = g.LW;
  int unit = 0;
  if ((g.W * cell) % 16 == 0 && (cell % 16 == 0 || 16 % cell == 0)) {
    unit = 16;
    if (cell < 16) {
      const int per = 16 / cell;  // cells per unit
      lead = ((w0 % per) + per) % per;
      pitch = (lead + g.LW + per - 1) / per * per;
    }
  } else if (cell % 4 == 0) {
    unit = 4;
  }
  if (unit != 0) {
    const int per_row = pitch * cell / unit;
    const int ws = w0 - lead;
    for (int u = threadIdx.x; u < rows * per_row; u += kThreads) {
      const int r = u / per_row, b = (u - r * per_row) * unit;
      const int d = d0 + r / g.LH, h = h0 + r % g.LH, w = ws + b / cell;
      const bool ok = d >= 0 && d < g.D && h >= 0 && h < g.H && w >= 0 &&
                      w < g.W;
      const T* src = ok ? x + ((n * g.D + d) * g.H + h) * row_stride +
                              (long long)ws * g.ci + b / kE
                        : x;
      const uint32_t dst = base + (uint32_t)(r * pitch * cell + b);
      if (unit == 16)
        cp_async16(dst, src, ok);
      else
        cp_async4(dst, src, ok);
    }
    return;
  }
  const int row_len = g.LW * g.ci;
  for (int i0 = threadIdx.x; i0 < rows * row_len; i0 += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * kThreads;
      const int r = i / row_len, e = i - r * row_len;
      const int d = d0 + r / g.LH, h = h0 + r % g.LH, w = w0 + e / g.ci;
      v[q] = (i < rows * row_len && d >= 0 && d < g.D && h >= 0 &&
              h < g.H && w >= 0 && w < g.W)
                 ? load1(x + ((n * g.D + d) * g.H + h) * row_stride +
                         (long long)w0 * g.ci + e)
                 : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (i0 + q * kThreads < rows * row_len)
        store1(xs + i0 + q * kThreads, v[q]);
  }
}

// A thread's cell (i0, i1, i2) of a (d0, d1, d2) tile, advanced by a
// fixed step of cells with carries instead of divisions.
struct Walk {
  int i0, i1, i2;       // current cell
  int s0, s1, s2;       // the step, as a cell offset
  int d1, d2;

  __device__ __forceinline__ void init(int pos, int step, int dd1, int dd2) {
    d1 = dd1;
    d2 = dd2;
    i2 = pos % d2;
    i1 = (pos / d2) % d1;
    i0 = pos / (d2 * d1);
    s2 = step % d2;
    s1 = (step / d2) % d1;
    s0 = step / (d2 * d1);
  }
  __device__ __forceinline__ void advance(int carry_in = 0) {
    i2 += s2 + carry_in;
    int c = 0;
    if (i2 >= d2) { i2 -= d2; c = 1; }
    i1 += s1 + c;
    c = 0;
    if (i1 >= d1) { i1 -= d1; c = 1; }
    i0 += s0 + c;
  }
};

template <bool FINAL>
__device__ __forceinline__ long long dst_offset(const Stage& a, int i0,
                                                int i1, int i2) {
  if constexpr (FINAL)
    return i0 * a.dst_st[0] + i1 * a.dst_st[1] + i2 * a.dst_st[2];
  else
    return i0 * (int)a.dst_st[0] + i1 * (int)a.dst_st[1] +
           i2 * (int)a.dst_st[2];
}

// R outputs along the conv axis per thread on the CUDA cores: each
// weight vector loaded from shared memory feeds R FMA chains
constexpr int kR = 4;

template <typename T, int G, bool FINAL>
__device__ void stage_cuda_cores(const T* src, T* dst,
                                 const float* __restrict__ wf,
                                 const float* __restrict__ bias,
                                 const Stage& a) {
  const int groups = a.cout / G;
  const int ax = a.axis;
  const int len = a.ddim[ax];                // outputs along the axis
  const int chunks = (len + kR - 1) / kR;    // of R outputs
  const int cd0 = ax == 0 ? chunks : a.ddim[0];
  const int cd1 = ax == 1 ? chunks : a.ddim[1];
  const int cd2 = ax == 2 ? chunks : a.ddim[2];
  const int total = cd0 * cd1 * cd2 * groups;
  const int tap = tap_stride(a);
  // item v = chunk cell * groups + channel group; each thread steps
  // kThreads items
  int cg = threadIdx.x % groups;
  const int step_cg = kThreads % groups;
  Walk wk;
  wk.init(threadIdx.x / groups, kThreads / groups, cd1, cd2);
  for (int v = threadIdx.x; v < total; v += kThreads) {
    // the chunk's first output cell (c0, c1, c2)
    const int j0 = (ax == 0 ? wk.i0 : ax == 1 ? wk.i1 : wk.i2) * kR;
    const int nj = min(kR, len - j0);
    const int c0 = ax == 0 ? j0 : wk.i0, c1 = ax == 1 ? j0 : wk.i1,
              c2 = ax == 2 ? j0 : wk.i2;
    float acc[kR][G];
#pragma unroll
    for (int jj = 0; jj < kR; ++jj)
#pragma unroll
      for (int e = 0; e < G; ++e)
        acc[jj][e] = bias != nullptr ? bias[cg * G + e] : 0.f;
    const T* sp = src + src_offset(a, c0, c1, c2);
    const int jstep = a.s * tap;
    for (int t = 0; t < a.k; ++t) {
      const T* st = sp + t * tap;
      const float* wt = wf + t * a.cin * a.cout + cg * G;
      for (int ci = 0; ci < a.cin; ++ci) {
        float w[G];
        if constexpr (G % 4 == 0) {
#pragma unroll
          for (int e = 0; e < G; e += 4) {
            const float4 wv =
                *reinterpret_cast<const float4*>(wt + ci * a.cout + e);
            w[e] = wv.x;
            w[e + 1] = wv.y;
            w[e + 2] = wv.z;
            w[e + 3] = wv.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < G; ++e) w[e] = wt[ci * a.cout + e];
        }
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          if (jj < nj) {
            const float xv = load1(st + jj * jstep + ci);
#pragma unroll
            for (int e = 0; e < G; ++e)
              acc[jj][e] = fmaf(xv, w[e], acc[jj][e]);
          }
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kR; ++jj) {
      if (jj >= nj) break;
      const int o0 = c0 + (ax == 0 ? jj : 0), o1 = c1 + (ax == 1 ? jj : 0),
                o2 = c2 + (ax == 2 ? jj : 0);
      const bool ok = inside(a, o0, o1, o2);
      if (FINAL && !ok) continue;
      T* out = dst + dst_offset<FINAL>(a, o0, o1, o2) + cg * G;
      if constexpr (G % 4 == 0) {
#pragma unroll
        for (int e = 0; e < G; e += 4)
          store4(out + e,
                 ok ? make_float4(acc[jj][e], acc[jj][e + 1], acc[jj][e + 2],
                                  acc[jj][e + 3])
                    : make_float4(0.f, 0.f, 0.f, 0.f));
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e) store1(out + e, ok ? acc[jj][e] : 0.f);
      }
    }
    cg += step_cg;
    int carry = 0;
    if (cg >= groups) { cg -= groups; carry = 1; }
    wk.advance(carry);
  }
}

// the src offset of each 8-wide K half of a tensor-core stage (tap t,
// channels c..c+7 at t * tap + c), or -1 past K: one table per stage in
// shared memory, so that the K loop does no division
__device__ void build_koff(const Stage& a, int* koff) {
  const int K = a.k * a.cin, halves = kpad_of(K) / 8;
  const int tap = tap_stride(a);
  for (int i = threadIdx.x; i < halves; i += kThreads) {
    const int kk = 8 * i, t = kk / a.cin;
    koff[i] = kk < K ? t * tap + (kk - t * a.cin) : -1;
  }
}

// NT: output-channel tiles of 8 per pass (Cout <= 8 NT, or passes of 64
// at NT = 8); MB: 16-row blocks per warp step, which share each B load
template <bool FINAL, int NT>
__device__ void stage_tensor_cores(const __nv_bfloat16* src,
                                   __nv_bfloat16* dst,
                                   const __nv_bfloat16* wt,
                                   const float* __restrict__ bias,
                                   const int* koff, const Stage& a) {
  constexpr int MB = NT >= 8 ? 1 : 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int kpad = kpad_of(a.k * a.cin), ws = kpad + 8;
  const int cells = a.ddim[0] * a.ddim[1] * a.ddim[2];
  const int msteps = (cells + 16 * MB - 1) / (16 * MB);
  const int last = cells - 1;
  const int soff_last =
      src_offset(a, last / (a.ddim[1] * a.ddim[2]),
                 (last / a.ddim[2]) % a.ddim[1], last % a.ddim[2]);
  for (int n0 = 0; n0 < a.cout; n0 += NT * 8) {
    const int nts = min(NT, (a.cout - n0) / 8);
    // this thread's bias columns n0 + 8 nt + 2q (+1), loaded once
    float bb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + nt * 8 + 2 * q;
      const bool has = bias != nullptr && nt < nts;
      bb[nt][0] = has ? bias[col] : 0.f;
      bb[nt][1] = has ? bias[col + 1] : 0.f;
    }
    // this thread's rows g and g + 8 of each of its warp's MB row blocks,
    // walked from step to step; rows past the stage's cells read the last
    // cell and are not stored
    Walk wk[MB][2];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wk[mb][h].init(min((warp * MB + mb) * 16 + g + 8 * h, last),
                       kWarps * MB * 16, a.ddim[1], a.ddim[2]);
    for (int ms = warp; ms < msteps; ms += kWarps) {
      int r[MB][2], soff[MB][2];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          r[mb][h] = (ms * MB + mb) * 16 + g + 8 * h;
          soff[mb][h] = r[mb][h] < cells
                            ? src_offset(a, wk[mb][h].i0, wk[mb][h].i1,
                                         wk[mb][h].i2)
                            : soff_last;
        }
      float acc[MB][NT][4];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mb][nt][e] = 0.f;
      for (int kb = 0; kb < kpad; kb += 16) {
        // per row block: a[0], a[1] rows g, g + 8 at K columns kb + 2q
        // (+1); a[2], a[3] the same rows at kb + 8 + 2q (+1)
        uint32_t af[MB][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int off = koff[kb / 8 + hf];
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              af[mb][2 * hf + h] =
                  off >= 0 ? *reinterpret_cast<const uint32_t*>(
                                 src + soff[mb][h] + off + 2 * q)
                           : 0u;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nts) break;
          const __nv_bfloat16* wp = wt + (n0 + nt * 8 + g) * ws + kb + 2 * q;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wp + 8);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            mma_16816(acc[mb][nt], af[mb], b0, b1);
        }
      }
      // accumulators: rows g (acc[..][..][0..1]) and g + 8 (..[2..3]),
      // columns n0 + 8 nt + 2q (+1)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (r[mb][h] >= cells) continue;
          const int i0 = wk[mb][h].i0, i1 = wk[mb][h].i1, i2 = wk[mb][h].i2;
          const bool ok = inside(a, i0, i1, i2);
          if (FINAL && !ok) continue;
          __nv_bfloat16* o =
              dst + dst_offset<FINAL>(a, i0, i1, i2) + n0 + 2 * q;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= nts) break;
            *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
                ok ? __floats2bfloat162_rn(acc[mb][nt][2 * h] + bb[nt][0],
                                           acc[mb][nt][2 * h + 1] + bb[nt][1])
                   : __floats2bfloat162_rn(0.f, 0.f);
          }
        }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        wk[mb][0].advance();
        wk[mb][1].advance();
      }
    }
  }
}

template <typename T, bool FINAL>
__device__ void run_stage(const T* src, T* dst, const void* wbuf,
                          const float* __restrict__ bias, const int* koff,
                          const Stage& a, bool mma) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mma) {
      const __nv_bfloat16* wt = static_cast<const __nv_bfloat16*>(wbuf);
      if (a.cout <= 8)
        stage_tensor_cores<FINAL, 1>(src, dst, wt, bias, koff, a);
      else if (a.cout <= 16)
        stage_tensor_cores<FINAL, 2>(src, dst, wt, bias, koff, a);
      else if (a.cout <= 32)
        stage_tensor_cores<FINAL, 4>(src, dst, wt, bias, koff, a);
      else
        stage_tensor_cores<FINAL, 8>(src, dst, wt, bias, koff, a);
      return;
    }
  }
  const float* wf = static_cast<const float*>(wbuf);
  if (a.cout % 8 == 0)
    stage_cuda_cores<T, 8, FINAL>(src, dst, wf, bias, a);
  else
    stage_cuda_cores<T, 1, FINAL>(src, dst, wf, bias, a);
}

// element strides of a dense (d0, d1, d2, c) shared tile
__device__ __forceinline__ void tile_strides(Stage& a) {
  a.dst_st[2] = a.cout;
  a.dst_st[1] = (long long)a.ddim[2] * a.cout;
  a.dst_st[0] = (long long)a.ddim[1] * a.ddim[2] * a.cout;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
separable_conv3d_kernel(const T* __restrict__ x,
                        const T* __restrict__ w0, const T* __restrict__ w1,
                        const T* __restrict__ w2,
                        const float* __restrict__ b0,
                        const float* __restrict__ b1,
                        const float* __restrict__ b2, T* __restrict__ out,
                        const Geo g) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int koff[kMaxKHalves];
  T* ra = reinterpret_cast<T*>(smem);            // input, then y2
  T* y1 = reinterpret_cast<T*>(smem + g.off_y1);
  void* wbuf = smem + g.off_w;

  int t = blockIdx.x;
  const int ow0 = (t % g.tiles_w) * g.TW;
  t /= g.tiles_w;
  const int oh0 = (t % g.tiles_h) * g.TH;
  t /= g.tiles_h;
  const int od0 = (t % g.tiles_d) * g.TD;
  const long long n = t / g.tiles_d;
  const int d_in = od0 * g.s[0] - g.p[0];
  const int h_in = oh0 * g.s[1] - g.p[1];
  const int w_in = ow0 * g.s[2] - g.p[2];

  int lead, pitch;
  load_input(x, ra, g, n, d_in, h_in, w_in, lead, pitch);
  // D stage, over input rows of `pitch` cells from `lead`: y1 cells
  // outside the volume in H or W are the H and W stages' zero padding
  Stage a{0, g.k[0], g.s[0], g.ci, g.c1,
          {g.LD, g.LH, pitch}, {g.TD, g.LH, g.LW},
          {-kBig, -h_in, -w_in}, {kBig, g.H - h_in, g.W - w_in}, {}};
  tile_strides(a);
  load_weights(w0, g.k[0], g.ci, g.c1, g.mma[0], wbuf);
  if (g.mma[0]) build_koff(a, koff);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  run_stage<T, false>(ra + lead * g.ci, y1, wbuf, b0, koff, a, g.mma[0]);
  __syncthreads();

  // H stage, into the input's space
  a = Stage{1, g.k[1], g.s[1], g.c1, g.c2,
            {g.TD, g.LH, g.LW}, {g.TD, g.TH, g.LW},
            {-kBig, -kBig, -w_in}, {kBig, kBig, g.W - w_in}, {}};
  tile_strides(a);
  load_weights(w1, g.k[1], g.c1, g.c2, g.mma[1], wbuf);
  if (g.mma[1]) build_koff(a, koff);
  __syncthreads();
  run_stage<T, false>(y1, ra, wbuf, b1, koff, a, g.mma[1]);
  __syncthreads();

  // W stage, to device memory: only the cells inside the output
  a = Stage{2, g.k[2], g.s[2], g.c2, g.c3,
            {g.TD, g.TH, g.LW}, {g.TD, g.TH, g.TW},
            {0, 0, 0}, {g.Do - od0, g.Ho - oh0, g.Wo - ow0}, {}};
  a.dst_st[2] = g.c3;
  a.dst_st[1] = (long long)g.Wo * g.c3;
  a.dst_st[0] = (long long)g.Ho * g.Wo * g.c3;
  load_weights(w2, g.k[2], g.c2, g.c3, g.mma[2], wbuf);
  if (g.mma[2]) build_koff(a, koff);
  __syncthreads();
  T* o = out + (((n * g.Do + od0) * g.Ho + oh0) * (long long)g.Wo + ow0) *
                   g.c3;
  run_stage<T, true>(ra, o, wbuf, b2, koff, a, g.mma[2]);
}

template <typename T>
static int launch(const void* x, const void* const* w,
                  const void* const* b, void* out, const Geo& g,
                  unsigned grid, cudaStream_t stream) {
  auto kern = separable_conv3d_kernel<T>;
  if (g.smem > 48 * 1024) {
    // per device, so set at every launch
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, g.smem, stream>>>(
      (const T*)x, (const T*)w[0], (const T*)w[1], (const T*)w[2],
      (const float*)b[0], (const float*)b[1], (const float*)b[2], (T*)out, g);
  return (int)cudaGetLastError();
}

}  // namespace sep
}  // namespace mri

// x: (N, D, H, W, Ci); w0, w1, w2: (Cout, Cin, k) in x's dtype, the D, H
// and W stages' weights in torch's layout; b0, b1, b2: (Cout,) f32 or null; out: (N, Do, Ho, Wo, C3) in x's
// dtype.  `geo` holds the plan's 34 ints (struct Geo).  Launches on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int mri_separable_conv3d(const void* x, const void* w0,
                                    const void* w1, const void* w2,
                                    const void* b0, const void* b1,
                                    const void* b2, void* out, int dtype,
                                    long long n, const int* geo, int ngeo,
                                    void* stream) {
  using namespace mri::sep;
  if (ngeo != kGeoInts) return (int)cudaErrorInvalidValue;
  Geo g;
  memcpy(&g, geo, sizeof g);
  const int cin[3] = {g.ci, g.c1, g.c2}, cout[3] = {g.c1, g.c2, g.c3};
  for (int i = 0; i < 3; ++i)
    if (g.mma[i] && (dtype != mri::kBFloat16 || cin[i] % 8 || cout[i] % 8 ||
                     g.k[i] * cin[i] > 8 * kMaxKHalves))
      return (int)cudaErrorInvalidValue;
  if (g.smem > kMaxSmem || g.off_y1 % 16 || g.off_w % 16 || g.TD < 1 ||
      g.TH < 1 || g.TW < 1)
    return (int)cudaErrorInvalidValue;
  const long long grid = n * g.tiles_d * g.tiles_h * g.tiles_w;
  if (grid == 0) return (int)cudaSuccess;
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const void* w[3] = {w0, w1, w2};
  const void* b[3] = {b0, b1, b2};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == mri::kFloat32)
    return launch<float>(x, w, b, out, g, (unsigned)grid, s);
  if (dtype == mri::kBFloat16)
    return launch<__nv_bfloat16>(x, w, b, out, g, (unsigned)grid, s);
  return (int)cudaErrorInvalidValue;
}
