// K1's mma.sync route (`conv2_packed_s8.cu`): the int8 implicit GEMM of
// the k=2 packed conv where the wgmma route (`s8_wgmma.cuh`) does not
// apply, the 8Ci = 8 stem of the served UNet above all: int8 x int8 ->
// int32 on the tensor cores with mma.sync.aligned.m16n8k32.row.col.s32.s8
// .s8.s32, over tiles staged in shared memory.
//
// One launch is a dense conv over packed cells with a 2 x 2 x 2 tap box:
//   out[n, p, :] = sum_{j in taps} x[n, p + j - pad, :] @ w_j
// per axis, x zero outside its extent, w_j the (8Ci, 8Co) matrix of tap j.
// GEMM view: M = the rows p (N x Do x Ho x Wo cells), K = 8 taps x 8Ci
// (k = tap * 8Ci + ci, tap = (jd * th + jh) * tw + jw), N = 8Co.  The
// weights arrive K-major, (8Co, K) row-major, so that each column of the
// B operand is contiguous.
//
// Tile: 128 rows x 64 columns per block of 256 threads (8 warps of 32 x
// 32, 2 x 4 MMAs of m16n8k32 per 32-byte K step).  Each K step stages the
// block's 128 x 32 bytes of A and 64 x 32 bytes of B in shared memory in
// 8-byte groups (8Ci % 8 == 0, so a group never straddles a tap: the
// 8Ci = 8 stem packs 4 taps into one step); the next step's global loads
// go into registers while the MMAs of this one run (two buffers, one
// barrier a step).  Rows are 48 bytes apart in shared memory, which makes
// the fragment reads free of bank conflicts.  The stem's K is 64, so its
// bound is bytes, and this simple kernel serves it.
#pragma once

#include "common.cuh"

namespace mri {
namespace s8 {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kStride = 48;  // bytes between staged rows (32 used)

// where the rows of one launch read and write
struct Geometry {
  long long M;           // rows: N * Pd * Ph * Pw
  int Pd, Ph, Pw;        // row grid per item: the output extent
  int Di, Hi, Wi, C8i;   // input extent
  int td, th, tw;        // taps per axis
  int pad;               // input coordinate = p + j - pad
  int K;                 // td * th * tw * C8i
  int C8o;
  const int8_t* w;       // (C8o, K) row-major
};

// a row's item base offset and cell, decoded once per thread
struct Row {
  long long base;        // n * Di * Hi * Wi * C8i
  long long out;         // output cell index: the row m itself
  int pz, py, px;
  bool ok;
};

__device__ __forceinline__ Row decode_row(const Geometry& g, long long m) {
  Row r;
  r.ok = m < g.M;
  if (!r.ok) m = 0;
  long long t = m;
  r.px = (int)(t % g.Pw); t /= g.Pw;
  r.py = (int)(t % g.Ph); t /= g.Ph;
  r.pz = (int)(t % g.Pd);
  const long long n = t / g.Pd;
  r.base = n * g.Di * g.Hi * (long long)g.Wi * g.C8i;
  r.out = m;
  return r;
}

// 8 bytes of A: row r, K entries [k, k + 8) (one tap, 8 channels)
__device__ __forceinline__ uint2 load_a(const int8_t* __restrict__ x,
                                        const Geometry& g, const Row& r,
                                        int k) {
  if (!r.ok || k >= g.K) return make_uint2(0u, 0u);
  const int tap = k / g.C8i, ci = k - tap * g.C8i;
  const int jw = tap % g.tw, t2 = tap / g.tw;
  const int jh = t2 % g.th, jd = t2 / g.th;
  const int iz = r.pz + jd - g.pad, iy = r.py + jh - g.pad,
            ix = r.px + jw - g.pad;
  if (iz < 0 || iz >= g.Di || iy < 0 || iy >= g.Hi || ix < 0 || ix >= g.Wi)
    return make_uint2(0u, 0u);
  const long long off =
      r.base + (((long long)iz * g.Hi + iy) * g.Wi + ix) * g.C8i + ci;
  return __ldg(reinterpret_cast<const uint2*>(x + off));
}

// 8 bytes of B: output channel co, K entries [k, k + 8)
__device__ __forceinline__ uint2 load_b(const Geometry& g, int co, int k) {
  if (co >= g.C8o || k >= g.K) return make_uint2(0u, 0u);
  return __ldg(reinterpret_cast<const uint2*>(g.w + (long long)co * g.K + k));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's 128 x 64 int32 tile at rows [m0, m0 + 128) and columns
// [n0, n0 + 64).  acc[mi][ni][e] holds row wm*32 + mi*16 + gid + 8*(e>>1)
// and column wn*32 + ni*8 + tig*2 + (e&1) of the tile, where warp =
// wm + 4 wn, gid = lane / 4, tig = lane % 4 (the m16n8 C fragment).
__device__ __forceinline__ void mainloop(const int8_t* __restrict__ x,
                                         const Geometry& g, long long m0,
                                         int n0, int (&acc)[2][4][4]) {
  __shared__ __align__(16) int8_t As[2][kBM][kStride];
  __shared__ __align__(16) int8_t Bs[2][kBN][kStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  // this thread's staging: A rows ar and ar + 64, B column bc, 8-byte
  // group grp of the 32-byte K step
  const int ar = tid >> 2, grp = tid & 3, bc = tid >> 2;
  const Row r0 = decode_row(g, m0 + ar);
  const Row r1 = decode_row(g, m0 + ar + 64);

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int steps = (g.K + kBK - 1) / kBK;
  uint2 a0 = load_a(x, g, r0, grp * 8);
  uint2 a1 = load_a(x, g, r1, grp * 8);
  uint2 b = load_b(g, n0 + bc, grp * 8);
  *reinterpret_cast<uint2*>(&As[0][ar][grp * 8]) = a0;
  *reinterpret_cast<uint2*>(&As[0][ar + 64][grp * 8]) = a1;
  *reinterpret_cast<uint2*>(&Bs[0][bc][grp * 8]) = b;
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < steps;
    if (more) {
      const int k = (s + 1) * kBK + grp * 8;
      a0 = load_a(x, g, r0, k);
      a1 = load_a(x, g, r1, k);
      b = load_b(g, n0 + bc, k);
    }
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = wm * 32 + mi * 16 + gid;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[buf][row][tig * 4]);
      af[mi][1] =
          *reinterpret_cast<const uint32_t*>(&As[buf][row + 8][tig * 4]);
      af[mi][2] =
          *reinterpret_cast<const uint32_t*>(&As[buf][row][16 + tig * 4]);
      af[mi][3] =
          *reinterpret_cast<const uint32_t*>(&As[buf][row + 8][16 + tig * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn * 32 + ni * 8 + gid;
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(&Bs[buf][col][tig * 4]);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(&Bs[buf][col][16 + tig * 4]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);
    }
    if (more) {
      *reinterpret_cast<uint2*>(&As[buf ^ 1][ar][grp * 8]) = a0;
      *reinterpret_cast<uint2*>(&As[buf ^ 1][ar + 64][grp * 8]) = a1;
      *reinterpret_cast<uint2*>(&Bs[buf ^ 1][bc][grp * 8]) = b;
    }
    __syncthreads();
  }
}

// the tile-relative row and column of accumulator entry (mi, ni, e)
__device__ __forceinline__ int acc_row(int mi, int e) {
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) & 3;
  return wm * 32 + mi * 16 + (lane >> 2) + 8 * (e >> 1);
}

__device__ __forceinline__ int acc_col(int ni, int e) {
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 7;
  return wn * 32 + ni * 8 + (lane & 3) * 2 + (e & 1);
}

}  // namespace s8
}  // namespace mri
