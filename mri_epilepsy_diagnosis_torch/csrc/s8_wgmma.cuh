// The int8 implicit GEMM on Hopper shared by K1 (`conv2_packed_s8_tc.cu`)
// and K2 (`upconv_packed_s8.cu`): wgmma.mma_async m64nBNk32 s32.s8.s8
// with int32 accumulators in registers, both operands in shared memory,
// brought in by TMA through an mbarrier ring.  The skeleton of B1's
// `conv2_packed_tc.cu`, taken over to 8-bit operands and made persistent.
//
// One launch runs a list of row classes.  A class is a dense conv over
// packed cells with a small tap box:
//   out[n, so*p + r, :] = sum_{j in taps} x[n, p + j - pad, :] @ w_{tap0+j}
// per axis, x zero outside its extent, w_t the (8Co, 8Ci) K-major matrix
// of weight tap t.  K1 is one class (taps 2 x 2 x 2, so = 1, r = 0, pad 0
// or 1); K2 is the 8 output parity classes of the lhs-dilated up-conv
// (taps 2 or 3 per axis, so = 2, r in {0, 1}, pad 0).
// GEMM view: M = the rows p, K = taps x 8Ci, N = 8Co.
// - M tile: a box of bw x bh x bd <= 128 rows of one batch item (B1's
//   box: `ops/cuda_kernels.py::conv2_tc_plan`), the same for every class
//   of a launch; rows past a class's grid are computed and never stored,
//   rows past the box stay zero in shared memory.  Its rows are the 128
//   rows of two 64-row wgmma halves, one per consumer warpgroup.
// - K step: KB bytes (one swizzled row) of one tap: 128 channels with the
//   128-byte swizzle where 8Ci % 128 == 0, else 64 with the 64-byte
//   swizzle (8Ci = 64, e0c2).  The A tile of a step is ONE TMA load of x
//   viewed as 5-D (8Ci, Wi, Hi, Di, N), uint8, box {KB, bw, bh, bd, 1}
//   at the box origin + tap - pad.  TMA fills what lies outside x with
//   zero bytes, int8 zero, so the pad-1 halo and the ragged edges need no
//   masks.  The B tile is a 2-D TMA load {KB, BN} of the weights viewed
//   as (taps x 8Co, 8Ci) at row (tap0 + tap) x 8Co + n0.  Both operands
//   are K-major, the only layout 8-bit wgmma takes (no transpose bit, no
//   immediate scales for integer types).
// - N tile: BN = the whole 8Co up to 256 (two tiles at 8Co = 512), so
//   each A tile is loaded once for all output channels.
// - Pipeline: a ring of (A, B) stages in ~192 KB of dynamic shared
//   memory, each stage with a full and an empty mbarrier.  One thread of
//   the producer warpgroup starts the TMA loads; two consumer warpgroups
//   issue the wgmmas of a stage, keep one wgmma group in flight and
//   release a stage once its group is done.  setmaxnreg moves registers
//   from the producer (40) to the consumers (232): m64n256 s32
//   accumulators take 128 registers a thread.
// - Persistent: one block per SM walks the work items (class, batch item,
//   box, N tile) with a stride of the grid.  Items are numbered class by
//   class in the order the host lists the classes (K2: heaviest first),
//   so the light classes fill the tail; the producer runs ahead into the
//   next item's stages while the consumers store the last one.
// - Store: each thread holds rows r and r + 8 of its warp's 16 and column
//   pairs 8j + 2 (lane % 4) of every 8-column group j.  int32 output: a
//   shuffle with the neighbouring lane gives each thread 4 consecutive
//   values, one 16-byte store.  int8 output (K1 fused): JAX's epilogue
//   (`common.cuh::s8_requant`) without a branch, the per-column vectors
//   and the addend of 4 groups loaded ahead of their math, then a 4 x 4
//   transpose of 32-bit words across the lane quad gives each thread 16
//   consecutive bytes of a 64-column chunk, one 16-byte store.  A launch
//   with the float32 addend (the decoder's first convs) asks L2 for a
//   tile's addend rows when its mainloop starts, so that the epilogue
//   does not wait on device memory.
//
// Bound on the H100: operations (1,979 TOP/s dense int8) at every site it
// serves: K = taps x 8Ci >= 512 products per output value read from
// shared memory.  A stage carries 170 (BN = 256) or 128 (BN = 128)
// operations per byte it brings from L2, so near the peak the L2 feed,
// more than the tensor cores, is the likely limit; sharing the B tile
// across a cluster by TMA multicast would halve the weights' part.
// Profiler names: `conv2_packed_s8_tc_kernel` (K1),
// `upconv_packed_s8_kernel` (K2).
#pragma once

#include "common.cuh"
#include "hopper_tma.cuh"

namespace mri {
namespace tc {

constexpr int kS8Rows = 128;          // rows per tile
constexpr int kS8RingBytes = 192 * 1024;

template <int BN, int KB>
struct S8Cfg {
  static constexpr int kABytes = kS8Rows * KB;
  static constexpr int kStageBytes = kABytes + BN * KB;
  static constexpr int kStages =
      kS8RingBytes / kStageBytes < 8 ? kS8RingBytes / kStageBytes : 8;
  // ring + 1 KB to align it to the swizzle's period + the barriers
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 16 * kStages;
};

// one class of rows: a dense conv of a tap box over the input
struct S8Class {
  int Pd, Ph, Pw;                 // row grid per batch item
  int td, th, tw;                 // taps per axis: t = (jd th + jh) tw + jw
  int tap0;                       // the class's first weight tap
  int rd, rh, rw;                 // output cell = so p + r per axis
  int tiles_w, tiles_h, tiles_d;  // boxes along each axis
  int item0;                      // the class's first work item
};

struct S8Launch {
  int bw, bh, bd;                 // box of rows, bw bh bd <= 128
  int tiles_n;                    // 8Co / BN
  int C8i, C8o, pad, so;
  int Do, Ho, Wo;                 // output extent
  int nclasses, items;
  S8Class cls[8];                 // in work order
};

// K1's fused epilogue: packed (8Co,) float32 vectors (bias, alpha may be
// null) and a float32 addend shaped like the output, or null
struct S8Epi {
  const float* dq;
  const float* bias;
  const float* alpha;
  const float* rq;
  const float* addend;
};

struct S8Tile {
  int c;                          // class, an index into cls
  int nb, z0, y0, x0;             // batch item, box origin on the row grid
  int n0;                         // first output channel
};

// work item -> tile: classes in list order; within a class the N tile
// varies fastest (the N tiles of one box run together and share its A
// loads in L2), then the box along W, H, D, then the batch item
__device__ __forceinline__ S8Tile s8_tile(const S8Launch& L, int item,
                                          int bn) {
  S8Tile T;
  int c = 0;
  while (c + 1 < L.nclasses && item >= L.cls[c + 1].item0) ++c;
  const S8Class& k = L.cls[c];
  int t = item - k.item0;
  T.c = c;
  T.n0 = (t % L.tiles_n) * bn;
  t /= L.tiles_n;
  T.x0 = (t % k.tiles_w) * L.bw;
  t /= k.tiles_w;
  T.y0 = (t % k.tiles_h) * L.bh;
  t /= k.tiles_h;
  T.z0 = (t % k.tiles_d) * L.bd;
  T.nb = t / k.tiles_d;
  return T;
}

template <int KB>
__device__ __forceinline__ uint64_t s8_desc(uint32_t addr) {
  return KB == 128 ? sw128_desc(addr) : sw64_desc(addr);
}

// d[64 x BN] += A[64 x 32] B[32 x BN], int8, both K-major in shared
// memory, int32 accumulators in the wgmma fragment layout (BN / 2 per
// thread).  Integer wgmma takes no immediate scales and no transpose.
template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Tile row r (0..127): whether it is stored (inside the box and the
// class grid), its output cell and the output offset of its column n0.
__device__ __forceinline__ bool s8_row(const S8Launch& L, const S8Class& k,
                                       const S8Tile& T, int r, int& oz,
                                       int& oy, int& ox, long long& base) {
  const int px = T.x0 + r % L.bw;
  const int py = T.y0 + (r / L.bw) % L.bh;
  const int pz = T.z0 + r / (L.bw * L.bh);
  ox = L.so * px + k.rw;
  oy = L.so * py + k.rh;
  oz = L.so * pz + k.rd;
  const bool ok = r < L.bw * L.bh * L.bd && px < k.Pw && py < k.Ph &&
                  pz < k.Pd;
  base = ok ? ((((long long)T.nb * L.Do + oz) * L.Ho + oy) * L.Wo + ox) *
                      L.C8o + T.n0
            : 0;
  return ok;
}

__device__ __forceinline__ uint32_t quad_pick(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// The store of one 64-row half of a tile, rows [row0, row0 + 64).
// Thread (warp, lane) of its warpgroup holds rows row0 + warp*16 + lane/4
// + 8h (h = 0, 1) and, of every 8-column group j, columns 8j + 2t + e
// (t = lane % 4, e = 0, 1) in acc[4j + 2h + e].
template <int BN, bool FUSED>
__device__ __forceinline__ void s8_store(int (&acc)[BN / 2],
                                         const S8Launch& L, const S8Class& k,
                                         const S8Tile& T, int row0, int warp,
                                         int lane, void* __restrict__ out,
                                         const S8Epi& epi) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int t = lane & 3;
  bool ok[2];
  long long base[2];        // output offset of the row's column n0
  unsigned drop[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int oz, oy, ox;
    ok[h] = s8_row(L, k, T, row0 + warp * 16 + lane / 4 + 8 * h, oz, oy, ox,
                   base[h]);
    drop[h] = FUSED && ok[h] && L.pad == 1
                  ? shifted_drop(oz, oy, ox, L.Do, L.Ho, L.Wo)
                  : 0u;
  }
  if constexpr (!FUSED) {
    // int32: groups j and j + 1; an even lane keeps its pair of group j
    // and takes its odd neighbour's, an odd lane the same for group j + 1
    int* o = static_cast<int*>(out);
    const bool odd = t & 1;
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        const int b0 = acc[4 * j + 4 + 2 * h], b1 = acc[4 * j + 5 + 2 * h];
        const int r0 = __shfl_xor_sync(kAll, odd ? a0 : b0, 1);
        const int r1 = __shfl_xor_sync(kAll, odd ? a1 : b1, 1);
        if (!ok[h]) continue;
        if (odd)
          *reinterpret_cast<int4*>(o + base[h] + 8 * (j + 1) + 2 * (t - 1)) =
              make_int4(r0, r1, b0, b1);
        else
          *reinterpret_cast<int4*>(o + base[h] + 8 * j + 2 * t) =
              make_int4(a0, a1, r0, r1);
      }
    }
  } else {
    // JAX's `_epilogue` (`s8_requant`, branch-free) per 64-column chunk,
    // in halves of 4 groups: every load of a half (the columns' vectors,
    // once for both rows; the addend, one float2 per thread, group and
    // row, a quad reading 32 contiguous bytes) is issued before its math;
    // then a transpose of the int8 results across the lane quad and one
    // 16-byte store per row
    int8_t* o = static_cast<int8_t*>(out);
    const bool has_add = epi.addend != nullptr, has_bias = epi.bias != nullptr,
               has_alpha = epi.alpha != nullptr;
    // bit j: group j of the tile lies in a packed sub that is a pad voxel
    // of the row (only rows on a face of a shifted output have one; 8Co /
    // 8 is a multiple of 8, so a group never straddles two subs)
    uint32_t dmask[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (drop[h] == 0u) continue;
      const int groups_per_sub = L.C8o >> 6;
#pragma unroll 1
      for (int j = 0; j < BN / 8; ++j)
        dmask[h] |= ((drop[h] >> ((T.n0 / 8 + j) / groups_per_sub)) & 1u)
                    << j;
    }
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += 8) {
      // m[h][jj]: the int8 pair of row h in group j0 + jj, bytes 0 and 1
      uint32_t m[2][8];
#pragma unroll
      for (int jq = 0; jq < 8; jq += 4) {
        float2 dq[4], rq[4], bs[4], al[4], ad[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = T.n0 + 8 * (j0 + jq + q) + 2 * t;
          dq[q] = __ldg(reinterpret_cast<const float2*>(epi.dq + c));
          rq[q] = __ldg(reinterpret_cast<const float2*>(epi.rq + c));
          bs[q] = has_bias ? __ldg(reinterpret_cast<const float2*>(
                                 epi.bias + c))
                           : make_float2(0.f, 0.f);
          al[q] = has_alpha ? __ldg(reinterpret_cast<const float2*>(
                                  epi.alpha + c))
                            : make_float2(1.f, 1.f);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ad[h][q] = has_add && ok[h]
                           ? __ldg(reinterpret_cast<const float2*>(
                                 epi.addend + base[h] + 8 * (j0 + jq + q) +
                                 2 * t))
                           : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + jq + q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool d = (dmask[h] >> j) & 1u;
            const uint32_t q0 =
                s8_requant(acc[4 * j + 2 * h], dq[q].x, ad[h][q].x, bs[q].x,
                           al[q].x, d, rq[q].x);
            const uint32_t q1 =
                s8_requant(acc[4 * j + 2 * h + 1], dq[q].y, ad[h][q].y,
                           bs[q].y, al[q].y, d, rq[q].y);
            m[h][jq + q] = __byte_perm(q0, q1, 0x0040);
          }
        }
      }
      // word k of lane s holds groups j0 + 2k, j0 + 2k + 1 (2 bytes each,
      // columns 2s, 2s + 1); after the transpose lane t holds word t of
      // every lane s of its quad: groups j0 + 2t and j0 + 2t + 1 whole
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4], y[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          y[k] = w[k] = __byte_perm(m[h][2 * k], m[h][2 * k + 1], 0x5410);
#pragma unroll
        for (int rr = 1; rr < 4; ++rr) {
          const int src = (t + rr) & 3;
          const uint32_t got = __shfl_sync(kAll, quad_pick(w, (t - rr) & 3),
                                           (lane & ~3) | src);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k == src) y[k] = got;
        }
        if (!ok[h]) continue;
        const uint4 val = make_uint4(__byte_perm(y[0], y[1], 0x5410),
                                     __byte_perm(y[2], y[3], 0x5410),
                                     __byte_perm(y[0], y[1], 0x7632),
                                     __byte_perm(y[2], y[3], 0x7632));
        *reinterpret_cast<uint4*>(o + base[h] + 8 * j0 + 16 * t) = val;
      }
    }
  }
}

// The kernel's body; the two kernels below give K1 and K2 names of their
// own in a profile.  The tensor maps and the plan are the kernels'
// __grid_constant__ parameters, read in place.
template <int BN, int KB, bool FUSED>
__device__ __forceinline__ void s8_igemm_tc(const CUtensorMap& xmap,
                                            const CUtensorMap& wmap,
                                            void* __restrict__ out,
                                            const S8Launch& L,
                                            const S8Epi& epi) {
  using C = S8Cfg<BN, KB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_ptr +
                                               C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  const int box_rows = L.bw * L.bh * L.bd;
  const int kslices = L.C8i / KB;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (box_rows < kS8Rows) {
    // rows that no box fills are read by wgmma: keep them zero (TMA only
    // ever writes the first box_rows rows of a stage)
    const int tail = (kS8Rows - box_rows) * KB / 16;
    for (int i = tid; i < C::kStages * tail; i += kThreads) {
      const int s = i / tail, j = i % tail;
      *reinterpret_cast<uint4*>(ring_ptr + s * C::kStageBytes +
                                box_rows * KB + j * 16) =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread starts every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      const uint32_t tx_bytes = (box_rows + BN) * KB;
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < L.items; item += gridDim.x) {
        const S8Tile T = s8_tile(L, item, BN);
        const S8Class& k = L.cls[T.c];
        const int x0 = T.x0 - L.pad, y0 = T.y0 - L.pad, z0 = T.z0 - L.pad;
        int slice = 0, jw = 0, jh = 0, jd = 0;
        int wrow = k.tap0 * L.C8o + T.n0;
        const int steps = k.td * k.th * k.tw * kslices;
        for (int s = 0; s < steps; ++s) {
          const uint32_t a = ring + stage * C::kStageBytes;
          const uint32_t fb = smem_addr(&full[stage]);
          mbar_wait(smem_addr(&empty[stage]), phase ^ 1);
          mbar_expect_tx(fb, tx_bytes);
          tma_load_5d(a, &xmap, fb, slice * KB, x0 + jw, y0 + jh, z0 + jd,
                      T.nb);
          tma_load_2d(a + C::kABytes, &wmap, fb, slice * KB, wrow);
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
          if (++slice == kslices) {
            slice = 0;
            wrow += L.C8o;
            if (++jw == k.tw) {
              jw = 0;
              if (++jh == k.th) {
                jh = 0;
                ++jd;
              }
            }
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    int acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < L.items; item += gridDim.x) {
      const S8Tile T = s8_tile(L, item, BN);
      const S8Class& k = L.cls[T.c];
      const int steps = k.td * k.th * k.tw * kslices;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      if (FUSED && epi.addend != nullptr) {
        // the epilogue reads the addend of the thread's two rows from
        // device memory: start bringing it into L2 now, lane t of a quad
        // every fourth 128-byte line of a row's BN floats
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int oz, oy, ox;
          long long row_base;
          if (s8_row(L, k, T, wg * 64 + warp * 16 + lane / 4 + 8 * h, oz,
                     oy, ox, row_base))
#pragma unroll
            for (int l = lane & 3; l < BN / 32; l += 4)
              asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                  epi.addend + row_base + 32 * l));
        }
      }
      int prev = -1;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(smem_addr(&full[stage]), phase);
        const uint32_t a = ring + stage * C::kStageBytes + wg * 64 * KB;
        const uint32_t b = ring + stage * C::kStageBytes + C::kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)
          wgmma_s8<BN>(acc, s8_desc<KB>(a + kk * 32), s8_desc<KB>(b + kk * 32));
        wgmma_commit();
        // the previous step's group is done: release its stage
        wgmma_wait<1>();
        if (prev >= 0 && tid % 128 == 0) mbar_arrive(smem_addr(&empty[prev]));
        prev = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      // every stage of this tile is read: the producer may refill the
      // last one while this tile is stored
      if (tid % 128 == 0) mbar_arrive(smem_addr(&empty[prev]));
      s8_store<BN, FUSED>(acc, L, k, T, wg * 64, warp, lane, out, epi);
    }
  }
}

// K1's wgmma route (`conv2_packed_s8_tc.cu`)
template <int BN, int KB, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
conv2_packed_s8_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          void* __restrict__ out,
                          const __grid_constant__ S8Launch L,
                          const S8Epi epi) {
  s8_igemm_tc<BN, KB, FUSED>(xmap, wmap, out, L, epi);
}

// K2 (`upconv_packed_s8.cu`): int32 sums only
template <int BN, int KB>
__global__ void __launch_bounds__(kThreads, 1)
upconv_packed_s8_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        int* __restrict__ out,
                        const __grid_constant__ S8Launch L) {
  s8_igemm_tc<BN, KB, false>(xmap, wmap, out, L, S8Epi{});
}

// The tensor maps of one launch: x (n, di, hi, wi, c8i) int8 as 5-D
// uint8 with box {kb, bw, bh, bd, 1}, and the K-major weights (wrows,
// c8i) int8 with box {kb, bn}, both with the kb-byte swizzle.
static int s8_tensor_maps(CUtensorMap* xm, CUtensorMap* wm, const void* x,
                          long long n, int di, int hi, int wi, int c8i,
                          int bw, int bh, int bd, const void* w, int wrows,
                          int bn, int kb) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const CUtensorMapSwizzle swz =
      kb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t xdims[5] = {(cuuint64_t)c8i, (cuuint64_t)wi,
                               (cuuint64_t)hi, (cuuint64_t)di,
                               (cuuint64_t)n};
  const cuuint64_t xstrides[4] = {(cuuint64_t)c8i, (cuuint64_t)wi * c8i,
                                  (cuuint64_t)hi * wi * c8i,
                                  (cuuint64_t)di * hi * wi * c8i};
  const cuuint32_t xbox[5] = {(cuuint32_t)kb, (cuuint32_t)bw,
                              (cuuint32_t)bh, (cuuint32_t)bd, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if (encode(xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x),
             xdims, xstrides, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;
  const cuuint64_t wdims[2] = {(cuuint64_t)c8i, (cuuint64_t)wrows};
  const cuuint64_t wstrides[1] = {(cuuint64_t)c8i};
  const cuuint32_t wbox[2] = {(cuuint32_t)kb, (cuuint32_t)bn};
  if (encode(wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
             wdims, wstrides, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;
  return 0;
}

// Fill in the box and N tiles of L (classes filled in by the caller, in
// work order, with their row grids) and check the plan: every class's
// tiles and first item, the item count.
static int s8_plan(S8Launch& L, long long n, int bw, int bh, int bd,
                   int bn, int kb) {
  if ((kb != 64 && kb != 128) || L.C8i % kb ||
      (bn != 64 && bn != 128 && bn != 256) || L.C8o % bn || bw < 1 ||
      bh < 1 || bd < 1 || bw * bh * bd > kS8Rows || L.nclasses < 1 ||
      L.nclasses > 8)
    return kErrPlan;
  L.bw = bw;
  L.bh = bh;
  L.bd = bd;
  L.tiles_n = L.C8o / bn;
  long long items = 0;
  for (int c = 0; c < L.nclasses; ++c) {
    S8Class& k = L.cls[c];
    k.tiles_w = (k.Pw + bw - 1) / bw;
    k.tiles_h = (k.Ph + bh - 1) / bh;
    k.tiles_d = (k.Pd + bd - 1) / bd;
    k.item0 = (int)items;
    items += n * k.tiles_w * k.tiles_h * (long long)k.tiles_d * L.tiles_n;
    if (items >= (1LL << 31)) return kErrPlan;
  }
  L.items = (int)items;
  return 0;
}

template <int BN, int KB, bool FUSED, bool UP>
static int s8_launch_bk(const CUtensorMap& xm, const CUtensorMap& wm,
                        void* out, const S8Launch& L, const S8Epi& epi,
                        cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // persistent: one block an SM (the ring fills its shared memory)
  const int grid = L.items < sms ? L.items : sms;
  constexpr int smem = S8Cfg<BN, KB>::kSmem;
  static bool regs_checked = false;
  if constexpr (UP) {
    auto kernel = upconv_packed_s8_kernel<BN, KB>;
    const int rc = prepare_launch(kernel, smem, regs_checked);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, smem, stream>>>(xm, wm, static_cast<int*>(out),
                                             L);
  } else {
    auto kernel = conv2_packed_s8_tc_kernel<BN, KB, FUSED>;
    const int rc = prepare_launch(kernel, smem, regs_checked);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, smem, stream>>>(xm, wm, out, L, epi);
  }
  return (int)cudaGetLastError();
}

// One launch of the plan L (s8_plan) with N tile bn and K step kb: K2's
// kernel (UP, int32 sums) or K1's (FUSED: the epilogue to int8).
template <bool FUSED, bool UP>
static int s8_launch(const CUtensorMap& xm, const CUtensorMap& wm, void* out,
                     const S8Launch& L, const S8Epi& epi, int bn, int kb,
                     cudaStream_t s) {
  if (L.items == 0) return (int)cudaSuccess;
  if (kb == 128) {
    if (bn == 256)
      return s8_launch_bk<256, 128, FUSED, UP>(xm, wm, out, L, epi, s);
    if (bn == 128)
      return s8_launch_bk<128, 128, FUSED, UP>(xm, wm, out, L, epi, s);
    return s8_launch_bk<64, 128, FUSED, UP>(xm, wm, out, L, epi, s);
  }
  if (bn == 256) return s8_launch_bk<256, 64, FUSED, UP>(xm, wm, out, L, epi, s);
  if (bn == 128) return s8_launch_bk<128, 64, FUSED, UP>(xm, wm, out, L, epi, s);
  return s8_launch_bk<64, 64, FUSED, UP>(xm, wm, out, L, epi, s);
}

}  // namespace tc
}  // namespace mri
