// B1 on Hopper tensor cores: the k=2 packed convolution of the packed
// UNet3D as an implicit GEMM with wgmma, fed by TMA through a ring of
// shared-memory stages.
//
// Replaces: mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py
//   `conv2_packed_pallas` (Pallas kernel `_conv2_tap_kernel`) for bfloat16
//   inputs with 8Ci % 64 == 0 and 8Co % 64 == 0.  conv2_packed.cu serves
//   the other calls (float32, and the 8Ci = 8 stem); the Python wrapper
//   `ops/cuda_kernels.py::conv2_packed` picks one from dtype and shape.
//
// What it computes (the same function as conv2_packed.cu), for pad in {0,1}:
//   out[n,z,y,x,:] = bias + sum_{qd,qh,qw in {0,1}}
//                    xin[n, z+qd-pad, y+qh-pad, x+qw-pad, :] @ w[qd,qh,qw]
// with xin zero outside its extent, the sum and the bias in float32, and
// one rounding to bfloat16 at the store.
//
// GEMM view: M = output cells, K = 8 taps x 8Ci, N = 8Co.
// - M tile: a box of bw x bh x bd <= 128 output cells of one batch item,
//   chosen by the wrapper to need the fewest tiles at the output's extent
//   (97, 49 and 25 at the aligned->shifted sites are no multiples of a
//   power of two).  Its cells are the 128 rows of two 64-row wgmma halves;
//   rows past the box stay zero in shared memory and are never stored.
// - K step: 64 input channels (one 128-byte row) of one tap.  The A tile
//   of a step is ONE TMA tiled load of x viewed as 5-D (8Ci, Wi, Hi, Di,
//   N) with box {64, bw, bh, bd, 1} at the box origin + (qw, qh, qd) - pad.
//   TMA fills what lies outside x with zeros, negative coordinates
//   included, so the pad-1 halo and the ragged edge need no masks and no
//   padded copy.  It writes 128-byte rows with the 128-byte swizzle, the
//   K-major layout that a wgmma shared-memory descriptor reads (8-row
//   groups 1024 bytes apart).
// - B: the wrapper lays w out K-major as (8 taps, 8Co, 8Ci); a 2-D TMA
//   load brings the {64, BN} slice of a step.  Both operands are K-major:
//   the plain "TN" wgmma.
// - Pipeline: kStages (A, B) buffers, each with a full and an empty
//   mbarrier.  One thread of the producer warpgroup starts the TMA loads;
//   two consumer warpgroups run m64nBNk16 wgmmas on their 64 rows, keep
//   one wgmma group in flight and release a stage once its group is done.
//   setmaxnreg moves registers from the producer warpgroup (40) to the
//   consumers (232).
// - Epilogue: f32 bias, one rounding to bf16, guarded st.global of the
//   cells that lie inside the output.  The EPI instantiation instead
//   applies B2 (`bn_act_zero_pads`, pallas_kernels.py:197) to the f32
//   accumulators of an aligned->shifted (pad = 1) launch: an optional bf16
//   addend (the decoder's skip half) added in f32, then x * scale + shift,
//   PReLU and the shifted pad mask, with one rounding at the store.  The
//   mask is index arithmetic on the output cell and the channel's packed
//   sub-position (sub = channel / (8Co / 8), bit 2 for D, 1 for H, 0 for
//   W): on the last cell of an axis a sub with the bit set is a pad voxel,
//   on the first cell one with the bit clear (`ops/cuda_kernels.py::
//   shifted_pad_keep`).  So B2 costs no pass of its own over the
//   shifted tensor, and the decoder's two partial sums meet in registers.
//
// Bound on the H100: operations (989 TFLOP/s dense bf16) at every site it
// serves: K = 8 x 8Ci >= 512 products per output value read from shared
// memory.  A tile is not persistent: its pipeline fill and its epilogue do
// not overlap another tile's (a persistent scheduler is later work).
//
// A wait on an mbarrier that outlasts ~2^35 cycles (over 10 s) traps, so
// a pipeline fault ends the launch with an error instead of hanging the
// card.  The mbarrier, TMA and wgmma helpers are shared with K1 and K2
// (`hopper_tma.cuh`).
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper_tma.cuh"

namespace mri {
namespace tc {

constexpr int kBM = 128;                 // output cells per tile
constexpr int kBK = 64;                  // channels per K step
constexpr int kRowBytes = kBK * 2;       // one swizzled 128-byte row
constexpr int kABytes = kBM * kRowBytes; // 16 KB
constexpr int kRingBytes = 192 * 1024;

template <int BN>
struct Cfg {
  static constexpr int kStageBytes = kABytes + BN * kRowBytes;
  static constexpr int kStages =
      kRingBytes / kStageBytes < 8 ? kRingBytes / kStageBytes : 8;
  // ring + 1 KB to align it to the 128-byte swizzle's 1024-byte period +
  // the full and empty barriers
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 16 * kStages;
};

struct Plan {
  int bw, bh, bd;                 // box of output cells, bw*bh*bd <= 128
  int tiles_w, tiles_h, tiles_d;  // boxes along each axis
  int tiles_n;                    // 8Co / BN
  int Do, Ho, Wo, C8i, C8o, pad;
};

// B2's parameters for the EPI instantiation: packed (8Co,) f32 vectors
// and an optional bf16 addend shaped like the output
struct Epi {
  const float* scale;
  const float* shift;
  const float* alpha;
  const __nv_bfloat16* addend;
};

// d[64 x BN] += A[64 x 16] B[16 x BN], both K-major in shared memory, f32
// accumulators in the wgmma fragment layout (BN / 2 per thread).
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float* d, uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
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
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN, bool EPI>
__global__ void __launch_bounds__(kThreads, 1)
conv2_packed_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, const Plan p,
                       const Epi epi) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_ptr +
                                               C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;

  // this block's tile: the N tile varies fastest, so that the N tiles of
  // one M tile run together and share its A loads in L2
  int t = blockIdx.x;
  const int n0 = (t % p.tiles_n) * BN;
  t /= p.tiles_n;
  const int ow0 = (t % p.tiles_w) * p.bw;
  t /= p.tiles_w;
  const int oh0 = (t % p.tiles_h) * p.bh;
  t /= p.tiles_h;
  const int od0 = (t % p.tiles_d) * p.bd;
  const int nb = t / p.tiles_d;
  const int box_rows = p.bw * p.bh * p.bd;
  const int kslices = p.C8i / kBK;
  const int steps = 8 * kslices;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (box_rows < kBM) {
    // rows that no box fills are read by wgmma: keep them zero
    const int tail = (kBM - box_rows) * kRowBytes / 16;
    for (int i = tid; i < C::kStages * tail; i += kThreads) {
      const int s = i / tail, j = i % tail;
      *reinterpret_cast<uint4*>(ring_ptr + s * C::kStageBytes +
                                box_rows * kRowBytes + j * 16) =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread starts every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      const uint32_t tx_bytes = (box_rows + BN) * kRowBytes;
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0; k < steps; ++k) {
        const int tap = k / kslices, c0 = (k % kslices) * kBK;
        const int qd = tap >> 2, qh = (tap >> 1) & 1, qw = tap & 1;
        const uint32_t a = ring + stage * C::kStageBytes;
        const uint32_t fb = smem_addr(&full[stage]);
        mbar_wait(smem_addr(&empty[stage]), phase ^ 1);
        mbar_expect_tx(fb, tx_bytes);
        tma_load_5d(a, &xmap, fb, c0, ow0 + qw - p.pad, oh0 + qh - p.pad,
                    od0 + qd - p.pad, nb);
        tma_load_2d(a + kABytes, &wmap, fb, c0, tap * p.C8o + n0);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid / 128;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int k = 0; k < steps; ++k) {
      mbar_wait(smem_addr(&full[stage]), phase);
      const uint32_t a = ring + stage * C::kStageBytes + wg * 64 * kRowBytes;
      const uint32_t b = ring + stage * C::kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_bf16<BN>(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
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

    // ---- epilogue: thread holds rows r and r + 8 of its warp's 16, and
    // column pairs 8j + 2 (lane % 4) of every 8-column group j
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int col = n0 + 2 * (lane % 4);
    if constexpr (EPI) {
      // B2 on the f32 sums.  Per row: whether it is stored, its offset,
      // and the packed subs that are pad voxels there (none inside the
      // volume).  Parameters and addend are read-only here and come
      // through the non-coherent path: a column's scale, shift and alpha
      // once for both rows, and the addend of up to 16 column pairs of
      // both rows in flight together ahead of their math.
      bool ok[2];
      long long base[2];
      unsigned drop[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
        const int ow = ow0 + r % p.bw;
        const int oh = oh0 + (r / p.bw) % p.bh;
        const int od = od0 + r / (p.bw * p.bh);
        ok[h] = r < box_rows && ow < p.Wo && oh < p.Ho && od < p.Do;
        base[h] = ((((long long)nb * p.Do + od) * p.Ho + oh) * p.Wo + ow) *
                      p.C8o + col;
        drop[h] = ok[h] ? shifted_drop(od, oh, ow, p.Do, p.Ho, p.Wo) : 0u;
      }
      const int c_sub = p.C8o >> 3;
      constexpr int kChunk = BN / 8 < 16 ? BN / 8 : 16;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
        uint32_t araw[2][kChunk];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj)
            araw[h][jj] =
                epi.addend != nullptr && ok[h]
                    ? __ldg(reinterpret_cast<const unsigned int*>(
                          epi.addend + base[h] + 8 * (j0 + jj)))
                    : 0u;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int j = j0 + jj;
          const int c = col + 8 * j;
          const float2 sc =
              __ldg(reinterpret_cast<const float2*>(epi.scale + c));
          const float2 sh =
              __ldg(reinterpret_cast<const float2*>(epi.shift + c));
          const float2 al =
              __ldg(reinterpret_cast<const float2*>(epi.alpha + c));
          // columns c and c + 1 share a sub: 8Co / 8 is even here
          const int sub = (drop[0] | drop[1]) != 0u ? c / c_sub : 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!ok[h]) continue;
            const float2 a = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&araw[h][jj]));
            float v0 = (acc[4 * j + 2 * h] + a.x) * sc.x + sh.x;
            float v1 = (acc[4 * j + 2 * h + 1] + a.y) * sc.y + sh.y;
            v0 = v0 >= 0.f ? v0 : v0 * al.x;
            v1 = v1 >= 0.f ? v1 : v1 * al.y;
            if ((drop[h] >> sub) & 1u) v0 = v1 = 0.f;
            *reinterpret_cast<__nv_bfloat162*>(out + base[h] + 8 * j) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
        if (r >= box_rows) continue;
        const int ow = ow0 + r % p.bw;
        const int oh = oh0 + (r / p.bw) % p.bh;
        const int od = od0 + r / (p.bw * p.bh);
        if (ow >= p.Wo || oh >= p.Ho || od >= p.Do) continue;
        __nv_bfloat16* dst =
            out + ((((long long)nb * p.Do + od) * p.Ho + oh) * p.Wo + ow) *
                      p.C8o + col;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (bias != nullptr) {
            v0 += bias[col + 8 * j];
            v1 += bias[col + 8 * j + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int BN, bool EPI>
static int launch(const CUtensorMap& xm, const CUtensorMap& wm,
                  const float* bias, __nv_bfloat16* out, const Plan& p,
                  const Epi& epi, unsigned grid, cudaStream_t stream) {
  auto kernel = conv2_packed_tc_kernel<BN, EPI>;
  static bool regs_checked = false;
  const int rc = prepare_launch(kernel, Cfg<BN>::kSmem, regs_checked);
  if (rc != 0) return rc;
  kernel<<<grid, kThreads, Cfg<BN>::kSmem, stream>>>(xm, wm, bias, out, p,
                                                     epi);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace mri

// x: (N, Di, Hi, Wi, 8Ci) bf16; wk: (8 taps, 8Co, 8Ci) bf16, K-major;
// bias: (8Co,) f32 or null; out: (N, Do, Ho, Wo, 8Co) bf16.  With scale
// non-null the launch runs the B2 epilogue (pad must be 1 and bias null):
// scale, shift, alpha (8Co,) f32, addend null or bf16 like out.  The tile
// plan (box, boxes per axis, BN) comes from the wrapper.  Launches on
// `stream`; returns cudaGetLastError() after the launch, or a negative code
// if the launch was refused on the host.
extern "C" int mri_conv2_packed_tc(const void* x, const void* wk,
                                   const void* bias, void* out, long long n,
                                   int di, int hi, int wi, int do_, int ho,
                                   int wo, int c8i, int c8o, int pad, int bw,
                                   int bh, int bd, int tiles_w, int tiles_h,
                                   int tiles_d, int bn, const void* scale,
                                   const void* shift, const void* alpha,
                                   const void* addend, void* stream) {
  using namespace mri::tc;
  const bool epi_on = scale != nullptr;
  if (epi_on && (pad != 1 || bias != nullptr || shift == nullptr ||
                 alpha == nullptr || c8o % 16))
    return kErrPlan;
  if (c8i % kBK || (bn != 64 && bn != 128 && bn != 256) || c8o % bn ||
      bw < 1 || bh < 1 || bd < 1 || bw * bh * bd > kBM ||
      (long long)tiles_w * bw < wo || (long long)tiles_h * bh < ho ||
      (long long)tiles_d * bd < do_)
    return kErrPlan;
  const long long grid = n * tiles_w * tiles_h * tiles_d * (c8o / bn);
  if (grid == 0) return (int)cudaSuccess;
  if (grid >= (1LL << 31)) return kErrPlan;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;

  const cuuint64_t e = 2;  // bytes per bf16
  CUtensorMap xm, wm;
  const cuuint64_t xdims[5] = {(cuuint64_t)c8i, (cuuint64_t)wi,
                               (cuuint64_t)hi, (cuuint64_t)di,
                               (cuuint64_t)n};
  const cuuint64_t xstrides[4] = {c8i * e, wi * c8i * e,
                                  (cuuint64_t)hi * wi * c8i * e,
                                  (cuuint64_t)di * hi * wi * c8i * e};
  const cuuint32_t xbox[5] = {kBK, (cuuint32_t)bw, (cuuint32_t)bh,
                              (cuuint32_t)bd, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
             xdims, xstrides, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;
  const cuuint64_t wdims[2] = {(cuuint64_t)c8i, (cuuint64_t)8 * c8o};
  const cuuint64_t wstrides[1] = {c8i * e};
  const cuuint32_t wbox[2] = {kBK, (cuuint32_t)bn};
  if (encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wk),
             wdims, wstrides, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;

  Plan p{bw, bh, bd, tiles_w, tiles_h, tiles_d, c8o / bn,
         do_, ho, wo, c8i, c8o, pad};
  const float* b = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)grid;
  const Epi epi{static_cast<const float*>(scale),
                static_cast<const float*>(shift),
                static_cast<const float*>(alpha),
                static_cast<const __nv_bfloat16*>(addend)};
  if (epi_on) {
    if (bn == 256) return launch<256, true>(xm, wm, b, o, p, epi, g, s);
    if (bn == 128) return launch<128, true>(xm, wm, b, o, p, epi, g, s);
    return launch<64, true>(xm, wm, b, o, p, epi, g, s);
  }
  if (bn == 256) return launch<256, false>(xm, wm, b, o, p, epi, g, s);
  if (bn == 128) return launch<128, false>(xm, wm, b, o, p, epi, g, s);
  return launch<64, false>(xm, wm, b, o, p, epi, g, s);
}
