// dw: the dense weight gradient of a packed k=2 conv on Hopper tensor
// cores, straight from the conv's saved input and its output gradient,
// with wgmma fed by TMA.
//
// Replaces: the einsum of mri_epilepsy_diagnosis_tpu/ops/packed.py
//   `_dw_packed_qgroup` (XLA's in JAX, outside any Pallas kernel), which
//   the port ran as a pad of x, 8 window copies and 8 cuBLAS GEMMs per
//   conv.  `ops/cuda_kernels.py::dw_packed` launches it for bfloat16 on
//   the card; `dw_packed_plain` is its plain version.
//
// What it computes, for pad in {0, 1}:
//   dw[qd,qh,qw][ci][co] = sum over n and output cells c of
//                          x[n, c + (qd,qh,qw) - pad][ci] * g[n, c][co]
// with x zero outside its extent, bf16 products summed in float32, and a
// float32 result of shape (2, 2, 2, 8Ci, 8Co).
//
// GEMM view per offset q: M = 8Co (A = g, 64 channels a tile), N = 8Ci
// (B = the window of x at q, BN = 64 channels a tile, or 8 at the
// 8Ci = 8 stem), K = output cells.
// - K step: a box of bw x bh output cells in one D plane of one batch
//   item (bw a multiple of 8, bw * bh a multiple of 16).  g's tile is one
//   5-D TMA load {64, bw, bh, 1, 1}.  x's: for each qw one load of the
//   haloed box {BN, bw, bh + 1, 2, 1} at (ow0 + qw - pad, oh0 - pad,
//   od - pad).  Its rows hold the four windows (qd, qh) of that qw as
//   runs of bw * bh rows starting at row (qd (bh + 1) + qh) bw, a
//   multiple of 8, so every window is a wgmma operand in place: a tile
//   brings each x row 4 (1 + 1/bh) times instead of 8.  TMA fills
//   what lies outside a tensor with zeros (the pad-1 halo, ragged
//   extents, channels past 8Co or 8Ci), so nothing is masked or padded.
// - Both operands land MN-major, channels contiguous: one cell a 128-byte
//   row with the 128-byte swizzle (the stem's x: 16-byte rows without
//   swizzle), which wgmma reads with its transpose bits.  A tile spans one
//   swizzle atom along M and N, so the descriptors' leading and stride
//   byte offsets both hold the step between 8-row groups along K.
// - Warp specialisation as B1 (`conv2_packed_tc.cu`): one producer thread
//   issues a step's three TMA loads into a ring of stages; consumer
//   warpgroup w runs the four windows of qw = w into four m64nBN
//   accumulators; both read the step's g tile.
// - Split-K: block (m tile, n tile, split s) sums the steps [s T / S,
//   (s + 1) T / S) and stores its 8 partial tiles to a float32 workspace;
//   `dw_packed_fold_kernel` sums each entry's S partials in split order
//   and writes dw as (q, 8Ci, 8Co).  No atomics: every call gives the
//   same bits, and nothing syncs with the host, so CUDA graphs capture
//   both launches.
//
// Bound on the H100: operations (989 TFLOP/s dense bf16) where 8Ci and
// 8Co are 64 or more: 8 x 8Ci x 8Co products a cell against (8Ci + 8Co)
// x 2 bytes read; bytes (3.35 TB/s) at the 8Ci = 8 stem.  A (m tile,
// n tile) reads each x row from L2 about 4.5 times (bh near 8-16) and
// each g row once, so the L2's bandwidth, not the tensor cores, is its
// limit: 300-630 TFLOP/s at the benchmark's larger sites.
//
// A wait on an mbarrier that outlasts ~2^35 cycles traps (`mbar_wait`).
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper_tma.cuh"

namespace mri {
namespace tc {

constexpr int kDwM = 64;             // 8Co channels a tile: one wgmma M
constexpr int kDwRow = 128;          // bytes of a swizzled row
constexpr int kDwMaxStages = 8;

struct DwPlan {
  int bw, bh;            // box of output cells (W, H) a K step
  int tw, th;            // boxes along W and H
  int Do;
  int steps, splits;     // K steps per tile (N x Do x th x tw), splits
  int tiles_m, tiles_n;  // ceil(8Co / 64), ceil(8Ci / BN)
  int pad;
  int stages, stage_bytes, x_off0, x_off1;
  int ldm, ldn;          // workspace tile grid: tiles_m x 64, tiles_n x BN
};

// wgmma shared-memory descriptor of an MN-major tile one swizzle atom
// wide: start address >> 4, both byte offsets `k_step` (the step between
// 8-row groups along K; the other offset steps along M or N, which a
// tile one atom wide never takes), layout `mode` (1: 128-byte swizzle,
// 0: none).
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t k_step,
                                            uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(k_step >> 4) << 16) |
         (static_cast<uint64_t>(k_step >> 4) << 32) | (mode << 62);
}

// d[64 x BN] += A[64 x 16] B[16 x BN], both MN-major in shared memory
// (transpose bits set), f32 accumulators in the wgmma fragment layout.
template <int BN>
__device__ __forceinline__ void wgmma_mn(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_mn<8>(float* d, uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_mn<64>(float* d, uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
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

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
dw_packed_tc_kernel(const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap xmap,
                    float* __restrict__ ws, const DwPlan p) {
  // the stem's x rows are 8 channels (16 bytes) without swizzle
  constexpr int kXRow = BN == 8 ? 16 : kDwRow;
  constexpr uint64_t kXMode = BN == 8 ? 0 : 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem_raw + (ring - raw) + p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;

  // m tiles vary fastest: the blocks that share a split's x boxes run
  // together and find them in L2
  int t = blockIdx.x;
  const int m0 = (t % p.tiles_m) * kDwM;
  t /= p.tiles_m;
  const int n0 = (t % p.tiles_n) * BN;
  const int split = t / p.tiles_n;
  const int k_begin = (int)((long long)split * p.steps / p.splits);
  const int k_end = (int)((long long)(split + 1) * p.steps / p.splits);
  const int rows = p.bw * p.bh;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread starts every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      const uint32_t tx = rows * kDwRow + 2 * 2 * (p.bh + 1) * p.bw * kXRow;
      int stage = 0;
      uint32_t phase = 0;
      for (int k = k_begin; k < k_end; ++k) {
        int b = k;
        const int ow0 = (b % p.tw) * p.bw;
        b /= p.tw;
        const int oh0 = (b % p.th) * p.bh;
        b /= p.th;
        const int od = b % p.Do;
        const int nb = b / p.Do;
        const uint32_t base = ring + stage * p.stage_bytes;
        const uint32_t fb = smem_addr(&full[stage]);
        mbar_wait(smem_addr(&empty[stage]), phase ^ 1);
        mbar_expect_tx(fb, tx);
        tma_load_5d(base, &gmap, fb, m0, ow0, oh0, od, nb);
        tma_load_5d(base + p.x_off0, &xmap, fb, n0, ow0 - p.pad,
                    oh0 - p.pad, od - p.pad, nb);
        tma_load_5d(base + p.x_off1, &xmap, fb, n0, ow0 + 1 - p.pad,
                    oh0 - p.pad, od - p.pad, nb);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: warpgroup w takes the offsets qw = w
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid / 128;
    float acc[4][BN / 2];
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[w][i] = 0.f;
    // first row of window (qd, qh) = (w >> 1, w & 1) in the haloed box
    int win[4];
#pragma unroll
    for (int w = 0; w < 4; ++w)
      win[w] = ((w >> 1) * (p.bh + 1) + (w & 1)) * p.bw;
    const int ksteps = rows / 16;

    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int k = k_begin; k < k_end; ++k) {
      mbar_wait(smem_addr(&full[stage]), phase);
      const uint32_t a = ring + stage * p.stage_bytes;
      const uint32_t b = a + (wg ? p.x_off1 : p.x_off0);
      wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const uint64_t da = mn_desc(a + kk * 16 * kDwRow, 8 * kDwRow, 1);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          wgmma_mn<BN>(acc[w], da,
                       mn_desc(b + (win[w] + kk * 16) * kXRow, 8 * kXRow,
                               kXMode));
      }
      wgmma_commit();
      // the previous step's group is done: release its stage
      wgmma_wait<1>();
      if (prev >= 0 && tid % 128 == 0) mbar_arrive(smem_addr(&empty[prev]));
      prev = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[w][i]);

    // ---- partial tiles: thread holds rows r and r + 8 of its warp's 16
    // and column pairs 8j + 2 (lane % 4) of every 8-column group j
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const long long plane = (long long)p.ldm * p.ldn;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int q = 4 * (w >> 1) + 2 * (w & 1) + wg;
      float* dst = ws + ((long long)split * 8 + q) * plane;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + warp * 16 + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(
              dst + (long long)r * p.ldn + n0 + 8 * j + 2 * (lane % 4)) =
              make_float2(acc[w][4 * j + 2 * h], acc[w][4 * j + 2 * h + 1]);
      }
    }
  }
}

// out[q][ci][co] = sum over s, in order, of ws[s][q][co][ci]: a 32 x 32
// tile of (co, ci) a block, transposed through shared memory.
__global__ void __launch_bounds__(256)
dw_packed_fold_kernel(const float* __restrict__ ws, float* __restrict__ out,
                      int splits, int ldm, int ldn, int c8i, int c8o) {
  __shared__ float tile[32][33];
  const int q = blockIdx.z;
  const int ci0 = blockIdx.x * 32, co0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long split_stride = 8LL * ldm * ldn;
  for (int r = ty; r < 32; r += 8) {
    const int co = co0 + r, ci = ci0 + tx;
    float sum = 0.f;
    if (co < c8o && ci < c8i) {
      const float* src = ws + ((long long)q * ldm + co) * ldn + ci;
#pragma unroll 8
      for (int s = 0; s < splits; ++s) sum += __ldg(src + s * split_stride);
    }
    tile[r][tx] = sum;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int ci = ci0 + r, co = co0 + tx;
    if (ci < c8i && co < c8o)
      out[((long long)q * c8i + ci) * c8o + co] = tile[tx][r];
  }
}

template <int BN>
static int dw_launch(const CUtensorMap& gm, const CUtensorMap& xm,
                     float* ws, const DwPlan& p, int smem, unsigned grid,
                     cudaStream_t stream) {
  auto kernel = dw_packed_tc_kernel<BN>;
  static bool regs_checked = false;
  const int rc = prepare_launch(kernel, smem, regs_checked);
  if (rc != 0) return rc;
  kernel<<<grid, kThreads, smem, stream>>>(gm, xm, ws, p);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace mri

// x: (N, Di, Hi, Wi, 8Ci) bf16, the conv's input without its pad; g:
// (N, Do, Ho, Wo, 8Co) bf16, its output gradient, with Di = Do - 1 + 2 pad
// (and so for H and W); ws: splits x 8 x (ceil(8Co / 64) 64) x
// (ceil(8Ci / BN) BN) f32, BN = 8 where 8Ci = 8 and 64 else; out:
// (8, 8Ci, 8Co) f32.  The box (bw, bh), splits and stages come from the
// wrapper's plan (`ops/cuda_kernels.py::dw_packed_plan`).  Two launches on
// `stream`: the split-K kernel, then the fold.  Returns
// cudaGetLastError() after them, or a negative code if refused on the
// host.
extern "C" int mri_dw_packed_tc(const void* x, const void* g, void* ws,
                                void* out, long long n, int di, int hi,
                                int wi, int do_, int ho, int wo, int c8i,
                                int c8o, int pad, int bw, int bh,
                                int splits, int stages, void* stream) {
  using namespace mri::tc;
  const int bn = c8i == 8 ? 8 : 64;
  const int xrow = bn == 8 ? 16 : kDwRow;
  const int step = 1 - 2 * pad;  // x extent - g extent
  if ((pad != 0 && pad != 1) || di != do_ + step || hi != ho + step ||
      wi != wo + step || c8i % 8 || c8o % 8 || bw < 8 || bw % 8 ||
      bh < 1 || (bw * bh) % 16 || bw > 256 || bh + 1 > 256 || stages < 2 ||
      stages > kDwMaxStages || n < 1 || do_ < 1 || ho < 1 || wo < 1)
    return kErrPlan;
  const int tw = (wo + bw - 1) / bw, th = (ho + bh - 1) / bh;
  const long long steps = n * do_ * th * tw;
  if (steps >= (1LL << 31) || splits < 1 || splits > steps) return kErrPlan;
  const int tiles_m = (c8o + kDwM - 1) / kDwM;
  const int tiles_n = (c8i + bn - 1) / bn;
  const long long grid = (long long)tiles_m * tiles_n * splits;
  if (grid >= (1LL << 31)) return kErrPlan;
  const int g_bytes = bw * bh * kDwRow;
  const int x_bytes = (2 * (bh + 1) * bw * xrow + 1023) / 1024 * 1024;
  const int stage_bytes = g_bytes + 2 * x_bytes;
  const int smem = stages * stage_bytes + 1024 + 16 * stages;
  if (smem > 232448) return kErrPlan;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;

  const cuuint64_t e = 2;  // bytes per bf16
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUtensorMap gm, xm;
  const cuuint64_t gdims[5] = {(cuuint64_t)c8o, (cuuint64_t)wo,
                               (cuuint64_t)ho, (cuuint64_t)do_,
                               (cuuint64_t)n};
  const cuuint64_t gstrides[4] = {c8o * e, wo * c8o * e,
                                  (cuuint64_t)ho * wo * c8o * e,
                                  (cuuint64_t)do_ * ho * wo * c8o * e};
  const cuuint32_t gbox[5] = {kDwM, (cuuint32_t)bw, (cuuint32_t)bh, 1, 1};
  if (encode(&gm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(g),
             gdims, gstrides, gbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;
  const cuuint64_t xdims[5] = {(cuuint64_t)c8i, (cuuint64_t)wi,
                               (cuuint64_t)hi, (cuuint64_t)di,
                               (cuuint64_t)n};
  const cuuint64_t xstrides[4] = {c8i * e, wi * c8i * e,
                                  (cuuint64_t)hi * wi * c8i * e,
                                  (cuuint64_t)di * hi * wi * c8i * e};
  const cuuint32_t xbox[5] = {(cuuint32_t)bn, (cuuint32_t)bw,
                              (cuuint32_t)(bh + 1), 2, 1};
  if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
             xdims, xstrides, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             bn == 8 ? CU_TENSOR_MAP_SWIZZLE_NONE
                     : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kErrTensorMap;

  DwPlan p{bw, bh, tw, th, do_, (int)steps, splits, tiles_m, tiles_n, pad,
           stages, stage_bytes, g_bytes, g_bytes + x_bytes,
           tiles_m * kDwM, tiles_n * bn};
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = bn == 8 ? dw_launch<8>(gm, xm, w, p, smem, (unsigned)grid, s)
                         : dw_launch<64>(gm, xm, w, p, smem, (unsigned)grid,
                                         s);
  if (rc != 0) return rc;
  const dim3 fgrid((c8i + 31) / 32, (c8o + 31) / 32, 8);
  dw_packed_fold_kernel<<<fgrid, dim3(32, 8), 0, s>>>(
      w, static_cast<float*>(out), splits, p.ldm, p.ldn, c8i, c8o);
  return (int)cudaGetLastError();
}
