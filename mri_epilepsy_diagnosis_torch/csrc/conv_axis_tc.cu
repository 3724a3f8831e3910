// B3's one-axis convolution on Hopper tensor cores, for bfloat16 x and
// bfloat16 weights.  `conv_axis.cu` keeps float32 (and bf16 x with float32
// weights) on CUDA cores; the wrapper `ops/cuda_kernels.py::conv_axis`
// picks one by `_axis_fwd_route`.
//
// Replaces: mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py:70
//   `conv_axis_last` (Pallas kernel `_conv_axis_kernel`, :37), reached
//   through `conv_one_axis` (:131) and `separable_conv3d` (:148).  On the
//   training paths it recomputes the fused stacks' intermediates y1 and
//   y2 in `SeparableConv3dFn.backward`, and runs the depth-6 AE's stacks
//   that the fused plan cannot hold (`_separable_route`).
//
// What it computes: x viewed as (A, L, B, Ci), L the conv axis, w (k, Ci,
// Co), bias (Co,) float32 or none:
//   out[a, j, b, co] = bias[co]
//       + sum_{t < k, ci < Ci} x[a, j*s + t - p, b, ci] * w[t, ci, co]
// with x zero outside [0, L); the sum and the bias in float32, rounded
// once to bf16 (the TPU kernel sums each tap in f32; the bias is added in
// f32 before the one rounding, ROADMAP §C "B3 bias").
//
// Bound on the H100: bytes, at every site of the fader alternation (batch
// 35) and of the depth-6 AE step (batch 3): 5 to 64 FLOP per byte moved,
// below the ~295 FLOP/byte of the bf16 tensor cores.  e0's D recompute
// (Ci = 1 -> 8, k6 s2) moves 2.48 GB (0.74 ms at 3.35 TB/s) for 12 us of
// tensor-core work; its H recompute moves 2.97 GB (0.89 ms) for 47.6
// GFLOP, 0.71 ms on the 67 TFLOP/s float32 CUDA cores that `conv_axis.cu`
// uses but 0.05 ms on the tensor cores.  The alternation's 14 recomputes
// need 1.69 ms of bytes and 0.07 ms of operations; the AE step's 51
// launches 1.62 ms of bytes, its 512- and 1024-wide stages each a few
// microseconds either way (small GEMMs, bound by fill and launch time).
//
// Design: an implicit GEMM, M = the output cells (jn positions j along the
// axis x bt positions b across it, of one a), N = Co, K = k x Ci, on
// mma.sync m16n8k16 (bf16 in, f32 sums).  n8 fits the fader's N = 8 and
// 16 with no waste, where a 64-wide wgmma tile would waste 7/8 of its
// columns; the wide AE stages are too small to fill wgmma's 64-row tiles
// usefully, so wgmma was not tried.
// - A block walks many tiles (persistent, one N tile of cot channels)
//   through a ring of `stages` shared-memory buffers (filled as Staging
//   below says, zeros outside x).  A tile stages its input rows once,
//   halo included: nl = (jn - 1) s + k positions along the axis, bt
//   wide, stored by parity class (l - l0) mod s, so that a
//   tap's rows for consecutive j are consecutive and every tap reads its
//   A operand as a shifted view of the one slab (one staged row serves
//   every tap that reads it).  K advances in (tap, 8-channel) groups:
//   Ci = 8 wastes no MMA depth.
// - The weights, in bf16 as rows (t, ci) of cot channels, swizzled, are
//   staged once per block and stay resident while Ci fits one K chunk
//   (cik <= 64 channels); wider weights (the AE's 3 x 512 x 512, the
//   disc's 2 x 512 x 1024) are tiled over N across blocks and over K
//   through the ring beside each chunk of x.  No weight is read from
//   global memory inside the MMA loop.
// - Ci = 1 (e0's D recompute, the AE's first stage): the slab
//   holds dense rows of b (2 bytes a cell, 16-byte copies along b) and a
//   tap is one K row: the A fragments are gathered with 16-bit shared
//   loads, B is one k16 step of the taps.
// - Co = 1 (the AE's output stack) takes a dense path without MMA: an n8
//   tile would waste 7 of its 8 columns and 14 of every 16 bytes stored.
// - Outputs: the f32 sums plus bias, rounded once to bf16, staged through
//   shared memory, then written by bulk copies of whole rows where a row of
//   the tile is contiguous (Co = 8 or 16), else 16 bytes a thread in
//   memory order.
// - Staging: TMA box copies of the slab, one a parity class (the map's
//   traversal stride along the axis is s, its swizzle that of `swz`),
//   where the shape allows (16-byte strides, b tiles of multiples of 8),
//   else cp.async (16-byte copies, zero fill by a source size of 0).
// - Index math: tile and row coordinates by multiply-high division by
//   per-launch constants (`FastDiv`); offsets are 64-bit.  Along the last
//   axis (B = 1, Ci > 1) the plan swaps A and B, so that a tile takes bt
//   consecutive a (each a row of l) instead of one short row; x and out
//   are addressed through (a, l, b) strides for that.
//
// The tile plan (`ops/cuda_kernels.py::conv_axis_tc_plan`) is plain Python
// and walked exactly on the CPU by tests/test_torch_axis_fwd_tc.py.
#include <cuda.h>
#include <string.h>

#include "tc_common.cuh"

namespace mri {
namespace {

constexpr int kThreads = 256;
// an mbarrier wait that outlasts ~2^35 cycles (over 10 s) traps
constexpr long long kWatchdogCycles = 1LL << 35;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from shared memory to global memory by the
// bulk-copy engine
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

}  // namespace

// the plan of `conv_axis_tc_plan`, with the shape
struct FwdGeo {
  long long B;
  long long xa, xl, xb, oa, ol, ob;  // strides of (a, l, b) of x and of
                                     // (a, j, b) of out, in cells
  int L, Lo, Ci, Co, k, s, p;
  int cik, cot, kst, wm, wn, bt, jn, nl, nlc, xpitch, jtiles, btiles, tiles,
      tpb, stages, swap;
  int cstride;  // Ci = 1: elements of a class's rows, 128-byte multiple
  int tma;   // x slabs by tensor-map box copies (else cp.async)
  int bulk;  // output rows by bulk copies (else 16-byte stores)
  int lg_sx, lg_so, lg_cik;  // log2 of an x row's 16-byte chunks, of an
                             // output row's, of cik
  FastDiv d_bt, d_jn, d_nlc, d_btiles, d_jtiles, d_kst, d_per;
  FastDiv d_bg, d_lo;  // the dense path: groups of 8 b, output positions
};

struct FwdTile {
  int a, j0, b0;
};

// tiles are ordered (a, j tile, b tile), b tiles fastest
__device__ __forceinline__ FwdTile fwd_tile(const FwdGeo& G, int tile) {
  const int rem = fdiv(G.d_btiles, tile);
  const int bi = tile - rem * G.btiles;
  const int a = fdiv(G.d_jtiles, rem);
  return {a, (rem - a * G.jtiles) * G.jn, bi * G.bt};
}

// the weights w[t, ci0 .., co0 ..] as rows (t, ci - ci0) of cot channels
// in swizzled 16-byte chunks, zeros past Ci and Co
__device__ __forceinline__ void fwd_stage_weights(const u16* __restrict__ w,
                                                  uint32_t ws, const FwdGeo& G,
                                                  int ci0, int co0) {
  const int So = 1 << G.lg_so, nc = min(G.cot, G.Co - co0);
  const int wrows = G.k << G.lg_cik;
  for (int u = threadIdx.x; u < (wrows << G.lg_so); u += kThreads) {
    const int r = u >> G.lg_so, c = u & (So - 1);
    const int t = r >> G.lg_cik, ci = ci0 + r - (t << G.lg_cik);
    const bool ok = ci < G.Ci;
    const u16* src =
        w + ((long long)t * G.Ci + (ok ? ci : 0)) * G.Co + co0 + 8 * c;
    stage_chunk(ws + (uint32_t)(r * So + (c ^ swz(r, So))) * 16, src,
                ok ? nc - 8 * c : 0);
  }
}

// one (tile, K chunk) unit: the x slab of the chunk's channels, row
// (class, idx[, bb]) holding l = j0 s - p + idx s + class; and the chunk's
// weights, unless they stay resident (one K chunk)
template <bool CI1>
__device__ __forceinline__ void fwd_stage_unit(const u16* __restrict__ x,
                                               const u16* __restrict__ w,
                                               const CUtensorMap* xmap,
                                               uint32_t bar, uint32_t xs,
                                               uint32_t ws, const FwdGeo& G,
                                               int tile, int cs, int co0) {
  const FwdTile T = fwd_tile(G, tile);
  const int lbase = T.j0 * G.s - G.p;
  const int ci0 = cs << G.lg_cik;
  const long long xa = T.a * G.xa;
  if (G.tma) {
    // one box a parity class: nlc positions l = lbase + class + s idx
    // (the map's traversal stride along l is s), zeros outside x; the
    // map's swizzle is `swz` of the slab's rows
    if (threadIdx.x == 0) {
      // a box's bytes, and the distance between two classes' boxes
      const uint32_t box_bytes =
          G.nlc * (CI1 ? G.xpitch : G.bt << G.lg_cik) * 2;
      const uint32_t cls_bytes = CI1 ? G.cstride * 2 : box_bytes;
      mbar_expect_tx(bar, G.s * box_bytes);
      for (int c = 0; c < G.s; ++c) {
        if constexpr (CI1)
          tma_load_3d(xs + c * cls_bytes, xmap, bar, T.b0, lbase + c, T.a);
        else
          tma_load_4d(xs + c * cls_bytes, xmap, bar, ci0, T.b0, lbase + c,
                      T.a);
      }
    }
  } else if constexpr (CI1) {
    // rows of bt consecutive b, xpitch elements apart, a class's rows
    // cstride elements apart
    const int per = G.xpitch >> 3;
    const int nb = (int)min((long long)G.bt, G.B - T.b0);
    const int rows = G.s * G.nlc;
    for (int u = threadIdx.x; u < rows * per; u += kThreads) {
      const int r = fdiv(G.d_per, u), c = u - r * per;
      const int cls = fdiv(G.d_nlc, r), idx = r - cls * G.nlc;
      const int q = idx * G.s + cls;
      const int l = lbase + q;
      const bool ok = q < G.nl && l >= 0 && l < G.L;
      const u16* src = x + (xa + (ok ? l : 0) * G.xl + T.b0 * G.xb) + 8 * c;
      stage_chunk(
          xs + (uint32_t)(cls * G.cstride + idx * G.xpitch + 8 * c) * 2, src,
          ok ? nb - 8 * c : 0);
    }
  } else {
    const int S = 1 << G.lg_sx, nc = min(G.cik, G.Ci - ci0);
    const int rows = G.s * G.nlc * G.bt;
    for (int u = threadIdx.x; u < (rows << G.lg_sx); u += kThreads) {
      const int r = u >> G.lg_sx, c = u & (S - 1);
      const int ri = fdiv(G.d_bt, r), bb = r - ri * G.bt;
      const int cls = fdiv(G.d_nlc, ri);
      const int q = (ri - cls * G.nlc) * G.s + cls;
      const int l = lbase + q;
      const bool ok =
          q < G.nl && l >= 0 && l < G.L && T.b0 + bb < G.B;
      const u16* src = x + (xa + (ok ? l : 0) * G.xl +
                            (ok ? T.b0 + bb : 0) * G.xb) * G.Ci + ci0 + 8 * c;
      stage_chunk(xs + (uint32_t)(r * S + (c ^ swz(r, S))) * 16, src,
                  ok ? nc - 8 * c : 0);
    }
  }
  if (G.kst > 1) fwd_stage_weights(w, ws, G, ci0, co0);
}

// Block (tile group, N tile); warp (wmi, wni), warp = wmi + wm wni, holds
// FM x FN m16n8 accumulators: m16 tiles wmi * FM + f of the tile's M rows
// m = jj bt + bb, n8 tiles wni * FN + n of its cot channels.  Units (tile,
// K chunk) pass through the ring; a tile's outputs are stored after its
// last chunk.  A row m of tap t is slab row m + (class(t) nlc + idx(t)) bt
// (Ci = 1: column bb of slab row jj + class(t) nlc + idx(t)).
template <int FM, int FN, bool CI1>
__global__ void __launch_bounds__(kThreads)
axis_fwd_tc_kernel(const u16* __restrict__ x, const u16* __restrict__ w,
                   const float* __restrict__ bias, u16* __restrict__ out,
                   const __grid_constant__ CUtensorMap xmap, const FwdGeo G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wmi = warp % G.wm, wni = warp / G.wm;
  const int co0 = blockIdx.y * G.cot;
  const int t0 = blockIdx.x * G.tpb;
  const int nunits = min(G.tpb, G.tiles - t0) * G.kst;
  // shared memory: [ring of stages: x slab (and the chunk's weights,
  // several K chunks), 1024-byte aligned with TMA] [weights, one K chunk]
  // [the output tile] [16 zero bytes: the rows of pad K groups] [each tap's
  // staged row at j = 0] [an mbarrier a stage, with TMA]
  const int x_bytes = CI1 ? G.s * G.cstride * 2
                          : G.s * G.nlc * G.bt * G.cik * 2;
  const int w_bytes = (G.k << G.lg_cik) * G.cot * 2;
  const bool wres = G.kst == 1;
  const int stage_raw = x_bytes + (wres ? 0 : w_bytes);
  const int stage_bytes = G.tma ? (stage_raw + 1023) & ~1023 : stage_raw;
  const int mrows = G.jn * G.bt;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = G.tma ? (raw + 1023u) & ~1023u : raw;
  const uint32_t wsres = base + G.stages * stage_bytes;
  const uint32_t outs = wsres + (wres ? w_bytes : 0);
  const uint32_t zero = outs + mrows * G.cot * 2;
  int* tapoff = reinterpret_cast<int*>(smem + (zero + 16 - raw));
  const uint32_t bars = zero + 16 + ((4 * G.k + 7) & ~7);
  if (G.tma && threadIdx.x == 0) {
    for (int b = 0; b < G.stages; ++b) mbar_init(bars + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (wres) fwd_stage_weights(w, wsres, G, 0, co0);  // in the first group
  if (threadIdx.x < 4)
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(zero + 4 * threadIdx.x),
                 "r"(0u)
                 : "memory");
  for (int t = threadIdx.x; t < G.k; t += kThreads)
    tapoff[t] = (t % G.s) * G.nlc + t / G.s;
  __syncthreads();
  const int S = 1 << G.lg_sx, So = 1 << G.lg_so;
  const int MT = mrows >> 4;
  const int grp = lane >> 2, qd = lane & 3, mat = lane >> 3;

  // this lane's bias pair per n8 tile
  float bv[FN][2];
#pragma unroll
  for (int n = 0; n < FN; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + (wni * FN + n) * 8 + 2 * qd + e;
      bv[n][e] = bias != nullptr && co < G.Co ? bias[co] : 0.f;
    }
  // Ci = 1: the slab offsets (jj xpitch + bb) of this lane's rows grp and
  // grp + 8 per m16 tile, and the staged rows of its taps 2 qd, 2 qd + 1,
  // 2 qd + 8, 2 qd + 9 (-1: no such tap)
  int offm[FM][2], toff1[4];
  if constexpr (CI1) {
#pragma unroll
    for (int f = 0; f < FM; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wmi * FM + f) * 16 + grp + 8 * h;
        const int jj = fdiv(G.d_bt, m);
        offm[f][h] = jj * G.xpitch + (m - jj * G.bt);
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 2 * qd + (e & 1) + 8 * (e >> 1);
      toff1[e] = t < G.k ? (t % G.s) * G.cstride + (t / G.s) * G.xpitch : -1;
    }
  }

  float acc[FM][FN][4];
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int n = 0; n < FN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][n][e] = 0.f;

  for (int i = 0; i < G.stages - 1; ++i) {
    if (i < nunits) {
      const uint32_t st = base + i * stage_bytes;
      const int tq = fdiv(G.d_kst, i);
      fwd_stage_unit<CI1>(x, w, &xmap, bars + 8 * i, st, st + x_bytes, G,
                          t0 + tq, i - tq * G.kst, co0);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nunits; ++i) {
    // the previous tile's bulk stores have read the output tile
    if (G.bulk)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    cp_async_wait(G.stages - 2);
    if (G.tma)
      mbar_wait(bars + 8 * (i % G.stages), (uint32_t)(i / G.stages) & 1);
    __syncthreads();
    {
      const int nx = i + G.stages - 1;
      if (nx < nunits) {
        const uint32_t st = base + (nx % G.stages) * stage_bytes;
        const int tq = fdiv(G.d_kst, nx);
        fwd_stage_unit<CI1>(x, w, &xmap, bars + 8 * (nx % G.stages), st,
                            st + x_bytes, G, t0 + tq, nx - tq * G.kst, co0);
      }
      cp_async_commit();
    }
    const uint32_t xs = base + (i % G.stages) * stage_bytes;
    const uint32_t ws = wres ? wsres : xs + x_bytes;
    const int tq = fdiv(G.d_kst, i), cs = i - tq * G.kst;
    if constexpr (CI1) {
      // one k16 step: K rows are the taps (k <= 16), weight rows t
      uint32_t bfr[FN][2];
      const int tb = lane & 15;
#pragma unroll
      for (int n = 0; n < FN; ++n) {
        const int nt = wni * FN + n;
        const uint32_t addr =
            tb < G.k ? ws + (uint32_t)(tb * So + (nt ^ swz(tb, So))) * 16
                     : zero;
        ldsm_x2_t(bfr[n][0], bfr[n][1], addr);
      }
#pragma unroll
      for (int f = 0; f < FM; ++f) {
        if (wmi * FM + f >= MT) break;
        uint32_t af[4];
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          // reg: bit 0 = rows + 8, bit 1 = taps + 8
          const int ro = offm[f][reg & 1];
          const int lo = toff1[2 * (reg >> 1)], hi = toff1[2 * (reg >> 1) + 1];
          const uint32_t vl = lo >= 0 ? lds16(xs + (uint32_t)(ro + lo) * 2) : 0;
          const uint32_t vh = hi >= 0 ? lds16(xs + (uint32_t)(ro + hi) * 2) : 0;
          af[reg] = vl | (vh << 16);
        }
#pragma unroll
        for (int n = 0; n < FN; ++n)
          mma_bf16(acc[f][n], af, bfr[n][0], bfr[n][1]);
      }
    } else {
      // K groups k8 = t nq + c (tap t, live 8-channel group c), two a
      // step: (t0, c0) and the next one (t1, c1)
      const int nq = min(S, (G.Ci - (cs << G.lg_cik) + 7) >> 3);
      const int nk8 = G.k * nq;
      int ta = 0, ca = 0;
      for (int k8 = 0; k8 < nk8; k8 += 2) {
        int tn = ta, cn = ca + 1;
        if (cn == nq) {
          cn = 0;
          ++tn;
        }
        uint32_t bfr[FN][2];
        {
          // ldmatrix.x2.trans: lanes 0-7 give the 8 weight rows of group
          // k8, lanes 8-15 those of group k8 + 1
          const bool hb = (lane >> 3) & 1;
          const int tb = hb ? tn : ta, cb = hb ? cn : ca;
          const bool live = k8 + hb < nk8;
          const int wrow = (tb << G.lg_cik) + cb * 8 + (lane & 7);
#pragma unroll
          for (int n = 0; n < FN; ++n) {
            const int nt = wni * FN + n;
            const uint32_t addr =
                live ? ws + (uint32_t)(wrow * So + (nt ^ swz(wrow, So))) * 16
                     : zero;
            ldsm_x2_t(bfr[n][0], bfr[n][1], addr);
          }
        }
        // ldmatrix.x4: lanes 8 mat .. 8 mat + 7 give the rows of matrix
        // mat = (m half mat & 1, k half mat >> 1)
        const bool hi = mat >> 1;
        const int t = hi ? tn : ta, cc = hi ? cn : ca;
        const bool live = k8 + hi < nk8;
        const int roff = live ? tapoff[t] * G.bt : 0;
#pragma unroll
        for (int f = 0; f < FM; ++f) {
          if (wmi * FM + f >= MT) break;
          const int row = (wmi * FM + f) * 16 + (mat & 1) * 8 + (lane & 7) +
                          roff;
          const uint32_t addr =
              live ? xs + (uint32_t)(row * S + (cc ^ swz(row, S))) * 16 : zero;
          uint32_t af[4];
          ldsm_x4(af, addr);
#pragma unroll
          for (int n = 0; n < FN; ++n)
            mma_bf16(acc[f][n], af, bfr[n][0], bfr[n][1]);
        }
        ta = tn;
        ca = cn + 1;
        if (ca == nq) {
          ca = 0;
          ++ta;
        }
      }
    }
    if (cs == G.kst - 1) {
      // the tile's outputs, bias added and rounded once to bf16, through
      // shared memory (row m of cot channels in 16-byte chunks, swizzled
      // unless bulk copies write the rows out), then out in memory order
#pragma unroll
      for (int f = 0; f < FM; ++f) {
        if (wmi * FM + f >= MT) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (wmi * FM + f) * 16 + grp + 8 * h;
#pragma unroll
          for (int n = 0; n < FN; ++n) {
            const int nt = wni * FN + n;
            const __nv_bfloat162 v2 =
                __floats2bfloat162_rn(acc[f][n][2 * h] + bv[n][0],
                                      acc[f][n][2 * h + 1] + bv[n][1]);
            const int ch = G.bulk ? nt : nt ^ swz(m, So);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             outs + (uint32_t)(m * So + ch) * 16 + 4 * qd),
                         "r"(*reinterpret_cast<const uint32_t*>(&v2))
                         : "memory");
          }
        }
      }
      if (G.bulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const FwdTile T = fwd_tile(G, t0 + tq);
      if (G.bulk) {
        // Co = cot and A, B not swapped: each j row of the tile is one
        // contiguous run in shared and in global memory
        const int jj = threadIdx.x, j = T.j0 + jj;
        if (jj < G.jn && j < G.Lo) {
          const int nb = (int)min((long long)G.bt, G.B - T.b0);
          bulk_store(out + (T.a * G.oa + j * G.ol + T.b0) * G.Co,
                     outs + (uint32_t)(jj * G.bt * G.Co * 2),
                     (uint32_t)(nb * G.Co * 2));
        }
      }
      const int nct = min(G.cot, G.Co - co0);
      const int live = (nct + 7) >> 3;  // 8-channel chunks
      for (int u = G.bulk ? mrows << G.lg_so : threadIdx.x;
           u < (mrows << G.lg_so); u += kThreads) {
        const int r = u >> G.lg_so, c = u & (So - 1);
        // memory order: b fastest, or j fastest where A and B swapped
        int jj, bb;
        if (G.swap) {
          bb = fdiv(G.d_jn, r);
          jj = r - bb * G.jn;
        } else {
          jj = fdiv(G.d_bt, r);
          bb = r - jj * G.bt;
        }
        const int j = T.j0 + jj;
        const long long b = T.b0 + bb;
        if (c >= live || j >= G.Lo || b >= G.B) continue;
        const int m = jj * G.bt + bb;
        uint32_t v[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "r"(outs + (uint32_t)(m * So + (c ^ swz(m, So))) * 16));
        u16* o = out + (T.a * G.oa + j * G.ol + b * G.ob) * G.Co + co0 + 8 * c;
        const int nc = min(8, nct - 8 * c);
        if (nc == 8 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
          *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
        } else {
          for (int e = 0; e < nc; ++e)
            o[e] = (u16)(v[e >> 1] >> (16 * (e & 1)));
        }
      }
#pragma unroll
      for (int f = 0; f < FM; ++f)
#pragma unroll
        for (int n = 0; n < FN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][n][e] = 0.f;
    }
  }
  cp_async_wait(0);
  if (G.bulk) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Co = 1, the dense path: an n8 MMA tile would waste 7 of its 8 columns
// and its output rows 14 of their 16 bytes.  Thread (a, j, b group) sums
// its cells' k x Ci products in float32 from global memory (the weights
// in shared memory as float32): with Ci = 1 (MODE 0) a group is 8
// consecutive b, read and written 16 bytes at a time; with Ci % 8 == 0
// (MODE 1, 16-byte loads along ci) and otherwise (MODE 2, scalar) a group
// is one cell, so that a warp's loads and stores are contiguous.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
axis_fwd_dense_kernel(const u16* __restrict__ x, const u16* __restrict__ w,
                      const float* __restrict__ bias, u16* __restrict__ out,
                      const FwdGeo G, int groups) {
  extern __shared__ float wsf[];
  const int nw = G.k * G.Ci;
  for (int i = threadIdx.x; i < nw; i += kThreads)
    wsf[i] = __bfloat162float(
        *reinterpret_cast<const __nv_bfloat16*>(w + i));
  __syncthreads();
  constexpr int kCells = MODE == 0 ? 8 : 1;  // cells a thread
  const float b0v = bias != nullptr ? bias[0] : 0.f;
  const int bgroups = (int)((G.B + kCells - 1) / kCells);
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += gridDim.x * kThreads) {
    const int rem = fdiv(G.d_bg, g);
    const int b0 = (g - rem * bgroups) * kCells;
    const int a = fdiv(G.d_lo, rem), j = rem - a * G.Lo;
    const int nb = (int)min((long long)kCells, G.B - b0);
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = b0v;
    for (int t = 0; t < G.k; ++t) {
      const int l = j * G.s + t - G.p;
      if (l < 0 || l >= G.L) continue;
      const u16* row = x + (a * G.xa + l * G.xl + b0 * G.xb) * G.Ci;
      if constexpr (MODE == 0) {
        const float wt = wsf[t];
        if (nb == 8 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
          const uint4 v = *reinterpret_cast<const uint4*>(row);
          const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[e] = fmaf(__uint_as_float((u[e >> 1] >> (16 * (e & 1))) << 16),
                          wt, acc[e]);
        } else {
          for (int e = 0; e < nb; ++e)
            acc[e] = fmaf(__uint_as_float((uint32_t)row[e * G.xb] << 16), wt,
                          acc[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kCells; ++e) {
          if (e >= nb) break;
          const u16* cell = row + e * G.xb * G.Ci;
          const float* wt = wsf + t * G.Ci;
          float sum = 0.f;
          if constexpr (MODE == 1) {
            float sum2 = 0.f;
            for (int c = 0; c < G.Ci; c += 8) {
              const uint4 v = __ldg(reinterpret_cast<const uint4*>(cell + c));
              const __nv_bfloat162* h =
                  reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float2 f = __bfloat1622float2(h[q]);
                const float2 ww =
                    *reinterpret_cast<const float2*>(wt + c + 2 * q);
                sum = fmaf(f.x, ww.x, sum);
                sum2 = fmaf(f.y, ww.y, sum2);
              }
            }
            sum += sum2;
          } else {
            for (int c = 0; c < G.Ci; ++c)
              sum = fmaf(__uint_as_float((uint32_t)cell[c] << 16), wt[c], sum);
          }
          acc[e] += sum;
        }
      }
    }
    u16* o = out + (a * G.oa + j * G.ol + b0 * G.ob);
    if (nb == 8 && G.ob == 1 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      uint32_t u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v2 =
            __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
        u[q] = *reinterpret_cast<const uint32_t*>(&v2);
      }
      *reinterpret_cast<uint4*>(o) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      for (int e = 0; e < nb; ++e) {
        const __nv_bfloat16 v1 = __float2bfloat16_rn(acc[e]);
        o[e * G.ob] = *reinterpret_cast<const u16*>(&v1);
      }
    }
  }
}

template <int MODE>
int launch_dense(const u16* x, const u16* w, const float* bias, u16* out,
                 const FwdGeo& G, int groups, cudaStream_t stream) {
  auto kern = axis_fwd_dense_kernel<MODE>;
  const size_t smem = (size_t)G.k * G.Ci * sizeof(float);
  const int rc = set_smem(kern, smem);
  if (rc) return rc;
  const int blocks = min((groups + kThreads - 1) / kThreads, 132 * 16);
  kern<<<blocks, kThreads, smem, stream>>>(x, w, bias, out, G, groups);
  return (int)cudaGetLastError();
}

template <int FM, int FN, bool CI1>
int launch_fwd(const u16* x, const u16* w, const float* bias, u16* out,
               const CUtensorMap& xmap, const FwdGeo& G, dim3 grid,
               size_t smem, cudaStream_t stream) {
  auto kern = axis_fwd_tc_kernel<FM, FN, CI1>;
  const int rc = set_smem(kern, smem);
  if (rc) return rc;
  kern<<<grid, kThreads, smem, stream>>>(x, w, bias, out, xmap, G);
  return (int)cudaGetLastError();
}

// warp tiles of at most 8 m16n8 accumulators
template <int FM, bool CI1>
int launch_fwd_fn(int fn, const u16* x, const u16* w, const float* bias,
                  u16* out, const CUtensorMap& m, const FwdGeo& G, dim3 grid,
                  size_t smem, cudaStream_t s) {
  switch (fn) {
    case 1: return launch_fwd<FM, 1, CI1>(x, w, bias, out, m, G, grid, smem, s);
    case 2:
      if constexpr (FM <= 4)
        return launch_fwd<FM, 2, CI1>(x, w, bias, out, m, G, grid, smem, s);
      break;
    case 4:
      if constexpr (FM <= 2)
        return launch_fwd<FM, 4, CI1>(x, w, bias, out, m, G, grid, smem, s);
      break;
  }
  return -4;
}

template <bool CI1>
int launch_fwd_fm(int fm, int fn, const u16* x, const u16* w,
                  const float* bias, u16* out, const CUtensorMap& m,
                  const FwdGeo& G, dim3 grid, size_t smem, cudaStream_t s) {
  switch (fm) {
    case 1:
      return launch_fwd_fn<1, CI1>(fn, x, w, bias, out, m, G, grid, smem, s);
    case 2:
      return launch_fwd_fn<2, CI1>(fn, x, w, bias, out, m, G, grid, smem, s);
    case 4:
      return launch_fwd_fn<4, CI1>(fn, x, w, bias, out, m, G, grid, smem, s);
    case 8:
      return launch_fwd_fn<8, CI1>(fn, x, w, bias, out, m, G, grid, smem, s);
  }
  return -4;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library needs no -lcuda
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

}  // namespace mri

// x viewed as (A, L, B, Ci), w (k, Ci, Co), out (A, Lo, B, Co), all bf16;
// bias (Co,) float32 or null.  geo: the shape and `conv_axis_tc_plan`, in
// the order of `ops/cuda_kernels.py::AxisTcPlan`.  One launch on `stream`;
// returns the CUDA error of the launch, 0 on success, -4 for a plan it does
// not serve (or shared memory that does not cover it), -1 / -2 where the
// x slab's tensor map cannot be made.  With Co = 1 the plan's `dense` flag
// takes the dense path instead (same geometry, no tiles).
extern "C" int mri_conv_axis_tc(const void* x, const void* w, const void* bias,
                                void* out, const long long* geo, int ngeo,
                                void* stream) {
  if (ngeo != 34) return -4;
  mri::FwdGeo G;
  const long long* v = geo;
  const long long A = v[0], tiles = v[23], blocks = v[25], ntiles = v[26];
  G.L = (int)v[1]; G.Lo = (int)v[2]; G.B = v[3];
  G.Ci = (int)v[4]; G.Co = (int)v[5]; G.k = (int)v[6]; G.s = (int)v[7];
  G.p = (int)v[8]; G.cik = (int)v[9]; G.cot = (int)v[10];
  G.kst = (int)v[11]; G.wm = (int)v[12]; G.wn = (int)v[13];
  const int fm = (int)v[14], fn = (int)v[15];
  G.bt = (int)v[16]; G.jn = (int)v[17]; G.nl = (int)v[18];
  G.nlc = (int)v[19]; G.xpitch = (int)v[20]; G.jtiles = (int)v[21];
  G.btiles = (int)v[22]; G.tiles = (int)tiles; G.tpb = (int)v[24];
  G.stages = (int)v[27];
  const size_t smem = (size_t)v[28];
  const bool ci1 = v[29] != 0;
  G.swap = (int)v[30];
  G.tma = (int)v[31];
  G.bulk = (int)v[32];
  const bool dense = v[33] != 0;
  // swapped: the caller's (A, L, 1) rows as (1, L, A), a = 0
  G.xa = G.swap ? 0 : (long long)G.L * G.B;
  G.xl = G.swap ? 1 : G.B;
  G.xb = G.swap ? G.L : 1;
  G.oa = G.swap ? 0 : (long long)G.Lo * G.B;
  G.ol = G.swap ? 1 : G.B;
  G.ob = G.swap ? G.Lo : 1;
  G.lg_sx = ci1 ? 0 : mri::log2_of(G.cik / 8);
  G.lg_so = mri::log2_of(G.cot / 8);
  G.lg_cik = mri::log2_of(G.cik);
  G.d_bt = mri::make_div(G.bt);
  G.d_jn = mri::make_div(G.jn);
  G.d_nlc = mri::make_div(G.nlc);
  G.d_btiles = mri::make_div(G.btiles);
  G.d_jtiles = mri::make_div(G.jtiles);
  G.d_kst = mri::make_div(G.kst);
  G.d_per = mri::make_div(G.xpitch >= 8 ? G.xpitch / 8 : 1);
  G.cstride = (G.nlc * G.xpitch + 63) / 64 * 64;
  // the shared memory as the kernel lays it out
  const long long mrows = (long long)G.jn * G.bt;
  const size_t x_bytes = ci1 ? (size_t)G.s * G.cstride * 2
                             : (size_t)G.s * G.nlc * G.bt * G.cik * 2;
  const size_t w_bytes = (size_t)G.k * G.cik * G.cot * 2;
  const size_t stage_raw = x_bytes + (G.kst == 1 ? 0 : w_bytes);
  const size_t stage_bytes =
      G.tma ? (stage_raw + 1023) / 1024 * 1024 : stage_raw;
  const size_t need = (G.tma ? 1024 : 0) + G.stages * stage_bytes +
                      (G.kst == 1 ? w_bytes : 0) +
                      (size_t)mrows * G.cot * 2 + 16 +
                      (4 * (size_t)G.k + 7) / 8 * 8 +
                      (G.tma ? 8 * (size_t)G.stages : 0);
  if (G.wm * G.wn != 8 || G.wn * fn * 8 != G.cot || mrows % 16 ||
      (long long)G.wm * fm * 16 < mrows || G.stages < 2 || G.stages > 5 ||
      (8 << G.lg_so) != G.cot || (1 << G.lg_cik) != G.cik ||
      (!ci1 && (8 << G.lg_sx) != G.cik) || ci1 != (G.Ci == 1) ||
      (ci1 && (G.swap || G.k > 16 || G.cik != 1 || G.xpitch < G.bt ||
               G.xpitch % 8)) ||
      (long long)G.kst * G.cik < G.Ci || G.nl != (G.jn - 1) * G.s + G.k ||
      (long long)G.nlc * G.s < G.nl || A < 1 || (G.swap && A != 1) ||
      blocks * G.tpb < tiles || tiles * G.kst >= (1LL << 31) ||
      blocks > 2147483647LL || ntiles > 65535 ||
      (long long)ntiles * G.cot < G.Co || smem < need || smem > 232448)
    return -4;
  // TMA: 16-byte strides, boxes of at most 256 a dimension, class boxes
  // at multiples of their swizzle span (bt % 8); bulk stores: whole
  // 16-byte rows of all Co channels, unswapped
  if ((dense && (G.tma || G.bulk)) || (G.tma && ((!ci1 && (G.Ci % 8 || G.bt % 8 || G.bt > 256)) ||
                 (ci1 && (G.B % 8 || G.xpitch > 256)) ||
                 G.nlc * G.s > 256 || (reinterpret_cast<uintptr_t>(x) & 15))) ||
      (G.bulk && (G.swap || G.Co != G.cot || G.cot > 16 ||
                  (reinterpret_cast<uintptr_t>(out) & 15))))
    return -4;
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  if (G.tma) {
    mri::EncodeTiled encode = mri::encode_tiled();
    if (encode == nullptr) return -1;
    const cuuint64_t e = 2;  // bytes per bf16
    CUresult rc;
    if (ci1) {
      const cuuint64_t dims[3] = {(cuuint64_t)G.B, (cuuint64_t)G.L,
                                  (cuuint64_t)A};
      const cuuint64_t strides[2] = {(cuuint64_t)G.B * e,
                                     (cuuint64_t)G.L * G.B * e};
      const cuuint32_t box[3] = {(cuuint32_t)G.xpitch,
                                 (cuuint32_t)(G.nlc * G.s), 1};
      const cuuint32_t es[3] = {1, (cuuint32_t)G.s, 1};
      rc = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(x), dims, strides, box, es,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    } else {
      // (ci, b, l, a); swapped, b runs over the caller's a (stride L rows)
      const cuuint64_t row = (cuuint64_t)G.Ci * e;
      const cuuint64_t dims[4] = {(cuuint64_t)G.Ci, (cuuint64_t)G.B,
                                  (cuuint64_t)G.L, (cuuint64_t)A};
      const cuuint64_t strides[3] = {
          G.swap ? G.L * row : row, G.swap ? row : G.B * row,
          (cuuint64_t)G.L * G.B * row};
      const cuuint32_t box[4] = {(cuuint32_t)G.cik, (cuuint32_t)G.bt,
                                 (cuuint32_t)(G.nlc * G.s), 1};
      const cuuint32_t es[4] = {1, 1, (cuuint32_t)G.s, 1};
      const CUtensorMapSwizzle sw[4] = {
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
          CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_SWIZZLE_128B};
      rc = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(x), dims, strides, box, es,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, sw[G.lg_sx],
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    }
    if (rc != CUDA_SUCCESS) return -2;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dense) {
    // Co = 1: the plan's (A, B) view and strides, no tiles; groups of 8
    // consecutive b with Ci = 1, single cells otherwise
    const int cells = ci1 && !G.swap ? 8 : 1;
    const long long groups = A * G.Lo * ((G.B + cells - 1) / cells);
    if (G.Co != 1 || groups >= (1LL << 31) ||
        (long long)G.k * G.Ci * 4 > 232448 ||
        (!ci1 && G.Ci % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15)))
      return -4;
    G.d_bg = mri::make_div((uint32_t)((G.B + cells - 1) / cells));
    G.d_lo = mri::make_div(G.Lo);
    const auto* xp = (const mri::u16*)x;
    const auto* wp = (const mri::u16*)w;
    const auto* bp = (const float*)bias;
    auto* op = (mri::u16*)out;
    if (ci1 && !G.swap)
      return mri::launch_dense<0>(xp, wp, bp, op, G, (int)groups, s);
    if (G.Ci % 8 == 0)
      return mri::launch_dense<1>(xp, wp, bp, op, G, (int)groups, s);
    return mri::launch_dense<2>(xp, wp, bp, op, G, (int)groups, s);
  }
  const dim3 grid((unsigned)blocks, (unsigned)ntiles);
  const auto* xp = (const mri::u16*)x;
  const auto* wp = (const mri::u16*)w;
  const auto* bp = (const float*)bias;
  auto* op = (mri::u16*)out;
  if (ci1)
    return mri::launch_fwd_fm<true>(fm, fn, xp, wp, bp, op, xmap, G, grid,
                                    smem, s);
  return mri::launch_fwd_fm<false>(fm, fn, xp, wp, bp, op, xmap, G, grid,
                                   smem, s);
}
