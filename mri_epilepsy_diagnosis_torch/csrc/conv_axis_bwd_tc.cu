// B3's backward on Hopper tensor cores: the weight and bias gradients (dw,
// db) and the input gradient (dx) of the one-axis convolution of
// `conv_axis.cu`, for bfloat16 cotangents (and bfloat16 weights, for dx).
// `conv_axis_bwd.cu` keeps the float32 route on CUDA cores; the wrappers
// `ops/cuda_kernels.py::conv_axis_dw` / `conv_axis_dx` pick one by
// `_axis_bwd_route`.
//
// Gradient of: mri_epilepsy_diagnosis_tpu/ops/pallas_kernels.py
//   `conv_axis_last` (Pallas kernel `_conv_axis_kernel`), through
//   `conv_one_axis` and `separable_conv3d`; the JAX package takes this
//   gradient through XLA convolutions.
//
// Layout as in conv_axis_bwd.cu: x viewed as (A, L, B, Ci), the cotangent
// g as (A, Lo, B, Co), y[a,j,b,co] = sum_{t,ci} x[a, j*s + t - p, b, ci]
// * w[t,ci,co].
//
// dw as an implicit GEMM: dW[(t,ci), co] = sum_r X_t[r, ci] G[r, co] over
// the rows r = (a, j, b): M = k x Ci, N = Co, K = A x Lo x B.
// - A block owns a row chunk (consecutive row tiles; a row tile is one a,
//   jn output positions j and bt positions b) and an M x N tile: all k
//   taps of cit input channels by cot output channels.  Per row tile it
//   stages the x slab l in [j0*s - p, (j0+jn-1)*s + k-1-p], bt wide, and
//   the g tile once in shared memory with cp.async (zeros outside x, g).
//   The slab's rows are stored by parity class (l - l0) mod s, so that one
//   tap's rows for consecutive j are consecutive: every tap reads its
//   operand as a strided view of the one slab, and one load of g serves
//   all of the tile's M.
// - mma.sync m16n8k16 (bf16 in, f32 sums): both operands come from rows
//   of 8 channels (16 bytes) through ldmatrix.trans with one row address
//   per lane, which is what lets a tap's shifted rows be gathered for
//   free.  mma.sync's n8 matches Co = 8 at the fader's widest sites, where
//   a 64-wide wgmma tile would waste 7/8 of its columns.  With Ci = 1 the
//   slab holds rows of b (16-byte copies along b) and a tap is an M row:
//   the A fragments are gathered with 16-bit shared loads.
// - db rides along: an mma with an all-ones A sums the g fragments.
// - Deterministic split-K: the 8 warps split the block's tile into wm x
//   wn warp tiles and wk groups over the row tiles' k-steps; each (chunk,
//   group) writes its own slot of float32 partial sums, and a second pass
//   sums the slots in order.  No float atomics: a run repeats bit for bit.
//   One wave of blocks (2 an SM), each walking many row tiles, measured
//   faster than 4 or 8 an SM.
//
// dx as an implicit GEMM per parity class i mod s: dX[r, ci] = sum over
// the class's taps t and co of G[j(r, t), co] W_t[co, ci]: K = (k/s) Co,
// N = Ci.
// - A block owns a tile of (a, in_ input positions i, bt positions b) x
//   cit input channels; its M rows are ordered (class c, u, b) with i = i0
//   + c + s*u, so a 16-row MMA tile has one class and one tap list.  It
//   stages the ng cotangent rows that its i-range reaches, once per
//   co-chunk, and the weights w[t, ci-tile, co-chunk] in bf16: weights
//   past one block's shared memory (the AE's 3 x 512 x 512) are tiled over
//   K in co-chunks.  K advances in 8-channel groups (one tap, 8 co), so Co
//   = 8 wastes no MMA depth; a pad group reads a zero row.
// - With one co-chunk the weights stay resident for the block's tiles.
// - Each output is written by one block, its f32 sums rounded once to
//   bf16 and staged in shared memory, then written out 16 bytes a thread
//   (the 4-byte stores straight from the MMA fragments measured slower).
//
// Along the last axis (B = 1) the plans swap A and B: a tile then takes bt
// consecutive a, each a row of l (x at l + b L, g at j + b Lo), instead of
// one short row.  The kernels address x, g and dx through (a, l, b)
// strides for that.
//
// Bound on the H100: bytes at the fader's sites (k x Ci x Co / (Ci + Co)
// products per element moved, under the ~295 FLOP/byte of the bf16 tensor
// cores); the AE's 512-wide sites are small GEMMs, bound by launch and
// fill time; the 1-channel sites (Ci or Co = 1) stage 2-byte rows element
// by element into 16-byte rows and run far from their bound.  Both kernels walk their row tiles through a ring of
// `stages` shared-memory buffers, loads of the next tiles in flight while
// the warps multiply the current one.
//
// The tile plans (`ops/cuda_kernels.py::conv_axis_dw_tc_plan`,
// `conv_axis_dx_tc_plan`) are plain Python and walked exactly on the CPU
// by tests/test_torch_axis_bwd_tc.py.  Offsets are 64-bit.
#include "tc_common.cuh"

namespace mri {
namespace {

constexpr int kThreads = 256;

}  // namespace

// ---------------------------------------------------------------------------
// dw
// ---------------------------------------------------------------------------

// the plan of `conv_axis_dw_tc_plan`, with the shape
struct DwGeo {
  long long B, nout;
  long long xa, xl, xb, ga, gl, gb;  // strides of (a, l, b) in channel rows
  int L, Lo, Ci, Co, k, s, p;
  int cit, cot, wm, wn, wk, bt, jn, nl, nlc, xpitch, jtiles, btiles, tiles,
      tpc, stages, with_bias, lg_sx, lg_sg;  // log2 of the 16-byte chunks
  FastDiv d_bt, d_nlc, d_btiles, d_jtiles;   // of an x row and a g row
};

template <bool CI1>
__device__ __forceinline__ void dw_stage_tile(const u16* __restrict__ x,
                                              const u16* __restrict__ g,
                                              uint32_t xs, uint32_t gs,
                                              const DwGeo& G, int tile,
                                              int ci0, int co0) {
  const int rem = fdiv(G.d_btiles, tile);
  const int bi = tile - rem * G.btiles;
  const int a = fdiv(G.d_jtiles, rem);
  const int jt = rem - a * G.jtiles;
  const int j0 = jt * G.jn, b0 = bi * G.bt;
  const int lbase = j0 * G.s - G.p;
  // the x slab: row (class, idx[, bb]) holds l = lbase + idx * s + class
  if constexpr (CI1) {
    const int per = G.xpitch >> 3, nb = (int)min((long long)G.bt, G.B - b0);
    const int rows = G.s * G.nlc;
    for (int u = threadIdx.x; u < rows * per; u += kThreads) {
      const int r = u / per, c = u - r * per;
      const int cls = fdiv(G.d_nlc, r), q = (r - cls * G.nlc) * G.s + cls;
      const int l = lbase + q;
      const bool ok = q < G.nl && l >= 0 && l < G.L;
      const u16* src =
          x + (a * G.xa + (ok ? l : 0) * G.xl + b0 * G.xb) + 8 * c;
      stage_chunk(xs + (uint32_t)(r * G.xpitch + 8 * c) * 2, src,
                  ok ? nb - 8 * c : 0);
    }
  } else {
    const int S = 1 << G.lg_sx, nc = min(G.cit, G.Ci - ci0);
    const int rows = G.s * G.nlc * G.bt;
    for (int u = threadIdx.x; u < (rows << G.lg_sx); u += kThreads) {
      const int r = u >> G.lg_sx, c = u & (S - 1);
      const int ri = fdiv(G.d_bt, r), bb = r - ri * G.bt;
      const int cls = fdiv(G.d_nlc, ri);
      const int q = (ri - cls * G.nlc) * G.s + cls;
      const int l = lbase + q;
      const bool ok = q < G.nl && l >= 0 && l < G.L && b0 + bb < G.B;
      const u16* src = x + (a * G.xa + (ok ? l : 0) * G.xl +
                            (ok ? b0 + bb : 0) * G.xb) * G.Ci + ci0 + 8 * c;
      stage_chunk(xs + (uint32_t)(r * S + (c ^ swz(r, S))) * 16, src,
                  ok ? nc - 8 * c : 0);
    }
  }
  // the g tile: row jj * bt + bb
  const int S = 1 << G.lg_sg, nc = min(G.cot, G.Co - co0);
  const int rows = G.jn * G.bt;
  for (int u = threadIdx.x; u < (rows << G.lg_sg); u += kThreads) {
    const int r = u >> G.lg_sg, c = u & (S - 1);
    const int jj = fdiv(G.d_bt, r), bb = r - jj * G.bt;
    const bool ok = j0 + jj < G.Lo && b0 + bb < G.B;
    const u16* src = g + (a * G.ga + (ok ? j0 + jj : 0) * G.gl +
                          (ok ? b0 + bb : 0) * G.gb) * G.Co + co0 + 8 * c;
    stage_chunk(gs + (uint32_t)(r * S + (c ^ swz(r, S))) * 16, src,
                ok ? nc - 8 * c : 0);
  }
}

// Block (chunk, M tile, N tile); warp (wmi, wni, kg) holds FM x FN
// m16n8 accumulators: m16 tiles wmi * FM + f of the block's M (m groups
// of 8 rows (t, 8 channels), two per m16 tile; with Ci = 1 the rows are
// the taps), n8 tiles wni * FN + f of its N.  A tap t = s tq + tr reads
// k-row r = jj bt + bb of a row tile at slab row (tr nlc + tq) bt + r:
// the offset of each of the warp's rows is fixed per launch.
template <int FM, int FN, bool CI1>
__global__ void __launch_bounds__(kThreads)
axis_dw_tc_kernel(const u16* __restrict__ x, const u16* __restrict__ g,
                  float* __restrict__ partials, const DwGeo G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wmi = warp % G.wm, wni = (warp / G.wm) % G.wn;
  const int kg = warp / (G.wm * G.wn);
  const int ci0 = blockIdx.y * G.cit, co0 = blockIdx.z * G.cot;
  const int t0 = blockIdx.x * G.tpc;
  const int ntiles = min(G.tpc, G.tiles - t0);
  const int x_bytes = CI1 ? G.s * G.nlc * G.xpitch * 2
                          : G.s * G.nlc * G.bt * G.cit * 2;
  const int stage_bytes = x_bytes + G.jn * G.bt * G.cot * 2;
  const uint32_t base = smem_u32(smem);
  const int cg8 = G.cit >> 3;                 // 8-channel groups per tap
  const int MG = CI1 ? G.k : G.k * cg8;       // m groups (CI1: M rows)
  const int MT = CI1 ? (G.k + 15) / 16 : (MG + 1) / 2;
  const int S = 1 << G.lg_sg;
  const int ksteps = G.jn * G.bt / 16;
  const bool do_db = G.with_bias && blockIdx.y == 0 && wmi == 0;
  const int grp = lane >> 2, qd = lane & 3, mat = lane >> 3;
  const uint32_t ones = 0x3F803F80u;  // two bf16 1.0
  const uint32_t ones_a[4] = {ones, ones, ones, ones};

  // this lane's A rows, per m16 tile: the slab row offset (and the 8-
  // channel group) of the rows its ldmatrix address serves; with Ci = 1
  // the x row offsets of taps grp and grp + 8 (-1: no such tap)
  int roff[FM][2], cgi[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) {
    const int m16 = wmi * FM + f;
    if constexpr (CI1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = m16 * 16 + grp + 8 * h;
        roff[f][h] = t < G.k ? ((t % G.s) * G.nlc + t / G.s) * G.xpitch : -1;
      }
      cgi[f] = 0;
    } else {
      int mg = 2 * m16 + (mat & 1);
      if (mg >= MG) mg = 0;  // the pad group: its rows are not stored
      const int t = mg / cg8;
      cgi[f] = mg - t * cg8;
      roff[f][0] = ((t % G.s) * G.nlc + t / G.s) * G.bt;
      roff[f][1] = 0;
    }
  }

  float acc[FM][FN][4], dacc[FN][4];
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int n = 0; n < FN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < FN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[n][e] = 0.f;

  for (int i = 0; i < G.stages - 1; ++i) {
    if (i < ntiles) {
      const uint32_t st = base + i * stage_bytes;
      dw_stage_tile<CI1>(x, g, st, st + x_bytes, G, t0 + i, ci0, co0);
    }
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait(G.stages - 2);
    __syncthreads();
    {
      const int nx = i + G.stages - 1;
      if (nx < ntiles) {
        const uint32_t st = base + (nx % G.stages) * stage_bytes;
        dw_stage_tile<CI1>(x, g, st, st + x_bytes, G, t0 + nx, ci0, co0);
      }
      cp_async_commit();
    }
    const uint32_t xs = base + (i % G.stages) * stage_bytes;
    const uint32_t gs = xs + x_bytes;
    for (int step = kg; step < ksteps; step += G.wk) {
      const int kk0 = step * 16;
      uint32_t bfr[FN][2];
      {
        const int r = kk0 + (lane & 15);
#pragma unroll
        for (int n = 0; n < FN; ++n) {
          const int nt = wni * FN + n;
          ldsm_x2_t(bfr[n][0], bfr[n][1],
                    gs + (uint32_t)(r * S + (nt ^ swz(r, S))) * 16);
        }
      }
      if (do_db) {
#pragma unroll
        for (int n = 0; n < FN; ++n)
          mma_bf16(dacc[n], ones_a, bfr[n][0], bfr[n][1]);
      }
      if constexpr (CI1) {
        // A[m = tap][k = row]: k-rows kk0 + 2 qd (+1) and + 8 (+1); a pair
        // shares its j (and is one 32-bit word) where bt is even
        int off[2][2];
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = kk0 + 2 * qd + 8 * kh + e;
            const int jj = fdiv(G.d_bt, r);
            off[kh][e] = jj * G.xpitch + (r - jj * G.bt);
          }
#pragma unroll
        for (int f = 0; f < FM; ++f) {
          if (wmi * FM + f >= MT) break;
          uint32_t af[4];
#pragma unroll
          for (int reg = 0; reg < 4; ++reg) {
            // reg: bit 0 = rows + 8, bit 1 = k + 8
            const int ro = roff[f][reg & 1], kh = reg >> 1;
            uint32_t v = 0;
            if (ro >= 0) {
              if ((G.bt & 1) == 0) {
                v = lds32(xs + (uint32_t)(ro + off[kh][0]) * 2);
              } else {
                v = (uint32_t)lds16(xs + (uint32_t)(ro + off[kh][0]) * 2) |
                    ((uint32_t)lds16(xs + (uint32_t)(ro + off[kh][1]) * 2)
                     << 16);
              }
            }
            af[reg] = v;
          }
#pragma unroll
          for (int n = 0; n < FN; ++n)
            mma_bf16(acc[f][n], af, bfr[n][0], bfr[n][1]);
        }
      } else {
        // ldmatrix.x4.trans: lanes 8 mat .. 8 mat + 7 give the rows of
        // matrix mat = (m half mat & 1, k half mat >> 1)
        const int r = kk0 + (mat >> 1) * 8 + (lane & 7);
#pragma unroll
        for (int f = 0; f < FM; ++f) {
          if (wmi * FM + f >= MT) break;
          const int row = roff[f][0] + r;
          uint32_t af[4];
          ldsm_x4_t(af, xs + (uint32_t)(row * cg8 +
                                        (cgi[f] ^ swz(row, cg8))) * 16);
#pragma unroll
          for (int n = 0; n < FN; ++n)
            mma_bf16(acc[f][n], af, bfr[n][0], bfr[n][1]);
        }
      }
    }
  }
  cp_async_wait(0);

  // this (chunk, group)'s slot of partial sums
  float* slot = partials + ((long long)blockIdx.x * G.wk + kg) * G.nout;
#pragma unroll
  for (int f = 0; f < FM; ++f) {
    const int m16 = wmi * FM + f;
    if (m16 >= MT) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m16 * 16 + grp + 8 * h;
      int t, ci;
      if constexpr (CI1) {
        t = m;
        ci = 0;
        if (t >= G.k) continue;
      } else {
        const int mg = m >> 3;
        if (mg >= MG) continue;
        t = mg / cg8;
        ci = ci0 + (mg - t * cg8) * 8 + (m & 7);
        if (ci >= G.Ci) continue;
      }
      float* row = slot + ((long long)t * G.Ci + ci) * G.Co;
#pragma unroll
      for (int n = 0; n < FN; ++n) {
        const int co = co0 + (wni * FN + n) * 8 + 2 * qd;
        if (co < G.Co) row[co] = acc[f][n][2 * h];
        if (co + 1 < G.Co) row[co + 1] = acc[f][n][2 * h + 1];
      }
    }
  }
  if (do_db && grp == 0) {
    float* db = slot + (long long)G.k * G.Ci * G.Co;
#pragma unroll
    for (int n = 0; n < FN; ++n) {
      const int co = co0 + (wni * FN + n) * 8 + 2 * qd;
      if (co < G.Co) db[co] = dacc[n][0];
      if (co + 1 < G.Co) db[co + 1] = dacc[n][1];
    }
  }
}

// pass 2: each output entry summed over the slots in slot order
__global__ void __launch_bounds__(kThreads)
axis_dw_tc_finish_kernel(const float* __restrict__ partials,
                         float* __restrict__ dw, float* __restrict__ db,
                         long long nw, long long n, long long nout,
                         int slots) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < slots; ++c) s += partials[(long long)c * nout + e];
  if (e < nw)
    dw[e] = s;
  else
    db[e - nw] = s;
}

// ---------------------------------------------------------------------------
// dx
// ---------------------------------------------------------------------------

// the plan of `conv_axis_dx_tc_plan`, with the shape
struct DxGeo {
  long long B;
  long long xa, xl, xb, ga, gl, gb;  // strides of (a, i, b) in channel rows
  int L, Lo, Ci, Co, k, s, p;
  int cit, cok, kst, wm, wn, bt, in_, U, jb, ng, itiles, btiles, tiles, tpb,
      stages, lg_s, lg_cit, lg_so;  // log2 of a g row's 16-byte chunks, of
                                    // cit, of an output row's chunks
  FastDiv d_bt, d_btiles, d_itiles, d_kst, d_rowsc;
};

// the weights w[t, ci0 .., co0 ..] as rows (t, ci - ci0) in shared
// memory, cok channels wide, swizzled
__device__ __forceinline__ void dx_stage_weights(const u16* __restrict__ w,
                                                 uint32_t ws, const DxGeo& G,
                                                 int co0, int ci0) {
  const int S = 1 << G.lg_s, nc = min(G.cok, G.Co - co0);
  const int wrows = G.k * G.cit;
  for (int u = threadIdx.x; u < (wrows << G.lg_s); u += kThreads) {
    const int r = u >> G.lg_s, c = u & (S - 1);
    const int t = r >> G.lg_cit, ci = ci0 + r - (t << G.lg_cit);
    const bool ok = ci < G.Ci;
    const u16* src = w + ((long long)t * G.Ci + (ok ? ci : 0)) * G.Co + co0 +
                     8 * c;
    stage_chunk(ws + (uint32_t)(r * S + (c ^ swz(r, S))) * 16, src,
                ok ? nc - 8 * c : 0);
  }
}

// the (tile, co-chunk) unit's g rows (jr, bb), j = i0 / s + jb + jr, in
// shared memory, cok channels wide, swizzled; and its weights, unless they
// stay resident (one co-chunk)
__device__ __forceinline__ void dx_stage_unit(const u16* __restrict__ g,
                                              const u16* __restrict__ w,
                                              uint32_t gs, uint32_t ws,
                                              const DxGeo& G, int tile,
                                              int cs, int ci0) {
  const int rem = fdiv(G.d_btiles, tile);
  const int bi = tile - rem * G.btiles;
  const int a = fdiv(G.d_itiles, rem);
  const int it = rem - a * G.itiles;
  const int jbase = it * G.U + G.jb, b0 = bi * G.bt;
  const int co0 = cs * G.cok;
  const int S = 1 << G.lg_s, nc = min(G.cok, G.Co - co0);
  const int rows = G.ng * G.bt;
  for (int u = threadIdx.x; u < (rows << G.lg_s); u += kThreads) {
    const int r = u >> G.lg_s, c = u & (S - 1);
    const int jr = fdiv(G.d_bt, r), bb = r - jr * G.bt;
    const int j = jbase + jr;
    const bool ok = j >= 0 && j < G.Lo && b0 + bb < G.B;
    const u16* src = g + (a * G.ga + (ok ? j : 0) * G.gl +
                          (ok ? b0 + bb : 0) * G.gb) * G.Co + co0 + 8 * c;
    stage_chunk(gs + (uint32_t)(r * S + (c ^ swz(r, S))) * 16, src,
                ok ? nc - 8 * c : 0);
  }
  if (G.kst > 1) dx_stage_weights(w, ws, G, co0, ci0);
}

// Block (tile group, ci tile); warp (wmi, wni) holds FM x FN m16n8
// accumulators: m16 tiles wmi * FM + f of the tile's M = (class, u, bb)
// rows, n8 tiles wni * FN + f of its cit channels.  Units (tile, co-chunk)
// pass through the ring; a tile's outputs are stored after its last chunk.
// Everything about a warp's rows but the tile origin is fixed per launch
// and computed once: the class and taps of each m16 tile, this lane's A
// row for tap 0, the (i, b) offsets of the rows it stores.
template <int FM, int FN>
__global__ void __launch_bounds__(kThreads)
axis_dx_tc_kernel(const u16* __restrict__ g, const u16* __restrict__ w,
                  u16* __restrict__ dx, const DxGeo G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wmi = warp % G.wm, wni = warp / G.wm;
  const int ci0 = blockIdx.y * G.cit;
  const int t0 = blockIdx.x * G.tpb;
  const int nunits = min(G.tpb, G.tiles - t0) * G.kst;
  // shared memory: [weights, one co-chunk] [ring of stages: g rows (and
  // the chunk's weights, several co-chunks)] [the output tile] [16 zero
  // bytes: the rows of the pad K groups]
  const int g_bytes = G.ng * G.bt * G.cok * 2;
  const int w_bytes = G.k * G.cit * G.cok * 2;
  const bool wres = G.kst == 1;
  const int stage_bytes = g_bytes + (wres ? 0 : w_bytes);
  const uint32_t wsres = smem_u32(smem);
  const uint32_t base = wsres + (wres ? w_bytes : 0);
  const uint32_t outs = base + G.stages * stage_bytes;
  const uint32_t zero = outs + G.in_ * G.bt * G.cit * 2;
  if (wres) dx_stage_weights(w, wsres, G, 0, ci0);  // in the first group
  if (threadIdx.x < 4)
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(zero + 4 * threadIdx.x),
                 "r"(0u)
                 : "memory");
  const int S = 1 << G.lg_s;
  const int rows_c = G.U * G.bt;        // M rows per class
  const int MT = G.s * rows_c / 16;
  const int grp = lane >> 2, qd = lane & 3, mat = lane >> 3;

  int arow[FM], tap0[FM], ntap[FM], orow[FM][2];
#pragma unroll
  for (int f = 0; f < FM; ++f) {
    const int m16 = wmi * FM + f;
    const int c = m16 * 16 / rows_c, mc = m16 * 16 - c * rows_c;
    const int tc = (c + G.p) % G.s, cp = (c + G.p) / G.s;
    tap0[f] = tc;
    ntap[f] = m16 < MT && tc < G.k ? (G.k - tc + G.s - 1) / G.s : 0;
    const int m = mc + (mat & 1) * 8 + (lane & 7);
    const int u = m / G.bt;
    arow[f] = (u + cp - G.jb) * G.bt + (m - u * G.bt);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ms = mc + grp + 8 * h, us = ms / G.bt;
      orow[f][h] = ((c + G.s * us) << 16) | (ms - us * G.bt);
    }
  }

  // whether the warp's tiles share one class, hence one tap list
  bool uniform = true;
#pragma unroll
  for (int f = 1; f < FM; ++f)
    if (wmi * FM + f < MT && (tap0[f] != tap0[0] || ntap[f] != ntap[0]))
      uniform = false;

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
      dx_stage_unit(g, w, st, st + g_bytes, G, t0 + tq, i - tq * G.kst, ci0);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nunits; ++i) {
    cp_async_wait(G.stages - 2);
    __syncthreads();
    {
      const int nx = i + G.stages - 1;
      if (nx < nunits) {
        const uint32_t st = base + (nx % G.stages) * stage_bytes;
        const int tq = fdiv(G.d_kst, nx);
        dx_stage_unit(g, w, st, st + g_bytes, G, t0 + tq, nx - tq * G.kst,
                      ci0);
      }
      cp_async_commit();
    }
    const uint32_t gs = base + (i % G.stages) * stage_bytes;
    const uint32_t ws = wres ? wsres : gs + g_bytes;
    const int tq = fdiv(G.d_kst, i), cs = i - tq * G.kst;
    const int nq = min(S, (G.Co - cs * G.cok + 7) >> 3);  // live co groups
    if (uniform) {
      // one tap list for the warp's tiles: each step's B fragments once
      const int nk8 = ntap[0] * nq;
      int v0 = 0, c0 = 0;
      for (int k8 = 0; k8 < nk8; k8 += 2) {
        int v1 = v0, c1 = c0 + 1;
        if (c1 == nq) {
          c1 = 0;
          ++v1;
        }
        uint32_t bfr[FN][2];
        {
          const bool hb = (lane >> 3) & 1;
          const int vb = hb ? v1 : v0, cb = hb ? c1 : c0;
          const int wrow0 = (tap0[0] + G.s * vb) * G.cit + (lane & 7);
#pragma unroll
          for (int n = 0; n < FN; ++n) {
            uint32_t addr = zero;
            if (k8 + hb < nk8) {
              const int row = wrow0 + (wni * FN + n) * 8;
              addr = ws + (uint32_t)(row * S + (cb ^ swz(row, S))) * 16;
            }
            ldsm_x2(bfr[n][0], bfr[n][1], addr);
          }
        }
        const bool hi = mat >> 1;
        const int v = hi ? v1 : v0, cc = hi ? c1 : c0;
        const bool live = k8 + hi < nk8;
#pragma unroll
        for (int f = 0; f < FM; ++f) {
          if (wmi * FM + f >= MT) break;
          uint32_t af[4];
          uint32_t addr = zero;
          if (live) {
            const int row = arow[f] - v * G.bt;
            addr = gs + (uint32_t)(row * S + (cc ^ swz(row, S))) * 16;
          }
          ldsm_x4(af, addr);
#pragma unroll
          for (int n = 0; n < FN; ++n)
            mma_bf16(acc[f][n], af, bfr[n][0], bfr[n][1]);
        }
        v0 = v1;
        c0 = c1 + 1;
        if (c0 == nq) {
          c0 = 0;
          ++v0;
        }
      }
    } else {
#pragma unroll
      for (int f = 0; f < FM; ++f) {
        const int nk8 = ntap[f] * nq;
        // K groups k8 = v nq + cc, two a step: (v0, c0) and the next one
        int v0 = 0, c0 = 0;
        for (int k8 = 0; k8 < nk8; k8 += 2) {
          int v1 = v0, c1 = c0 + 1;
          if (c1 == nq) {
            c1 = 0;
            ++v1;
          }
          uint32_t af[4];
          {
            const bool hi = mat >> 1;
            const int v = hi ? v1 : v0, cc = hi ? c1 : c0;
            uint32_t addr = zero;
            if (k8 + hi < nk8) {
              const int row = arow[f] - v * G.bt;
              addr = gs + (uint32_t)(row * S + (cc ^ swz(row, S))) * 16;
            }
            ldsm_x4(af, addr);
          }
          const bool hb = (lane >> 3) & 1;
          const int vb = hb ? v1 : v0, cb = hb ? c1 : c0;
          const bool live = k8 + hb < nk8;
          const int wrow0 = (tap0[f] + G.s * vb) * G.cit + (lane & 7);
#pragma unroll
          for (int n = 0; n < FN; ++n) {
            uint32_t b0, b1;
            uint32_t addr = zero;
            if (live) {
              const int row = wrow0 + (wni * FN + n) * 8;
              addr = ws + (uint32_t)(row * S + (cb ^ swz(row, S))) * 16;
            }
            ldsm_x2(b0, b1, addr);
            mma_bf16(acc[f][n], af, b0, b1);
          }
          v0 = v1;
          c0 = c1 + 1;
          if (c0 == nq) {
            c0 = 0;
            ++v0;
          }
        }
      }
    }
    if (cs == G.kst - 1) {
      // the tile's outputs, rounded once to bf16, through shared memory:
      // the fragments into the output tile (row m of cit channels in
      // swizzled 16-byte chunks), then out to dx in 16-byte pieces
      const int So = G.cit >> 3;
#pragma unroll
      for (int f = 0; f < FM; ++f) {
        if (wmi * FM + f >= MT) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (wmi * FM + f) * 16 + grp + 8 * h;
#pragma unroll
          for (int n = 0; n < FN; ++n) {
            const int nt = wni * FN + n;
            const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                acc[f][n][2 * h], acc[f][n][2 * h + 1]);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             outs + (uint32_t)(m * So + (nt ^ swz(m, So))) *
                                        16 + 4 * qd),
                         "r"(*reinterpret_cast<const uint32_t*>(&v2))
                         : "memory");
          }
        }
      }
      __syncthreads();
      const int tile = t0 + tq;
      const int rem = fdiv(G.d_btiles, tile);
      const int bi = tile - rem * G.btiles;
      const int a = fdiv(G.d_itiles, rem);
      const int i0 = (rem - a * G.itiles) * G.in_, b0 = bi * G.bt;
      const long long arow0 = a * G.xa;
      const int live = min(So, (G.Ci - ci0 + 7) >> 3);  // 8-channel chunks
      for (int u = threadIdx.x; u < ((MT * 16) << G.lg_so); u += kThreads) {
        const int m = u >> G.lg_so, c = u & (So - 1);
        const int cl = fdiv(G.d_rowsc, m), r = m - cl * rows_c;
        const int uu = fdiv(G.d_bt, r), bb = r - uu * G.bt;
        const int ii = i0 + cl + G.s * uu, b = b0 + bb;
        if (c >= live || ii >= G.L || b >= G.B) continue;
        uint32_t v[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "r"(outs + (uint32_t)(m * So + (c ^ swz(m, So))) * 16));
        u16* o = dx + (arow0 + ii * G.xl + b * G.xb) * G.Ci + ci0 + 8 * c;
        const int nc = min(8, G.Ci - ci0 - 8 * c);
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
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int FM, int FN, bool CI1>
int launch_dw(const u16* x, const u16* g, float* partials, const DwGeo& G,
              dim3 grid, size_t smem, cudaStream_t stream) {
  auto kern = axis_dw_tc_kernel<FM, FN, CI1>;
  const int rc = set_smem(kern, smem);
  if (rc) return rc;
  kern<<<grid, kThreads, smem, stream>>>(x, g, partials, G);
  return (int)cudaGetLastError();
}

template <int FM, bool CI1>
int launch_dw_fn(int fn, const u16* x, const u16* g, float* partials,
                 const DwGeo& G, dim3 grid, size_t smem, cudaStream_t s) {
  switch (fn) {
    case 1: return launch_dw<FM, 1, CI1>(x, g, partials, G, grid, smem, s);
    case 2: return launch_dw<FM, 2, CI1>(x, g, partials, G, grid, smem, s);
    case 4: return launch_dw<FM, 4, CI1>(x, g, partials, G, grid, smem, s);
  }
  return -4;
}

template <int FM, int FN>
int launch_dx(const u16* g, const u16* w, u16* dx, const DxGeo& G,
              dim3 grid, size_t smem, cudaStream_t stream) {
  auto kern = axis_dx_tc_kernel<FM, FN>;
  const int rc = set_smem(kern, smem);
  if (rc) return rc;
  kern<<<grid, kThreads, smem, stream>>>(g, w, dx, G);
  return (int)cudaGetLastError();
}

// warp tiles of at most 8 m16n8 accumulators
template <int FM>
int launch_dx_fn(int fn, const u16* g, const u16* w, u16* dx,
                 const DxGeo& G, dim3 grid, size_t smem, cudaStream_t s) {
  switch (fn) {
    case 1: return launch_dx<FM, 1>(g, w, dx, G, grid, smem, s);
    case 2:
      if constexpr (FM <= 4) return launch_dx<FM, 2>(g, w, dx, G, grid, smem,
                                                     s);
      break;
    case 4:
      if constexpr (FM <= 2) return launch_dx<FM, 4>(g, w, dx, G, grid, smem,
                                                     s);
      break;
  }
  return -4;
}

}  // namespace mri

// x viewed as (A, L, B, Ci), g as (A, Lo, B, Co), both bf16; dw (k, Ci, Co)
// and db (Co,) or null in float32; partials: slots x nout floats of
// scratch.  geo: the shape and `conv_axis_dw_tc_plan`, in the order of
// `ops/cuda_kernels.py::DwTcPlan`.  Two launches on `stream`; returns the
// first CUDA error, 0 on success, -4 for a plan it does not serve.
extern "C" int mri_conv_axis_dw_tc(const void* x, const void* g, void* dw,
                                   void* db, void* partials,
                                   const long long* geo, int ngeo,
                                   void* stream) {
  if (ngeo != 32) return -4;
  mri::DwGeo G;
  const long long* v = geo;
  const long long tiles = v[23], chunks = v[25], mtiles = v[26],
                  ntiles = v[27];
  G.L = (int)v[1]; G.Lo = (int)v[2]; G.B = v[3];
  G.Ci = (int)v[4]; G.Co = (int)v[5]; G.k = (int)v[6]; G.s = (int)v[7];
  G.p = (int)v[8]; G.cit = (int)v[9]; G.cot = (int)v[10];
  G.wm = (int)v[11]; G.wn = (int)v[12]; G.wk = (int)v[13];
  const int fm = (int)v[14], fn = (int)v[15];
  G.bt = (int)v[16]; G.jn = (int)v[17]; G.nl = (int)v[18];
  G.nlc = (int)v[19]; G.xpitch = (int)v[20]; G.jtiles = (int)v[21];
  G.btiles = (int)v[22]; G.tiles = (int)tiles; G.tpc = (int)v[24];
  G.stages = (int)v[28];
  const size_t smem = (size_t)v[29];
  const bool ci1 = v[30] != 0, swap = v[31] != 0;
  G.nout = (long long)G.k * G.Ci * G.Co + G.Co;
  // swapped: the caller's (A, L, 1) rows as (1, L, A), a = 0
  G.xa = swap ? 0 : G.L * G.B;
  G.xl = swap ? 1 : G.B;
  G.xb = swap ? G.L : 1;
  G.ga = swap ? 0 : G.Lo * G.B;
  G.gl = swap ? 1 : G.B;
  G.gb = swap ? G.Lo : 1;
  G.with_bias = db != nullptr;
  G.lg_sx = mri::log2_of(G.cit / 8);
  G.lg_sg = mri::log2_of(G.cot / 8);
  G.d_bt = mri::make_div(G.bt);
  G.d_nlc = mri::make_div(G.nlc);
  G.d_btiles = mri::make_div(G.btiles);
  G.d_jtiles = mri::make_div(G.jtiles);
  // the ring as the kernel lays it out: per stage the x slab, then g
  const size_t x_bytes = ci1 ? (size_t)G.s * G.nlc * G.xpitch * 2
                             : (size_t)G.s * G.nlc * G.bt * G.cit * 2;
  const size_t stage_bytes = x_bytes + (size_t)G.jn * G.bt * G.cot * 2;
  if (G.wm * G.wn * G.wk != 8 || G.stages < 2 || G.stages > 5 ||
      smem < (size_t)G.stages * stage_bytes ||
      chunks * G.tpc < tiles || tiles >= (1LL << 31) || mtiles > 65535 ||
      ntiles > 65535 || (G.jn * G.bt) % 16 || smem > 232448 ||
      ci1 != (G.Ci == 1) || (ci1 && swap) ||
      (!ci1 && (8 << G.lg_sx) != G.cit) ||
      (8 << G.lg_sg) != G.cot ||
      (long long)G.s * G.nlc * G.bt * (ci1 ? 1 : G.cit) >= (1LL << 30))
    return -4;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)chunks, (unsigned)mtiles, (unsigned)ntiles);
  const auto* xp = (const mri::u16*)x;
  const auto* gp = (const mri::u16*)g;
  float* pp = (float*)partials;
  int rc;
  if (ci1) {
    rc = fm == 1 ? mri::launch_dw_fn<1, true>(fn, xp, gp, pp, G, grid, smem,
                                              s)
                 : -4;
  } else {
    switch (fm) {
      case 1: rc = mri::launch_dw_fn<1, false>(fn, xp, gp, pp, G, grid, smem,
                                               s); break;
      case 2: rc = mri::launch_dw_fn<2, false>(fn, xp, gp, pp, G, grid, smem,
                                               s); break;
      case 3: rc = mri::launch_dw_fn<3, false>(fn, xp, gp, pp, G, grid, smem,
                                               s); break;
      case 4: rc = mri::launch_dw_fn<4, false>(fn, xp, gp, pp, G, grid, smem,
                                               s); break;
      default: rc = -4;
    }
  }
  if (rc != 0) return rc;
  const long long nw = (long long)G.k * G.Ci * G.Co;
  const long long n = G.with_bias ? G.nout : nw;
  const unsigned blocks = (unsigned)((n + mri::kThreads - 1) / mri::kThreads);
  mri::axis_dw_tc_finish_kernel<<<blocks, mri::kThreads, 0, s>>>(
      pp, (float*)dw, (float*)db, nw, n, G.nout, (int)(chunks * G.wk));
  return (int)cudaGetLastError();
}

// g viewed as (A, Lo, B, Co), w (k, Ci, Co), dx (A, L, B, Ci), all bf16.
// geo: the shape and `conv_axis_dx_tc_plan`, in the order of
// `ops/cuda_kernels.py::DxTcPlan`.  One launch on `stream`; returns the
// CUDA error of the launch, 0 on success, -4 for a plan it does not serve.
extern "C" int mri_conv_axis_dx_tc(const void* g, const void* w, void* dx,
                                   const long long* geo, int ngeo,
                                   void* stream) {
  if (ngeo != 29) return -4;
  mri::DxGeo G;
  const long long* v = geo;
  const long long tiles = v[23], blocks = v[25], ctiles = v[26];
  G.L = (int)v[1]; G.Lo = (int)v[2]; G.B = v[3];
  G.Ci = (int)v[4]; G.Co = (int)v[5]; G.k = (int)v[6]; G.s = (int)v[7];
  G.p = (int)v[8]; G.cit = (int)v[9]; G.cok = (int)v[10];
  G.kst = (int)v[11]; G.wm = (int)v[12]; G.wn = (int)v[13];
  const int fm = (int)v[14], fn = (int)v[15];
  G.bt = (int)v[16]; G.in_ = (int)v[17]; G.U = (int)v[18];
  G.jb = (int)v[19]; G.ng = (int)v[20]; G.itiles = (int)v[21];
  G.btiles = (int)v[22]; G.tiles = (int)tiles; G.tpb = (int)v[24];
  G.stages = (int)v[27];
  const bool swap = v[28] != 0;
  // swapped: the caller's (A, L, 1) rows as (1, L, A), a = 0
  G.xa = swap ? 0 : G.L * G.B;
  G.xl = swap ? 1 : G.B;
  G.xb = swap ? G.L : 1;
  G.ga = swap ? 0 : G.Lo * G.B;
  G.gl = swap ? 1 : G.B;
  G.gb = swap ? G.Lo : 1;
  G.lg_s = mri::log2_of(G.cok / 8);
  G.lg_cit = mri::log2_of(G.cit);
  G.lg_so = G.lg_cit - 3;
  G.d_bt = mri::make_div(G.bt);
  G.d_btiles = mri::make_div(G.btiles);
  G.d_itiles = mri::make_div(G.itiles);
  G.d_kst = mri::make_div(G.kst);
  G.d_rowsc = mri::make_div(G.U * G.bt);
  const size_t g_bytes = (size_t)G.ng * G.bt * G.cok * 2;
  const size_t w_bytes = (size_t)G.k * G.cit * G.cok * 2;
  const size_t out_bytes = (size_t)G.in_ * G.bt * G.cit * 2;
  const size_t smem = out_bytes + 16 +
                      (G.kst == 1 ? w_bytes + G.stages * g_bytes
                                  : G.stages * (g_bytes + w_bytes));
  if (G.wm * G.wn != 8 || G.stages < 2 || G.stages > 5 ||
      blocks * G.tpb < tiles || tiles * G.kst >= (1LL << 31) ||
      ctiles > 65535 || (G.U * G.bt) % 16 || G.in_ != G.s * G.U ||
      smem > 232448 || (8 << G.lg_s) != G.cok || (1 << G.lg_cit) != G.cit ||
      G.in_ >= 32768)
    return -4;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks, (unsigned)ctiles);
  const auto* gp = (const mri::u16*)g;
  const auto* wp = (const mri::u16*)w;
  auto* op = (mri::u16*)dx;
  switch (fm) {
    case 1: return mri::launch_dx_fn<1>(fn, gp, wp, op, G, grid, smem, s);
    case 2: return mri::launch_dx_fn<2>(fn, gp, wp, op, G, grid, smem, s);
    case 4: return mri::launch_dx_fn<4>(fn, gp, wp, op, G, grid, smem, s);
    case 8: return mri::launch_dx_fn<8>(fn, gp, wp, op, G, grid, smem, s);
  }
  return -4;
}
