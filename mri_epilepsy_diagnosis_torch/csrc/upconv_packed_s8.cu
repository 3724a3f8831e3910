// K2: the composed decoder up-conv in int8, for the int8 serving path of the
// packed UNet3D (`models/unet_packed_q.py`).
//
// Replaces: mri_epilepsy_diagnosis_tpu/models/unet_packed_q.py
//   `upconv_int8` (:76, `lax.conv_general_dilated(int8, int8) -> int32`
//   with lhs_dilation 2 in XLA): the trilinear 2x upsample and the fine
//   k=3 conv composed into one 5^3 kernel over packed cells
//   (ops/packed.py::upconv_packed, pack_upconv_weights).
//
// What it computes: with xe = edge_pad_cells(x8) (N, Sc+2, ..., 8Ci) and
// the composed kernel wk (5, 5, 5, 8Ci, 8Co), the lhs-dilated conv of
// stride 1 and padding 1,
//   out[o] = sum_k [o + k - 1 even] xe[(o + k - 1) / 2] @ wk[k]  per axis,
// for o in [0, 2Sc]: (N, 2Sc+1, ..., 8Co) int32.  The dilation's zeros
// are never computed: the output splits by cell parity per axis.  An even
// output cell o = 2p meets the 2 odd kernel taps k = 1 + 2j (j = 0, 1),
// reading xe[p + j]; an odd one o = 2p + 1 the 3 even taps k = 2j
// (j = 0, 1, 2), reading xe[p + j].  So each of the 8 parity classes
// (rd, rh, rw) is a dense conv over xe with a (2 + rd) x (2 + rh) x
// (2 + rw) tap box, on a (Sc + 1 - rd) x ... grid of rows, written to
// output cells 2p + r: 2.5^3 ~ 15.6 taps per cell where the dilated form
// has 125.  One launch serves all 8 classes (blockIdx.z); each class's
// weights are its taps' (8Co, taps x 8Ci) K-major matrix, the classes
// concatenated in the order c = 4 rd + 2 rh + rw (ops/cuda_kernels.py::
// upconv_s8_plan and upconv_s8_weights build both).
//
// Bound on the H100: operations (the d0 and d1 sites of the 192^3 trunk
// do thousands of int8 operations per byte they must move).  The classes
// run the shared mma.sync m16n8k32 implicit GEMM of s8_igemm.cuh: right
// and simple, not yet fed by TMA or wgmma.
//
// Requires 8Ci % 8 == 0 and 8Co % 8 == 0, contiguous tensors and
// 16-byte-aligned base pointers (checked by the Python wrapper,
// ops/cuda_kernels.py::upconv_packed_s8).
#include "s8_igemm.cuh"

namespace mri {
namespace s8 {

struct Classes {
  Geometry g[8];
};

__global__ void __launch_bounds__(kThreads)
upconv_packed_s8_kernel(const int8_t* __restrict__ xe, const Classes cls,
                        int* __restrict__ out) {
  const Geometry& g = cls.g[blockIdx.z];
  const long long m0 = (long long)blockIdx.x * kBM;
  if (m0 >= g.M) return;  // the whole block: this class has fewer rows
  const int n0 = blockIdx.y * kBN;
  int acc[2][4][4];
  mainloop(xe, g, m0, n0, acc);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const Row r = decode_row(g, m0 + acc_row(mi, 2 * half));
      if (!r.ok) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = n0 + acc_col(ni, 2 * half);
        if (co >= g.C8o) continue;
        const int* v = &acc[mi][ni][2 * half];
        *reinterpret_cast<int2*>(out + r.out * g.C8o + co) =
            make_int2(v[0], v[1]);
      }
    }
  }
}

}  // namespace s8
}  // namespace mri

// K2.  xe: (n, dp, hp, wp, c8i) int8, the edge-padded coarse cells; w: the
// 8 classes' K-major weights concatenated (class c = 4 rd + 2 rh + rw:
// (c8o, (2 + rd)(2 + rh)(2 + rw) c8i), tap t = (jd th + jh) tw + jw holding
// wk[2 jd + 1 - rd, 2 jh + 1 - rh, 2 jw + 1 - rw]); out: (n, 2 dp - 3,
// 2 hp - 3, 2 wp - 3, c8o) int32.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int mri_upconv_packed_s8(const void* xe, const void* w, void* out,
                                    long long n, int dp, int hp, int wp,
                                    int c8i, int c8o, void* stream) {
  using namespace mri::s8;
  if (c8i % 8 || c8o % 8 || dp < 3 || hp < 3 || wp < 3)
    return (int)cudaErrorInvalidValue;
  Classes cls;
  long long offset = 0, max_rows = 0;
  for (int c = 0; c < 8; ++c) {
    const int rd = c >> 2, rh = (c >> 1) & 1, rw = c & 1;
    Geometry& g = cls.g[c];
    g.Di = dp; g.Hi = hp; g.Wi = wp; g.C8i = c8i;
    g.Do = 2 * dp - 3; g.Ho = 2 * hp - 3; g.Wo = 2 * wp - 3; g.C8o = c8o;
    g.Pd = dp - 1 - rd; g.Ph = hp - 1 - rh; g.Pw = wp - 1 - rw;
    g.M = n * g.Pd * g.Ph * (long long)g.Pw;
    g.td = 2 + rd; g.th = 2 + rh; g.tw = 2 + rw;
    g.pad = 0;
    g.K = g.td * g.th * g.tw * c8i;
    g.so = 2; g.rd = rd; g.rh = rh; g.rw = rw;
    g.w = static_cast<const int8_t*>(w) + offset;
    offset += (long long)c8o * g.K;
    if (g.M > max_rows) max_rows = g.M;
  }
  if (max_rows <= 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((max_rows + kBM - 1) / kBM), (c8o + kBN - 1) / kBN, 8);
  upconv_packed_s8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(xe), cls, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
