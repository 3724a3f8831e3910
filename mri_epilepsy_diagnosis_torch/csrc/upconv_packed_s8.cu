// K2: the composed decoder up-conv in int8, for the int8 serving path of the
// packed UNet3D (`models/unet_packed_q.py`), on Hopper tensor cores: the 8
// output parity classes as row classes of the int8 implicit GEMM with
// wgmma fed by TMA (`s8_wgmma.cuh`), in one persistent launch.
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
// (rd, rh, rw) is a pad-0 dense conv over xe with a (2 + rd) x (2 + rh) x
// (2 + rw) tap box, on a (Sc + 1 - rd) x ... grid of rows, written to
// output cells 2p + r: 2.5^3 ~ 15.6 taps per cell where the dilated form
// has 125.  Its A tile for tap j is one TMA box at p + j, inside xe for
// every row of the class grid; each stored row goes to output cell
// 2p + r with 16-byte int32 stores (a TMA store cannot write the stride-2
// pattern).  The classes' weights are tap-major, (taps, 8Co, 8Ci) each,
// concatenated in class order c = 4 rd + 2 rh + rw: one 2-D tensor map of
// 125 x 8Co rows, class c starting at its first tap's row
// (ops/cuda_kernels.py::upconv_s8_plan and upconv_s8_weights build both).
//
// Schedule: the classes' K ranges from 8 x 8Ci to 27 x 8Ci, so the work
// items are numbered heaviest class first (the 27-tap class 7, the
// 18-tap classes 3, 5, 6, the 12-tap classes 1, 2, 4, the 8-tap class 0
// last: `kClassOrder`, the order of `upconv_s8_tc_plan`), and the
// persistent blocks take them with a stride of the grid, so the light
// classes fill the tail.
//
// Bound on the H100: operations (the d0 and d1 sites of the 192^3 trunk
// do thousands of int8 operations per byte they must move).
//
// Requires 8Ci % 64 == 0 and 8Co % 64 == 0, contiguous tensors and
// 16-byte-aligned base pointers (checked by the Python wrapper,
// ops/cuda_kernels.py::upconv_packed_s8).
#include "s8_wgmma.cuh"

namespace mri {
namespace tc {

constexpr int kClassOrder[8] = {7, 3, 5, 6, 1, 2, 4, 0};

}  // namespace tc
}  // namespace mri

// K2.  xe: (n, dp, hp, wp, c8i) int8, the edge-padded coarse cells; w: the
// 8 classes' tap-major weights concatenated (class c = 4 rd + 2 rh + rw:
// (taps, c8o, c8i), tap t = (jd th + jh) tw + jw holding
// wk[2 jd + 1 - rd, 2 jh + 1 - rh, 2 jw + 1 - rw]); out: (n, 2 dp - 3,
// 2 hp - 3, 2 wp - 3, c8o) int32.  The box (bw, bh, bd), N tile bn and K
// step kb (bytes) come from the wrapper.  Launches on `stream`; returns
// cudaGetLastError() after the launch, or a negative code if the launch
// was refused on the host.
extern "C" int mri_upconv_packed_s8(const void* xe, const void* w, void* out,
                                    long long n, int dp, int hp, int wp,
                                    int c8i, int c8o, int bw, int bh, int bd,
                                    int bn, int kb, void* stream) {
  using namespace mri::tc;
  if (dp < 3 || hp < 3 || wp < 3) return kErrPlan;
  S8Launch L{};
  L.C8i = c8i;
  L.C8o = c8o;
  L.pad = 0;
  L.so = 2;
  L.Do = 2 * dp - 3;
  L.Ho = 2 * hp - 3;
  L.Wo = 2 * wp - 3;
  L.nclasses = 8;
  int tap0[8], taps = 0;
  for (int c = 0; c < 8; ++c) {
    tap0[c] = taps;
    taps += (2 + (c >> 2)) * (2 + ((c >> 1) & 1)) * (2 + (c & 1));
  }
  for (int i = 0; i < 8; ++i) {
    const int c = kClassOrder[i];
    S8Class& k = L.cls[i];
    k.rd = c >> 2;
    k.rh = (c >> 1) & 1;
    k.rw = c & 1;
    k.Pd = dp - 1 - k.rd;
    k.Ph = hp - 1 - k.rh;
    k.Pw = wp - 1 - k.rw;
    k.td = 2 + k.rd;
    k.th = 2 + k.rh;
    k.tw = 2 + k.rw;
    k.tap0 = tap0[c];
  }
  int rc = s8_plan(L, n, bw, bh, bd, bn, kb);
  if (rc != 0) return rc;
  if (L.items == 0) return (int)cudaSuccess;
  CUtensorMap xm, wm;
  rc = s8_tensor_maps(&xm, &wm, xe, n, dp, hp, wp, c8i, bw, bh, bd, w,
                      taps * c8o, bn, kb);
  if (rc != 0) return rc;
  return s8_launch<false, true>(xm, wm, out, L, S8Epi{}, bn, kb,
                               static_cast<cudaStream_t>(stream));
}
