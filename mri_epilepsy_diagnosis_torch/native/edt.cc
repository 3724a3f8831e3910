// Exact 3D euclidean distance transform (squared-parabola lower envelope,
// Felzenszwalb & Huttenlocher), with anisotropic voxel spacing.
//
// Native replacement for the scipy.ndimage C routine the reference's
// surface-distance metrics depend on (`segmentation/metrics.py:140-147`).
// Exposed through ctypes (no pybind11 in this image); built on demand by
// `native/__init__.py`.
//
// Layout: row-major (d, h, w).  Input: nonzero = feature ("on") voxels.
// Output: euclidean distance in physical units from every voxel to the
// nearest feature voxel (0 inside features, inf if the mask is empty).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
// finite stand-in for "no feature on this line": far larger than any real
// squared distance in a volume, small enough that parabola arithmetic stays
// well-behaved
constexpr double kFar = 1e30;

// 1-D squared distance transform along n samples with grid step `step`.
// f: finite squared distances (kFar for "empty").  out: transformed values.
void dt1d(const double* f, double* out, int n, double step, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  const double s2 = step * step;
  for (int q = 1; q < n; ++q) {
    double s;
    while (true) {
      s = ((f[q] + s2 * q * q) - (f[v[k]] + s2 * v[k] * v[k])) /
          (2.0 * s2 * (q - v[k]));
      if (s <= z[k] && k > 0) {
        --k;
      } else {
        break;
      }
    }
    if (s <= z[k]) {  // k == 0: new parabola dominates everywhere
      v[0] = q;
      z[0] = -kInf;
      z[1] = kInf;
      k = 0;
    } else {
      ++k;
      v[k] = q;
      z[k] = s;
      z[k + 1] = kInf;
    }
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    const double dq = step * (q - v[k]);
    out[q] = dq * dq + f[v[k]];
  }
}

}  // namespace

extern "C" {

// mask: d*h*w uint8 (nonzero = feature).  spacing: 3 doubles.  out: d*h*w.
void edt3d(const uint8_t* mask, int d, int h, int w, const double* spacing,
           double* out) {
  const int64_t n = static_cast<int64_t>(d) * h * w;
  bool any_feature = false;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = mask[i] ? 0.0 : kFar;
    any_feature |= (mask[i] != 0);
  }
  if (!any_feature) {
    for (int64_t i = 0; i < n; ++i) out[i] = kInf;
    return;
  }

  const int max_dim = std::max(d, std::max(h, w));
  std::vector<double> f(max_dim), g(max_dim);
  std::vector<int> v(max_dim);
  std::vector<double> z(max_dim + 1);

  // pass 1: along w (contiguous)
  for (int64_t x = 0; x < static_cast<int64_t>(d) * h; ++x) {
    double* line = out + x * w;
    dt1d(line, g.data(), w, spacing[2], v.data(), z.data());
    std::copy(g.data(), g.data() + w, line);
  }

  // pass 2: along h
  for (int x = 0; x < d; ++x) {
    for (int y = 0; y < w; ++y) {
      double* base = out + static_cast<int64_t>(x) * h * w + y;
      for (int q = 0; q < h; ++q) f[q] = base[static_cast<int64_t>(q) * w];
      dt1d(f.data(), g.data(), h, spacing[1], v.data(), z.data());
      for (int q = 0; q < h; ++q) base[static_cast<int64_t>(q) * w] = g[q];
    }
  }

  // pass 3: along d
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t yz = 0; yz < hw; ++yz) {
    double* base = out + yz;
    for (int q = 0; q < d; ++q) f[q] = base[q * hw];
    dt1d(f.data(), g.data(), d, spacing[0], v.data(), z.data());
    for (int q = 0; q < d; ++q) base[q * hw] = g[q];
  }

  for (int64_t i = 0; i < n; ++i) out[i] = std::sqrt(out[i]);
}

}  // extern "C"
