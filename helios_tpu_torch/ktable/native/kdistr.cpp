// Native accelerators for the ktable pipeline hot loops.
//
// The reference uses runtime-compiled CUDA for the solver and a numba-jit
// kernel for the table combination (ktable/source_ktable/combination.py:
// 189-281); here the offline pipeline's hot loops are plain C++ compiled
// once into a shared library and driven through ctypes:
//
//  * kdistr_tp     -- per-(T,P) k-distribution construction: per-bin sort
//                     of kappa with trapezoid weights and linear rebinning
//                     onto the Gauss y-points
//                     (build_individual_opacities.py:438-494 semantics)
//  * bilinear_tp   -- edge-clamped bilinear (T, log10 P) interpolation of
//                     a [nt, np, inner] table onto a new grid
//                     (combination.py:189-281 semantics)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

const double MIN_OPAC = 1e-15;

}  // namespace

extern "C" {

// lamda_hk:   [n_hk] ascending wavelengths
// opac_hk:    [n_hk] aligned opacities
// lamda_int:  [nbin+1] bin edges (ascending)
// delta_lam:  [nbin] bin widths
// y_gauss:    [ny]
// out:        [nbin*ny] bin-major, y-fastest
void kdistr_tp(const double* lamda_hk, const double* opac_hk,
               int64_t n_hk, const double* lamda_int, int64_t nbin,
               const double* delta_lam, const double* y_gauss, int64_t ny,
               double* out) {
  std::vector<std::pair<double, double>> kg;  // (log10 k, w)
  std::vector<double> ycum;

  // bin start indices via lower_bound
  std::vector<int64_t> starts(nbin + 1);
  for (int64_t x = 0; x <= nbin; ++x) {
    starts[x] = std::lower_bound(lamda_hk, lamda_hk + n_hk, lamda_int[x]) -
                lamda_hk;
  }

  for (int64_t x = 0; x < nbin; ++x) {
    const int64_t s = starts[x], e = starts[x + 1];
    const int64_t n = e - s;
    double* o = out + x * ny;

    if (n == 0) {
      for (int64_t y = 0; y < ny; ++y) o[y] = MIN_OPAC;
      continue;
    }
    if (n == 1) {
      const double v = std::max(MIN_OPAC, opac_hk[s]);
      for (int64_t y = 0; y < ny; ++y) o[y] = v;
      continue;
    }

    kg.resize(n);
    for (int64_t i = 0; i < n; ++i) {
      kg[i].first = std::log10(std::max(MIN_OPAC, opac_hk[s + i]));
    }
    kg[0].second = (lamda_hk[s] - lamda_int[x]) +
                   (lamda_hk[s + 1] - lamda_hk[s]) / 2.0;
    for (int64_t i = 1; i < n - 1; ++i) {
      kg[i].second = (lamda_hk[s + i + 1] - lamda_hk[s + i - 1]) / 2.0;
    }
    kg[n - 1].second = (lamda_int[x + 1] - lamda_hk[e - 1]) +
                       (lamda_hk[e - 1] - lamda_hk[e - 2]) / 2.0;
    for (int64_t i = 0; i < n; ++i) kg[i].second /= delta_lam[x];

    std::stable_sort(kg.begin(), kg.end(),
                     [](const std::pair<double, double>& a,
                        const std::pair<double, double>& b) {
                       return a.first < b.first;
                     });

    ycum.resize(n);
    ycum[0] = 0.5 * kg[0].second;
    for (int64_t i = 1; i < n; ++i) {
      ycum[i] = ycum[i - 1] + 0.5 * (kg[i - 1].second + kg[i].second);
    }

    // linear interpolation with edge clamping (np.interp semantics)
    int64_t j = 0;
    for (int64_t y = 0; y < ny; ++y) {
      const double g = y_gauss[y];
      if (g <= ycum[0]) {
        o[y] = std::pow(10.0, kg[0].first);
        continue;
      }
      if (g >= ycum[n - 1]) {
        o[y] = std::pow(10.0, kg[n - 1].first);
        continue;
      }
      while (j + 1 < n && ycum[j + 1] < g) ++j;
      const double t = (g - ycum[j]) / (ycum[j + 1] - ycum[j]);
      o[y] = std::pow(10.0,
                      kg[j].first + t * (kg[j + 1].first - kg[j].first));
    }
  }
}

// values: [nt_old, np_old, inner] row-major
// out:    [nt_new, np_new, inner]
void bilinear_tp(const double* values, int64_t nt_old, int64_t np_old,
                 int64_t inner, const double* temp_old,
                 const double* press_old, const double* temp_new,
                 int64_t nt_new, const double* press_new, int64_t np_new,
                 double* out) {
  std::vector<double> logp_old(np_old);
  for (int64_t p = 0; p < np_old; ++p) logp_old[p] = std::log10(press_old[p]);

  for (int64_t i = 0; i < nt_new; ++i) {
    // left index + weight in T (edge-clamped)
    int64_t ti = std::upper_bound(temp_old, temp_old + nt_old, temp_new[i]) -
                 temp_old - 1;
    if (ti < 0) ti = 0;
    if (ti > nt_old - 1) ti = nt_old - 1;
    int64_t th = std::min(ti + 1, nt_old - 1);
    double wt = 0.0;
    if (th > ti && temp_new[i] >= temp_old[0]) {
      wt = (temp_new[i] - temp_old[ti]) / (temp_old[th] - temp_old[ti]);
    }

    for (int64_t j = 0; j < np_new; ++j) {
      int64_t pi =
          std::upper_bound(press_old, press_old + np_old, press_new[j]) -
          press_old - 1;
      if (pi < 0) pi = 0;
      if (pi > np_old - 1) pi = np_old - 1;
      int64_t ph = std::min(pi + 1, np_old - 1);
      double wp = 0.0;
      if (ph > pi && press_new[j] >= press_old[0]) {
        wp = (std::log10(press_new[j]) - logp_old[pi]) /
             (logp_old[ph] - logp_old[pi]);
      }

      const double* v00 = values + (ti * np_old + pi) * inner;
      const double* v01 = values + (ti * np_old + ph) * inner;
      const double* v10 = values + (th * np_old + pi) * inner;
      const double* v11 = values + (th * np_old + ph) * inner;
      double* o = out + (i * np_new + j) * inner;

      const double w00 = (1 - wt) * (1 - wp), w01 = (1 - wt) * wp;
      const double w10 = wt * (1 - wp), w11 = wt * wp;
      for (int64_t k = 0; k < inner; ++k) {
        o[k] = w00 * v00[k] + w01 * v01[k] + w10 * v10[k] + w11 * v11[k];
      }
    }
  }
}

}  // extern "C"
