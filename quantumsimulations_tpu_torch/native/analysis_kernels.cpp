// Native analysis kernels: batched coarse-graining and slope-fit metrics.
//
// The host side of this framework runs on small single-core VMs; when
// reprocessing thousands of sweep traces (sweep/reprocess.py), the Python
// per-trace overhead of the metric kernel dominates.  These C implementations
// mirror analysis/metrics.py exactly (same edge-case semantics, golden-tested
// against the Python versions) and are loaded via ctypes — no pybind11
// dependency.
//
// The port's own copy of quantumsimulations_tpu/native/analysis_kernels.cpp,
// unchanged apart from this comment.  native/__init__.py builds it into the
// git-ignored build/ tree beside the package:
//
//   g++ -O3 -shared -fPIC analysis_kernels.cpp -o build/native/libqstnative.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

namespace {
const double NaN = std::numeric_limits<double>::quiet_NaN();
}

extern "C" {

// Block-average a batch of traces: y is (n_traces, n); out is
// (n_traces, n/window) row-major.  Returns the coarse length per trace.
// window <= 1 or n < window follows the Python contract (caller handles the
// no-op case; this function requires window >= 1 and n >= window).
int64_t coarse_grain_batch(const double* y, int64_t n_traces, int64_t n,
                           int64_t window, double* out) {
  if (window < 1 || n < window) return -1;
  const int64_t m = n / window;
  const double inv = 1.0 / static_cast<double>(window);
  for (int64_t tr = 0; tr < n_traces; ++tr) {
    const double* row = y + tr * n;
    double* orow = out + tr * m;
    for (int64_t b = 0; b < m; ++b) {
      double acc = 0.0;
      const double* blk = row + b * window;
      for (int64_t k = 0; k < window; ++k) acc += blk[k];
      orow[b] = acc * inv;
    }
  }
  return m;
}

// Linear-fit drift metric over the central ~60% of a coarse trace.
// Mirrors analysis/metrics.py::iz_slope_from_coarse (reference semantics:
// sweep_sea_detuning.py:148-268).  out must hold 10 doubles:
// [I_z_slope, t_start, t_end, I_z_start, I_z_end, slope, slope_std,
//  t_value, R_value, R2_value].
void iz_slope_from_coarse(const double* t, const double* y, int64_t n,
                          double* out) {
  for (int i = 0; i < 10; ++i) out[i] = NaN;
  if (n < 4) return;

  int64_t i0 = static_cast<int64_t>(0.2 * static_cast<double>(n));
  int64_t i1 = static_cast<int64_t>(0.8 * static_cast<double>(n));
  if (i0 > n - 2) i0 = n - 2;
  if (i0 < 0) i0 = 0;
  if (i1 < i0 + 2) i1 = i0 + 2;
  if (i1 > n) i1 = n;
  const int64_t m = i1 - i0;
  if (m < 2) return;
  const double* ts = t + i0;
  const double* ys = y + i0;

  // least squares via centered sums (matches np.polyfit on these inputs)
  double tm = 0.0, ym = 0.0;
  for (int64_t k = 0; k < m; ++k) { tm += ts[k]; ym += ys[k]; }
  tm /= m; ym /= m;
  double ss_t = 0.0, ss_y = 0.0, s_ty = 0.0;
  for (int64_t k = 0; k < m; ++k) {
    const double dt = ts[k] - tm;
    const double dy = ys[k] - ym;
    ss_t += dt * dt;
    ss_y += dy * dy;
    s_ty += dt * dy;
  }
  const double b = (ss_t > 0.0) ? s_ty / ss_t : NaN;
  const double a = ym - b * tm;

  const double t_start = ts[0];
  const double t_end = ts[m - 1];
  const double y_start = a + b * t_start;
  const double y_end = a + b * t_end;

  out[0] = y_end - y_start;
  out[1] = t_start;
  out[2] = t_end;
  out[3] = y_start;
  out[4] = y_end;
  out[5] = b;

  if (ss_t > 0.0 && ss_y > 0.0) {
    const double R = s_ty / std::sqrt(ss_t * ss_y);
    out[8] = R;
    out[9] = R * R;
  }

  if (m > 2 && ss_t > 0.0) {
    double sse = 0.0;
    for (int64_t k = 0; k < m; ++k) {
      const double resid = ys[k] - (a + b * ts[k]);
      sse += resid * resid;
    }
    const double s2 = sse / static_cast<double>(m - 2);
    const double var = s2 / ss_t;
    if (var > 0.0) {
      const double sd = std::sqrt(var);
      out[6] = sd;
      if (sd > 0.0 && std::isfinite(sd)) out[7] = b / sd;
    }
  }
}

// Batched form: t (m,), y (n_traces, m), out (n_traces, 10).
void iz_slope_batch(const double* t, const double* y, int64_t n_traces,
                    int64_t m, double* out) {
  for (int64_t tr = 0; tr < n_traces; ++tr)
    iz_slope_from_coarse(t, y + tr * m, m, out + tr * 10);
}

// Michelson contrast with t-statistic gating
// (analysis/metrics.py::contrast_michelson_with_t_gate).
double contrast_michelson_with_t_gate(double slope_on, double slope_off,
                                      double t_on, double t_off,
                                      double t_min) {
  if (!std::isfinite(slope_on) || !std::isfinite(slope_off)) return NaN;
  if (!std::isfinite(t_on) || !std::isfinite(t_off)) return NaN;
  const double eff_on = (std::fabs(t_on) < t_min) ? 0.0 : slope_on;
  const double eff_off = (std::fabs(t_off) < t_min) ? 0.0 : slope_off;
  const double denom = std::fabs(eff_on) + std::fabs(eff_off);
  if (!std::isfinite(denom) || denom <= 1e-16) return 0.0;
  return (std::fabs(eff_on) - std::fabs(eff_off)) / denom;
}

}  // extern "C"
