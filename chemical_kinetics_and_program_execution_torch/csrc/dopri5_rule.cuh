// K29's rule: one member's adaptive Dormand-Prince 5(4) solve of the
// autocatalysis rate law.
//
// The JAX package's `ode/dopri5.py:48-146 odeint_dopri5` on
// `models/autocatalysis.py:29-53 dy_dt`, as `_solve_batch` (`:57`) vmaps
// it over members; the port's plain version is
// `models/autocatalysis.py:_solve_batch_plain`. Per member:
//
// - the rate law in the JAX expression's order (`ac_rhs`);
// - the initial step (`:72-86`): d0, d1, the Euler probe, d2, h1, dt0 =
//   min(100 h0, h1) clipped to [1e-14 span, span];
// - steps clamped to the next sample time, which a step reaches when it
//   covers 1 - 1e-14 of the way;
// - the 7 stages, the last (FSAL) at its own input y + h sum A6 k, y_new
//   from row B5 apart from it; each stage input y + h * (c_0 k_0 + c_1
//   k_1 + ...) over the table's terms in stage order;
// - the error sqrt(((e0^2 + e1^2) + e2^2) / 3), e = (h * sum E k) /
//   (atol + max(|y|, |y_new|) rtol), floored at 1e-30;
// - the PI controller (0.9 err^(-0.7/5) err_prev^(0.4/5) clipped to
//   [0.2, 10]; on a reject clip(0.9 err^(-1/5), 0.2, 1)), err_prev from
//   1.0 and carried only on an accept;
// - at most ``max_steps`` accepted plus rejected steps: samples not
//   reached stay as the caller left them (zeros).
//
// The coefficients are launch data (`Dp5Tab`): K6's second table
// (`ode/dop853.py:TABLEAU` rows 18-25: A's rows 1-6, B5 and B5 - B4), a
// row's terms as a dense row with a flag where the table has a term, so
// the stage loops unroll and the stages stay in registers.
//
// Every sum, difference, product and quotient goes through `dp5_add`,
// `dp5_sub`, `dp5_mul` and `dp5_div`: on the card the round-to-nearest
// intrinsics, which are never contracted into fused multiply-adds, so the
// unit can be compiled with contraction allowed (`cuda.FMAD_SOURCES`),
// which gives its `pow` the bits of PyTorch's.
//
// Plain C++ under `g++` as well (`dp5_host_run`), so a CPU test holds the
// rule to the plain version.

#pragma once

#ifdef __CUDACC__
#define DP5_FN __host__ __device__ __forceinline__
#else
#include <cmath>
#define DP5_FN static inline
#endif

#ifdef __CUDA_ARCH__
DP5_FN double dp5_add(double a, double b) { return __dadd_rn(a, b); }
DP5_FN double dp5_sub(double a, double b) { return __dsub_rn(a, b); }
DP5_FN double dp5_mul(double a, double b) { return __dmul_rn(a, b); }
DP5_FN double dp5_div(double a, double b) { return __ddiv_rn(a, b); }
#else
DP5_FN double dp5_add(double a, double b) { return a + b; }
DP5_FN double dp5_sub(double a, double b) { return a - b; }
DP5_FN double dp5_mul(double a, double b) { return a * b; }
DP5_FN double dp5_div(double a, double b) { return a / b; }
#endif

constexpr int kDp5Stages = 7;
constexpr int kDp5Rows = 8;  // A rows 1-6 (0-5), B5 (6), the error row (7)
constexpr int kDp5B5 = 6, kDp5Err = 7;
constexpr int kAcParams = 8;
constexpr double kDp5Order = 5.0;
constexpr double kDp5ExpAccept = -0.7 / kDp5Order;  // the PI controller's
constexpr double kDp5ExpPrev = 0.4 / kDp5Order;
constexpr double kDp5ExpReject = -1.0 / kDp5Order;
constexpr double kDp5ExpInit = 1.0 / kDp5Order;
constexpr double kDp5Reach = 1 - 1e-14;  // a step this close hits its sample

struct Dp5Tab {
  double coef[kDp5Rows][kDp5Stages];
  int has[kDp5Rows][kDp5Stages];
};

// dy/dt for [A-dimer, B-dimer, monomer] at parameters p (the JAX
// package's `dy_dt`, its expression order).
DP5_FN void ac_rhs(const double* p, const double (&y)[3], double (&out)[3]) {
  const double c_form_a = p[0], c_auto_a = p[1], c_stab_a = p[2];
  const double c_form_b = p[3], c_auto_b = p[4], c_stab_b = p[5];
  const double c_add = p[6], c_remove = p[7];
  const double c_sdiss_a = dp5_div(c_form_a, c_stab_a);
  const double c_adiss_a = dp5_div(c_auto_a, c_stab_a);
  const double c_sdiss_b = dp5_div(c_form_b, c_stab_b);
  const double c_adiss_b = dp5_div(c_auto_b, c_stab_b);
  const double ca = y[0], cb = y[1], cm = y[2];
  const double form_a = dp5_mul(dp5_mul(c_form_a, cm), cm);
  const double form_b = dp5_mul(dp5_mul(c_form_b, cm), cm);
  const double auto_a = dp5_mul(dp5_mul(dp5_mul(c_auto_a, ca), cm), cm);
  const double auto_b = dp5_mul(dp5_mul(dp5_mul(c_auto_b, cb), cm), cm);
  const double sdiss_a = dp5_mul(c_sdiss_a, ca);
  const double sdiss_b = dp5_mul(c_sdiss_b, cb);
  const double adiss_a = dp5_mul(dp5_mul(c_adiss_a, ca), ca);
  const double adiss_b = dp5_mul(dp5_mul(c_adiss_b, cb), cb);
  out[0] = dp5_sub(dp5_sub(dp5_sub(dp5_add(form_a, auto_a), sdiss_a), adiss_a),
                   dp5_mul(c_remove, ca));
  out[1] = dp5_sub(dp5_sub(dp5_sub(dp5_add(form_b, auto_b), sdiss_b), adiss_b),
                   dp5_mul(c_remove, cb));
  double m = dp5_add(dp5_mul(2.0, dp5_add(sdiss_a, sdiss_b)),
                     dp5_mul(2.0, dp5_add(adiss_a, adiss_b)));
  m = dp5_sub(m, dp5_mul(2.0, dp5_add(form_a, form_b)));
  m = dp5_sub(m, dp5_mul(2.0, dp5_add(auto_a, auto_b)));
  m = dp5_sub(m, dp5_mul(c_remove, cm));
  out[2] = dp5_add(m, c_add);
}

// sum over the row's terms of c_j k_j[d], in stage order.
DP5_FN double dp5_comb(const Dp5Tab& tab, int row,
                       const double (&k)[kDp5Stages][3], int d) {
  double acc = 0.0;
  bool first = true;
#pragma unroll
  for (int j = 0; j < kDp5Stages; ++j) {
    if (tab.has[row][j]) {
      const double term = dp5_mul(tab.coef[row][j], k[j][d]);
      acc = first ? term : dp5_add(acc, term);
      first = false;
    }
  }
  return acc;
}

// y + h * (the row's sum).
DP5_FN double dp5_stage(const Dp5Tab& tab, int row,
                        const double (&k)[kDp5Stages][3], double y, double h,
                        int d) {
  return dp5_add(y, dp5_mul(h, dp5_comb(tab, row, k, d)));
}

// sqrt(mean(x^2)) over 3 entries, summed in order.
DP5_FN double dp5_rms(const double (&x)[3]) {
  const double s = dp5_add(dp5_add(dp5_mul(x[0], x[0]), dp5_mul(x[1], x[1])),
                           dp5_mul(x[2], x[2]));
  return sqrt(dp5_div(s, 3.0));
}

DP5_FN double dp5_max(double a, double b) { return a > b ? a : b; }
DP5_FN double dp5_min(double a, double b) { return a < b ? a : b; }
DP5_FN double dp5_clip(double x, double lo, double hi) {
  return dp5_min(dp5_max(x, lo), hi);
}

// One member: y0 [3], params [8], sample times ts [n_out]; writes out[i]
// [3] for each sample reached (out[0] = y0) and the step counts.
DP5_FN void dp5_member(const Dp5Tab& tab, const double* y0p, const double* p,
                       const double* ts, int n_out, double rtol, double atol,
                       long long max_steps, double* out, int* n_acc_out,
                       int* n_rej_out) {
  double y[3] = {y0p[0], y0p[1], y0p[2]};
  for (int d = 0; d < 3; ++d) out[d] = y[d];
  double f[3];
  ac_rhs(p, y, f);
  // The initial step.
  double a[3], b[3], scale0[3];
  for (int d = 0; d < 3; ++d) {
    scale0[d] = dp5_add(atol, dp5_mul(fabs(y[d]), rtol));
    a[d] = dp5_div(y[d], scale0[d]);
    b[d] = dp5_div(f[d], scale0[d]);
  }
  const double d0 = dp5_rms(a), d1 = dp5_rms(b);
  const double h0 =
      (d0 < 1e-5 || d1 < 1e-5) ? 1e-6 : dp5_div(dp5_mul(0.01, d0), d1);
  double y1[3], f1[3];
  for (int d = 0; d < 3; ++d) y1[d] = dp5_add(y[d], dp5_mul(h0, f[d]));
  ac_rhs(p, y1, f1);
  for (int d = 0; d < 3; ++d) a[d] = dp5_div(dp5_sub(f1[d], f[d]), scale0[d]);
  const double d2 = dp5_div(dp5_rms(a), h0);
  const double h1 = (d1 <= 1e-15 && d2 <= 1e-15)
                        ? dp5_max(1e-6, dp5_mul(h0, 1e-3))
                        : pow(dp5_div(0.01, dp5_max(d1, d2)), kDp5ExpInit);
  const double t0 = ts[0];
  const double span = dp5_sub(ts[n_out - 1], t0);
  double dt = dp5_clip(dp5_min(dp5_mul(100.0, h0), h1), dp5_mul(1e-14, span),
                       span);

  double t = t0, err_prev = 1.0;
  int i_out = 1;
  long long n_acc = 0, n_rej = 0;
  double k[kDp5Stages][3];
  double ys[3], y_new[3], e[3];
  while (i_out < n_out && n_acc + n_rej < max_steps) {
    const double t_target = ts[i_out < n_out - 1 ? i_out : n_out - 1];
    const double gap = dp5_sub(t_target, t);
    const double dt_eff = dp5_min(dt, gap);
    const bool hits = dt_eff >= dp5_mul(gap, kDp5Reach);
    for (int d = 0; d < 3; ++d) k[0][d] = f[d];
#pragma unroll
    for (int i = 1; i < kDp5Stages; ++i) {
      for (int d = 0; d < 3; ++d)
        ys[d] = dp5_stage(tab, i - 1, k, y[d], dt_eff, d);
      ac_rhs(p, ys, k[i]);
    }
    for (int d = 0; d < 3; ++d)
      y_new[d] = dp5_stage(tab, kDp5B5, k, y[d], dt_eff, d);
    for (int d = 0; d < 3; ++d) {
      const double scale =
          dp5_add(atol, dp5_mul(dp5_max(fabs(y[d]), fabs(y_new[d])), rtol));
      e[d] = dp5_div(dp5_mul(dt_eff, dp5_comb(tab, kDp5Err, k, d)), scale);
    }
    const double err = dp5_max(dp5_rms(e), 1e-30);
    const bool accept = err <= 1.0;
    const double factor =
        dp5_clip(dp5_mul(dp5_mul(0.9, pow(err, kDp5ExpAccept)),
                         pow(err_prev, kDp5ExpPrev)),
                 0.2, 10.0);
    const double dt_next =
        accept ? dp5_mul(dt_eff, factor)
               : dp5_mul(dt_eff, dp5_clip(dp5_mul(0.9, pow(err, kDp5ExpReject)),
                                          0.2, 1.0));
    if (accept) {
      t = hits ? t_target : dp5_add(t, dt_eff);
      for (int d = 0; d < 3; ++d) {
        y[d] = y_new[d];
        f[d] = k[kDp5Stages - 1][d];
      }
      if (hits) {
        for (int d = 0; d < 3; ++d) out[3LL * i_out + d] = y_new[d];
        ++i_out;
      }
      err_prev = err;
      ++n_acc;
    } else {
      ++n_rej;
    }
    dt = dt_next;
  }
  *n_acc_out = (int)n_acc;
  *n_rej_out = (int)n_rej;
}

#ifndef __CUDACC__
// The launch on the host: every member in turn. y0 [B, 3], params [B, 8],
// out [B, n_out, 3] (zeros where no sample is written), counts [B] each.
extern "C" void dp5_host_run(const double* coef, const int* has, int B,
                             const double* y0, const double* params,
                             const double* ts, int n_out, double rtol,
                             double atol, long long max_steps, double* out,
                             int* n_acc, int* n_rej) {
  Dp5Tab tab;
  for (int r = 0; r < kDp5Rows; ++r)
    for (int j = 0; j < kDp5Stages; ++j) {
      tab.coef[r][j] = coef[r * kDp5Stages + j];
      tab.has[r][j] = has[r * kDp5Stages + j];
    }
  for (int b = 0; b < B; ++b)
    dp5_member(tab, y0 + 3LL * b, params + (long long)kAcParams * b, ts,
               n_out, rtol, atol, max_steps, out + 3LL * n_out * b,
               n_acc + b, n_rej + b);
}
#endif
