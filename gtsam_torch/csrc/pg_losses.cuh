// Kernel 6's robust losses (gtsam_torch/base/losses.py), shared by its SE3
// (pg_between.cu) and Pose2 (pg_pose2.cu) variants: the loss codes, the
// IRLS weight w(d) and rho(d), and the noise kind of constrained models.
#pragma once

#include "ba_common.cuh"

namespace pg {

constexpr int kConstrained = 3;      // noise kind: a diagonal, 0 = hard row

// the losses of gtsam_torch/base/losses.py, by its CODES (0: none)
enum Loss {
  kLossNone = 0, kLossNull, kLossFair, kLossHuber, kLossCauchy, kLossTukey,
  kLossWelsch, kLossGemanMcClure, kLossDcs, kLossDeadZone
};

// the IRLS weight w(d) of loss `code` with parameter c (k) at the whitened
// norm d >= 0, in losses.py's formulas and branches (inclusive <= at a
// threshold, max(d, 1e-30), Tukey's 0 beyond c)
__device__ __noinline__ double loss_weight(int code, double c, double d) {
  switch (code) {
    case kLossFair:
      return 1.0 / (1.0 + d / c);
    case kLossHuber:
      return d <= c ? 1.0 : c / fmax(d, 1e-30);
    case kLossCauchy: {
      const double k2 = c * c;
      return k2 / (k2 + d * d);
    }
    case kLossTukey: {
      const double r = d * d / (c * c), u = 1.0 - r;
      return d <= c ? u * u : 0.0;
    }
    case kLossWelsch:
      return exp(-d * d / (c * c));
    case kLossGemanMcClure: {
      const double c2 = c * c, q = c2 / (c2 + d * d);
      return q * q;
    }
    case kLossDcs: {
      const double e2 = d * d, q = 2.0 * c / (c + e2);
      return e2 > c ? q * q : 1.0;
    }
    case kLossDeadZone:
      return d <= c ? 0.0 : (d - c) / fmax(d, 1e-30);
    default:   // kLossNull
      return 1.0;
  }
}

// rho(d) of loss `code` (as loss_weight)
__device__ __noinline__ double loss_rho(int code, double c, double d) {
  switch (code) {
    case kLossFair: {
      const double ad = d / c;
      return c * c * (ad - log1p(ad));
    }
    case kLossHuber:
      return d <= c ? 0.5 * d * d : c * d - 0.5 * c * c;
    case kLossCauchy: {
      const double k2 = c * c;
      return 0.5 * k2 * log1p(d * d / k2);
    }
    case kLossTukey: {
      const double c2 = c * c, u = 1.0 - fmin(d * d / c2, 1.0);
      return c2 / 6.0 * (1.0 - u * u * u);
    }
    case kLossWelsch: {
      const double c2 = c * c;
      return 0.5 * c2 * (1.0 - exp(-d * d / c2));
    }
    case kLossGemanMcClure: {
      const double c2 = c * c;
      return 0.5 * c2 * d * d / (c2 + d * d);
    }
    case kLossDcs: {
      const double e2 = d * d;
      return e2 > c ? 2.0 * c * e2 / (c + e2) - c : 0.5 * e2;
    }
    case kLossDeadZone: {
      const double u = d - c;
      return d <= c ? 0.0 : 0.5 * u * u;
    }
    default:   // kLossNull
      return 0.5 * d * d;
  }
}

}  // namespace pg
