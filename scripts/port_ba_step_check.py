#!/usr/bin/env python3
"""Hold the first LM try of BA at the Ladybug-1723 shape against a
float64 cuSOLVER solve of the same reduced camera system, on one card.

    python3 scripts/port_ba_step_check.py [--root DIR]

Imports gtsam_torch from DIR (default: this checkout) and makes
make_bal_problem(1723, 150000, 4, seed=0) at its initial state.  For each
mode (float64; mixed: float32 Jacobians and S, refined in float64) it takes
the first try's step (dc, dl) at lam 1e-4 (bench.py's lambda_initial)
through ba._schur_step, as ba_optimize does, then assembles the same S
again and solves it with torch.linalg.cholesky_ex and cholesky_solve in
float64 (S's lower triangle upcast, the same equilibration s), with dl from
the same back-substitution.  Prints one JSON line: per mode the largest
differences of dc and dl from the reference, relative to the reference's
largest entry, each step's relative residual |S x - rhs| / |rhs| in
float64, and the card's name and power limit.  Give two roots in turns to
compare two versions on one card: a change that moves BA's answers by
rounding leaves both near the reference, a fault leaves one far from it.
"""

import argparse
import json
import os
import subprocess
import sys


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_ba_step_check: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    from gtsam_torch._kernels import row_strided
    from gtsam_torch.sfm import ba, ba_kernels as bk, synthetic
    prob = synthetic.make_bal_problem(1723, 150000, 4, seed=0)
    plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                                prob.num_points).to("cuda")
    cams, pts = ba.state_from_numpy(prob.cam_R, prob.cam_t, prob.cam_calib,
                                    prob.points, "cuda")
    uv = torch.as_tensor(prob.obs_uv[plan.order], dtype=torch.float64,
                         device="cuda")
    proj = ba._projection_args(plan, cams, pts, uv)
    n, lam = 9 * prob.num_cameras, 1e-4
    out = {}
    for mode, dt in (("float64", torch.float64), ("mixed", torch.float32)):
        mixed = dt == torch.float32
        A_cam, A_pt, b = bk.linearize(*proj, *((dt,) if mixed else ()))
        S = row_strided(n, dt, "cuda")
        dc, dl = ba._schur_step(plan, A_cam, A_pt, b, lam, False, S, mixed)
        red = ba.assemble(plan, A_cam, A_pt, b, lam, False, S)
        L = S.double().tril()
        S64 = L + L.tril(-1).mT
        rhs = red.g.reshape(-1) * red.s
        F, info = torch.linalg.cholesky_ex(S64)
        x = torch.cholesky_solve(rhs[:, None], F)[:, 0]
        dc_ref = (x * red.s).reshape(-1, 9)
        dl_ref = bk.back_substitute(plan.pt_ptr, plan.pt_tile, plan.obs_cam,
                                    red.W, dc_ref, red.C, red.gl)

        def rel(got, ref):
            return float((got.double() - ref.double()).abs().max()
                         / ref.double().abs().max())

        def resid(dcv):
            y = dcv.reshape(-1) / red.s
            return float((S64 @ y - rhs).norm() / rhs.norm())
        out[mode] = {"cholesky_info": int(info),
                     "dc_rel_diff": rel(dc, dc_ref),
                     "dl_rel_diff": rel(dl, dl_ref),
                     "residual": resid(dc),
                     "residual_reference": resid(dc_ref),
                     "dc_max": float(dc_ref.abs().max())}
        del S, S64, L, F
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"step_check": out, "root": root,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
