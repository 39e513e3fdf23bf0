#!/usr/bin/env python3
"""Time the point-pass kernels of gtsam_torch on one card: kernel 4
(ba_back_substitute) and, where the tree has it, kernel 5
(ba_schur_matvec).

    python3 scripts/port_point_pass_time.py [--root DIR] [--reps N]

Imports gtsam_torch from DIR (default: this checkout), makes
make_bal_problem(1723, 150000, 4, seed=0), linearizes its initial state,
eliminates the points at lam = 1 (float64 for kernel 4, float32 Jacobians
and the damped Hpp for kernel 5) and times N calls of each wrapper back to
back between two CUDA events, on the inputs ba_optimize gives it.  Prints
one JSON line with the card's name and power limit, the root and the times
in ms.  Give two roots in turns (A, B, B, A) in one run on one card to
compare two versions; a tree whose back_substitute takes no pt_tile (the
first version) is called without it.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=200)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_point_pass_time: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.root))
    from gtsam_torch.sfm import ba, ba_kernels as bk, synthetic
    prob = synthetic.make_bal_problem(1723, 150000, 4, seed=0)
    plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                                prob.num_points).to("cuda")
    uv = torch.as_tensor(prob.obs_uv[plan.order], dtype=torch.float64,
                         device="cuda")
    cams, pts = ba.state_from_numpy(prob.cam_R, prob.cam_t, prob.cam_calib,
                                    prob.points, "cuda")
    proj = ba._projection_args(plan, cams, pts, uv)
    dc = torch.randn((prob.num_cameras, 9), dtype=torch.float64,
                     device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))

    def events_ms(fn, reps):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    A_cam, A_pt, b = bk.linearize(*proj)
    W, WC, corr, C, gl = bk.point_eliminate(plan.pt_ptr, plan.pt_tile, A_cam,
                                            A_pt, b, 1.0, False)
    params = inspect.signature(bk.back_substitute).parameters
    bs_args = ((plan.pt_ptr, plan.pt_tile) if "pt_tile" in params
               else (plan.pt_ptr,)) + (plan.obs_cam, W, dc, C, gl)
    out = {"ms": {"ba_back_substitute": events_ms(
        lambda: bk.back_substitute(*bs_args), a.reps)}}
    if hasattr(bk, "schur_matvec"):
        A32, P32, b = bk.linearize(*proj, torch.float32)
        W, WC, corr, C, gl = bk.point_eliminate(plan.pt_ptr, plan.pt_tile,
                                                A32, P32, b, 1.0, False)
        n = 9 * prob.num_cameras
        S = torch.zeros((n, n), dtype=torch.float32, device="cuda")
        _, _, Hpp_d = bk.camera_assemble(
            plan.cam_ptr, plan.cam_obs, A32, b, corr, plan.cell_ptr,
            plan.diag_cell, plan.cell_a, plan.cell_b, WC, W, 1.0, False, S)
        del S
        mv = (plan.pt_ptr, plan.pt_tile, plan.obs_cam, plan.obs_pt,
              plan.cam_ptr, plan.cam_obs, W, WC, Hpp_d, dc)
        out["ms"]["ba_schur_matvec"] = events_ms(
            lambda: bk.schur_matvec(*mv), a.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    out.update(root=a.root, card=smi[0] if smi else None, reps=a.reps,
               K=prob.num_observations, module=bk.__file__)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
