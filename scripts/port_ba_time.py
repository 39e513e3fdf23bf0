#!/usr/bin/env python3
"""Time gtsam_torch's bundle adjustment at the Ladybug-1723 shape on one
card, end to end and by stage.

    python3 scripts/port_ba_time.py [--root DIR] [--reps N]

Imports gtsam_torch from DIR (default: this checkout), makes
make_bal_problem(1723, 150000, 4, seed=0) and runs ba_optimize with
bench.py's LM settings to half-chi2 <= 329,909 x 1.0001, in float64 and in
the mixed mode (dtype=float32, mixed_precision=True): one untimed run, then
N timed runs (wall in seconds, ending in torch.cuda.synchronize(), and each
iteration's time), then one run under torch.profiler whose device time is
summed by stage (kernel names matched against STAGES; the rest is
"other").  Prints one JSON line with the card's name, the root and those
numbers.  Give two roots in turns (A, B, B, A) in one run to compare
two versions on one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

TARGET = 329909.0 * 1.0001
# stage: substrings of the kernel names it holds (lower case), first match
STAGES = (
    ("factor: kernel 10", ("dense_factor_diag",)),
    ("solve: kernel 11", ("dense_forward", "dense_backward")),
    ("factor: cuSOLVER", ("potrf", "syrk", "trsm", "herk")),
    ("solve: cuBLAS trsv", ("trsv",)),
    ("factor: tril", ("tril",)),
    ("factor: trailing products", ("gemm", "xmma", "cutlass", "sm90")),
    ("copies and fills", ("copy", "fill", "memset", "memcpy")),
    ("linearize and error", ("bal_linearize", "bal_error")),
    ("point elimination", ("ba_point_eliminate",)),
    ("assembly", ("ba_camera_assemble", "ba_pair_assemble")),
    ("refinement matvec", ("ba_matvec_camera", "point_pass_kernel<false>")),
    ("back-substitution", ("point_pass",)),
)


def stage_of(name):
    k = name.lower()
    for stage, keys in STAGES:
        if any(w in k for w in keys):
            return stage
    return "other"


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=2)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_ba_time: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.root))
    from torch.profiler import ProfilerActivity, profile

    from gtsam_torch import LMParams
    from gtsam_torch.sfm import ba, synthetic
    prob = synthetic.make_bal_problem(1723, 150000, 4, seed=0)
    lm = LMParams(max_iterations=20, relative_error_tol=1e-6,
                  lambda_policy="conservative", lambda_initial=1e-4,
                  lambda_lower_bound=1e-4)
    modes = {"float64": {},
             "mixed": dict(dtype=torch.float32, mixed_precision=True)}
    out = {}
    for mode, kw in modes.items():
        def run():
            _, info = ba.ba_optimize(prob, lm, target_error=TARGET,
                                     device="cuda", **kw)
            torch.cuda.synchronize()
            return info

        run()
        walls, iters, errs = [], [], []
        for _ in range(a.reps):
            t0 = time.time()
            info = run()
            walls.append(time.time() - t0)
            iters.append(info["iter_times"])
            errs.append(info["error"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            run()
            traced = time.time() - t0
        stages = {}
        for e in prof.key_averages():
            if (str(e.device_type).endswith("CUDA")
                    and e.self_device_time_total > 0):
                s = stage_of(e.key)
                ms, n = stages.get(s, (0.0, 0))
                stages[s] = (ms + e.self_device_time_total / 1e3,
                             n + e.count)
        busy = sum(ms for ms, _ in stages.values())
        out[mode] = {"wall_s": walls, "iter_times": iters, "half_chi2": errs,
                     "traced_wall_ms": traced * 1e3, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / (traced * 1e3),
                     "stages_ms_launches": dict(sorted(
                         stages.items(), key=lambda kv: -kv[1][0]))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"ba": out, "root": a.root,
                      "card": smi[0] if smi else None,
                      "module": ba.__file__}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
