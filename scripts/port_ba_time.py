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
"other"), and from whose kernel timeline the time kernel 10 stands on the
critical path is read: the device time during which the side stream that
blocked_cholesky factors its super-panels on was busy and no other stream
ran a kernel (the main stream waiting on the side stream's events), for
all of the side stream's kernels and for kernel 10's alone, in total and
per factorization.  Prints one JSON line with the card's name, the root and those
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


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _minus(A, B):
    """The length of the union of intervals A less that of B (both merged
    and sorted)."""
    total, j = 0, 0
    for a, b in A:
        while j < len(B) and B[j][1] <= a:
            j += 1
        cur, k = a, j
        while k < len(B) and B[k][0] < b:
            total += max(0, B[k][0] - cur)
            cur = max(cur, B[k][1])
            k += 1
        total += max(0, b - cur)
    return total


def exposed(prof, panels):
    """Device ms of the traced run during which the side stream (the one
    kernel 10 runs on) was busy and no other stream ran a kernel: of all of
    its kernels, and of kernel 10's alone; in total and per factorization
    (kernel 10's launches / panels).  None if the trace has no kernel 10 or
    no stream ids."""
    try:
        evs = [(e.name(), e.device_resource_id(), e.start_ns(),
                e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")]
    except AttributeError:
        return None
    k10 = [e for e in evs if "dense_factor_diag" in e[0]]
    if not k10:
        return None
    streams = {}
    for e in k10:
        streams[e[1]] = streams.get(e[1], 0) + 1
    side = max(streams, key=streams.get)
    main = _merge([(a, b) for _, s, a, b in evs if s != side])
    fact = len(k10) / panels
    side_ms = _minus(_merge([(a, b) for _, s, a, b in evs if s == side]),
                     main) / 1e6
    k10_ms = _minus(_merge([(a, b) for _, _, a, b in k10]), main) / 1e6
    return {"side_stream_ms": side_ms, "kernel10_ms": k10_ms,
            "factorizations": fact,
            "side_stream_ms_per_factorization": side_ms / fact,
            "kernel10_ms_per_factorization": k10_ms / fact,
            "kernel10_streams": len(streams)}


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
                     "exposed": exposed(prof, -(-9 * prob.num_cameras // 128)),
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
