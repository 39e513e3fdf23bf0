#!/usr/bin/env python3
"""Time kernel 1 of gtsam_torch (bal_linearize, bal_error) on one card.

    python3 scripts/port_kernel1_time.py [--root DIR] [--reps N]

Imports gtsam_torch from DIR (default: this checkout), makes
make_bal_problem(1723, 150000, 4, seed=0) and, on its initial state, times
  - each wrapper as ba_optimize calls it, N calls back to back between two
    CUDA events (what chip_smoke.py phase 5 reports);
  - each kernel alone: N launches of its C entry point into outputs
    allocated once, so the host enqueues faster than the card runs and the
    events measure device time;
  - the host side of the error wrapper, step by step (perf_counter over N
    calls each): the argument checks, the stream lookup, one torch.empty,
    one launch through Kernel.launch.
Prints one JSON line with the card's name and power limit, the root and
the times in ms (host steps in microseconds).  Give two roots in turns
(A, B, B, A) in one run on one card to compare two versions.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=200)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_kernel1_time: needs a CUDA card", file=sys.stderr)
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
    dev, K = uv.device, prob.num_observations
    ptrs = [t.data_ptr() for t in proj]

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

    def host_us(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    out = {}
    out["wrapper_ms"] = {
        "linearize": events_ms(lambda: bk.linearize(*proj), a.reps),
        "error": events_ms(lambda: bk.error(*proj), a.reps)}

    # kernels alone, outputs allocated once
    bk.linearize(*proj)
    bk.error(*proj)
    stream = torch.cuda.current_stream(dev).cuda_stream
    f64 = dict(dtype=torch.float64, device=dev)
    A_cam, A_pt, b = (torch.empty(s, **f64) for s in ((K, 2, 9), (K, 2, 3),
                                                      (K, 2)))
    partial = torch.zeros(-(-K // bk.ERROR_BLOCK), **f64)
    counter = torch.zeros((), dtype=torch.int32, device=dev)
    res = torch.empty((), **f64)

    def c_args(kern, outs):
        """The entry point's arguments but the stream: its leading ints
        (K, or K, M, N), the seven inputs, then as many of `outs` as it
        takes (the error kernels take the partials alone, or the partials,
        the counter and the result)."""
        ints = next(i for i, t in enumerate(kern.argtypes)
                    if t is not ctypes.c_int)
        lead = (K, prob.num_cameras, prob.num_points)[:ints]
        n_out = len(kern.argtypes) - 1 - ints - len(ptrs)
        return (*lead, *ptrs, *[t.data_ptr() for t in outs[:n_out]])

    lin_args = c_args(bk.KERNELS["bal_linearize"], (A_cam, A_pt, b))
    err_args = c_args(bk.KERNELS["bal_error"], (partial, counter, res))
    lin = bk.KERNELS["bal_linearize"]._fn
    err = bk.KERNELS["bal_error"]._fn
    out["kernel_ms"] = {
        "linearize": events_ms(lambda: lin(*lin_args, stream), a.reps),
        "error": events_ms(lambda: err(*err_args, stream), a.reps)}

    # the error wrapper's host steps
    kern = bk.KERNELS["bal_error"]
    out["error_host_us"] = {
        "checks": host_us(lambda: bk._projection_specs("bal_error", *proj),
                          a.reps),
        "current_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream, a.reps),
        "torch_empty": host_us(lambda: torch.empty((), **f64), a.reps),
        "launch": host_us(lambda: kern.launch(dev, *err_args), a.reps),
        "wrapper": host_us(lambda: bk.error(*proj), a.reps),
    }
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        out["error_host_us"]["raw_stream"] = host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev.index), a.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    out.update(root=a.root, card=smi[0] if smi else None, reps=a.reps,
               K=K, module=bk.__file__)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
