#!/usr/bin/env python3
"""Time the pose graph's assembly and refinement matvec, and the path around
them, on one card at the sphere2500 shape.

    python3 scripts/port_assemble_time.py [--root DIR] [--reps N]

Imports gtsam_torch and chip_smoke.py from DIR (default: this checkout) and
drives chip_smoke's sphere path there: the 50 x 50 stand-in of
scripts/port_sphere_data.py with bench.py's prior, chordal initialization,
optimizers.make_fused_lm on SparseSolver (SPHERE_SOLVER, SPHERE_LM).  It
runs the path once to warm up, then N times (host clock, synchronized: wall
to converged), and on the converged state times, with CUDA events (mean of
N calls): the solver's system() as the path calls it, the graph's error,
the matvec (lam 1e-3), one factorization and one try (solve, retract,
error), and the host time of system(), the error and a factorization
(their calls enqueued back to back, the clock stopped before the device is
waited for).  Then the device time per call (torch.profiler, N calls) of
kernel 6's linearize and assembly kernels (names containing
"pg_linearize", "pg_assemble") inside system(), of its error kernel inside
the error, of kernel 9 inside the matvec and of every kernel of the
factorization (in all, and by kernel with its launches), and one traced
run of the
path (device busy time, idle share, kernel launches).  Prints one JSON line
with the card's name and power limit.  Give two roots in turns (A, B, B,
A), one process each on one card, to compare two versions.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time


def _cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _host_ms(fn, reps):
    """Host time per call of fn: its calls enqueued back to back, the clock
    stopped before the device is waited for."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / reps


def _kernel_ms(fn, reps, key):
    """Device time per call of fn's kernels whose names contain key."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and key in e.key
               ) / 1e3 / reps


def _kernels_ms(fn, reps):
    """Device time per call of the kernels fn launches, by the first 60
    characters of their names, with their launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total:
            row = out.setdefault(e.key[:60], [0.0, 0.0])
            row[0] += e.self_device_time_total / 1e3 / reps
            row[1] += e.count / reps
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_assemble_time: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from gtsam_torch import LMParams
    from gtsam_torch.graph.values import retract_arrays
    from gtsam_torch.optimize import optimizers as O
    graph, vals0, _, _ = cs.sphere_graph(50, 50)
    fn = O.make_fused_lm(graph, vals0, LMParams(**cs.SPHERE_LM),
                         solver=O.SparseSolver(**cs.SPHERE_SOLVER),
                         device="cuda")
    solver, s, layout = fn.solver, fn.solver._s, vals0.layout()
    fn(vals0.arrays)
    walls = []
    for _ in range(a.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it, arrays, err, _, _, tries = fn(vals0.arrays)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    blocks, g = s.system(arrays)
    x = s._solve_padded(s.factorize(blocks, 1e-3), g)

    def try_():
        dx = solver.solve((blocks, g), 1e-3, False)[0]
        return fn.bound.error(retract_arrays(arrays, dx, layout))
    walls.sort()
    # one traced run of the path: device busy time, idle share, launches
    # (every device kernel's count), and the factorize stage's device time
    # per factorization
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced_tries = fn(vals0.arrays)[5]
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    trace = {"wall_ms": traced_ms, "tries": traced_tries,
             "device_busy_ms": busy, "idle_share": 1.0 - busy / traced_ms,
             "launches": sum(e.count for e in dev)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({
        "root": root, "card": smi[0] if smi else None,
        "half_chi2": err, "iterations": it, "tries": tries,
        "wall_ms": walls, "wall_median_ms": walls[len(walls) // 2],
        "system_ms": _cuda_ms(lambda: solver.system(arrays), a.reps),
        "error_ms": _cuda_ms(lambda: fn.bound.error(arrays), a.reps),
        "system_host_ms": _host_ms(lambda: solver.system(arrays), a.reps),
        "error_host_ms": _host_ms(lambda: fn.bound.error(arrays), a.reps),
        "matvec_ms": _cuda_ms(lambda: s.matvec(blocks, x, 1e-3), a.reps),
        "try_ms": _cuda_ms(try_, a.reps),
        "factorize_ms": _cuda_ms(lambda: s.factorize(blocks, 1e-3), a.reps),
        "factorize_device_ms": _kernel_ms(lambda: s.factorize(blocks, 1e-3),
                                          a.reps, ""),
        "factorize_host_ms": _host_ms(lambda: s.factorize(blocks, 1e-3),
                                      a.reps),
        "factorize_by_kernel": _kernels_ms(
            lambda: s.factorize(blocks, 1e-3), a.reps),
        "trace": trace,
        "pg_linearize_device_ms": _kernel_ms(
            lambda: solver.system(arrays), a.reps, "pg_linearize"),
        "pg_assemble_device_ms": _kernel_ms(lambda: solver.system(arrays),
                                            a.reps, "pg_assemble"),
        "pg_error_device_ms": _kernel_ms(lambda: fn.bound.error(arrays),
                                         a.reps, "pg_error"),
        "sn_matvec_device_ms": _kernel_ms(lambda: s.matvec(blocks, x, 1e-3),
                                          a.reps, "sn_matvec")}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
