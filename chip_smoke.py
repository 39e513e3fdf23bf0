#!/usr/bin/env python3
"""Drive the gtsam_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py            # full run: needs one NVIDIA card
    python3 chip_smoke.py --quick    # build + kernel checks + a small BA only

Phases (each one raises on failure; the script exits 0 only if all pass):
  1. the card's name and power limit (nvidia-smi) and torch's device name;
  2. build every kernel of gtsam_torch/csrc with nvcc (sm_90a), timed;
  3. a fast first gate: each kernel against its plain PyTorch version on the
     same CUDA tensors at make_bal_problem(100, 5000, 4, seed=0), with stated
     tolerances, and a small ba_optimize on the card against the same run on
     the CPU;
  4. the main path: gtsam_torch.sfm.ba.ba_optimize at the Ladybug-1723 shape
     (make_bal_problem(1723, 150000, 4, seed=0)) with bench.py's LM settings,
     held to the C++ GTSAM optimum 329,909 x 1.0001, every kernel's launch
     count read from this run alone;
  5. each kernel against its plain version again at the Ladybug shape, on
     the converged state (same tolerances), then its time (CUDA events)
     beside the plain version's time and its bound from this run's shapes;
  6. one profiled run of the main path: device busy time by kernel.
The last three lines are the kernels' JSON, the nvidia-smi line and
{"ok": true, "device": {...}}.  Imports neither JAX nor gtsam_tpu.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS = 34e12             # H100 SXM FP64 outside the tensor cores
FP64_TC_FLOPS = 67e12          # H100 SXM FP64 tensor cores (cuSOLVER's DGEMMs)
TARGET = 329909.0 * 1.0001     # baselines/reference_cpu.json bal_ladybug x 1.0001
# Kernel source, wrapper, plain version and the JAX routine each replaces
# are read from gtsam_torch.sfm.ba_kernels.KERNELS.
# kernel-vs-plain tolerances, relative to the plain output's largest entry:
# kernel 1 shares the plain version's formulas (FMA contraction only);
# kernels 2 and 4 sum in another order; kernel 3's atomics in a run-dependent
# order (S is reproducible only to rounding).
TOL = {"bal_linearize": 1e-12, "bal_error": 1e-12, "ba_point_eliminate": 1e-10,
       "ba_camera_assemble": 1e-10, "ba_pair_assemble": 1e-10,
       "ba_back_substitute": 1e-10}


def log(*a):
    print(*a, flush=True)


def rel_err(got, ref):
    """(max |got - ref| / max |ref|, max |got - ref|) over tensors."""
    import torch
    worst_rel, worst_abs = 0.0, 0.0
    for g, r in zip(got, ref):
        d = float(torch.max(torch.abs(g - r)))
        scale = max(float(torch.max(torch.abs(r))), 1e-300)
        worst_rel, worst_abs = max(worst_rel, d / scale), max(worst_abs, d)
    return worst_rel, worst_abs


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
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


class Inputs:
    """One problem on the card: plan, state, linearization, elimination."""

    def __init__(self, prob, lam, cams=None, pts=None):
        import torch
        from gtsam_torch.sfm import ba, ba_kernels as bk
        self.prob, self.lam = prob, lam
        self.plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt,
                                         prob.num_cameras,
                                         prob.num_points).to("cuda")
        self.uv = torch.as_tensor(prob.obs_uv[self.plan.order],
                                  dtype=torch.float64, device="cuda")
        if cams is None:
            cams, pts = ba.state_from_numpy(prob.cam_R, prob.cam_t,
                                            prob.cam_calib, prob.points,
                                            "cuda")
        self.cams, self.pts = cams, pts
        self.proj = ba._projection_args(self.plan, cams, pts, self.uv)
        self.A_cam, self.A_pt, self.b = bk.linearize_plain(*self.proj)
        (self.W, self.WC, self.corr, self.C, self.gl) = \
            bk.point_eliminate_plain(self.plan.pt_ptr, self.A_cam, self.A_pt,
                                     self.b, lam, False)
        n = 9 * prob.num_cameras
        self.S = torch.zeros((n, n), dtype=torch.float64, device="cuda")
        self.dc = torch.randn((prob.num_cameras, 9), dtype=torch.float64,
                              device="cuda",
                              generator=torch.Generator("cuda").manual_seed(0))

    # argument tuples of each kernel wrapper and its plain version
    def args(self, name):
        p = self.plan
        return {
            "bal_linearize": self.proj,
            "bal_error": self.proj,
            "ba_point_eliminate": (p.pt_ptr, self.A_cam, self.A_pt, self.b,
                                   self.lam, False),
            "ba_camera_assemble": (p.cam_ptr, p.cam_obs, self.A_cam, self.b,
                                   self.corr, self.lam, False, self.S),
            "ba_pair_assemble": (p.pair_ptr, p.pair_a, p.pair_b, p.obs_cam,
                                 self.WC, self.W, self.S),
            "ba_back_substitute": (p.pt_ptr, p.obs_cam, self.W, self.dc,
                                   self.C, self.gl),
        }[name]

    def work(self, name):
        """(bytes that must move, FP64 operations) of one call, counted from
        this problem's shapes; each input read once, each output written
        once."""
        import numpy as np
        M, N = self.prob.num_cameras, self.prob.num_points
        K = self.prob.num_observations
        p = self.plan
        P = int(p.pair_ptr[-1])
        oc = p.obs_cam.cpu().numpy().astype(np.int64)
        cells = np.unique(oc[p.pair_a.cpu().numpy()] * M
                          + oc[p.pair_b.cpu().numpy()]).size
        params = M * (9 + 3 + 3) * 8 + N * 3 * 8
        return {
            "bal_linearize": (K * (8 + 16) + params + K * (18 + 6 + 2) * 8,
                              K * 110),
            "bal_error": (K * (8 + 16) + params + 8 * (-(-K // 256)), K * 40),
            "ba_point_eliminate": (K * (18 + 6 + 2) * 8 + (N + 1) * 4
                                   + K * (27 + 27 + 9) * 8 + N * (9 + 3) * 8,
                                   K * 350 + N * 60),
            "ba_camera_assemble": (K * (18 + 2 + 9) * 8 + K * 4 + (M + 1) * 4
                                   + M * (81 + 9) * 8, K * 370),
            "ba_pair_assemble": (K * (27 + 27) * 8 + K * 4 + P * 8
                                 + (N + 1) * 4 + cells * 81 * 8, P * 81 * 6),
            "ba_back_substitute": (K * (27 * 8 + 4) + M * 9 * 8
                                   + N * (9 + 3 + 3) * 8 + (N + 1) * 4,
                                   K * 54 + N * 15),
        }[name]


def run_pair(name, inp, bk):
    """(kernel outputs, plain outputs) of kernel `name` on the same inputs."""
    import torch
    outs = []
    wrapper = bk.KERNELS[name].wrapper
    for f in (getattr(bk, wrapper), getattr(bk, wrapper + "_plain")):
        inp.S.zero_()
        if name == "ba_pair_assemble":
            # start both from the same diagonal blocks (kernel 3a's plain run)
            bk.camera_assemble_plain(*inp.args("ba_camera_assemble"))
        r = f(*inp.args(name))
        if name in ("ba_camera_assemble", "ba_pair_assemble"):
            r = (inp.S.clone(),) + ((r,) if r is not None else ())
        elif not isinstance(r, tuple):
            r = (r,)
        outs.append(r)
    torch.cuda.synchronize()
    return outs


def check_kernels(inp, bk, label):
    """Each kernel against its plain version on the same tensors of `inp`;
    raises on a miss of TOL.  Returns {kernel: max abs err}."""
    errs = {}
    for name in bk.KERNELS:
        kern, plain = run_pair(name, inp, bk)
        rel, ab = rel_err(kern, plain)
        del kern, plain
        errs[name] = ab
        log(f"check {label} {name}: max rel err {rel:.3e} "
            f"(tol {TOL[name]:.0e}), max abs err {ab:.3e}")
        if not rel <= TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({label}): {rel:.3e} > {TOL[name]:.0e}")
    return errs


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    quick = "--quick" in argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gtsam_torch import LMParams, _build
    from gtsam_torch.sfm import ba, ba_kernels as bk, synthetic

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.time()
    paths = _build.build()
    log(f"build: {time.time() - t0:.3f} s for {len(paths)} libraries")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions, small problem -------------
    torch.manual_seed(0)
    small = synthetic.make_bal_problem(100, 5000, 4, seed=0)
    # the kernel checks move a few points outside the camera ring, behind
    # every camera that sees them, so the cheirality branch runs too
    bad = dataclasses.replace(small, points=small.points.copy())
    first = bad.obs_cam[[int((bad.obs_pt == j).argmax()) for j in range(8)]]
    bad.points[:8] = 3.0 * bad.cam_t[first]
    # lam = 1 keeps every damped 3x3 point block well conditioned, so the
    # differences measure the kernels' arithmetic: at lam = 1e-4 a track that
    # sees one camera twice has an unobservable depth (condition ~1e7), and
    # two correct inverses of it differ by ~1e-8 of their largest entry.
    inp = Inputs(bad, 1.0)
    behind = int((bk.linearize_plain(*inp.proj)[2] == -1e3).all(1).sum())
    log(f"kernel checks: {behind} observations behind their camera")
    if behind == 0:
        raise AssertionError("the kernel checks miss the cheirality branch")
    check_kernels(inp, bk, "small")
    del inp
    lm_small = LMParams(max_iterations=10)
    _, info_gpu = ba.ba_optimize(small, lm_small, device="cuda")
    _, info_cpu = ba.ba_optimize(small, lm_small, device="cpu")
    d = abs(info_gpu["error"] - info_cpu["error"]) / info_cpu["error"]
    log(f"small BA: card {info_gpu['error']!r} cpu {info_cpu['error']!r} "
        f"rel diff {d:.3e} ({info_gpu['iterations']} iterations)")
    if not d <= 1e-6:
        raise AssertionError("small BA on the card disagrees with the CPU")

    if quick:
        log(json.dumps({"kernels": [], "quick": True}))
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # -- 4. main path at the Ladybug-1723 shape ------------------------------
    t0 = time.time()
    prob = synthetic.make_bal_problem(1723, 150000, 4, seed=0)
    log(f"ladybug problem: {prob.num_cameras} cams, {prob.num_points} pts, "
        f"{prob.num_observations} obs (made in {time.time() - t0:.2f} s)")
    lm = LMParams(max_iterations=20, relative_error_tol=1e-6,
                  lambda_policy="conservative", lambda_initial=1e-4,
                  lambda_lower_bound=1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.time()
    vals, info = ba.ba_optimize(prob, lm, verbose=True, target_error=TARGET,
                                device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = bk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tries = launches["ba_point_eliminate"]
    log(f"main path: half-chi2 {info['error']!r} (target {TARGET!r}) in "
        f"{info['iterations']} iterations, {tries} tries, wall {wall:.3f} s")
    log(f"  trajectory {info['history']}")
    log(f"  iter_times {info['iter_times']}")
    log(f"  peak device memory {peak / 2**30:.3f} GiB; launches {launches}")
    if not info["error"] <= TARGET:
        raise AssertionError(f"BA did not reach {TARGET}: {info['error']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

    # -- 5. kernels against their plain versions, and timed, at the Ladybug
    # shape (the converged state; lam = 1 as in phase 3, so conditioning
    # cannot mask a fault; the kernels' work does not depend on lam) --------
    big = Inputs(prob, 1.0, vals["cams"], vals["points"])
    check = check_kernels(big, bk, "ladybug")
    kernels = []
    for name, kern in bk.KERNELS.items():
        kfn = getattr(bk, kern.wrapper)
        pfn = getattr(bk, kern.wrapper + "_plain")
        args = big.args(name)
        ms = cuda_ms(lambda: kfn(*args), reps=20)
        plain_ms = cuda_ms(lambda: pfn(*args), reps=3, warmup=1)
        nbytes, flops = big.work(name)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP64_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gtsam_torch/csrc/{kern.source}.cu",
            "replaces": kern.replaces, "launches": launches[name],
            "max_abs_err": check[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        log(f"time {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms by {kernels[-1]['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); launches "
            f"{launches[name]}, {launches[name] / tries:.2f} per try")
    n = big.S.shape[0]
    zero_ms = cuda_ms(big.S.zero_, reps=5)
    info_t = torch.empty((), dtype=torch.int32, device="cuda")
    # the factorization of one try: S assembled at lam 1e-4, equilibrated
    ba.assemble(big.plan, big.A_cam, big.A_pt, big.b, 1e-4, False, big.S)
    s = torch.diagonal(big.S).clamp(min=1e-12).rsqrt()
    big.S.mul_(s[:, None]).mul_(s[None, :])
    S0 = big.S.clone()
    chol_ms = []
    for _ in range(3):   # each factorization overwrites S: restore, then time
        big.S.copy_(S0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.linalg.cholesky_ex(big.S.mT, out=(big.S.mT, info_t))
        b.record()
        b.synchronize()
        chol_ms.append(a.elapsed_time(b))
    del S0
    chol_bound = max(n ** 3 / 3 / FP64_TC_FLOPS,
                     2 * n * n * 8 / HBM_BYTES_PER_S) * 1e3
    del big
    t0 = time.time()
    ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                         prob.num_points)
    plan_s = time.time() - t0
    log(json.dumps({"library": {
        "cholesky_ex": {"ms": chol_ms, "n": n, "bound_ms": chol_bound,
                        "calls": tries},
        "S.zero_": {"ms": zero_ms, "bytes": n * n * 8}},
        "main_path": {"wall_s": wall, "plan_s": plan_s,
                      "iterations": info["iterations"], "tries": tries,
                      "half_chi2": info["error"], "peak_bytes": peak}}))

    # -- 6. where the time goes: one traced run of the main path -------------
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        ba.ba_optimize(prob, lm, target_error=TARGET, device="cuda")
        torch.cuda.synchronize()
        traced_ms = (time.time() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(json.dumps({"profile": {
        "wall_ms": traced_ms, "device_busy_ms": busy if rows else None,
        "idle_share": 1.0 - busy / traced_ms if rows else None,
        "by_kernel_ms": [[k[:80], ms, c] for k, ms, c in rows[:15]]}}))

    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
