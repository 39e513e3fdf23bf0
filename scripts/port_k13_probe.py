#!/usr/bin/env python3
"""Time kernel 13 (sp_level_factor) by level, beside the design before it
given as a source file, and kernel 16's CG iteration, on one card at the
sphere2500 shape.

    python3 scripts/port_k13_probe.py [--reps N] [--old PATH]

--old PATH: a copy of csrc/sp_level.cu whose gt_sp_level_factor launches
one leading level at a time (the design before the one-launch kernel:
`git show 34d1ccb:gtsam_torch/csrc/sp_level.cu > .chipcheck/k13_old.cu`),
built by nvcc into build/port_k13_probe/.  The probe runs
levenberg_marquardt with the level solver on chip_smoke.py's sphere
stand-in (50 x 50 poses, bench.py's prior, chordal start) to its
converged state, binds the subgraph preconditioner's tree there, and on
both plans (the sphere's levels at lam 1, the tree at its 1e-8) times
kernel 13 as the package builds it:

  - its one launch over every leading level (mean of N: CUDA events, and
    device time by torch.profiler);
  - the same launch with every flag already at its epoch (the epoch of the
    launch before, so every wait passes at once: the factor is not used),
    whose difference from the one launch is the hand-offs' cost;
  - by level: the kernel launched on one level's jobs at a time (the same
    flags and epoch, its sources done by the launches before it), and on
    the first l levels, l = 1 .. L_cut (a level's share of the one launch,
    hand-offs included), each launch's device time from CUDA events
    recorded between launches queued behind a spin kernel (so the host's
    pace does not enter);
  - with --old, the old design's launches, by level and whole, and its
    factor's largest difference from the new one's;

with the plan's columns, blocks, triples and sources a level.  Then kernel
16: a block-Jacobi solve of 500 iterations in one launch (device and wall
time an iteration), a subgraph CG iteration (wall and device time), and
the host's microseconds a call of pcg_loop's wrapper and of its C entry
(a group launched with the done word set).  Prints one JSON line a part,
and last one with every result and the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the launch-a-level design's C entry: a leading level a launch
# (J, d, cols, cptr, cblk, tptr, tik, tjk, A, pad, lam, L, rec, stream)
OLD_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [
    ctypes.c_double] + [ctypes.c_void_p] * 3


def _build_old(path, out_dir):
    """The old design's library, built by nvcc as the package's are."""
    from gtsam_torch import _build as b
    so = os.path.join(out_dir, "libk13_old.so")
    out = subprocess.run([b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC),
                          "-o", so, path], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(so)
    fn = lib.gt_sp_level_factor
    fn.argtypes = OLD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _queued_ms(torch, calls):
    """Device ms of each call of `calls`, queued behind a spin kernel so
    that the host has enqueued them all before the card starts: CUDA
    events between the calls."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(calls) + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for e, c in zip(ev, calls):
        e.record()
        c()
    ev[-1].record()
    ev[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]


def _plans(cs, torch):
    """{plan: (solver, blocks, lam)}: the level solver at the sphere's
    converged state (lam 1) and the subgraph tree there (1e-8); and the
    PCG solver and system there."""
    from gtsam_torch import LMParams
    from gtsam_torch.graph.graph import BoundGraph
    from gtsam_torch.linear.pcg import PCGSolver, SubgraphPCGSolver
    from gtsam_torch.optimize import optimizers as O
    graph, vals, _, _ = cs.sphere_graph(50, 50)
    res = O.levenberg_marquardt(graph, vals, LMParams(**cs.SPHERE_LM),
                                solver=O.SparseSolver(method="levels"),
                                device="cuda")
    v = res.values
    bound = BoundGraph(graph, v, "cuda")
    from gtsam_torch.linear.sparse import SparseCholeskySolver
    s = SparseCholeskySolver(bound)
    sg = SubgraphPCGSolver().bind(bound)
    tree = sg._tree
    ps = PCGSolver().bind(bound)
    return ({"levels": (s, s.system(v.arrays)[0], 1.0),
             "tree": (tree, tree.system(v.arrays)[0], 1e-8)},
            (ps, ps.system(v.arrays)), (sg, sg.system(v.arrays)))


def _factor_calls(K, s, blocks, lam, L, rec):
    """(one(levels, same_epoch), level(lv), new_epoch): the one-launch
    wrapper on the jobs of the first `levels` levels (with same_epoch, at
    the epoch of the launch before: every flag already holds it), and on
    level lv's jobs alone (one epoch for a factorization's launches: set by
    new_epoch())."""
    dv = s.dev
    flags = s._scratch_buffers()[4][2]
    ep = [s._next_epoch(s._scratch_buffers()[4])]

    def call(c0, c1):
        K.sp_level_factor(blocks, dv.f_cols[c0:c1], dv.f_cptr[c0:c1 + 1],
                          dv.f_cblk, dv.f_tptr, dv.f_tik, dv.f_tjk,
                          dv.f_lptr, dv.f_wptr[c0:c1 + 1], dv.f_wsrc,
                          dv.pad_diag, lam, L, rec[c0:c1], flags, ep[0])

    def new_epoch():
        ep[0] = s._next_epoch(s._scratch_buffers()[4])

    def one(levels=None, same_epoch=False):
        if not same_epoch:
            new_epoch()
        call(0, s.lev_off[levels if levels is not None else s.L_cut])

    def level(lv):
        call(s.lev_off[lv], s.lev_off[lv + 1])

    return one, level, new_epoch


def _old_calls(fn, s, blocks, lam, L, rec, stream):
    """The old design's launch of level lv (its C entry, a level's slices
    by pointer offsets)."""
    dv = s.dev

    def level(lv):
        c0, c1 = s.lev_off[lv], s.lev_off[lv + 1]
        err = fn(c1 - c0, s.d, dv.f_cols.data_ptr() + 4 * c0,
                 dv.f_cptr.data_ptr() + 4 * c0, dv.f_cblk.data_ptr(),
                 dv.f_tptr.data_ptr(), dv.f_tik.data_ptr(),
                 dv.f_tjk.data_ptr(), blocks.data_ptr(),
                 dv.pad_diag.data_ptr(), float(lam), L.data_ptr(),
                 rec.data_ptr() + 4 * c0, stream())
        if err:
            raise RuntimeError(f"old sp_level_factor: CUDA error {err}")

    return level


def _plan_levels(s):
    out = []
    for lv in range(s.L_cut):
        c0, c1 = s.lev_off[lv], s.lev_off[lv + 1]
        e0, e1 = s.f_cptr[c0], s.f_cptr[c1]
        out.append([int(c1 - c0), int(e1 - e0),
                    int(s.f_tptr[e1] - s.f_tptr[e0]),
                    int(s.f_wptr[c1] - s.f_wptr[c0])])
    return out


def _host_us(torch, kern, call, reps):
    """Microseconds of host time a call of `call` (a launch that returns at
    once on the card) through its wrapper, and of its C entry alone."""
    args = []
    fn = kern._fn
    kern._fn = lambda *a: (args.append(a), fn(*a))[1]
    try:
        call()
    finally:
        kern._fn = fn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        fn(*args[-1])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"host_wrapper_us": (t1 - t0) / reps * 1e6,
            "host_c_entry_us": (t2 - t1) / reps * 1e6}


def _cg(cs, torch, K, pcg, sub, reps):
    """Kernel 16: a block-Jacobi solve (its 500 iterations, a tolerance
    never met) in one launch, and a subgraph CG iteration."""
    ps, (pool, g, diag) = pcg
    ps.max_iterations, ps.tol = 500, 1e-300
    ps.solve((pool, g, diag), 1.0, False)
    torch.cuda.synchronize()
    its = ps.last_solve["iterations"]
    t0 = time.perf_counter()
    for _ in range(reps):
        ps.solve((pool, g, diag), 1.0, False)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    dev = cs.device_ms(lambda: ps.solve((pool, g, diag), 1.0, False), 3)
    out = {"jacobi_iterations": its, "jacobi_solve_s": wall,
           "jacobi_device_ms_per_iteration": dev / its,
           "jacobi_wall_ms_per_iteration": wall * 1e3 / its}
    sg, ssys = sub
    sg.max_iterations, sg.tol = 64, 1e-300
    sg.solve(ssys, 1e-3, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg.solve(ssys, 1e-3, False)
    torch.cuda.synchronize()
    out["subgraph_wall_ms_per_iteration"] = (time.perf_counter() - t0) \
        * 1e3 / 64
    out["subgraph_device_ms_per_iteration"] = cs.device_ms(
        lambda: sg.solve(ssys, 1e-3, False), 2) / 64
    # the host's time a call of the loop's wrapper: a group launched with
    # the done word set returns at once on the card
    st, ist = ps._state("cuda")
    ist[K.DONE] = 1
    vec = [torch.empty_like(g) for _ in range(6)]
    Minv = torch.empty_like(diag)

    def group():
        K.pcg_loop(K.G_MATVEC | K.G_UPDATE, False, pool, diag, Minv, g,
                   *vec[:5], *ps._mv_plan(), 1.0, 1e-9, 500, True, False, st,
                   ist)

    out.update(_host_us(torch, K.KERNELS["pcg_loop"], group, 200))
    out["stopped_group_device_ms"] = cs.device_ms(group, 20)
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--old", default=None)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_k13_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gtsam_torch import _kernels
    from gtsam_torch.linear import sparse_kernels as K
    old_fn = None
    if a.old:
        out_dir = os.path.join(ROOT, "build", "port_k13_probe")
        os.makedirs(out_dir, exist_ok=True)
        old_fn = _build_old(a.old, out_dir)
    plans, pcg, sub = _plans(cs, torch)
    res = {}
    dev = torch.device("cuda", torch.cuda.current_device())
    for p, (s, blocks, lam) in plans.items():
        rows = torch.as_tensor(s.f_cblk, dtype=torch.long, device=dev)
        L = torch.zeros_like(blocks)
        rec = torch.zeros(len(s.f_cols), dtype=torch.int32, device=dev)
        one, level, new_epoch = _factor_calls(K, s, blocks, lam, L, rec)
        one()
        torch.cuda.synchronize()
        new = L[rows].clone()
        r = {"levels": s.L_cut, "columns": len(s.f_cols),
             "plan_by_level": _plan_levels(s),
             "ms": cs.cuda_ms(one, a.reps),
             "device_ms": cs.device_ms(one, a.reps),
             "flags_set_ms": cs.cuda_ms(lambda: one(same_epoch=True),
                                        a.reps),
             "flags_set_device_ms": cs.device_ms(
                 lambda: one(same_epoch=True), a.reps)}
        new_epoch()
        r["by_level_ms"] = _queued_ms(
            torch, [lambda lv=lv: level(lv) for lv in range(s.L_cut)])
        r["prefix_ms"] = _queued_ms(
            torch, [lambda n=n: one(n) for n in range(1, s.L_cut + 1)])
        if old_fn is not None:
            old = _old_calls(old_fn, s, blocks, lam, L, rec,
                             lambda: _kernels.stream(dev))

            def whole(old=old, s=s):
                for lv in range(s.L_cut):
                    old(lv)
            L.zero_()
            whole()
            torch.cuda.synchronize()
            r["old"] = {
                "max_abs_diff_from_new": float((L[rows] - new).abs().max()),
                "ms": cs.cuda_ms(whole, a.reps),
                "device_ms": cs.device_ms(whole, a.reps),
                "by_level_ms": _queued_ms(
                    torch, [lambda lv=lv: old(lv) for lv in range(s.L_cut)])}
        res[p] = r
        print(json.dumps({p: r}), flush=True)
    cg = _cg(cs, torch, K, pcg, sub, 3)
    print(json.dumps({"cg": cg}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"k13": res, "cg": cg,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
