#!/usr/bin/env python3
"""Check and time kernel 7's narrow route (csrc/sn_narrow.cu) on one card.

    python3 scripts/port_narrow_probe.py [--root DIR] [--reps N] [--quick]

Imports gtsam_torch and chip_smoke.py (its timers and graphs) from DIR
(default: this checkout) and builds csrc/sn_narrow.cu, printing its ptxas
lines.  Then, along factorize's own path on the plain versions, it holds
each narrow kernel against its plain version on every narrow level of a
few plans, twice with the same bits, at lam 1 and 1e-4 with diagonal
damping off and on: the small graph-form BA (d = 9, force_width 4), the
6 x 8 sphere (d = 6, its five-pose level), the 60-pose Manhattan world
(d = 3) and the dubrovnik-16-22106 stand-in (its 21,636 one-point
fronts); the front kernel's L, L^-1, Lp, tile inverses and chunk rows,
relative to each output's largest entry, its records exactly; the scatter's
store relative to its largest entry.  Unless --quick it then times, on the
stand-in's level 0 at lam = 1 by CUDA events and device time (mean of N
calls): the narrow pair; the wide pair (sn_front_factor, sn_schur_update)
on the same level; the plain pair; the library calls on that level
(cholesky_ex + solve_triangular(L, I), the two bmm, index_add_ of U's
blocks); the root's front kernel and its library pair; and a whole
factorize().  Prints one JSON line with the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

# variants of csrc/sn_narrow.cu for --variants: [(text of the source, its
# replacement)]; a replacement whose text the source no longer holds raises.
# A cut variant computes nothing correct: its time against "base" is the
# cut part's.
VARIANTS = {
    "base": [],
    "regs64": [("__launch_bounds__(kMaxWarps * 32) sn_narrow_front_kernel",
                "__launch_bounds__(kMaxWarps * 32, 4) sn_narrow_front_kernel")],
    "regs80": [("__launch_bounds__(kMaxWarps * 32) sn_narrow_front_kernel",
                "__launch_bounds__(kMaxWarps * 32, 3) sn_narrow_front_kernel")],
    "batch8": [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "batch1": [("constexpr int kBatch = 4;", "constexpr int kBatch = 1;")],
    "no_sums": [("idx < groups * dd && R; idx += nthreads",
                 "idx < groups * dd && R < 0; idx += nthreads")],
    "no_tile": [("        T[e] = make_double2(x[0], x[1]);", "")],
    "no_factor": [("      for (int k = 0; k < Wd; ++k) {\n        const double piv",
                   "      for (int k = 0; k < 0; ++k) {\n        const double piv"),
                  ("      for (int r = 0; r < Wd; ++r) {\n        if (lane <= r)",
                   "      for (int r = 0; r < 0; ++r) {\n        if (lane <= r)")],
    "no_panel": [("      for (int r = lane; r < Rd; r += 32) {\n        double* a",
                  "      for (int r = lane; r < 0; r += 32) {\n        double* a")],
}


def build_variants(names, out_dir):
    """{name: the variant's gt_sn_narrow_front}, compiled from copies of
    csrc/sn_narrow.cu, one nvcc process each, into out_dir; each variant's
    ptxas lines printed."""
    from gtsam_torch import _build as b
    from gtsam_torch.linear import supernodal_kernels as K
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = (b.CSRC / "sn_narrow.cu").read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise ValueError(f"variant {name}: the source no longer "
                                 f"holds {old!r}")
            src = src.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(so).gt_sn_narrow_front
        fn.argtypes = K.KERNELS["sn_narrow_front"].argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _rel(got, ref):
    import torch
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    if not fin.any():
        return 0.0
    d = float((got[fin] - ref[fin]).abs().max())
    return d / max(float(ref[fin].abs().max()), 1e-300)


def check_solver(s, blocks, lam, dd, label, worst):
    """Each narrow level of solver s along factorize's path (the plain
    versions carry the working store from level to level): the narrow
    kernels against their plain versions, twice for the same bits."""
    import torch
    from gtsam_torch.linear import supernodal_kernels as K
    dv = s.dev
    work = blocks.clone()
    nan = float("nan")
    for k, lv in enumerate(dv.levels):
        rec_p = torch.empty(lv.S, dtype=torch.int32, device="cuda")
        args = (blocks, lv.diag_ids, lv.diag_flip, lv.diag_pad,
                lv.valid_diag, lv.col_vars, dv.dbc, lv.panel_ids, lam, dd)
        if lv.narrow is None:
            _, Linv, At, _ = K.sn_front_factor_plain(work, *args, rec_p)
            if lv.R:
                K.sn_schur_update_plain(Linv, At, lv.schur, work, None)
            continue
        plan = lv.narrow
        Wd, Rd = lv.W * s.d, lv.R * s.d
        part_p = torch.zeros_like(dv.narrow_part)
        ref = K.sn_narrow_front_plain(work, *args, rec_p, plan, part_p)
        outs = []
        for _ in range(2):
            rec = torch.full((lv.S,), -7, dtype=torch.int32, device="cuda")
            part = torch.full_like(dv.narrow_part, nan)
            bufs = [torch.full((lv.S, Wd, Wd), nan, dtype=torch.float64,
                               device="cuda") for _ in range(2)]
            bufs.append(torch.full((lv.S, Wd, Rd), nan, dtype=torch.float64,
                                   device="cuda") if lv.R else None)
            bufs.append(torch.full((lv.S, 32, 32), nan, dtype=torch.float64,
                                   device="cuda"))
            got = K.sn_narrow_front(work, *args, rec, plan, part,
                                    out=tuple(bufs))
            outs.append((got, rec, part))
        torch.cuda.synchronize()
        (g1, r1, p1), (g2, r2, p2) = outs
        n = plan.nrows * s.d ** 2
        same = (all(torch.equal(a, b) for a, b in zip(g1, g2)
                    if a is not None) and torch.equal(r1, r2)
                and torch.equal(p1[:n], p2[:n]))
        errs = {"L": _rel(g1[0], ref[0]), "Linv": _rel(g1[1], ref[1]),
                "tiles": _rel(g1[3], ref[3]),
                "rec_equal": bool(torch.equal(r1, rec_p))}
        if lv.R:
            errs["Lp"] = _rel(g1[2], ref[2])
            errs["part"] = _rel(p1[:n], part_p[:n])
            w1, w2, w3 = work.clone(), work.clone(), work.clone()
            K.sn_narrow_scatter(ref[2], part_p, plan, w1)
            K.sn_narrow_scatter(ref[2], part_p, plan, w2)
            K.sn_narrow_scatter_plain(ref[2], part_p, plan, w3)
            torch.cuda.synchronize()
            same = same and torch.equal(w1, w2)
            errs["store"] = _rel(w1, w3)
            work = w3
        print(f"{label} lam={lam} dd={dd} level {k} (S {lv.S}, W*d {Wd}, "
              f"R*d {Rd}, chunks {plan.cptr.numel() - 1}, rows "
              f"{plan.nrows}, warps {plan.warps}): same bits {same}; "
              f"{json.dumps(errs)}", flush=True)
        for key, v in errs.items():
            if key != "rec_equal":
                worst[key] = max(worst.get(key, 0.0), v)
        if not (same and errs["rec_equal"]):
            raise AssertionError(f"{label}: the narrow kernels repeat or "
                                 "record otherwise")


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--variants", default="",
                    help="comma-separated VARIANTS to time level 0's "
                    "narrow front kernel by")
    ap.add_argument("--chunks", default="",
                    help="comma-separated chunk sizes to time level 0's "
                    "narrow pair at (its plan rebuilt at each)")
    a = ap.parse_args(argv)
    sys.path.insert(0, a.root)
    import torch
    import chip_smoke as cs
    from gtsam_torch import _build
    from gtsam_torch.graph.graph import BoundGraph
    from gtsam_torch.linear import supernodal_kernels as K
    from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
    from gtsam_torch.sfm import bal, synthetic
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    _build.build(("sn_narrow",))
    for line in _build.BUILD_LOG.get("sn_narrow", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip(), flush=True)

    prob = synthetic.make_bal_problem(*cs.SFM_SMALL, seed=0)
    cases = {"graph BA": (*bal.to_graph(prob), dict(force_width=4,
                                                    max_width=8)),
             "sphere 6x8": (*cs.sphere_graph(6, 8)[:2],
                            dict(force_width=4, max_width=8)),
             "manhattan 60": (*cs.manhattan_graph(60, 150),
                              dict(force_width=4, max_width=8))}
    prob = synthetic.make_bal_problem(*cs.SFM_SHAPE, seed=0)
    cases["sfm"] = (*bal.to_graph(prob), dict(order=cs.SFM_ORDER))
    worst, out = {}, {"card": smi}
    sfm = None
    for label, (graph, vals, kw) in cases.items():
        vals = vals.to("cuda")
        s = SupernodalCholeskySolver(BoundGraph(graph, vals, "cuda"), **kw)
        print(f"{label}: d {s.d}, levels (S, W, R, narrow) "
              f"{[(lp.S, lp.W, lp.R, lp.narrow) for lp in s.level_plans]}",
              flush=True)
        blocks, _ = s.system(vals.arrays)
        lams = (1.0,) if label == "sfm" else (1.0, 1e-4)
        for lam in lams:
            for dd in (False, True):
                check_solver(s, blocks, lam, dd, label, worst)
        if label == "sfm":
            sfm = (s, blocks)
    out["worst_rel"] = worst
    print(f"worst relative errors {json.dumps(worst)}", flush=True)
    if a.quick:
        print(json.dumps(out))
        return 0
    # times on the stand-in's level 0 (lam = 1)
    s, blocks = sfm
    dv, lv, root = s.dev, s.dev.levels[0], s.dev.levels[1]
    lam, reps = 1.0, a.reps
    rec = torch.empty(lv.S, dtype=torch.int32, device="cuda")
    args = (blocks, lv.diag_ids, lv.diag_flip, lv.diag_pad, lv.valid_diag,
            lv.col_vars, dv.dbc, lv.panel_ids, lam, False, rec)
    work = blocks.clone()
    part = dv.narrow_part
    _, _, Lp, _ = K.sn_narrow_front(work, *args, lv.narrow, part)
    U = torch.empty(lv.schur.split.scratch, dtype=torch.float64,
                    device="cuda")
    _, Linv, At, _ = K.sn_front_factor(work, *args)
    front = K._front_gather(work, *args[:-1], 1e-6, 1e32)[0]
    eye = torch.eye(lv.W * s.d, dtype=torch.float64,
                    device="cuda").expand(lv.S, -1, -1)
    Ub = K._u_blocks(Lp, lv.S, lv.R, s.d)
    owner = K.segment_owner(lv.schur.ptr)
    tgt = lv.schur.tgt.long()[owner]
    src = lv.schur.src.long()

    def lib():
        L = torch.linalg.cholesky_ex(front)[0]
        X = torch.linalg.solve_triangular(L, eye, upper=False)
        P = torch.bmm(X, At).mT
        torch.bmm(P, P.mT)
        work.index_add_(0, tgt, Ub[src], alpha=-1.0)
    rargs = (blocks, root.diag_ids, root.diag_flip, root.diag_pad,
             root.valid_diag, root.col_vars, dv.dbc, root.panel_ids, lam,
             False, torch.empty(1, dtype=torch.int32, device="cuda"))
    rfront = K._front_gather(work, *rargs[:-1], 1e-6, 1e32)[0]
    reye = torch.eye(root.W * s.d, dtype=torch.float64, device="cuda")[None]

    def rlib():
        L = torch.linalg.cholesky_ex(rfront)[0]
        torch.linalg.solve_triangular(L, reye, upper=False)
    calls = {
        "narrow_front": lambda: K.sn_narrow_front(work, *args, lv.narrow,
                                                  part),
        "narrow_scatter": lambda: K.sn_narrow_scatter(Lp, part, lv.narrow,
                                                      work),
        "wide_front": lambda: K.sn_front_factor(work, *args),
        "wide_update": lambda: K.sn_schur_update(Linv, At, lv.schur, work,
                                                 U),
        "plain_pair": lambda: K.sn_narrow_scatter_plain(
            K.sn_narrow_front_plain(work, *args, lv.narrow, part)[2], part,
            lv.narrow, work),
        "library_level0": lib,
        "root_front": lambda: K.sn_front_factor(work, *rargs),
        "root_library": rlib,
        "factorize": lambda: s.factorize(blocks, 1e-3)}
    times = {}
    for name, fn in calls.items():
        r = 2 if name == "plain_pair" else reps
        times[name] = {"ms": cs.cuda_ms(fn, reps=r),
                       "device_ms": cs.device_ms(fn, reps=r)}
        print(f"time {name}: {json.dumps(times[name])}", flush=True)
    out["times"] = times
    # the narrow pair on level 0 with its chunk plan cut at other sizes
    sweep = {}
    chunk0 = K.NARROW_CHUNK
    lp0 = s.level_plans[0]
    for c in [int(x) for x in a.chunks.split(",") if x]:
        K.NARROW_CHUNK = c
        plan = K.narrow_plan(lp0, s.schur_ptr[0], s.d, s.B + 1, "cuda")
        part_c = torch.empty(plan.nrows * s.d ** 2, dtype=torch.float64,
                             device="cuda")
        fr = lambda: K.sn_narrow_front(work, *args, plan, part_c)
        _, _, Lpc, _ = fr()
        sc = lambda: K.sn_narrow_scatter(Lpc, part_c, plan, work)
        sweep[c] = {"chunks": plan.cptr.numel() - 1, "rows": plan.nrows,
                    "rows_max": plan.rows_max,
                    "front_device_ms": cs.device_ms(fr, reps=reps),
                    "scatter_device_ms": cs.device_ms(sc, reps=reps)}
        print(f"chunk {c}: {json.dumps(sweep[c])}", flush=True)
    out["chunk_sweep"] = sweep
    # the narrow front kernel's variants on level 0 (at NARROW_CHUNK)
    names = [x for x in a.variants.split(",") if x]
    if names:
        K.NARROW_CHUNK = chunk0
        kern = K.KERNELS["sn_narrow_front"]
        fns = build_variants(names, os.path.join(a.root, "build",
                                                 "port_narrow_probe"))
        base_fn = kern._fn
        var = {}
        for name in names:
            kern._fn = fns[name]
            fr = lambda: K.sn_narrow_front(work, *args, lv.narrow, part)
            var[name] = cs.device_ms(fr, reps=reps)
            print(f"variant {name}: {var[name]:.4f} ms device", flush=True)
        kern._fn = base_fn
        out["variants"] = var
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
