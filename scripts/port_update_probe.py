#!/usr/bin/env python3
"""Break kernel 7's Schur update (sn_schur_update) down by its parts and its
plan's choices, on one card at the sphere2500 shape or the w10000
stand-in's.

    python3 scripts/port_update_probe.py [--reps N] [--only a,b,...]
                                         [--graph sphere|standin]

Builds variants of csrc/sn_factor.cu, each compiled from a copy of the
source with text replacements (VARIANTS; a replacement whose text the
source no longer holds raises), all nvcc processes at once, under
build/port_update_probe/.  Binds the graph on the card (sphere: the 50 x 50
stand-in of scripts/port_sphere_data.py, bench.py's prior, chordal
initialization, SparseSolver's supernodal plan with force_width=32;
standin: the w10000 stand-in of scripts/port_2d_data.py at LAGO's start,
d = 3, the default plan), runs one factorization at lam = 1e-3 level by
level and keeps each wide level's inputs of the update (the front
kernel's L^-1 and At, the working store).  Then it times every level's
update, CUDA events (mean of N launches) and device time (torch.profiler,
N launches), under each plan of PLANS (the pitch of L^-1, At and U's
operand, the direct route of one-front levels): with the base library
and "fitted" (a 96-wide output tile, a multiple of d = 3 and 6, planned
with supernodal_kernels' tile constants set to match) all of them, with
each cut library "odd" and "plan" (the cut's difference from "base" is
the part's time).  Prints one JSON line: per library and plan the
per-level times and their sums, for "base" and "fitted" each plan's panel
and store against base "odd"'s (the largest difference relative to its
largest entry) and whether two launches give the same bits, the ptxas
lines of sn_schur_update_kernel, and the card's name and power limit.
The cut libraries' results are wrong by design; only their times mean
anything.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# library variant: [(text of the source, its replacement)]
_JOBS = "  const int jobs1 = S * mtn * ntn * nk1, jobs2 = S * per * nk2;"
_SCATTER_OFF = ("       idx < rows; idx += (int64_t)gridDim.x * kUThreads) {",
                "       idx < 0; idx += (int64_t)gridDim.x * kUThreads) {")
VARIANTS = {
    "base": [],
    # the slabs staged and awaited, no fragment loads and no products
    "no_products": [("            if (!(rows >> mb & 1u) || !(live >> (4 * mb"
                     " + nb) & 1u))\n              continue;\n",
                     "            continue;\n")],
    # the products on whatever the buffers hold, no copies
    "no_copies": [("      stage_kslab(P, ldp, k1, pcols, k0 + kTile * i, m0, "
                   "buf);\n      if (!same)\n        stage_kslab(Q, ldq, k1, "
                   "qcols, k0 + kTile * i, n0, buf + kUSlab);\n", "")],
    "no_scatter": [_SCATTER_OFF],
    "panel_only": [(_JOBS, "  const int jobs1 = S * mtn * ntn * nk1, "
                           "jobs2 = 0;"),
                   ("  if (nk2 > 1) {", "  if (false) {"), _SCATTER_OFF],
    # launch and the grid barriers only
    "empty": [(_JOBS, "  const int jobs1 = 0, jobs2 = 0;"),
              ("  if (nk1 > 1) {", "  if (false) {"),
              ("  if (nk2 > 1) {", "  if (false) {"), _SCATTER_OFF],
    "no_barriers": [("grid.sync();", ";")],
    # a 96 x 96 output tile (9 warps, one CTA an SM): no d x d block
    # straddles two tiles at d = 3 and 6
    "fitted": [("constexpr int kUT = 64;", "constexpr int kUT = 96;"),
               ("__launch_bounds__(kUThreads, 2)",
                "__launch_bounds__(kUThreads, 1)")],
}
# supernodal_kernels' constants of the Schur update's plan for the
# "fitted" library: its tile, its threads, and half the jobs of 64's
FITTED = {"UPDATE_TILE": 96, "UPDATE_THREADS": 9 * 32, "UPDATE_JOBS": 128}
# plan variants: (even pitches of L^-1, At and U's operand; the direct
# route where the level has one front)
PLANS = {"odd": (False, False),       # contiguous operands, scatter
         "even": (True, False),
         "plan": (True, True)}        # the plan's own


def _build(name, edits, out_dir):
    from gtsam_torch import _build as b
    src = (b.CSRC / "sn_factor.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant {name}: the source no longer holds "
                             f"{old!r}")
        src = src.replace(old, new)
    cu = os.path.join(out_dir, f"sn_factor_{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, f"libsn_factor_{name}.so")
    proc = subprocess.Popen([b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC),
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, proc


def _contiguous(K, fn):
    """fn() with supernodal_kernels' layout of the front kernel's L^-T and
    At at row pitches W*d and R*d (K.even_pitch the identity while it
    runs): contiguous, for the front kernel's new buffers and the Schur
    update's operands."""
    even = K.even_pitch
    K.even_pitch = int
    try:
        return fn()
    finally:
        K.even_pitch = even


def _standin():
    """(graph, LAGO values) of the w10000 stand-in, as chip_smoke.py's
    stand-in path builds them."""
    import tempfile
    import chip_smoke as cs
    from gtsam_torch.base import noise
    from gtsam_torch.graph import factors
    from gtsam_torch.io import datasets
    from gtsam_torch.slam.initialize import initialize_pose2_lago
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "w10000_standin.graph")
        cs._port_module("port_2d_data").write_manhattan_graph(path)
        graph, loaded = datasets.load_2d(path)
    graph.add(factors.prior_factors("SE2", [0], loaded.at(0)[None].numpy(),
                                    noise.sigmas(cs.PRIOR_SIGMAS_2D)))
    return graph, initialize_pose2_lago(graph)


def _plan(K, lv, d, variant, lib):
    """Level lv's SchurPlan under a plan variant for library `lib` (the
    "fitted" library's with FITTED's constants), and its At pitch."""
    even, direct = PLANS[variant]
    sp = lv.schur
    saved = {k: getattr(K, k) for k in FITTED}
    if lib == "fitted":
        for k, v in FITTED.items():
            setattr(K, k, v)
    try:
        plan = K.schur_plan(sp.src, sp.ptr, sp.tgt, sp.S, sp.W, sp.R, d,
                            sp.nb)
        if not direct and plan.split.direct:
            plan = plan._replace(split=K.update_split(
                sp.S, sp.W, sp.R, d, sp.tgt.shape[0]), utgt=None)
    finally:
        for k, v in saved.items():
            setattr(K, k, v)
    Rd = sp.R * d
    if not even:
        plan = plan._replace(split=plan.split._replace(
            pitch=Rd, scratch=plan.split.scratch
            - (sp.S * sp.W * d * plan.split.pitch if Rd % 2 else 0)))
    return plan, even


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="")
    ap.add_argument("--graph", default="sphere",
                    choices=("sphere", "standin"))
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_update_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gtsam_torch.graph.graph import BoundGraph
    from gtsam_torch.linear import supernodal_kernels as K
    from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
    names = [n for n in VARIANTS if not a.only or n in a.only.split(",")]
    out_dir = os.path.join(ROOT, "build", "port_update_probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {n: _build(n, VARIANTS[n], out_dir) for n in names}
    libs, ptxas = {}, {}
    for n, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{out}")
        lines = out.splitlines()
        at = [i for i, line in enumerate(lines) if "sn_schur_update" in line]
        ptxas[n] = [line.strip() for i in at for line in lines[i:i + 3]]
        libs[n] = ctypes.CDLL(so)
    if a.graph == "sphere":
        graph, vals, _, _ = cs.sphere_graph(50, 50)
        kw = dict(force_width=32)
    else:
        graph, vals = _standin()
        kw = {}
    vals = vals.to("cuda")
    s = SupernodalCholeskySolver(BoundGraph(graph, vals, "cuda"), **kw)
    blocks, _ = s.system(vals.arrays)
    dv = s.dev
    work = blocks.clone()
    inputs = []
    for lv in dv.levels:
        if lv.narrow is not None:
            raise RuntimeError("port_update_probe: a narrow level")
        rec = torch.empty(lv.S, dtype=torch.int32, device="cuda")
        _, Linv, At, _ = K.sn_front_factor(
            work, blocks, lv.diag_ids, lv.diag_flip, lv.diag_pad,
            lv.valid_diag, lv.col_vars, dv.dbc, lv.panel_ids, 1e-3, False,
            rec, ctas=lv.ctas)
        if lv.R:
            inputs.append((lv, Linv, At, work.clone()))
            K.sn_schur_update(Linv, At, lv.schur, work, dv.schur_U)
    kern = K.KERNELS["sn_schur_update"]
    fn0 = kern._fn
    times, ref, diffs, same = {}, {}, {}, {}
    try:
        for n, lib in libs.items():
            fn = lib.gt_sn_schur_update
            fn.argtypes = kern.argtypes
            fn.restype = ctypes.c_int
            kern._fn = fn
            full = n in ("base", "fitted")
            for pv in (PLANS if full else ("odd", "plan")):
                key = f"{n}/{pv}"
                ms, dev = [], []
                for k, (lv, Linv, At, wk) in enumerate(inputs):
                    plan, even = _plan(K, lv, s.d, pv, n)
                    X = Linv if even else Linv.mT.contiguous().mT
                    A = At if even else At.contiguous()
                    w = wk.clone()
                    out = torch.empty(A.shape, dtype=torch.float64,
                                      device="cuda")
                    scratch = torch.empty(plan.split.scratch,
                                          dtype=torch.float64, device="cuda")

                    def call(X=X, A=A, plan=plan, w=w, scratch=scratch,
                             out=out, even=even):
                        def run():
                            K.sn_schur_update(X, A, plan, w, scratch, out)
                        return run() if even else _contiguous(K, run)
                    if full:
                        got = []
                        for _ in range(2):
                            w.copy_(wk)
                            call()
                            got.append((out.clone(), w.clone()))
                        same.setdefault(key, []).append(all(
                            torch.equal(x, y) for x, y in zip(*got)))
                        if key == "base/odd":
                            ref[k] = got[0]
                        if k in ref:
                            diffs.setdefault(key, []).append(float(max(
                                (x - y).abs().max() / y.abs().max()
                                for x, y in zip(got[0], ref[k]))))
                    ms.append(cs.cuda_ms(call, reps=a.reps))
                    dev.append(cs.device_ms(call, reps=a.reps))
                times[key] = {"ms": ms, "device_ms": dev, "sum_ms": sum(ms),
                              "sum_device_ms": sum(dev)}
                cs.log(f"{key}: {sum(dev):.4f} ms device a factorization")
    finally:
        kern._fn = fn0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"graph": a.graph,
                      "levels": [(lv.S, lv.W * s.d, lv.R * s.d,
                                  lv.schur.split.direct)
                                 for lv, *_ in inputs],
                      "times": times, "rel_diff_from_base_odd": diffs,
                      "same_bits_twice": same, "ptxas": ptxas,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
