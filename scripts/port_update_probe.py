#!/usr/bin/env python3
"""Break kernel 7's Schur update (sn_schur_update) down by its parts, on one
card at the sphere2500 shape.

    python3 scripts/port_update_probe.py [--reps N] [--only a,b,...]

Builds variants of csrc/sn_factor.cu, each compiled from a copy of the
source with text replacements (VARIANTS; a replacement whose text the
source no longer holds raises), all nvcc processes at once, under
build/port_update_probe/.  Binds the sphere-shaped stand-in of
scripts/port_sphere_data.py (50 x 50 poses, bench.py's prior, chordal
initialization) on the card with SparseSolver's supernodal plan
(force_width=32), runs one factorization at lam = 1e-3 level by level and
keeps each level's inputs of the update (the front kernel's L^-1 and At,
the working store).  Then it times, for each variant, the update of every
level with a panel: CUDA events (mean of N launches) and device time
(torch.profiler, N launches).  Prints one JSON line: per variant the
per-level times and their sums (and the base kernel's again on plans split
otherwise, SPLITS, each level's panel and store beside the unsplit
kernel's: the largest difference relative to its largest entry), whether
one launch captured in a CUDA graph replays to the bits of a direct
launch, the ptxas lines of sn_schur_update_kernel, and the card's name
and power limit.  The variants' results are wrong by design; only their times mean
anything.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# variant: [(text of the source, its replacement)]
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
}
# the base library again on plans split otherwise: no product split (one
# k-chunk a tile), or with UPDATE_JOBS at 512
SPLITS = {"base_no_split": None, "base_jobs512": 512, "base_jobs1024": 1024}


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


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="")
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
        ptxas[n] = [line.strip() for i in at[-1:]
                    for line in lines[i:i + 3]]
        libs[n] = ctypes.CDLL(so)
    graph, vals, _, _ = cs.sphere_graph(50, 50)
    vals = vals.to("cuda")
    s = SupernodalCholeskySolver(BoundGraph(graph, vals, "cuda"),
                                 force_width=32)
    blocks, _ = s.system(vals.arrays)
    dv = s.dev
    work = blocks.clone()
    inputs = []
    for lv in dv.levels:
        rec = torch.empty(lv.S, dtype=torch.int32, device="cuda")
        _, Linv, At, _ = K.sn_front_factor(
            work, blocks, lv.diag_ids, lv.diag_flip, lv.diag_pad,
            lv.valid_diag, lv.col_vars, dv.dbc, lv.panel_ids, 1e-3, False,
            rec)
        if lv.R:
            inputs.append((lv, Linv, At, work.clone()))
            K.sn_schur_update(Linv, At, lv.schur, work, dv.schur_U)
    kern = K.KERNELS["sn_schur_update"]
    fn0 = kern._fn
    times, ref, diffs = {}, {}, {}
    try:
        for n, lib in libs.items():
            fn = lib.gt_sn_schur_update
            fn.argtypes = kern.argtypes
            fn.restype = ctypes.c_int
            kern._fn = fn
            for key in (["base_no_split", n] + [k for k in SPLITS
                                                if k != "base_no_split"]
                        if n == "base" else [n]):
                ms, dev = [], []
                for lv, Linv, At, wk in inputs:
                    w = wk.clone()
                    out = torch.empty(At.shape, dtype=torch.float64,
                                      device="cuda")
                    plan = lv.schur
                    if key in SPLITS:
                        jobs = K.UPDATE_JOBS
                        K.UPDATE_JOBS = SPLITS[key] or 1
                        plan = plan._replace(split=K.update_split(
                            lv.S, lv.W, lv.R, s.d, plan.tgt.shape[0]))
                        K.UPDATE_JOBS = jobs
                    scratch = torch.empty(plan.split.scratch,
                                          dtype=torch.float64, device="cuda")

                    def call():
                        K.sn_schur_update(Linv, At, plan, w, scratch, out)
                    if n == "base":
                        # each split's panel and store against the unsplit
                        # kernel's (another order of the same sums)
                        w.copy_(wk)
                        call()
                        got = (out.clone(), w.clone())
                        if key == "base_no_split":
                            ref[lv.S, lv.W] = got
                        diffs.setdefault(key, []).append(
                            float(max((x - y).abs().max() / y.abs().max()
                                      for x, y in zip(got, ref[lv.S, lv.W])))
                            if (lv.S, lv.W) in ref else None)
                    ms.append(cs.cuda_ms(call, reps=a.reps))
                    dev.append(cs.device_ms(call, reps=a.reps))
                times[key] = {"ms": ms, "device_ms": dev, "sum_ms": sum(ms),
                              "sum_device_ms": sum(dev)}
    finally:
        kern._fn = fn0
    # one launch captured in a CUDA graph (as a try would be) and replayed:
    # the same bits as a direct launch on the same inputs
    lv, Linv, At, wk = inputs[0]
    outs = []
    for capture in (False, True):
        w = wk.clone()
        out = torch.empty(At.shape, dtype=torch.float64, device="cuda")
        if capture:
            graph = torch.cuda.CUDAGraph()
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream), torch.cuda.graph(graph,
                                                             stream=stream):
                K.sn_schur_update(Linv, At, lv.schur, w, dv.schur_U, out)
            graph.replay()
        else:
            K.sn_schur_update(Linv, At, lv.schur, w, dv.schur_U, out)
        torch.cuda.synchronize()
        outs.append((out, w))
    captured = all(torch.equal(x, y) for x, y in zip(*outs))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"levels": [(lv.S, lv.W * s.d, lv.R * s.d)
                                 for lv, *_ in inputs],
                      "times": times, "split_rel_diff": diffs,
                      "graph_capture_same_bits": captured,
                      "ptxas": ptxas,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
