#!/usr/bin/env python3
"""Break kernel 7's front kernel (sn_front_factor) down by its parts, on one
card at the sphere2500 shape.

    python3 scripts/port_front_probe.py [--reps N]

Compiles variants of gtsam_torch/csrc/sn_factor.cu, each from a copy of the
source with text replacements (VARIANTS; a replacement whose text the
source no longer holds raises), one nvcc process each, into
build/port_front_probe/, and prints each variant's ptxas register and spill
lines.  Then it binds the 50 x 50 stand-in of scripts/port_sphere_data.py
(chip_smoke.py's sphere path: bench.py's prior, chordal initialization,
SparseSolver's supernodal plan, force_width=32), assembles the system and
times, with CUDA events (mean of N calls), every variant's launch on each
level's fronts gathered from the assembled store (lam 1e-3), through the
wrapper.  A variant's difference from "base" is the time of the part it
cuts; a cut variant computes nothing correct.  Prints one JSON line with
the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# variant: [(text of the source, its replacement)]
VARIANTS = {
    "base": [],
    "no_products": [("                        bool lower = false, int h0 = 0, "
                     "int h1 = 2) {\n",
                     "                        bool lower = false, int h0 = 0, "
                     "int h1 = 2) {\n  if (n >= 0) return;\n")],
    "no_factor": [("    chol::factor_block(b);\n", "    __syncthreads();\n")],
    "no_inverse": [("  for (int i = 1; i < nb; ++i) {\n    const int wi",
                    "  for (int i = 1; i < 0; ++i) {\n    const int wi")],
    "no_mma": [("      mma_slab(acc, buf + at * kTileSz, Bt, c, live);\n",
                "")],
    "no_panel": [("  if (R > 0) {\n    double* Ats",
                  "  if (R < 0) {\n    double* Ats")],
    "no_gather": [("  for (int a = gw; a < W; a += nw) {\n"
                   "    const int cend",
                   "  for (int a = gw; a < 0; a += nw) {\n"
                   "    const int cend")],
    "no_xcopy": [("        Wk[(int64_t)(o + C) * ldx + o + r] =\n"
                  "            finite_or_zero(dsm[C * (kNB + 1) + r]);",
                  "        ;")],
}


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
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_front_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gtsam_torch.graph.graph import BoundGraph
    from gtsam_torch.linear import supernodal_kernels as K
    from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
    out_dir = os.path.join(ROOT, "build", "port_front_probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {n: _build(n, e, out_dir) for n, e in VARIANTS.items()}
    libs, ptxas = {}, {}
    for n, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{out}")
        ptxas[n] = [line.strip() for line in out.splitlines()
                    if "sn_front_factor" in line or "spill" in line
                    or "registers" in line][-2:]
        libs[n] = ctypes.CDLL(so)
    graph, vals, _, _ = cs.sphere_graph(50, 50)
    vals = vals.to("cuda")
    s = SupernodalCholeskySolver(BoundGraph(graph, vals, "cuda"),
                                 force_width=32)
    blocks, _ = s.system(vals.arrays)
    dv = s.dev
    kern = K.KERNELS["sn_front_factor"]
    fn0 = kern._fn
    times = {}
    try:
        for n, lib in libs.items():
            fn = lib.gt_sn_front_factor
            fn.argtypes = kern.argtypes
            fn.restype = ctypes.c_int
            kern._fn = fn
            row = []
            for lv in dv.levels:
                rec = torch.empty(lv.S, dtype=torch.int32, device="cuda")
                args = (blocks, blocks, lv.diag_ids, lv.diag_flip,
                        lv.diag_pad, lv.valid_diag, lv.col_vars, dv.dbc,
                        lv.panel_ids, 1e-3, False, rec)
                row.append(cs.cuda_ms(lambda: K.sn_front_factor(*args),
                                      reps=a.reps))
            times[n] = row
    finally:
        kern._fn = fn0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"levels": [(lp.S, lp.W * s.d, lp.R * s.d)
                                 for lp in s.level_plans],
                      "ms": times, "ptxas": ptxas,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
