#!/usr/bin/env python3
"""Time kernel 13's second entry (sp_tail_assemble: the dense root's M) by
its parts, on one card at the sphere2500 shape.

    python3 scripts/port_tail_probe.py [--reps N] [--only base,no_zero]

Compiles variants of gtsam_torch/csrc/sp_level.cu, each from a copy of the
source with text replacements (VARIANTS; a replacement whose text the
source no longer holds raises), one nvcc process each, into
build/port_tail_probe/, and prints each variant's ptxas register and spill
lines.  Then it binds chip_smoke.py's sphere stand-in (50 x 50 poses) to
the level-scheduled solver and to the subgraph preconditioner's tree,
factors each once (lam 1; the tree at its 1e-8), and times each variant's
launch through the wrapper on both roots by device time (torch.profiler)
and CUDA events, with its largest difference from the base variant's M.
The cuts give wrong M: their times show what a part costs.  Prints one
JSON line with the card's name and power limit.
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
    # no zero fill of M's blocks without a stored block
    "no_zero": [("  const int zero_ctas = (T * d + kTailWarps - 1) / "
                 "kTailWarps;", "  const int zero_ctas = 0;")],
    # the triples staged but not multiplied
    "no_products": [("        for (int u = 0; u < nt; ++u) acc[s] += "
                     "dot_rows<kD>(sw, u, d, i, k);",
                     "        acc[s] += sw[idx];"),
                    ("          ? dot_rows<6>(sw, lane >> 2, 6, 5, 2 + j) "
                     ": 0.0;", "          ? sw[lane] : 0.0;")],
    # the triples multiplied but not staged (the slice's old contents)
    "no_staging": [("      if (q < nt * 2 * dd) copy_async8(sw + q, L + "
                    "(int64_t)b * dd + w);\n", "")],
    # the blocks not stored to M
    "no_stores": [("    M[(int64_t)(r * d + i) * ld + c * d + k] = sw[idx];",
                   "    if (sw[idx] == 0.5) M[0] = 0.0;"),
                  ("      M[(int64_t)(c * d + k) * ld + r * d + i] = "
                   "sw[i * d + k];", "      if (sw[i] == 0.5) M[1] = 0.0;")],
}


def _source(name, edits):
    from gtsam_torch import _build as b
    with open(b.CSRC / "sp_level.cu") as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant {name}: the source no longer holds "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def _build(name, src, out_dir):
    from gtsam_torch import _build as b
    cu = os.path.join(out_dir, f"sp_level_{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, f"libsp_level_{name}.so")
    proc = subprocess.Popen([b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC),
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, proc


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=",".join(VARIANTS))
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_tail_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gtsam_torch.graph.graph import BoundGraph
    from gtsam_torch.linear import sparse_kernels as K
    from gtsam_torch.linear.pcg import SubgraphPCGSolver
    from gtsam_torch.linear.sparse import SparseCholeskySolver
    names = a.only.split(",")
    out_dir = os.path.join(ROOT, "build", "port_tail_probe")
    os.makedirs(out_dir, exist_ok=True)
    srcs = {n: _source(n, VARIANTS[n]) for n in names}
    procs = {n: _build(n, src, out_dir) for n, src in srcs.items()}
    outs = {n: proc.communicate()[0] for n, (_, proc) in procs.items()}
    libs, ptxas = {}, {}
    for n, (so, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{outs[n]}")
        ptxas[n] = [line.strip() for line in outs[n].splitlines()
                    if "registers" in line or "spill" in line]
        libs[n] = ctypes.CDLL(so)
    graph, vals, _, _ = cs.sphere_graph(50, 50)
    vals = vals.to("cuda")
    bound = BoundGraph(graph, vals, "cuda")
    s = SparseCholeskySolver(bound)
    tree = SubgraphPCGSolver().bind(bound)._tree
    roots = {}
    for p, sv, lam in (("sphere", s, 1.0), ("tree", tree, 1e-8)):
        blocks = sv.system(vals.arrays)[0]
        f = sv.factorize(blocks, lam)
        roots[p] = (sv, blocks, f.L, f.tail[0], lam)
    kern = K.KERNELS["sp_tail_assemble"]
    fn0 = kern._fn
    out, base = {}, {}
    try:
        for n, lib in libs.items():
            fn = lib.gt_sp_tail_assemble
            fn.argtypes = kern.argtypes
            fn.restype = ctypes.c_int
            kern._fn = fn
            out[n] = {"ptxas": ptxas[n]}
            for p, (sv, blocks, L, M, lam) in roots.items():
                dv = sv.dev

                def call(sv=sv, blocks=blocks, L=L, M=M, lam=lam, dv=dv):
                    K.sp_tail_assemble(blocks, L, dv.t_map, dv.t_bid,
                                       dv.t_pos, dv.l_ptr, dv.l_ik, dv.l_jk,
                                       dv.t_cols, dv.pad_diag, lam, M)
                M.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                if n == "base":
                    base[p] = M.clone()
                diff = float((M - base[p]).abs().nan_to_num(
                    float("inf")).max()) if p in base else None
                out[n][p] = {"ms": cs.cuda_ms(call, a.reps),
                             "device_ms": cs.device_ms(call, a.reps),
                             "max_diff_from_base": diff}
            print(n, json.dumps(out[n]), flush=True)
    finally:
        kern._fn = fn0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "variants": out,
                      "sphere": {"T": s.n_tail, "stored": len(s.tail_bids),
                                 "late": len(s.l_ik)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
