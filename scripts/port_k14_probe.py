#!/usr/bin/env python3
"""Time kernel 14 (sp_level_forward, sp_level_backward) by its parts, on
one card at the sphere2500 shape.

    python3 scripts/port_k14_probe.py [--reps N] [--only base,spin]
                                      [--alt NAME=PATH ...]

Compiles variants of gtsam_torch/csrc/sp_level.cu, each from a copy of the
source with text replacements (VARIANTS; a replacement whose text the
source no longer holds raises), one nvcc process each, into
build/port_k14_probe/, and prints each variant's ptxas register and spill
lines; --alt compiles another copy of the source with the same C entry
points (an earlier design, say) beside them under NAME.  Then it binds chip_smoke.py's sphere stand-in (50 x 50 poses,
bench.py's prior, chordal start) to the level-scheduled solver and to the
subgraph preconditioner's tree, factors each once (lam 1; the tree at its
1e-8), and times each variant's forward and backward launch through the
wrappers, on both plans, with CUDA events (mean of N back-to-back calls, a
new epoch each; bound by the host where the launch is short) and by
device time (torch.profiler), beside the base variant's launches with the
done word set (the launch and its CTAs' start alone) and the host's time
a call (wrapper, and its C entry point alone), and each variant's
largest difference from the base outputs.  Prints one JSON line with the
card's name and power limit.
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
    # poll without sleeping between the loads of a flag
    "spin": [("      __nanosleep(32);\n", "")],
    # poll with relaxed loads, then one fence once every flag is seen
    "relaxed_poll": [
        ("    while (ld_acquire(flags + k) != epoch) {",
         "    while (*(volatile const int*)(flags + k) != epoch) {"),
        ("  __syncwarp();\n}\n\n// Lane c of group",
         "  __threadfence();\n  __syncwarp();\n}\n\n// Lane c of group")],
    # a slice of 160 doubles: the diagonal block and three of the list
    "small_slice": [("constexpr int kSlice = 1024;",
                     "constexpr int kSlice = 160;")],
    # the source rows read a block at a time
    "batch1": [("constexpr int kBatch = 8;", "constexpr int kBatch = 1;")],
    # the substitution dividing by L_jj's diagonal on the chain (the
    # reciprocals not taken before the wait)
    "divide": [("if (lane == k) acc *= rinv;",
                "if (lane == k) acc /= sl[k * d + k];"),
               ("if (lane == k) x *= rinv;",
                "if (lane == k) x /= sl[k * d + k];")],
    # cuts (their results are wrong; their times show what a part costs):
    # no wait on the sources: every job at once (the chain removed)
    "cut_wait": [("    if (k >= nflag) continue;", "    continue;")],
}


def _source(name, edits, path=None):
    """The text of variant `name`: csrc/sp_level.cu (or `path`) with its
    replacements made."""
    from gtsam_torch import _build as b
    with open(path or b.CSRC / "sp_level.cu") as f:
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


def _plans(cs, torch):
    """{plan: (solver, factor, rhs, rhs map)}: the level solver on the
    sphere's padded g at lam 1, the subgraph tree on the PCG g through
    map_canon at 1e-8, as the main paths call them."""
    from gtsam_torch.graph.graph import BoundGraph
    from gtsam_torch.linear.pcg import SubgraphPCGSolver
    from gtsam_torch.linear.sparse import SparseCholeskySolver
    graph, vals, _, _ = cs.sphere_graph(50, 50)
    vals = vals.to("cuda")
    bound = BoundGraph(graph, vals, "cuda")
    s = SparseCholeskySolver(bound)
    blocks, g = s.system(vals.arrays)
    sg = SubgraphPCGSolver().bind(bound)
    _, gp, _, tf = sg.system(vals.arrays)
    tree = sg._tree
    return {"levels": (s, s.factorize(blocks, 1.0), g.reshape(-1), None),
            "tree": (tree, tf, gp, tree.dev.map_canon)}


def _host_us(torch, kern, call, reps):
    """Microseconds of host time a call of `call` (a launch that returns at
    once on the card, so the host sets the pace) through its wrapper, and
    of the kernel's C entry point alone with the same arguments."""
    import time
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


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--alt", action="append", default=[])
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_k14_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gtsam_torch.linear import sparse_kernels as K
    names = a.only.split(",")
    out_dir = os.path.join(ROOT, "build", "port_k14_probe")
    os.makedirs(out_dir, exist_ok=True)
    # every variant's text first, so that a stale replacement raises
    # before any nvcc starts
    srcs = {n: _source(n, VARIANTS[n]) for n in names}
    for alt in a.alt:
        n, path = alt.split("=", 1)
        srcs[n] = _source(n, [], path)
    procs = {n: _build(n, src, out_dir) for n, src in srcs.items()}
    libs, ptxas = {}, {}
    outs = {n: proc.communicate()[0] for n, (_, proc) in procs.items()}
    for n, (so, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{outs[n]}")
        ptxas[n] = [line.strip() for line in outs[n].splitlines()
                    if "registers" in line or "spill" in line][-4:]
        libs[n] = ctypes.CDLL(so)
    plans = _plans(cs, torch)
    kern = {k: K.KERNELS[k] for k in ("sp_level_forward",
                                      "sp_level_backward")}
    fn0 = {k: kn._fn for k, kn in kern.items()}
    out, base = {}, {}
    try:
        for n, lib in libs.items():
            for k, kn in kern.items():
                fn = getattr(lib, "gt_" + k)
                fn.argtypes = kn.argtypes
                fn.restype = ctypes.c_int
                kn._fn = fn
            out[n] = {}
            for p, (s, f, rhs, rmap) in plans.items():
                n_, d, T = s.nvars, s.d, s.n_tail
                bufs = (torch.zeros((n_, d), dtype=torch.float64,
                                    device="cuda"),
                        torch.zeros((n_ + T, d), dtype=torch.float64,
                                    device="cuda"),
                        torch.zeros((T, d), dtype=torch.float64,
                                    device="cuda"),
                        torch.zeros(s.layout.total_dim, dtype=torch.float64,
                                    device="cuda"))
                fwd, bwd, prep = cs.kernel14_calls(s, f, rhs, rmap)
                prep(*bufs)
                bwd()
                torch.cuda.synchronize()
                res = (bufs[0].clone(), bufs[3].clone())
                row = {"forward_ms": cs.cuda_ms(fwd, a.reps),
                       "backward_ms": cs.cuda_ms(bwd, a.reps),
                       "forward_device_ms": cs.device_ms(fwd, a.reps),
                       "backward_device_ms": cs.device_ms(bwd, a.reps)}
                if n == "base":
                    base[p] = res
                    stop = torch.ones(K.IST_SIZE, dtype=torch.int32,
                                      device="cuda")
                    sf, sb, sp = cs.kernel14_calls(s, f, rhs, rmap, stop)
                    sp(*(t.clone() for t in bufs))
                    row["stopped_forward_device_ms"] = cs.device_ms(sf,
                                                                    a.reps)
                    row["stopped_backward_device_ms"] = cs.device_ms(sb,
                                                                     a.reps)
                    row.update(_host_us(torch, kern["sp_level_forward"],
                                        sf, a.reps))
                elif p in base:
                    row["max_abs_diff"] = max(
                        float((x - y).abs().max())
                        for x, y in zip(res, base[p]))
                out[n][p] = row
            print(json.dumps({n: out[n]}), flush=True)
    finally:
        for k, kn in kern.items():
            kn._fn = fn0[k]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"variants": out, "ptxas": ptxas,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
