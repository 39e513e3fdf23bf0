#!/usr/bin/env python3
"""Break kernel 6's linearize and error kernels (csrc/pg_between.cu) down by
their parts, on one card, at the sphere2500 shape and at 50,000 factors.

    python3 scripts/port_pg_probe.py [--reps N] [--only a,b]
                                     [--alt NAME=PATH ...]

Compiles variants of gtsam_torch/csrc/pg_between.cu, each from a copy of
the source with text replacements (VARIANTS; a replacement whose text the
source no longer holds raises), one nvcc process each, into
build/port_pg_probe/, and prints each variant's ptxas register and spill
lines; --only keeps the named variants; --alt adds another copy of the
source as it is (an older tree's, to compare two designs in one call; a
source whose entry points predate the loss arguments is called with the
arguments it has, and times the loss-free calls only).  Then it binds the 50 x 50 stand-in of
scripts/port_sphere_data.py (chip_smoke.py's sphere graph, bench.py's
prior, chordal initialization, SparseSolver's supernodal plan) and makes
chip_smoke.py's synthetic batch of 50,000 between factors over 10,000 poses
(a gaussian model a factor), and times, as device time per launch
(torch.profiler over N launches), each variant's linearize and error launch
through the wrappers on the sphere's between batch, its prior and the
synthetic batch, each without a loss and under Huber (k = 1.345, the
robust-huber run's loss; "+huber" in the key).  A variant's difference from "base" is the time of the
part it cuts or changes; a cut variant computes nothing correct.  Prints
one JSON line with the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the stores of H: cut, which leaves the gv span (so phase 1 stays live)
_H_LOOP = "  for (int q = lane; q < npd; q += kLinThreads) {\n"

# variant: [(text of the source, its replacement)]
VARIANTS = {
    "base": [],
    "no_H_stores": [(_H_LOOP, _H_LOOP.replace("q < npd", "q < 0"))],
    "no_whitening": [("    whiten_into(kind, nz, D, C,",
                      "    whiten_into(0, nz, D, C,"),
                     ("      whiten_vec(kind, nz, r, wr);",
                      "      whiten_vec(0, nz, r, wr);")],
    "no_jr_inverse": [("    jr_inverse(r, Jw, Q2);\n",
                       "    for (int i = 0; i < 9; ++i) {\n"
                       "      Jw[i] = r[i % 6];\n"
                       "      Q2[i] = r[(i + 1) % 6];\n"
                       "    }\n")],
}


def _build(name, edits, out_dir, path=None):
    from gtsam_torch import _build as b
    src = open(path or b.CSRC / "pg_between.cu").read()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant {name}: the source no longer holds "
                             f"{old!r}")
        src = src.replace(old, new)
    cu = os.path.join(out_dir, f"pg_between_{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, f"libpg_between_{name}.so")
    proc = subprocess.Popen([b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC),
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, proc


def _params(src, name):
    """The parameter names of entry point gt_<name> in a source's text."""
    m = re.search(rf"GT_EXPORT int gt_{name}\(([^)]*)\)", src)
    return [re.findall(r"\w+", p)[-1] for p in m.group(1).split(",")]


def _entry(lib, kern, src):
    """gt_<kern.name> of `lib` as a function of the current argument list:
    the arguments an older source's entry point lacks are dropped."""
    from gtsam_torch import _build as b
    now = _params(open(b.CSRC / "pg_between.cu").read(), kern.name)
    old = _params(src, kern.name)
    fn = getattr(lib, "gt_" + kern.name)
    fn.restype = ctypes.c_int
    if old == now:
        fn.argtypes = kern.argtypes
        return fn, True
    keep = [now.index(n) for n in old]
    fn.argtypes = [kern.argtypes[i] for i in keep]
    return (lambda *a: fn(*(a[i] for i in keep))), False


def _launch_ms(fn, reps, key):
    """Device time of one launch of the kernels named `key` in fn."""
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


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build (default all)")
    ap.add_argument("--alt", action="append", default=[],
                    metavar="NAME=PATH")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_pg_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gtsam_torch.graph.graph import BoundGraph
    from gtsam_torch.linear import supernodal_kernels as K
    from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
    out_dir = os.path.join(ROOT, "build", "port_pg_probe")
    os.makedirs(out_dir, exist_ok=True)
    only = a.only.split(",") if a.only else list(VARIANTS)
    procs = {n: _build(n, e, out_dir) for n, e in VARIANTS.items()
             if n in only}
    srcs = {n: open(os.path.join(out_dir, f"pg_between_{n}.cu")).read()
            for n in procs}
    for alt in a.alt:
        n, path = alt.split("=", 1)
        procs[n] = _build(n, [], out_dir, os.path.abspath(path))
        srcs[n] = open(os.path.abspath(path)).read()
    libs, ptxas = {}, {}
    for n, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{out}")
        ptxas[n] = [line.strip() for line in out.splitlines()
                    if "registers" in line or "spill" in line]
        libs[n] = ctypes.CDLL(so)
    graph, vals, _, _ = cs.sphere_graph(50, 50)
    vals = vals.to("cuda")
    s = SupernodalCholeskySolver(BoundGraph(graph, vals, "cuda"),
                                 force_width=32)
    batches = {}
    for i, (b, st) in enumerate(zip(s.bound.graph.batches,
                                    s.bound.structures)):
        base = (vals.arrays["SE3"].R, vals.arrays["SE3"].t, st.rows_i32,
                b.measurements.R, b.measurements.t, b.noise.kind,
                b.noise.data, b.sign)
        name = "sphere_between" if b.arity == 2 else "sphere_prior"
        batches[name] = (base, s.dev.flips[i][1 if b.arity == 2 else 0], s.d)
    batches["synthetic_50000"] = cs.SE3Batches(
        [(cs.SE3_POSES, cs.SE3_BIG, 2, 6, "gaussian", True)]).batches[0]
    huber = cs.loss_args("huber", cs.HUBER_K)
    calls = {(kname, bname + tag): cs.se3_calls(
        kname, cs.with_loss([batch], la) if la else [batch])[0][0]()
        for kname in ("pg_linearize", "pg_error")
        for bname, batch in batches.items()
        for tag, la in (("", None), ("+huber", huber))}
    kerns = {k: K.KERNELS[k] for k in ("pg_linearize", "pg_error")}
    saved = {k: kern._fn for k, kern in kerns.items()}
    times = {}
    try:
        for n, lib in libs.items():
            with_loss = True
            for k, kern in kerns.items():
                kern._fn, same = _entry(lib, kern, srcs[n])
                with_loss &= same
            times[n] = {f"{k} {b}": _launch_ms(
                lambda k=k, args=args: getattr(K, k)(*args), a.reps,
                k + "_kernel") for (k, b), args in calls.items()
                if with_loss or not b.endswith("+huber")}
    finally:
        for k, kern in kerns.items():
            kern._fn = saved[k]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"device_ms_per_launch": times, "ptxas": ptxas,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
