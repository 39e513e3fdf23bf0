#!/usr/bin/env python3
"""Time kernel 12 (sn_front_qr) by its panel width and its CTAs a front, on
one card at the sphere2500 shape.

    python3 scripts/port_qr_probe.py [--reps N] [--only base,nb32]
                                     [--alt NAME=PATH ...]

Compiles variants of gtsam_torch/csrc/sn_qr.cu, each from a copy of the
source with text replacements (VARIANTS; a replacement whose text the
source no longer holds raises), one nvcc process each, into
build/port_qr_probe/, and prints each variant's ptxas register and spill
lines; --alt compiles another copy of the source (an older design, say)
beside them under NAME.  Then it binds chip_smoke.py's sphere stand-in (50 x 50 poses,
bench.py's prior, chordal start, the sparse QR's supernodal plan,
force_width=32), forms kernel 6's Jacobian pool, factors it once at lam 1
(every level's children's R_sep in place) and, level by level, times with
CUDA events (mean of N calls) each variant's launch through the wrapper
with the default CTAs a front (supernodal_kernels.qr_ctas) and with one
CTA a front, and holds each variant's R against the plain version's (max
error over the largest entry).  Prints one JSON line with the card's name
and power limit.
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
    # 32-column panels: half the panels and trailing passes, a panel twice
    # as wide (in shared memory up to 772 rows, else through L2)
    "nb32": [("constexpr int kNb = 16;", "constexpr int kNb = 32;")],
    # every panel in place in the scratch (through L1 and L2)
    "panel_in_l2": [("const bool in_smem = (int64_t)h * tw <= kRegion;",
                     "const bool in_smem = false;")],
    # cuts (their results are wrong; their times show what a part costs):
    # the panel's column work (dots and updates; barriers kept)
    "cut_columns": [("for (int j = k + 1 + warp; j < tw; j += kWarps) {",
                     "for (int j = tw + warp; j < tw; j += kWarps) {")],
    # every trailing update
    "cut_apply": [("  const int k0 = p * kNb, c0 = j * kNb;\n",
                   "  if (p >= 0) return;\n"
                   "  const int k0 = p * kNb, c0 = j * kNb;\n")],
    # G = V^T V and T
    "cut_gram_t": [("  gram<true>(f, k0, wp, 0, 0, sh.region, sh.W);\n"
                    "  double* T = sh.T[p & 1];\n  if (warp == 0) {",
                    "  double* T = sh.T[p & 1];\n  if (warp < 0) {")],
}


def _source(name, edits, path=None):
    """The text of variant `name`: csrc/sn_qr.cu (or `path`) with its
    replacements made."""
    from gtsam_torch import _build as b
    with open(path or b.CSRC / "sn_qr.cu") as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant {name}: the source no longer holds "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def _build(name, src, out_dir):
    from gtsam_torch import _build as b
    cu = os.path.join(out_dir, f"sn_qr_{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, f"libsn_qr_{name}.so")
    proc = subprocess.Popen([b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC),
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, proc


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--alt", action="append", default=[])
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_qr_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gtsam_torch.graph.graph import BoundGraph
    from gtsam_torch.linear import supernodal_kernels as K
    from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
    names = a.only.split(",")
    out_dir = os.path.join(ROOT, "build", "port_qr_probe")
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
        out = outs[n]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {n}:\n{out}")
        ptxas[n] = [line.strip() for line in out.splitlines()
                    if "sn_front_qr" in line or "spill" in line
                    or "registers" in line][-2:]
        libs[n] = ctypes.CDLL(so)
    graph, vals, _, _ = cs.sphere_graph(50, 50)
    vals = vals.to("cuda")
    s = SupernodalCholeskySolver(BoundGraph(graph, vals, "cuda"),
                                 **cs.QR_SOLVER["supernodal_kwargs"])
    pool = s.jacobian_pool(vals.arrays)
    s.factorize_qr(pool, 1.0)
    qp, dv = s._qr_plan(), s.dev
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # room for the widest variant's panel blocks (32 columns: twice the
    # doubles a column of 16's)
    scratch = torch.empty(2 * qp.scratch.numel(), dtype=torch.float64,
                          device="cuda")
    # room for the narrowest variant's flags
    K._launch_flags("qr", torch.device("cuda", 0), 4 * max(
        q.S * -(-(q.W + q.R) * q.d // K.QR_PANEL) for q in qp.levels))
    kern = K.KERNELS["sn_front_qr"]
    fn0 = kern._fn
    out = {}
    try:
        for n, lib in libs.items():
            fn = lib.gt_sn_front_qr
            fn.argtypes = kern.argtypes
            fn.restype = ctypes.c_int
            kern._fn = fn
            rows = []
            for lv, ql in zip(dv.levels, qp.levels):
                rsep = qp.rsep.clone()
                rec = torch.empty(ql.S, dtype=torch.int32, device="cuda")
                tiles = torch.empty((lv.tiles.stop - lv.tiles.start, K.TILE,
                                     K.TILE), dtype=torch.float64,
                                    device="cuda")
                args = (pool, ql, lv.valid_diag, lv.col_vars, qp.roff,
                        qp.rld, rsep, 1.0, rec, tiles, 1e-10, scratch)
                Lt, Pt = K.sn_front_qr(*args)
                Lp, Pp = K.sn_front_qr_plain(*args[:6], qp.rsep.clone(),
                                             *args[7:11])
                err = float((Lt - Lp).abs().max() / Lp.abs().max())
                if Pt is not None:
                    err = max(err, float((Pt - Pp).abs().max()
                                         / Pp.abs().max()))
                rows.append({
                    "S": ql.S, "C": (ql.W + ql.R) * ql.d, "rows": ql.mmax,
                    "ctas": K.qr_ctas(ql.S, (ql.W + ql.R) * ql.d, sms),
                    "ms": cs.cuda_ms(lambda: K.sn_front_qr(*args),
                                     reps=a.reps),
                    "one_cta_ms": cs.cuda_ms(
                        lambda: K.sn_front_qr(*args, ctas=1), reps=a.reps),
                    "rel_err": err})
            out[n] = {"levels": rows,
                      "ms": sum(r["ms"] for r in rows),
                      "one_cta_ms": sum(r["one_cta_ms"] for r in rows)}
    finally:
        kern._fn = fn0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"variants": out, "ptxas": ptxas,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
