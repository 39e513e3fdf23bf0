#!/usr/bin/env python3
"""Time the level algebra of gtsam_torch's supernodal factorization on one
card, at the sphere2500 shape.

    python3 scripts/port_level_time.py [--root DIR] [--reps N]

Imports gtsam_torch from DIR (default: this checkout), writes the
sphere-shaped stand-in of scripts/port_sphere_data.py (50 x 50 poses) under
DIR/build/port_sphere/, adds bench.py's prior, binds it on the card with
SparseSolver's supernodal plan (force_width=32) and assembles the system at
the chordal initialization.  Then it runs one factorization at lam = 1e-3
level by level and times, with CUDA events and by device time
(torch.profiler, mean of N calls), each level's algebra: in a tree with
kernel 7's Schur update (sn_schur_update), the front kernel's launch and
the update's (the panel, U's block-lower triangle and the scatter, one
launch); in a tree with the front kernel alone, its launch, the level's two
products (the panel Lp^T = L^-1 At and U = Lp Lp^T, torch.bmm) and the
Schur scatter (sn_schur_scatter), the three as the level's tail; in an
older tree, cholesky_ex, the panel's triangular solve
(solve_triangular(L^T, panel, left=False)) and U; then the whole
factorize() and the level algebra's (and tail's) device time summed over
the levels.  Then, on the factor of that lam, it times kernel 8 by CUDA
events and by device time (torch.profiler): one solve (_solve_padded),
its forward and its backward alone over all levels (in a tree with
per-level kernels, the forward's segment sums included), and the tile
inverses of one factorization where the tree has a kernel of their own
(sn_invert_tiles; since the update, the front kernel leaves them); in a
tree whose solve splits
the top levels' fronts over thread-block clusters, forward, backward and
solve again with a CTA per front throughout.  Prints one JSON line with the
card's name and power limit.  Give two roots in turns (A, B, B, A), one
process each on one card, to compare two versions.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys


def _cuda_ms(fn, reps):
    import torch
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


def _device_ms(fn, reps):
    """The self device time of every kernel fn launches (torch.profiler),
    per call."""
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
               if str(e.device_type).endswith("CUDA")) / 1e3 / reps


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("port_level_time: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    from gtsam_torch.base import noise
    from gtsam_torch.geometry.se3 import SE3
    from gtsam_torch.graph import factors
    from gtsam_torch.graph.graph import BoundGraph
    from gtsam_torch.io import datasets
    from gtsam_torch.linear import supernodal_kernels as K
    from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
    from gtsam_torch.slam.initialize import initialize_pose3_chordal
    spec = importlib.util.spec_from_file_location(
        "port_sphere_data", os.path.join(root, "scripts",
                                         "port_sphere_data.py"))
    data = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(data)
    out = os.path.join(root, "build", "port_sphere")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "sphere_50x50.g2o")
    data.write_sphere_g2o(path, 50, 50)
    graph, _ = datasets.load_3d(path)
    graph.add(factors.prior_factors(
        "SE3", [0], SE3(np.eye(3)[None], np.zeros((1, 3))),
        noise.sigmas([[1e-3] * 3 + [1e-2] * 3])))
    vals = initialize_pose3_chordal(graph).to("cuda")
    s = SupernodalCholeskySolver(BoundGraph(graph, vals, "cuda"),
                                 force_width=32)
    blocks, g = s.system(vals.arrays)
    dv = s.dev
    work = blocks.clone()
    rows = []
    if hasattr(K, "sn_front_factor"):
        # the front kernel (gather, factor and inverse in one launch) and
        # the level's tail: the Schur update, or the two products and the
        # scatter
        rec = torch.empty(dv.fronts, dtype=torch.int32, device="cuda")
        off = 0
        for lv in dv.levels:
            r = rec[off:off + lv.S]
            off += lv.S

            def front(lv=lv, r=r):
                return K.sn_front_factor(
                    work, blocks, lv.diag_ids, lv.diag_flip, lv.diag_pad,
                    lv.valid_diag, lv.col_vars, dv.dbc, lv.panel_ids, 1e-3,
                    False, r)
            Linv, At = front()[1:3]
            row = {"S": lv.S, "W": lv.W, "R": lv.R,
                   "front_ms": _cuda_ms(front, a.reps),
                   "front_device_ms": _device_ms(front, a.reps)}
            if lv.R and hasattr(K, "sn_schur_update"):
                # timed on a copy of the store (each call subtracts again)
                w = work.clone()

                def update(Linv=Linv, At=At, lv=lv, w=w):
                    return K.sn_schur_update(Linv, At, lv.schur, w,
                                             dv.schur_U)
                row.update(tail_ms=_cuda_ms(update, a.reps),
                           tail_device_ms=_device_ms(update, a.reps))
                update(w=work)
            elif lv.R:
                Lp = torch.bmm(Linv, At).mT
                U = torch.bmm(Lp, Lp.mT)
                w = work.clone()

                def scatter(U=U, lv=lv, w=w):
                    K.sn_schur_scatter(U, lv.schur_src, lv.schur_ptr,
                                       lv.schur_tgt, w)

                def tail(Linv=Linv, At=At, lv=lv, w=w):
                    Lp = torch.bmm(Linv, At).mT
                    K.sn_schur_scatter(torch.bmm(Lp, Lp.mT), lv.schur_src,
                                       lv.schur_ptr, lv.schur_tgt, w)
                row.update(
                    panel_bmm_ms=_cuda_ms(lambda: torch.bmm(Linv, At),
                                          a.reps),
                    panel_bmm_device_ms=_device_ms(
                        lambda: torch.bmm(Linv, At), a.reps),
                    u_bmm_ms=_cuda_ms(lambda: torch.bmm(Lp, Lp.mT), a.reps),
                    u_bmm_device_ms=_device_ms(lambda: torch.bmm(Lp, Lp.mT),
                                               a.reps),
                    scatter_ms=_cuda_ms(scatter, a.reps),
                    scatter_device_ms=_device_ms(scatter, a.reps),
                    tail_ms=_cuda_ms(tail, a.reps),
                    tail_device_ms=_device_ms(tail, a.reps))
                K.sn_schur_scatter(U, lv.schur_src, lv.schur_ptr,
                                   lv.schur_tgt, work)
            row["algebra_device_ms"] = (row["front_device_ms"]
                                        + row.get("tail_device_ms", 0))
            rows.append(row)
        state = torch.empty(2, dtype=torch.int32, device="cuda")
        K.sn_pivot_check(rec, state)
    else:
        # an older tree: the gather kernel, then cholesky_ex, the panel's
        # triangular solve and U in the library, and the pivot check
        state = torch.tensor([1, -1], dtype=torch.int32, device="cuda")
        for lv in dv.levels:
            front, panel = K.sn_front_gather(
                work, blocks, lv.diag_ids, lv.diag_flip, lv.diag_pad,
                lv.valid_diag, lv.col_vars, dv.dbc, lv.panel_ids, 1e-3, False)
            L, info = torch.linalg.cholesky_ex(front)

            def chol(front=front):
                return torch.linalg.cholesky_ex(front)
            row = {"S": lv.S, "W": lv.W, "R": lv.R,
                   "cholesky_ex_ms": _cuda_ms(chol, a.reps),
                   "cholesky_ex_device_ms": _device_ms(chol, a.reps)}
            Lp = None
            if lv.R:
                def right(L=L, panel=panel):
                    return torch.linalg.solve_triangular(
                        L.mT, panel, upper=True, left=False)
                Lp = right()
                row.update(
                    right_ms=_cuda_ms(right, a.reps),
                    right_device_ms=_device_ms(right, a.reps),
                    u_bmm_ms=_cuda_ms(lambda: torch.bmm(Lp, Lp.mT), a.reps),
                    u_bmm_device_ms=_device_ms(lambda: torch.bmm(Lp, Lp.mT),
                                               a.reps))
            row["algebra_device_ms"] = (row["cholesky_ex_device_ms"]
                                        + row.get("right_device_ms", 0)
                                        + row.get("u_bmm_device_ms", 0))
            K.sn_pivot_check(L, Lp, info, lv.valid_diag, lv.col_vars, state)
            if lv.R:
                K.sn_schur_scatter(torch.bmm(Lp, Lp.mT), lv.schur_src,
                                   lv.schur_ptr, lv.schur_tgt, work)
            rows.append(row)
    factorize = {
        "factorize_ms": _cuda_ms(lambda: s.factorize(blocks, 1e-3), a.reps),
        "factorize_device_ms": _device_ms(lambda: s.factorize(blocks, 1e-3),
                                          a.reps),
        "level_algebra_device_ms": sum(r["algebra_device_ms"]
                                       for r in rows),
        "tail_ms": sum(r.get("tail_ms", 0) for r in rows),
        "tail_device_ms": sum(r.get("tail_device_ms", 0) for r in rows)}
    f = s.factorize(blocks, 1e-3)
    if hasattr(K, "sn_forward"):
        # one launch per direction over all levels; the tile inverses once
        # per factorization
        x = torch.empty((s.nvars, s.d), dtype=torch.float64, device="cuda")

        def forward():
            K.sn_forward(g, f.levels, f.Linv, dv.sol_cols, dv.gat_ptr,
                         dv.gat_seg, dv.gat_src, dv.sol_y, dv.sol_c)

        def backward():
            K.sn_backward(dv.sol_y, f.levels, f.Linv, dv.sol_cols,
                          dv.sol_rows, x)

        parts = {"forward": forward, "backward": backward}
        if hasattr(K, "sn_invert_tiles"):
            parts["invert"] = lambda: K.sn_invert_tiles(f.levels, f.Linv)
    else:
        # the per-level launches of an older tree: forward and segment sum
        # per level, then backward per level
        levels = list(zip(dv.levels, f.Ldiag, f.Lpanel))
        acc = torch.zeros((s.nvars + 1, s.d), dtype=torch.float64,
                          device="cuda")
        ys = [K.sn_forward_level(g, acc, L, P, lv.col_vars)[0]
              for lv, L, P in levels]
        x = torch.zeros_like(acc)

        def forward():
            for lv, L, P in levels:
                c = K.sn_forward_level(g, acc, L, P, lv.col_vars)[1]
                if P is not None:
                    K.sn_segment_add(c, lv.fwd_src, lv.fwd_ptr, lv.fwd_tgt,
                                     acc)

        def backward():
            for (lv, L, P), y in reversed(list(zip(levels, ys))):
                K.sn_backward_level(y, L, P, lv.row_vars, lv.col_vars, x)
        parts = {"forward": forward, "backward": backward}
    parts["solve"] = lambda: s._solve_padded(f, g)
    solve = {}
    for name, fn in parts.items():
        solve[name + "_ms"] = _cuda_ms(fn, a.reps)
        solve[name + "_device_ms"] = _device_ms(fn, a.reps)
    cluster = getattr(K, "_SOLVE_CLUSTER", None)
    if cluster is not None:
        # the same without the cluster split (a CTA per front throughout)
        solve["cluster"] = cluster
        K._SOLVE_CLUSTER = 1
        for name in ("forward", "backward", "solve"):
            solve[name + "_no_split_ms"] = _cuda_ms(parts[name], a.reps)
            solve[name + "_no_split_device_ms"] = _device_ms(parts[name],
                                                             a.reps)
        K._SOLVE_CLUSTER = cluster
    # kernel 8's device time per solve: forward + backward, plus the tile
    # inverses over the two solves of a factorization (the solve and its
    # refinement)
    solve["kernel8_per_solve_device_ms"] = (
        solve["forward_device_ms"] + solve["backward_device_ms"]
        + solve.get("invert_device_ms", 0.0) / 2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"levels": rows, "factorize": factorize,
                      "kernel8": solve,
                      "ok": bool(state[0] == 1),
                      "root": root, "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
