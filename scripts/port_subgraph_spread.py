#!/usr/bin/env python3
"""How far rounding alone moves LM with the subgraph-preconditioned PCG on
the sphere (chip_smoke.py's phase-4 run), on one card and on the CPU.

    python3 scripts/port_subgraph_spread.py [--seeds N] [--eps E] [--no-cpu]

Builds the sphere of chip_smoke.py (50 x 50 poses, the prior, chordal
initialization) and runs levenberg_marquardt with SPHERE_LM and
SubgraphPCGSolver: on the card from the chordal start; on the card from N
starts (default 3) each moved by a seeded tangent step of E (default
1e-14) times a standard normal in every coordinate, a step far below
anything the problem can resolve; and on the CPU, through the kernels'
plain versions, from the chordal start.  Every CG solve of these runs
stops at max_iterations (500), so the runs differ only by how rounding, or
the tiny step, moves each truncated CG step.  Prints one JSON line: per
run its history, its largest relative difference from the JAX run
(chip_smoke.LINEAR_REF) and from the card's chordal-start run, and its
lag against each, |e_k - ref_k| / (ref_{k-1} - ref_k) over k >= 1 (the
difference as a share of that iteration's decrease in the reference); and
the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(hist, ref):
    """(max relative difference, max lag) of a history against ref's."""
    import numpy as np
    h, r = np.asarray(hist), np.asarray(ref)
    if h.shape != r.shape:
        return float("inf"), float("inf")
    lag = np.abs(h[1:] - r[1:]) / (r[:-1] - r[1:])
    return float(np.max(np.abs(h - r) / r)), float(np.max(lag))


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--eps", type=float, default=1e-14)
    ap.add_argument("--no-cpu", action="store_true")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_subgraph_spread: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gtsam_torch import LMParams
    from gtsam_torch.linear.pcg import SubgraphPCGSolver
    graph, vals0, _, _ = cs.sphere_graph(50, 50)
    p = LMParams(**cs.SPHERE_LM)
    jax = cs.LINEAR_REF["subgraph"]["history"]
    starts = [("card", "cuda", vals0)]
    for seed in range(1, a.seeds + 1):
        gen = torch.Generator().manual_seed(seed)
        dx = a.eps * torch.randn(vals0.layout().total_dim,
                                 dtype=torch.float64, generator=gen)
        starts.append((f"card seed {seed}", "cuda", vals0.retract(dx)))
    if not a.no_cpu:
        starts.append(("cpu", "cpu", vals0))
    runs = {}
    for name, dev, v in starts:
        t0 = time.time()
        res, tries = cs.lm_counted(graph, v, SubgraphPCGSolver(), dev, p)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[name] = {"history": [float(e) for e in res.history],
                      "iterations": res.iterations, "tries": tries,
                      "wall_s": time.time() - t0}
        print(f"{name}: {res.error!r} in {res.iterations} iterations, "
              f"{tries} tries, {runs[name]['wall_s']:.1f} s", file=sys.stderr,
              flush=True)
    base = runs["card"]["history"]
    for r in runs.values():
        r["rel_to_jax"], r["lag_to_jax"] = spread(r["history"], jax)
        r["rel_to_card"], r["lag_to_card"] = spread(r["history"], base)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"eps": a.eps, "runs": runs, "jax": jax,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
