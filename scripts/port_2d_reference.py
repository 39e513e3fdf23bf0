#!/usr/bin/env python3
"""The JAX package's float64 optimum of the w10000 stand-in (2D).

    python3 scripts/port_2d_reference.py [--poses 10000 --edges 64311]

Writes the Manhattan-world graph of scripts/port_2d_data.py (seed 0) to a
temporary file and runs gtsam_tpu on the CPU in float64 over it, as a user
runs a 2D pose graph: load_2d, a prior on pose 0 at its loaded value with
sigmas (1e-3, 1e-3, 1e-4) (tests/test_dataset_regressions.py), LAGO
(initialize_pose2_lago), then the fused LM with the gain lambda policy and
SparseSolver(refine_iters=1), error_tol = 0, so that LM runs to its own
convergence (at most 100 iterations).  Prints one JSON line: the half-chi2
trajectory, iterations, tries, the final half-chi2, the ATE (RMSE after
SE(2) alignment) against the true poses, and the target chip_smoke.py
holds the port to, the final half-chi2 x (1 + 1e-4).  Like
port_sphere_reference.py, it imports JAX: it makes the reference.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# LM settings of the 2D main path (chip_smoke.py's STANDIN_LM, with
# error_tol there set to the target)
LM = dict(max_iterations=100, relative_error_tol=1e-7,
          absolute_error_tol=1e-9, lambda_policy="gain")
PRIOR_SIGMAS = [[1e-3, 1e-3, 1e-4]]


def data_module():
    spec = importlib.util.spec_from_file_location(
        "port_2d_data", os.path.join(HERE, "port_2d_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--poses", type=int, default=10000)
    ap.add_argument("--edges", type=int, default=64311)
    a = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import gtsam_tpu as gt
    from gtsam_tpu.io import datasets
    from gtsam_tpu.optimize import optimizers as O
    from gtsam_tpu.slam.initialize import initialize_pose2_lago

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "w10000.graph")
        true, _ = data_module().write_manhattan_graph(path, a.poses, a.edges)
        graph, initial = datasets.load_2d(path)
    graph.add(gt.prior_factors("SE2", [0], np.asarray(initial.at(0))[None],
                               gt.noise.sigmas(PRIOR_SIGMAS)))
    t0 = time.time()
    vals0 = initialize_pose2_lago(graph)
    lago_s = time.time() - t0
    fused = O.make_fused_lm(graph, vals0, gt.LMParams(error_tol=0.0, **LM),
                            solver=O.SparseSolver(refine_iters=1))
    t0 = time.time()
    it, arrays, error, conv, hist, tries = fused(vals0.arrays)
    jax.block_until_ready(arrays)
    wall = time.time() - t0
    it, error = int(it), float(error)
    est = np.asarray(arrays["SE2"])[np.argsort(np.asarray(
        vals0.keys["SE2"]))]
    print(json.dumps({
        "poses": a.poses, "edges": a.edges, "iterations": it,
        "tries": int(tries), "converged": bool(conv),
        "history": [float(h) for h in np.asarray(hist)[:it + 1]],
        "final_half_chi2": error, "target": error * (1 + 1e-4),
        "ate_rmse": data_module().ate_2d(est, true), "lago_s": lago_s,
        "lm_wall_s": wall}))


if __name__ == "__main__":
    main()
