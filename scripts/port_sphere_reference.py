#!/usr/bin/env python3
"""The JAX package's float64 optimum of the sphere-shaped pose graph.

    python3 scripts/port_sphere_reference.py [--laps 50 --per-lap 50]

Writes the graph of scripts/port_sphere_data.py (seed 0) to a temporary
file and runs gtsam_tpu on the CPU in float64 over it, as bench.py's
run_sphere does (the prior on pose 0, chordal initialization, fused LM with
the gain lambda policy, SparseSolver(refine_iters=1) with force_width=32)
except error_tol = 0, so that LM runs to its own convergence.  Prints one
JSON line: the half-chi2 trajectory, iterations, tries, the final half-chi2,
the ATE (RMSE after SE(3) alignment) against the true poses, and the
target chip_smoke.py holds the port to, the final half-chi2 x (1 + 1e-4).
This is the one port script that imports JAX: it makes the reference.
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


def _data_module():
    spec = importlib.util.spec_from_file_location(
        "port_sphere_data", os.path.join(HERE, "port_sphere_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--laps", type=int, default=50)
    ap.add_argument("--per-lap", type=int, default=50)
    a = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import gtsam_tpu as gt
    from gtsam_tpu.io import datasets
    from gtsam_tpu.optimize import optimizers as O
    from gtsam_tpu.slam.initialize import initialize_pose3_chordal
    from gtsam_tpu.utils.metrics import ate

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sphere.g2o")
        _, true_t = _data_module().write_sphere_g2o(path, a.laps, a.per_lap)
        graph, _ = datasets.load_3d(path)
    graph.add(gt.prior_factors(
        "SE3", [0], gt.SE3(np.eye(3)[None], np.zeros((1, 3))),
        gt.noise.sigmas([[1e-3] * 3 + [1e-2] * 3])))
    t0 = time.time()
    vals0 = initialize_pose3_chordal(graph)
    chordal_s = time.time() - t0
    p = gt.LMParams(max_iterations=30, error_tol=0.0,
                    relative_error_tol=1e-7, absolute_error_tol=1e-9,
                    lambda_policy="gain")
    fused = O.make_fused_lm(
        graph, vals0, p,
        solver=O.SparseSolver(refine_iters=1,
                              supernodal_kwargs=dict(force_width=32)))
    t0 = time.time()
    it, arrays, error, conv, hist, tries = fused(vals0.arrays)
    jax.block_until_ready(arrays)
    wall = time.time() - t0
    it, error = int(it), float(error)
    est = np.asarray(arrays["SE3"].t)[np.argsort(np.asarray(
        vals0.keys["SE3"]))]
    print(json.dumps({
        "laps": a.laps, "per_lap": a.per_lap, "iterations": it,
        "tries": int(tries), "converged": bool(conv),
        "history": [float(h) for h in np.asarray(hist)[:it + 1]],
        "final_half_chi2": error, "target": error * (1 + 1e-4),
        "ate_rmse": ate(est, true_t)["rmse"], "chordal_s": chordal_s,
        "lm_s_cpu_with_compile": wall}))


if __name__ == "__main__":
    main()
