#!/usr/bin/env python3
"""The JAX package's QR-LM, dogleg and nonlinear-CG runs on the sphere.

    python3 scripts/port_optimizers_reference.py [--laps 50 --per-lap 50]
        [--no-qr] [--no-dogleg] [--no-ncg]

Writes the graph of scripts/port_sphere_data.py (seed 0) to a temporary
file, adds bench.py's prior on pose 0, starts from
initialize_pose3_chordal, and runs gtsam_tpu on the CPU in float64:
  qr:     make_fused_lm with SparseSolver(method="qr", refine_iters=1,
          supernodal_kwargs=dict(force_width=32)) and QR_LM (the "gtsam"
          lambda policy: the sparse QR has no gain-ratio denominator);
          minutes on a CPU: each factorization is ~37 GFLOP of padded
          fronts;
  dogleg: dogleg with SparseSolver(refine_iters=1, supernodal_kwargs=
          dict(force_width=32)) and DOGLEG;
  ncg:    nonlinear_conjugate_gradient for NCG_ITERATIONS iterations (no
          tolerance stops it).
Prints one JSON line: each run's iterations, tries (QR), convergence,
history, final half-chi2 and seconds (compiles included).  chip_smoke.py
holds the numbers as constants (SPHERE_QR_REF, SPHERE_DOGLEG_REF,
SPHERE_NCG_REF).  Like port_sphere_reference.py, it imports JAX: it makes
the reference.
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

# the parameters chip_smoke.py runs the port with (its QR_LM, DOGLEG and
# NCG_ITERATIONS)
QR_LM = dict(max_iterations=30, error_tol=0.0, relative_error_tol=1e-7,
             absolute_error_tol=1e-9, lambda_policy="gtsam")
DOGLEG = dict(max_iterations=30, error_tol=0.0, relative_error_tol=1e-7,
              absolute_error_tol=1e-9)
NCG_ITERATIONS = 25
SOLVER = dict(refine_iters=1, supernodal_kwargs=dict(force_width=32))


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
    ap.add_argument("--no-qr", action="store_true")
    ap.add_argument("--no-dogleg", action="store_true")
    ap.add_argument("--no-ncg", action="store_true")
    a = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import gtsam_tpu as gt
    from gtsam_tpu.io import datasets
    from gtsam_tpu.optimize import optimizers as O
    from gtsam_tpu.slam.initialize import initialize_pose3_chordal

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sphere.g2o")
        _data_module().write_sphere_g2o(path, a.laps, a.per_lap)
        graph, _ = datasets.load_3d(path)
    graph.add(gt.prior_factors(
        "SE3", [0], gt.SE3(np.eye(3)[None], np.zeros((1, 3))),
        gt.noise.sigmas([[1e-3] * 3 + [1e-2] * 3])))
    vals0 = initialize_pose3_chordal(graph)
    out = {"laps": a.laps, "per_lap": a.per_lap}

    if not a.no_qr:
        t0 = time.time()
        fused = O.make_fused_lm(graph, vals0, O.LMParams(**QR_LM),
                                solver=O.SparseSolver(method="qr", **SOLVER))
        it, arrays, error, conv, hist, tries = fused(vals0.arrays)
        jax.block_until_ready(arrays)
        it = int(it)
        out["qr"] = {"iterations": it, "tries": int(tries),
                     "converged": bool(conv),
                     "history": [float(h) for h in np.asarray(hist)[:it + 1]],
                     "final_half_chi2": float(error),
                     "s_cpu_with_compile": time.time() - t0}
        print(json.dumps({"qr": out["qr"]}), file=sys.stderr, flush=True)
    if not a.no_dogleg:
        t0 = time.time()
        res = O.dogleg(graph, vals0, O.DoglegParams(**DOGLEG),
                       solver=O.SparseSolver(**SOLVER))
        out["dogleg"] = {"iterations": res.iterations,
                         "converged": res.converged,
                         "history": [float(h) for h in res.history],
                         "final_half_chi2": float(res.error),
                         "s_cpu_with_compile": time.time() - t0}
        print(json.dumps({"dogleg": out["dogleg"]}), file=sys.stderr,
              flush=True)
    if not a.no_ncg:
        t0 = time.time()
        res = O.nonlinear_conjugate_gradient(
            graph, vals0, O.OptimizerParams(
                max_iterations=NCG_ITERATIONS, relative_error_tol=0.0,
                absolute_error_tol=0.0, error_tol=0.0))
        out["ncg"] = {"iterations": res.iterations,
                      "history": [float(h) for h in res.history],
                      "final_half_chi2": float(res.error),
                      "s_cpu_with_compile": time.time() - t0}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
