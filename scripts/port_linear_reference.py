#!/usr/bin/env python3
"""The JAX package's LM runs on the sphere with its remaining linear solvers.

    python3 scripts/port_linear_reference.py [--laps 50 --per-lap 50]
        [--only levels,pcg,subgraph]

Writes the graph of scripts/port_sphere_data.py (seed 0) to a temporary
file, adds bench.py's prior on pose 0, starts from
initialize_pose3_chordal, and runs gtsam_tpu's levenberg_marquardt (the
host loop, the "gtsam" lambda policy) on the CPU in float64 with
chip_smoke.py's SPHERE_LM parameters and each solver at its defaults:
  levels:   SparseSolver(method="levels") (the level-scheduled sparse
            Cholesky, linear/sparse.py);
  pcg:      PCGSolver() (matrix-free CG, block-Jacobi preconditioner);
  subgraph: SubgraphPCGSolver() (CG preconditioned by the spanning tree's
            sparse Cholesky).
Each run's tries are counted by wrapping the optimizer's try step.  Prints
one JSON line: per run the iterations, tries, convergence, the error
history and the final half-chi2, and the seconds it took (compiles
included).  chip_smoke.py holds the numbers as constants (LINEAR_REF).
Like the other port_*_reference.py scripts, it imports JAX: it makes the
reference.
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

# chip_smoke.py's SPHERE_LM: error_tol is the sphere's target, 7283.31667050108
# (the JAX package's fused-LM optimum) x 1.0001; levenberg_marquardt ignores
# the lambda policy
TARGET_SPHERE = 7283.31667050108 * 1.0001
SPHERE_LM = dict(max_iterations=30, error_tol=TARGET_SPHERE,
                 relative_error_tol=1e-7, absolute_error_tol=1e-9,
                 lambda_policy="gain")
RUNS = ("levels", "pcg", "subgraph")


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
    ap.add_argument("--only", default=",".join(RUNS))
    a = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import gtsam_tpu as gt
    from gtsam_tpu.io import datasets
    from gtsam_tpu.linear.pcg import PCGSolver, SubgraphPCGSolver
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

    # count every try: levenberg_marquardt calls the try step once a try
    tries = [0]
    make = O._make_step_fns

    def counted(*args, **kw):
        bound, error_fn, system_fn, try_step, solver = make(*args, **kw)

        def step(*sargs):
            tries[0] += 1
            return try_step(*sargs)
        return bound, error_fn, system_fn, step, solver

    O._make_step_fns = counted
    solvers = {"levels": lambda: O.SparseSolver(method="levels"),
               "pcg": PCGSolver, "subgraph": SubgraphPCGSolver}
    out = {"laps": a.laps, "per_lap": a.per_lap, "lm": SPHERE_LM}
    for name in a.only.split(","):
        tries[0] = 0
        t0 = time.time()
        res = O.levenberg_marquardt(graph, vals0, O.LMParams(**SPHERE_LM),
                                    solver=solvers[name]())
        out[name] = {"iterations": res.iterations, "tries": tries[0],
                     "converged": bool(res.converged),
                     "history": [float(h) for h in res.history],
                     "final_half_chi2": float(res.error),
                     "reached_target": bool(res.error <= TARGET_SPHERE),
                     "s_cpu_with_compile": time.time() - t0}
        print(json.dumps({name: out[name]}), file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
