#!/usr/bin/env python3
"""The JAX package's graph-form bundle adjustment of the dubrovnik-16-22106
stand-in, the numbers chip_smoke.py's SFM_REF holds the port to.

    python3 scripts/port_sfm_reference.py [--cameras 16 --points 22106
                                           --obs 4 --iterations 20
                                           --spread 3]

Makes the seeded stand-in of the reference's timing default
(make_bal_problem(16, 22106, 4, seed=0): BAL's dubrovnik-16-22106 is not
in the repository), builds its factor graph with gtsam_tpu.sfm.bal.to_graph
(a BalCamera variable a camera, a Point3 a point, one ProjectionBal batch)
and runs gtsam_tpu's levenberg_marquardt on the CPU in float64 with
SparseSolver(order=ORDER) and LMParams(max_iterations=ITERATIONS), as
timing/timeSFMBAL.cpp runs it.  ORDER is "amd" by default: the ordering
that SparseSolver()'s order="auto" picks on this graph (the port's, which
chip_smoke.py prints and requires, and the JAX package's at 6,000 points),
so the plan and the arithmetic are the default's; "auto" itself also
scores a BFS nested dissection whose plan took 2.5 GB at 6,000 points and
24 GB before it finished at the full size.  Prints one JSON line: the problem's sizes,
the final half-chi2, the iterations, the tries (every solve, accepted or
not), the accepted history and, with --spread K, how far rounding moves
that history: K more runs from the points moved by 1e-15 of their value
(seeded), each run's largest relative history difference from the first
and its iterations and tries.  Like the other scripts/port_*_reference.py,
it imports JAX: it makes the reference.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cameras", type=int, default=16)
    ap.add_argument("--points", type=int, default=22106)
    ap.add_argument("--obs", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--spread", type=int, default=0)
    ap.add_argument("--order", default="amd")
    a = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from gtsam_tpu.optimize import optimizers as O
    from gtsam_tpu.sfm import bal, synthetic

    # the tries: calls of the try_step that _make_step_fns returns (the LM
    # loop calls it once a try; the solve inside it is traced once)
    calls = []
    make = O._make_step_fns

    def counting(*args, **kw):
        out = list(make(*args, **kw))
        step = out[-2]

        def counted(*a2, **k2):
            calls.append(1)
            return step(*a2, **k2)
        out[-2] = counted
        return tuple(out)
    O._make_step_fns = counting

    def run(prob):
        calls.clear()
        graph, values = bal.to_graph(prob)
        t0 = time.time()
        res = O.levenberg_marquardt(
            graph, values, O.LMParams(max_iterations=a.iterations),
            solver=O.SparseSolver(order=a.order))
        return res, len(calls), time.time() - t0

    prob = synthetic.make_bal_problem(a.cameras, a.points, a.obs, seed=0)
    res, tries, wall = run(prob)
    hist = np.asarray(res.history)
    out = {"cameras": prob.num_cameras, "points": prob.num_points,
           "observations": prob.num_observations,
           "iterations": res.iterations, "tries": tries,
           "order": a.order, "final_half_chi2": res.error,
           "history": res.history,
           "cpu_s": wall}
    if a.spread:
        rng = np.random.default_rng(1)
        spread = []
        for _ in range(a.spread):
            moved = dataclasses.replace(prob, points=prob.points * (
                1.0 + 1e-15 * rng.standard_normal(prob.points.shape)))
            r, t, _ = run(moved)
            h = np.asarray(r.history)
            n = min(len(h), len(hist))
            spread.append({"max_rel": float(np.max(
                np.abs(h[:n] - hist[:n]) / hist[:n])),
                "iterations": r.iterations, "tries": t})
        out["spread"] = spread
    print(json.dumps(out))


if __name__ == "__main__":
    main()
