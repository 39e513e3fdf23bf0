#!/usr/bin/env python3
"""The JAX package's answers on the sphere-outliers configuration.

    python3 scripts/port_robust_reference.py [--laps 50 --per-lap 50]
        [--no-gnc]

Writes the graph of scripts/port_robust_data.py to a temporary file, splits
its edges with slice_batch into an odometry and a closure batch, adds
bench.py's prior on pose 0, and runs gtsam_tpu on the CPU in float64, each
run from initialize_pose3_chordal of its own graph:
  robust-huber: the closures under noise.robust(base, huber(1.345)); fused
                LM with the gain policy, SparseSolver(refine_iters=1,
                force_width=32), relative/absolute tolerances 1e-7/1e-9,
                error_tol 0, at most 100 iterations; on the graph with 5%
                of the edges replaced (248 closures; --huber-share): at
                10% it does not converge within 100 iterations from the
                chordal start;
  inlier:       the same LM on the inlier graph (the stand-in without the
                replaced closures): its optimum, against which GNC's basin
                is held;
  hard-prior:   the clean stand-in (port_sphere_data.py, seed 0) with the
                prior noise.constrained_all(6), the same LM;
  gnc-kept:     after gnc-tls, the same LM on the graph of the closures
                GNC keeps (weight >= 0.5): its optimum, and its half-chi2
                at GNC's values (GNC's basin; TLS also rejects true
                closures past the chi2 quantile, which the inlier graph
                still holds);
  gnc-tls:      gnc_optimize(GncParams(loss_type="TLS",
                robust_batches=[1], max_iterations=100)), the JAX defaults
                but for GTSAM's 100 outer iterations (with the JAX
                package's 20 its TLS keeps 0.6% of the true closures
                here), its inner solver the auto one (SparseSolver() at
                D = 15,000), its outer iterations counted by its inner LM
                calls; --no-gnc skips it.
Prints one JSON line: each run's iterations, tries, convergence, history,
final half-chi2 and seconds (compiles included), GNC's closures below a
weight of 0.5, and the targets chip_smoke.py holds the port to (each
final half-chi2 x (1 + 1e-4)).  Like port_sphere_reference.py, it imports
JAX: it makes the reference.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

HUBER_K = 1.345


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--laps", type=int, default=50)
    ap.add_argument("--per-lap", type=int, default=50)
    ap.add_argument("--no-gnc", action="store_true")
    ap.add_argument("--huber-share", type=float, default=0.05,
                    help="share of the edges replaced for robust-huber")
    ap.add_argument("--gnc-max-iterations", type=int, default=100,
                    help="GncParams.max_iterations (GTSAM's default 100; "
                    "the JAX package's is 20)")
    a = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import gtsam_tpu as gt
    from gtsam_tpu.base import losses, noise
    from gtsam_tpu.graph import factors
    from gtsam_tpu.graph.graph import FactorGraph
    from gtsam_tpu.io import datasets
    from gtsam_tpu.optimize import gnc
    from gtsam_tpu.optimize import optimizers as O
    from gtsam_tpu.slam.initialize import initialize_pose3_chordal

    n_odo = a.laps * a.per_lap - 1
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "outliers.g2o")
        _, _, bad = _module("port_robust_data").write_outlier_g2o(
            path, a.laps, a.per_lap)
        edges = datasets.load_3d(path)[0].batches[0]
        data = _module("port_robust_data")
        hpath = os.path.join(tmp, "outliers_huber.g2o")
        _, _, hbad = data.write_outlier_g2o(
            hpath, a.laps, a.per_lap,
            data.default_bad(a.laps, a.per_lap, a.huber_share))
        hedges = datasets.load_3d(hpath)[0].batches[0]
        clean = os.path.join(tmp, "sphere.g2o")
        _module("port_sphere_data").write_sphere_g2o(clean, a.laps,
                                                     a.per_lap)
        clean_edges = datasets.load_3d(clean)[0].batches[0]
    odo = factors.slice_batch(edges, np.arange(n_odo))
    clo = factors.slice_batch(edges, np.arange(n_odo, edges.num_factors))
    good = np.setdiff1d(np.arange(clo.num_factors), bad)
    prior_pose = gt.SE3(np.eye(3)[None], np.zeros((1, 3)))

    def prior(model=None):
        return gt.prior_factors("SE3", [0], prior_pose, model or
                                gt.noise.sigmas([[1e-3] * 3 + [1e-2] * 3]))

    hclo = factors.slice_batch(hedges, np.arange(n_odo, hedges.num_factors))
    huber = FactorGraph([factors.slice_batch(hedges, np.arange(n_odo)),
                         dataclasses.replace(hclo, noise=noise.robust(
                             hclo.noise, losses.huber(HUBER_K))), prior()])
    inlier = FactorGraph([odo, factors.slice_batch(clo, good), prior()])
    hard = FactorGraph([clean_edges, prior(noise.constrained_all(6))])
    plain = FactorGraph([odo, clo, prior()])

    p = gt.LMParams(max_iterations=100, error_tol=0.0,
                    relative_error_tol=1e-7, absolute_error_tol=1e-9,
                    lambda_policy="gain")
    out = {"laps": a.laps, "per_lap": a.per_lap, "replaced": len(bad),
           "huber_replaced": len(hbad), "closures": clo.num_factors}

    def lm(name, graph):
        vals0 = initialize_pose3_chordal(graph)
        t0 = time.time()
        fused = O.make_fused_lm(graph, vals0, p, solver=O.SparseSolver(
            refine_iters=1, supernodal_kwargs=dict(force_width=32)))
        it, arrays, error, conv, hist, tries = fused(vals0.arrays)
        jax.block_until_ready(arrays)
        it, error = int(it), float(error)
        out[name] = {"iterations": it, "tries": int(tries),
                     "converged": bool(conv),
                     "history": [float(h) for h in np.asarray(hist)[:it + 1]],
                     "final_half_chi2": error, "target": error * (1 + 1e-4),
                     "s_cpu_with_compile": time.time() - t0}
        return vals0.replace_arrays(arrays)

    lm("robust_huber", huber)
    lm("inlier", inlier)
    hv = lm("hard_prior", hard)
    d = np.asarray(gt.SE3(*(np.asarray(x) for x in (hv.arrays["SE3"].R[:1],
                                                    hv.arrays["SE3"].t[:1]))
                          ).t)
    out["hard_prior"]["prior_position_m"] = [float(x) for x in d[0]]

    if not a.no_gnc:
        calls = [0]
        inner_lm = O.levenberg_marquardt

        def counted(*args, **kw):
            calls[0] += 1
            return inner_lm(*args, **kw)
        gnc.opt_mod.levenberg_marquardt = counted
        vals0 = initialize_pose3_chordal(plain)
        t0 = time.time()
        gp = gnc.GncParams(loss_type="TLS", robust_batches=[1],
                           max_iterations=a.gnc_max_iterations)
        res = gnc.gnc_optimize(plain, vals0, gp)
        secs = time.time() - t0
        (tag, (w,)), = res.history[-1:]
        w = np.asarray(w)
        vals = res.values
        inl = inlier.bind(vals)
        kept = np.flatnonzero(w >= 0.5)
        kept_graph = FactorGraph([odo, factors.slice_batch(clo, kept),
                                  prior()])
        kept_at_gnc = float(kept_graph.bind(vals).error(vals.arrays))
        lm("gnc_kept", kept_graph)
        out["gnc_kept"]["half_chi2_at_gnc"] = kept_at_gnc
        out["gnc_tls"] = {
            "max_iterations": gp.max_iterations,
            "outer_iterations": calls[0] - 1, "final_error": res.error,
            "inner_iterations_last": res.iterations,
            "below_half": np.flatnonzero(w < 0.5).tolist(),
            "replaced_max_weight": float(w[bad].max()),
            "true_above_0.9": float(np.mean(w[good] > 0.9)),
            "inlier_half_chi2_at_gnc": float(inl.error(vals.arrays)),
            "s_cpu_with_compile": secs}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
