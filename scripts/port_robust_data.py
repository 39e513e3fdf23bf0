#!/usr/bin/env python3
"""Write the sphere-outliers pose graph in g2o format (numpy only).

    python3 scripts/port_robust_data.py OUT.g2o [--laps 50 --per-lap 50]

The graph of scripts/port_sphere_data.py (seed 0: at 50 x 50, 2,500 poses,
2,499 odometry edges and 2,450 ring-to-ring closures, in that order in the
file) with a share of its closures replaced by wrong ones, as place
recognition makes them (Yang et al., "Graduated Non-Convexity for Robust
Spatial Perception", RA-L 2020, section VII, corrupts 10-90% of the loop
closures of pose-graph benchmarks).  With numpy default_rng(1), `n_bad`
closures (495 at 50 x 50: 10% of all edges) are chosen, and each one's
measurement becomes a uniform random rotation (a normalized Gaussian
quaternion) with a translation uniform in [-10, 10]^3 m, its information
kept (sigma_t = 0.01 m; the ring spacing is ~6.3 m).  The structure is the
stand-in's, so the supernodal plan is too.  Prints the replaced closures'
indices (into the closures, 0-based) as JSON.
"""

import argparse
import importlib.util
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _sphere_module():
    spec = importlib.util.spec_from_file_location(
        "port_sphere_data", os.path.join(HERE, "port_sphere_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def default_bad(laps, per_lap, share=0.10):
    """`share` of all edges, rounded up: 495 of 4,949 at 50 x 50 for 10%,
    248 for 5% (the robust-huber run's share)."""
    edges = laps * per_lap - 1 + (laps - 1) * per_lap
    return -(-edges * round(share * 100) // 100)


def write_outlier_g2o(path, laps=50, per_lap=50, n_bad=None,
                      outlier_seed=1, **kw):
    """Write the graph to `path`; returns (true rotations, true positions,
    the replaced closures' indices into the closures, sorted).  `kw` goes
    to write_sphere_g2o (radius, sigmas, its seed)."""
    sphere = _sphere_module()
    Rs, ts = sphere.write_sphere_g2o(path, laps, per_lap, **kw)
    n = laps * per_lap
    n_closures = (laps - 1) * per_lap
    if n_bad is None:
        n_bad = default_bad(laps, per_lap)
    rng = np.random.default_rng(outlier_seed)
    bad = np.sort(rng.choice(n_closures, n_bad, replace=False))
    q = rng.normal(size=(n_bad, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 0] < 0] *= -1.0
    t = rng.uniform(-10.0, 10.0, size=(n_bad, 3))
    with open(path) as f:
        lines = f.read().splitlines()
    first = n + (n - 1)          # vertices, then the odometry edges
    for k, c in enumerate(bad):
        tok = lines[first + c].split()
        assert tok[0] == "EDGE_SE3:QUAT"
        tok[3:10] = [repr(float(x)) for x in (*t[k], *q[k, 1:], q[k, 0])]
        lines[first + c] = " ".join(tok)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return Rs, ts, bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--laps", type=int, default=50)
    ap.add_argument("--per-lap", type=int, default=50)
    ap.add_argument("--bad", type=int, default=None)
    a = ap.parse_args()
    _, _, bad = write_outlier_g2o(a.out, a.laps, a.per_lap, a.bad)
    print(json.dumps({"replaced_closures": bad.tolist()}))


if __name__ == "__main__":
    main()
