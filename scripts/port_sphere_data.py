#!/usr/bin/env python3
"""Write a sphere-shaped 3D pose graph in g2o format (numpy only).

    python3 scripts/port_sphere_data.py OUT.g2o [--laps 50 --per-lap 50]

The layout of g2o's create_sphere: `laps` rings of `per_lap` poses on a
sphere of `radius` metres, pose k rotated by Rz(-pi + 2 pi n / per_lap)
Ry(-pi/2 + (k+1) pi / (laps per_lap)) and placed at R (radius, 0, 0).  Edges:
the odometry k -> k+1 (laps per_lap - 1 of them) and one closure from each
pose of a ring to the pose at the same place of the next ring
((laps - 1) per_lap), 4,949 edges at 50 x 50 -- sphere2500's shape.  Each
measurement is the true relative pose times Exp of Gaussian noise (sigma_r
radians on the rotation, sigma_t metres on the translation), written as
EDGE_SE3:QUAT with information 1/sigma_t^2 on translation and 1/sigma_r^2
on rotation, in g2o's (t, R) order -- 10000 and 40000 at the defaults, as
in sphere2500.txt.  Vertices (VERTEX_SE3:QUAT) compose the noisy odometry
from the first pose, as a dead-reckoning initial guess does.
"""

import argparse

import numpy as np


def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def _rot(w):
    """Rodrigues: exp(hat(w))."""
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-12:
        return np.eye(3) + W
    return (np.eye(3) + np.sin(th) / th * W
            + (1.0 - np.cos(th)) / th ** 2 * W @ W)


def _se3_exp(xi):
    """[omega; v] -> (R, t), t = V(omega) v."""
    w, v = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-12:
        V = np.eye(3) + 0.5 * W
    else:
        V = (np.eye(3) + (1.0 - np.cos(th)) / th ** 2 * W
             + (th - np.sin(th)) / th ** 3 * W @ W)
    return _rot(w), V @ v


def _quat(R):
    """Rotation -> unit quaternion (w, x, y, z), w >= 0."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def sphere_poses(laps=50, per_lap=50, radius=100.0):
    """The true poses (N, 3, 3), (N, 3) of create_sphere's layout."""
    n = laps * per_lap
    Rs, ts = np.empty((n, 3, 3)), np.empty((n, 3))
    for k in range(n):
        f, m = divmod(k, per_lap)
        az = -np.pi + 2.0 * m * np.pi / per_lap
        el = -0.5 * np.pi + (k + 1) * np.pi / n
        Rz = _rot(np.array([0.0, 0.0, az]))
        Ry = _rot(np.array([0.0, el, 0.0]))
        Rs[k] = Rz @ Ry
        ts[k] = Rs[k] @ np.array([radius, 0.0, 0.0])
    return Rs, ts


def sphere_edges(laps=50, per_lap=50):
    """(i, j) of the odometry edges, then the ring-to-ring closures."""
    n = laps * per_lap
    odo = [(k, k + 1) for k in range(n - 1)]
    closures = [((f - 1) * per_lap + m, f * per_lap + m)
                for f in range(1, laps) for m in range(per_lap)]
    return odo + closures


def write_sphere_g2o(path, laps=50, per_lap=50, radius=100.0, sigma_t=0.01,
                     sigma_r=0.005, seed=0):
    """Write the graph to `path`; returns the true poses (Rs, ts)."""
    rng = np.random.default_rng(seed)
    Rs, ts = sphere_poses(laps, per_lap, radius)
    edges = sphere_edges(laps, per_lap)
    noise = rng.normal(size=(len(edges), 6)) * np.array(
        [sigma_r] * 3 + [sigma_t] * 3)
    info_t, info_r = 1.0 / sigma_t ** 2, 1.0 / sigma_r ** 2
    upper = []
    for a in range(6):
        for b in range(a, 6):
            upper.append(0.0 if a != b else (info_t if a < 3 else info_r))
    info = " ".join(repr(float(v)) for v in upper)
    meas = []
    lines = []
    for e, (i, j) in enumerate(edges):
        Rij = Rs[i].T @ Rs[j]
        tij = Rs[i].T @ (ts[j] - ts[i])
        dR, dt = _se3_exp(noise[e])
        meas.append((Rij @ dR, Rij @ dt + tij))
    # vertices: dead reckoning along the noisy odometry
    n = laps * per_lap
    vR, vt = [Rs[0]], [ts[0]]
    for k in range(n - 1):
        R, t = meas[k]
        vt.append(vt[k] + vR[k] @ t)
        vR.append(vR[k] @ R)
    def num(v):
        return " ".join(repr(float(x)) for x in v)

    for k in range(n):
        q = _quat(vR[k])
        lines.append(f"VERTEX_SE3:QUAT {k} {num(vt[k])} {num(q[1:])} "
                     f"{num(q[:1])}")
    for (i, j), (R, t) in zip(edges, meas):
        q = _quat(R)
        lines.append(f"EDGE_SE3:QUAT {i} {j} {num(t)} {num(q[1:])} "
                     f"{num(q[:1])} {info}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return Rs, ts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--laps", type=int, default=50)
    ap.add_argument("--per-lap", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    write_sphere_g2o(a.out, a.laps, a.per_lap, seed=a.seed)


if __name__ == "__main__":
    main()
