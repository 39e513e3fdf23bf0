#!/usr/bin/env python3
"""Write a Manhattan-world 2D pose graph in TORO format (numpy only).

    python3 scripts/port_2d_data.py OUT.graph [--poses 10000 --edges 64311]

The generator behind M3500 and w10000 (Olson, Leonard and Teller, "Fast
iterative alignment of pose graphs with poor initial estimates", ICRA
2006): a robot walks on a grid of `grid` x `grid` cells in unit steps,
heading along one of the four axes; before each step it turns left or
right with probability `p_turn`, and where the step would leave the grid it
turns (left or right, drawn) until it would not.  Pose k is its cell and
heading (theta in {0, pi/2, pi, -pi/2}).  Edges: the odometry k-1 -> k
(poses - 1 of them), then closures i -> k from every earlier pose i in pose
k's cell.  These are cut or topped up to the exact edge count: when there
are more than `edges` - (poses - 1), a seeded draw without replacement
keeps that many; when fewer, closures i -> k from the earlier poses in the
four neighbouring cells (but k - 1) are drawn the same way to fill up.
The grid's default side is the one at which a uniform walk's same-cell
closures number about the closures wanted, sqrt(poses^2 / (2 closures)):
30 for w10000's 10,000 poses and 64,311 edges.  Each edge is written in
time order (k's odometry, then its closures by i).

Each measurement is the true relative pose times Exp of Gaussian noise of
sigmas `sigmas` (x and y in metres, theta in radians; default 0.1, 0.1,
0.05), written as an EDGE2 row with that covariance in TORO's layout
(ff, fs, ss, rr, fr, sr = sx^2, 0, sy^2, st^2, 0, 0), which load_2d's
auto-detection reads as a covariance.  Vertices (VERTEX2) compose the
noisy odometry from the first pose, as a dead-reckoning initial guess
does.
"""

import argparse

import numpy as np

HEADINGS = np.array([0.0, 0.5 * np.pi, np.pi, -0.5 * np.pi])
STEPS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]])


def _compose(a, b):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                     a[..., 1] + s * b[..., 0] + c * b[..., 1],
                     a[..., 2] + b[..., 2]], axis=-1)


def _between(a, b):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    dth = np.arctan2(np.sin(b[..., 2] - a[..., 2]), np.cos(b[..., 2]
                                                           - a[..., 2]))
    return np.stack([c * dx + s * dy, -s * dx + c * dy, dth], axis=-1)


def _expmap(xi):
    """[vx, vy, w] -> pose, t = V(w) v (SE(2)'s exponential)."""
    w = xi[..., 2]
    small = np.abs(w) < 1e-9
    sw = np.where(small, 1.0, w)
    A = np.where(small, 1.0, np.sin(sw) / sw)
    B = np.where(small, 0.5 * w, (1.0 - np.cos(sw)) / sw)
    return np.stack([A * xi[..., 0] - B * xi[..., 1],
                     B * xi[..., 0] + A * xi[..., 1], w], axis=-1)


def manhattan_walk(poses, grid, p_turn, rng):
    """(cells (poses, 2) int, headings (poses,) int) of the walk."""
    cells = np.empty((poses, 2), dtype=np.int64)
    heads = np.empty(poses, dtype=np.int64)
    cell, h = np.array([grid // 2, grid // 2]), 0
    cells[0], heads[0] = cell, h
    for k in range(1, poses):
        if rng.random() < p_turn:
            h = (h + rng.choice((1, 3))) % 4
        while not (0 <= cell + STEPS[h]).all() or not (
                cell + STEPS[h] < grid).all():
            h = (h + rng.choice((1, 3))) % 4
        cell = cell + STEPS[h]
        cells[k], heads[k] = cell, h
    return cells, heads


def manhattan_edges(cells, n_edges, rng):
    """(i, j) of the odometry edges and the closures, n_edges in all, in
    time order (the module docstring says how the closures are chosen)."""
    poses = len(cells)
    need = n_edges - (poses - 1)
    at = {}
    same, near = [], []
    for k, c in enumerate(map(tuple, cells)):
        same += [(i, k) for i in at.get(c, ())]
        for dx, dy in STEPS:
            near += [(i, k) for i in at.get((c[0] + dx, c[1] + dy), ())
                     if i < k - 1]
        at.setdefault(c, []).append(k)
    if len(same) >= need:
        keep = [same[m] for m in rng.choice(len(same), need, replace=False)]
    else:
        if len(same) + len(near) < need:
            raise ValueError(f"the walk offers {len(same) + len(near)} "
                             f"closures, fewer than {need}")
        keep = same + [near[m] for m in rng.choice(
            len(near), need - len(same), replace=False)]
    odo = [(k - 1, k) for k in range(1, poses)]
    return sorted(odo + keep, key=lambda e: (e[1], e[0] != e[1] - 1, e[0]))


def write_manhattan_graph(path, poses=10000, n_edges=64311, grid=None,
                          p_turn=0.2, sigmas=(0.1, 0.1, 0.05), seed=0):
    """Write the graph to `path`; returns (the true poses (poses, 3), the
    edges (E, 2))."""
    rng = np.random.default_rng(seed)
    closures = n_edges - (poses - 1)
    if grid is None:
        grid = max(2, int(round(np.sqrt(poses ** 2 / (2.0 * closures)))))
    cells, heads = manhattan_walk(poses, grid, p_turn, rng)
    true = np.concatenate([cells.astype(np.float64),
                           HEADINGS[heads][:, None]], axis=1)
    edges = np.asarray(manhattan_edges(cells, n_edges, rng))
    sig = np.asarray(sigmas, dtype=np.float64)
    noise = rng.normal(size=(len(edges), 3)) * sig
    z = _compose(_between(true[edges[:, 0]], true[edges[:, 1]]),
                 _expmap(noise))
    # dead reckoning: compose the noisy odometry from the first pose
    odo = {int(j): z[e] for e, (i, j) in enumerate(edges) if j == i + 1}
    init = np.empty_like(true)
    init[0] = true[0]
    for k in range(1, poses):
        init[k] = _compose(init[k - 1], odo[k])
    cov = " ".join(repr(float(v)) for v in (sig[0] ** 2, 0.0, sig[1] ** 2,
                                             sig[2] ** 2, 0.0, 0.0))
    with open(path, "w") as f:
        for k, p in enumerate(init.tolist()):
            f.write(f"VERTEX2 {k} {p[0]!r} {p[1]!r} {p[2]!r}\n")
        for (i, j), m in zip(edges.tolist(), z.tolist()):
            f.write(f"EDGE2 {i} {j} {m[0]!r} {m[1]!r} {m[2]!r} {cov}\n")
    return true, edges


def ate_2d(est, true):
    """RMSE of the positions after the least-squares rigid 2D alignment of
    est onto true (Umeyama without scale)."""
    a, b = est[:, :2], true[:, :2]
    ma, mb = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((b - mb).T @ (a - ma))
    D = np.diag([1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    return float(np.sqrt(np.mean(np.sum((a - ma) @ R.T + mb - b, axis=1)
                                 ** 2)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--poses", type=int, default=10000)
    ap.add_argument("--edges", type=int, default=64311)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    _, edges = write_manhattan_graph(a.out, a.poses, a.edges, seed=a.seed)
    print(f"{a.out}: {a.poses} poses, {len(edges)} edges")


if __name__ == "__main__":
    main()
