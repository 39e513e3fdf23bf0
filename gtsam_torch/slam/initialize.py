"""Pose-graph initialization: 3D chordal relaxation and 2D LAGO.

Counterpart of gtsam_tpu/slam/initialize.py (reference
gtsam/slam/InitializePose3.{h,cpp}, computeOrientationsChordal:45,
initialize:87, and gtsam/slam/lago.{h,cpp}): one-time host preprocessing
with scipy's sparse LU, as in the reference; the nonlinear refinement then
runs on the device.

Rotations: for each between factor (i, j, Rij), Rj ~ Ri Rij; with the rows
of each R as unknowns this is three decoupled sparse least-squares systems
sharing one matrix, projected back to SO(3) by SVD.  Translations then
solve t_j - t_i = R_i t_ij with the anchor fixed.
"""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..geometry.se3 import SE3
from ..graph.graph import FactorGraph
from ..graph.values import Values


def _between_se3_edges(graph: FactorGraph):
    """(I keys, J keys, Rij (E, 3, 3), tij (E, 3)) of all BetweenSE3
    batches, in batch order."""
    ks, Rs, ts = [], [], []
    for b in graph.batches:
        if b.var_types == ("SE3", "SE3") and b.name.startswith("Between"):
            ks.append(b.keys)
            Rs.append(b.measurements.R.detach().cpu().numpy())
            ts.append(b.measurements.t.detach().cpu().numpy())
    if not ks:
        raise ValueError("no BetweenSE3 factors in graph")
    k = np.concatenate(ks)
    return k[:, 0], k[:, 1], np.concatenate(Rs), np.concatenate(ts)


def initialize_pose3_chordal(graph: FactorGraph, anchor_key=None) -> Values:
    """Chordal initialization of an SE3 between-factor graph (Values on the
    CPU, keys sorted)."""
    ki, kj, Rijs, tijs = _between_se3_edges(graph)
    keys = np.unique(np.concatenate([ki, kj]))
    n = len(keys)
    if anchor_key is None:
        anchor_key = keys[0]
    a = int(np.searchsorted(keys, anchor_key))
    E = len(ki)
    I = np.searchsorted(keys, ki).astype(np.int64)
    J = np.searchsorted(keys, kj).astype(np.int64)

    # --- rotations: 3 decoupled systems over 3n unknowns ------------------
    # per edge: rows 3e+r get  +1 at col 3j+r  and  -Rij[c, r] at col 3i+c
    r3 = np.arange(3)
    e3 = 3 * np.arange(E)
    rows_id = (e3[:, None] + r3[None, :]).reshape(-1)
    cols_id = (3 * J[:, None] + r3[None, :]).reshape(-1)
    vals_id = np.ones(3 * E)
    rows_R = (e3[:, None, None] + r3[None, :, None]
              + np.zeros((1, 1, 3), np.int64)).reshape(-1)
    cols_R = (3 * I[:, None, None] + np.zeros((1, 3, 1), np.int64)
              + r3[None, None, :]).reshape(-1)
    vals_R = (-Rijs.transpose(0, 2, 1)).reshape(-1)
    rcount = 3 * E
    # anchor: x_a = e_r (per system), strong weight
    rows = np.concatenate([rows_id, rows_R, rcount + r3])
    cols = np.concatenate([cols_id, cols_R, 3 * a + r3])
    vals = np.concatenate([vals_id, vals_R, np.full(3, 10.0)])
    A = sp.csr_matrix((vals, (rows, cols)), shape=(rcount + 3, 3 * n))
    lu = spla.splu((A.T @ A).tocsc())
    B = np.zeros((rcount + 3, 3))
    B[rcount + r3, r3] = 10.0          # anchor rows = 10 * e_r
    X = lu.solve(A.T @ B).reshape(n, 3, 3).transpose(0, 2, 1)
    # project to SO(3)
    U, _s, Vt = np.linalg.svd(X)
    det = np.linalg.det(U @ Vt)
    D = np.zeros((n, 3, 3))
    D[:, 0, 0] = 1.0
    D[:, 1, 1] = 1.0
    D[:, 2, 2] = det
    R = U @ D @ Vt

    # --- translations: t_j - t_i = R_i t_ij -------------------------------
    rhs = np.einsum("eij,ej->ei", R[I], tijs)         # (E, 3)
    rows_t = np.concatenate([rows_id, rows_id, rcount + r3])
    cols_t = np.concatenate([cols_id,
                             (3 * I[:, None] + r3[None, :]).reshape(-1),
                             3 * a + r3])
    vals_t = np.concatenate([np.ones(3 * E), -np.ones(3 * E),
                             np.full(3, 10.0)])
    A = sp.csr_matrix((vals_t, (rows_t, cols_t)), shape=(rcount + 3, 3 * n))
    bv = np.concatenate([rhs.reshape(-1), np.zeros(3)])
    t = spla.splu((A.T @ A).tocsc()).solve(A.T @ bv).reshape(n, 3)
    return Values({"SE3": SE3(torch.as_tensor(R), torch.as_tensor(t))},
                  {"SE3": keys})


def initialize_pose2_lago(graph: FactorGraph, anchor_key=None) -> Values:
    """LAGO 2D initialization (gtsam/slam/lago.{h,cpp}) of the BetweenSE2
    batches of `graph`: orientations first, from a linear system whose
    2 pi corrections come off a spanning tree (depth-first from the
    anchor), then positions linearly at those orientations.  Values on the
    CPU, keys sorted; the JAX package's algorithm, loop for loop."""
    edges = []
    for b in graph.batches:
        if b.var_types == ("SE2", "SE2") and b.name.startswith("Between"):
            m = b.measurements.detach().cpu().numpy()
            for n in range(b.num_factors):
                edges.append((int(b.keys[n, 0]), int(b.keys[n, 1]),
                              m[n, 0], m[n, 1], m[n, 2]))
    if not edges:
        raise ValueError("no BetweenSE2 factors")
    keys = sorted({k for e in edges for k in (e[0], e[1])})
    idx = {k: i for i, k in enumerate(keys)}
    n = len(keys)
    a = idx[anchor_key] if anchor_key is not None else 0

    # spanning tree -> initial theta guesses
    adj = {}
    for ei, (i, j, dx, dy, dth) in enumerate(edges):
        adj.setdefault(idx[i], []).append((idx[j], dth, ei))
        adj.setdefault(idx[j], []).append((idx[i], -dth, ei))
    theta0 = np.full(n, np.nan)
    theta0[a] = 0.0
    stack = [a]
    while stack:
        u = stack.pop()
        for (v, dth, _e) in adj.get(u, []):
            if np.isnan(theta0[v]):
                theta0[v] = theta0[u] + dth
                stack.append(v)
    theta0 = np.nan_to_num(theta0)

    # linear orientation solve with integer 2 pi corrections from theta0
    rows, cols, vals, rhs = [], [], [], []
    rc = 0
    for (i, j, _dx, _dy, dth) in edges:
        ii, jj = idx[i], idx[j]
        k2pi = np.round((theta0[jj] - theta0[ii] - dth) / (2 * np.pi))
        rows += [rc, rc]
        cols += [jj, ii]
        vals += [1.0, -1.0]
        rhs.append(dth + 2 * np.pi * k2pi)
        rc += 1
    rows.append(rc)
    cols.append(a)
    vals.append(10.0)
    rhs.append(0.0)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(rc + 1, n))
    theta = spla.splu((A.T @ A).tocsc()).solve(A.T @ np.asarray(rhs))

    # linear position solve at the fixed orientations
    rows, cols, vals, rhs = [], [], [], []
    rc = 0
    for (i, j, dx, dy, _dth) in edges:
        ii, jj = idx[i], idx[j]
        c, s = np.cos(theta[ii]), np.sin(theta[ii])
        wx, wy = c * dx - s * dy, s * dx + c * dy
        for r, w in ((0, wx), (1, wy)):
            rows += [rc, rc]
            cols += [2 * jj + r, 2 * ii + r]
            vals += [1.0, -1.0]
            rhs.append(w)
            rc += 1
    for r in range(2):
        rows.append(rc + r)
        cols.append(2 * a + r)
        vals.append(10.0)
        rhs.append(0.0)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(rc + 2, 2 * n))
    xy = spla.splu((A.T @ A).tocsc()).solve(
        A.T @ np.asarray(rhs)).reshape(n, 2)
    pose = np.concatenate([xy, theta[:, None]], axis=1)  # key order
    return Values({"SE2": torch.as_tensor(pose)}, {"SE2": np.asarray(keys)})
