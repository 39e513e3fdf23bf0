"""Pose-graph dataset input: 3D g2o / TORO files.

Counterpart of gtsam_tpu/io/datasets.py (reference gtsam/slam/dataset.cpp):
  - EDGE3 rotations read as roll, pitch, yaw -> Rot3::Ypr(y, p, r)
    (dataset.cpp:748);
  - EDGE_SE3:QUAT information reordered from g2o's (t, R) to GTSAM's (R, t)
    (dataset.cpp:850).
`load_2d` and `write_g2o` are not ported yet.
"""

import numpy as np
import torch

from ..base import noise as noise_mod
from ..geometry.se3 import SE3
from ..graph import factors as factors_mod
from ..graph.graph import FactorGraph
from ..graph.values import Values


def load_3d(path: str):
    """Parse a 3D pose-graph file (VERTEX3 / VERTEX_SE3:QUAT, EDGE3 /
    EDGE_SE3:QUAT).  Returns (graph, initial Values of SE3 poses, on the
    CPU); reference load3D (dataset.cpp:780-880).  Without vertices the
    initial poses compose the edges from the first one."""
    verts_R, verts_t = {}, {}
    e_i, e_j, e_R, e_t, e_info = [], [], [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = tok[0]
            if tag == "VERTEX3":
                idx = int(tok[1])
                x, y, z, roll, pitch, yaw = (float(t) for t in tok[2:8])
                verts_R[idx] = _ypr_np(yaw, pitch, roll)
                verts_t[idx] = np.array([x, y, z])
            elif tag == "VERTEX_SE3:QUAT":
                idx = int(tok[1])
                x, y, z, qx, qy, qz, qw = (float(t) for t in tok[2:9])
                verts_R[idx] = _quat_np(qw, qx, qy, qz)
                verts_t[idx] = np.array([x, y, z])
            elif tag == "EDGE3":
                i, j = int(tok[1]), int(tok[2])
                x, y, z, roll, pitch, yaw = (float(t) for t in tok[3:9])
                e_i.append(i)
                e_j.append(j)
                e_R.append(_ypr_np(yaw, pitch, roll))
                e_t.append([x, y, z])
                e_info.append(_upper6(tok[9:30]))
            elif tag == "EDGE_SE3:QUAT":
                i, j = int(tok[1]), int(tok[2])
                x, y, z, qx, qy, qz, qw = (float(t) for t in tok[3:10])
                m = _upper6(tok[10:31])
                # reorder g2o (t, R) -> GTSAM (R, t) (dataset.cpp:850)
                mg = np.empty((6, 6))
                mg[:3, :3] = m[3:, 3:]
                mg[3:, 3:] = m[:3, :3]
                mg[3:, :3] = m[:3, 3:]
                mg[:3, 3:] = m[3:, :3]
                e_i.append(i)
                e_j.append(j)
                e_R.append(_quat_np(qw, qx, qy, qz))
                e_t.append([x, y, z])
                e_info.append(mg)
    graph = FactorGraph()
    if e_i:
        graph.add(factors_mod.between_factors(
            "SE3", np.array(e_i), np.array(e_j),
            SE3(np.stack(e_R), np.asarray(e_t, dtype=np.float64)),
            noise_mod.information(np.stack(e_info))))
    if not verts_t:
        R0 = {e_i[0]: np.eye(3)}
        t0 = {e_i[0]: np.zeros(3)}
        for i, j, Rm, tm in zip(e_i, e_j, e_R, e_t):
            if i in R0 and j not in R0:
                R0[j] = R0[i] @ Rm
                t0[j] = t0[i] + R0[i] @ np.asarray(tm)
        verts_R, verts_t = R0, t0
    keys = sorted(verts_t)
    f64 = torch.float64
    vals = Values({"SE3": SE3(
        torch.as_tensor(np.stack([verts_R[k] for k in keys]), dtype=f64),
        torch.as_tensor(np.stack([verts_t[k] for k in keys]), dtype=f64))},
        {"SE3": np.asarray(keys)})
    return graph, vals


def _upper6(tokens) -> np.ndarray:
    vals = [float(t) for t in tokens[:21]]
    m = np.zeros((6, 6))
    k = 0
    for i in range(6):
        for j in range(i, 6):
            m[i, j] = m[j, i] = vals[k]
            k += 1
    return m


def _ypr_np(yaw, pitch, roll) -> np.ndarray:
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _quat_np(w, x, y, z) -> np.ndarray:
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def groundtruth_trajectory(path: str):
    """Compose a TORO edge-list groundtruth file (noise-free EDGE3 rows, no
    vertices) into (N, 3, 3), (N, 3) poses by its sequential edges."""
    odo = {}
    n_max = 0
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0] != "EDGE3":
                continue
            i, j = int(tok[1]), int(tok[2])
            n_max = max(n_max, i, j)
            if j != i + 1:
                continue
            x, y, z, roll, pitch, yaw = (float(t) for t in tok[3:9])
            odo[i] = (_ypr_np(yaw, pitch, roll), np.array([x, y, z]))
    n = n_max + 1
    Rs = np.empty((n, 3, 3))
    ts = np.empty((n, 3))
    Rs[0] = np.eye(3)
    ts[0] = 0.0
    for i in range(n - 1):
        dR, dt = odo[i]
        ts[i + 1] = ts[i] + Rs[i] @ dt
        Rs[i + 1] = Rs[i] @ dR
    return Rs, ts
