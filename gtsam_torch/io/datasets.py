"""Pose-graph dataset I/O: 2D and 3D g2o / TORO files, example-data lookup.

Counterpart of gtsam_tpu/io/datasets.py (reference gtsam/slam/dataset.cpp):
  - 2D noise layouts (g2o's upper triangle against TORO's ff, fs, ss, rr,
    fr, sr order), and which of them store information and which
    covariance: dataset.cpp:216-262 createNoiseModel (_info2d_from_vector);
  - EDGE3 rotations read as roll, pitch, yaw -> Rot3::Ypr(y, p, r)
    (dataset.cpp:748);
  - EDGE_SE3:QUAT information reordered from g2o's (t, R) to GTSAM's (R, t)
    (dataset.cpp:850).
Bearing-range rows (BR, LANDMARK) wait for sam/factors.py's
bearing_range_2d_factors and raise NotImplementedError.
"""

import os

import numpy as np
import torch

from ..base import keys as keys_mod
from ..base import noise as noise_mod
from ..geometry.se3 import SE3
from ..graph import factors as factors_mod
from ..graph.graph import FactorGraph
from ..graph.values import Values

# where find_example_data looks: $GTSAM_TORCH_DATA, then examples/Data under
# the repository's root (where a GTSAM checkout keeps its datasets)
_DATA_DIRS = [
    os.environ.get("GTSAM_TORCH_DATA", ""),
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "examples", "Data"),
]


def find_example_data(name: str) -> str:
    """Reference findExampleDataFile (dataset.cpp:56)."""
    for d in _DATA_DIRS:
        if d and os.path.exists(os.path.join(d, name)):
            return os.path.join(d, name)
    raise FileNotFoundError(name)


def _info2d_from_vector(v, fmt: str) -> np.ndarray:
    """6-vector -> 3x3 INFORMATION matrix (dataset.cpp:216-279).

    Layouts: 'g2o' / 'cov' are the row-major upper triangle [v0 v1 v2;
    . v3 v4; . . v5]; 'toro' / 'graph' the TORO order [v0 v1 v4; . v2 v5;
    . . v3].  Semantics: 'g2o' / 'toro' files store the information matrix;
    'graph' / 'cov', and the reference's auto-detection, which only ever
    yields graph or cov, store the covariance, which createNoiseModel
    inverts (noiseModel::Gaussian::Covariance).  Reading auto-detected
    matrices as information mis-weights a file's edges by the square of
    its sigmas.  An unrecognized auto layout raises."""
    v = np.asarray(v, dtype=np.float64)
    if fmt == "auto":
        if (v[0] != 0 and v[1] == 0 and v[2] != 0 and v[3] != 0
                and v[4] == 0 and v[5] == 0):
            fmt = "graph"
        elif (v[0] != 0 and v[1] == 0 and v[2] == 0 and v[3] != 0
              and v[4] == 0 and v[5] != 0):
            fmt = "cov"
        else:
            raise ValueError(
                "load_2d: unrecognized covariance matrix format; pass "
                "noise_format explicitly (dataset.cpp:220-231 analog)")
    if fmt in ("g2o", "cov"):
        M = np.array([[v[0], v[1], v[2]],
                      [v[1], v[3], v[4]],
                      [v[2], v[4], v[5]]])
    else:  # toro / graph layout
        M = np.array([[v[0], v[1], v[4]],
                      [v[1], v[2], v[5]],
                      [v[4], v[5], v[3]]])
    if fmt in ("cov", "graph"):
        M = np.linalg.inv(M)
    return M


def load_2d(path: str, noise_format: str = "auto"):
    """Parse a 2D pose-graph file (VERTEX_SE2 / VERTEX2 / VERTEX, EDGE_SE2
    / EDGE2 / EDGE / ODOMETRY).  Returns (graph, initial Values of SE2
    poses, on the CPU); reference load2D (dataset.cpp:152).  EDGE_SE2 rows
    store information (g2o) under noise_format "auto"; the other edge tags
    are auto-detected (_info2d_from_vector).  Poses without a vertex
    compose the odometry (_initials_2d).  BR and LANDMARK rows (bearing-
    range sightings of landmark l_j, dataset.cpp:463-486) become one
    bearing_range_2d_factors batch, each landmark's initial Point2 from its
    first sighting of a pose with an initial value."""
    poses = {}
    e_i, e_j, e_meas, e_info = [], [], [], []
    br_i, br_l, br_b, br_r, br_sig = [], [], [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = tok[0]
            if tag in ("VERTEX_SE2", "VERTEX2", "VERTEX"):
                poses[int(tok[1])] = np.array([float(tok[2]), float(tok[3]),
                                               float(tok[4])])
            elif tag in ("EDGE_SE2", "EDGE2", "EDGE", "ODOMETRY"):
                fmt = noise_format
                if fmt == "auto" and tag == "EDGE_SE2":
                    fmt = "g2o"   # g2o-tagged rows store information
                e_i.append(int(tok[1]))
                e_j.append(int(tok[2]))
                e_meas.append([float(tok[3]), float(tok[4]), float(tok[5])])
                e_info.append(_info2d_from_vector(
                    [float(t) for t in tok[6:12]], fmt))
            elif tag in ("BR", "LANDMARK"):
                i, lm = int(tok[1]), int(tok[2])
                if tag == "BR":
                    b, r = float(tok[3]), float(tok[4])
                    bs, rs = float(tok[5]), float(tok[6])
                else:
                    lmx, lmy = float(tok[3]), float(tok[4])
                    v1, v3 = float(tok[5]), float(tok[7])
                    b = np.arctan2(lmy, lmx)
                    r = np.hypot(lmx, lmy)
                    if abs(v1 - v3) < 1e-4:
                        bs, rs = np.sqrt(v1 / 10.0), np.sqrt(v1)
                    else:
                        bs, rs = 1.0, 1.0
                br_i.append(i)
                br_l.append(keys_mod.symbol("l", lm))
                br_b.append(b)
                br_r.append(r)
                br_sig.append([bs, rs])
    graph = FactorGraph()
    if e_i:
        graph.add(factors_mod.between_factors(
            "SE2", np.array(e_i), np.array(e_j), np.asarray(e_meas),
            noise_mod.information(np.asarray(e_info))))
    if br_i:
        from ..sam.factors import bearing_range_2d_factors
        graph.add(bearing_range_2d_factors(
            br_i, br_l, br_b, br_r, noise_mod.sigmas(np.asarray(br_sig))))
    initial = _initials_2d(poses, e_i, e_j, e_meas)
    entries = [(k, "SE2", torch.as_tensor(initial[k], dtype=torch.float64))
               for k in sorted(initial)]
    # landmark initials from the first sighting
    seen = {}
    for i, lk, b, r in zip(br_i, br_l, br_b, br_r):
        if lk in seen or i not in initial:
            continue
        px, py, th = initial[i]
        seen[lk] = np.array([px + r * np.cos(th + b),
                             py + r * np.sin(th + b)])
    entries += [(lk, "Point2", torch.as_tensor(p, dtype=torch.float64))
                for lk, p in sorted(seen.items())]
    return graph, Values.from_entries(entries)


def _initials_2d(poses, e_i, e_j, e_meas):
    """Every edge end an initial pose: the vertices, then (in edge order) a
    missing i at the origin and a missing j composed from i by the edge."""
    out = dict(poses)
    for i, j, m in zip(e_i, e_j, e_meas):
        if i not in out:
            out[i] = np.zeros(3)
        if j not in out:
            pi = out[i]
            c, s = np.cos(pi[2]), np.sin(pi[2])
            out[j] = np.array([pi[0] + c * m[0] - s * m[1],
                               pi[1] + s * m[0] + c * m[1],
                               pi[2] + m[2]])
    return out


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


def read_g2o(path: str, is_3d: bool = False):
    """Reference readG2o (dataset.cpp:190)."""
    return load_3d(path) if is_3d else load_2d(path, noise_format="g2o")


def write_g2o(path: str, graph: FactorGraph, values: Values) -> None:
    """Reference writeG2o (dataset.cpp:205): SE2 and SE3 vertices, and the
    SE2 between edges with a unit information."""
    lines = []
    for t, ks in values.keys.items():
        if t == "SE2":
            arr = values.arrays["SE2"].detach().cpu().numpy()
            for k, p in zip(ks, arr):
                lines.append(f"VERTEX_SE2 {int(k)} {p[0]} {p[1]} {p[2]}")
        elif t == "SE3":
            R = values.arrays["SE3"].R.detach().cpu().numpy()
            tr = values.arrays["SE3"].t.detach().cpu().numpy()
            for k, Rk, tk in zip(ks, R, tr):
                q = _to_quat_np(Rk)
                lines.append(
                    "VERTEX_SE3:QUAT "
                    f"{int(k)} {tk[0]} {tk[1]} {tk[2]} {q[1]} {q[2]} {q[3]} "
                    f"{q[0]}")
    for b in graph.batches:
        if b.name.startswith("Between") and b.var_types[0] == "SE2":
            meas = b.measurements.detach().cpu().numpy()
            for n in range(b.num_factors):
                i, j = b.keys[n]
                m = meas[n]
                lines.append(
                    f"EDGE_SE2 {i} {j} {m[0]} {m[1]} {m[2]} 1 0 0 1 0 1")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


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


def _to_quat_np(R) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix (Shepperd)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


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
