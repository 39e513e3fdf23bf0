"""Synthetic BAL-style problem generator.

Numpy copy of gtsam_tpu/sfm/synthetic.py: the same seed gives bit-identical
arrays.  Cameras on a ring look inward; each point is seen by a window of
consecutive cameras, which gives the Ladybug-1723 compute shape without a
download.
"""

import numpy as np

from . import bal


def make_bal_problem(num_cameras=1723, num_points=156000, obs_per_point=4,
                     pixel_noise=1.0, point_noise=0.05, seed=0) -> bal.BalProblem:
    """Cameras on a ring looking inward; each point seen by a window of cameras."""
    rng = np.random.default_rng(seed)
    M, N = num_cameras, num_points

    # ring trajectory of radius 50, points inside radius ~40
    ang = np.linspace(0, 4 * np.pi, M, endpoint=False)
    centers = np.stack([50 * np.cos(ang), 50 * np.sin(ang),
                        5 * np.sin(ang * 3)], axis=1)

    def look_at(c, target):
        z = target - c
        z = z / np.linalg.norm(z)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        n = np.linalg.norm(x)
        x = x / (n if n > 1e-9 else 1.0)
        y = np.cross(z, x)
        return np.stack([x, y, z], axis=1)  # columns are camera axes in world

    targets = rng.normal(scale=5.0, size=(M, 3))
    cam_R = np.stack([look_at(centers[i], targets[i]) for i in range(M)])
    cam_t = centers
    f = 500.0 + rng.normal(scale=10.0, size=M)
    # zero distortion: BAL-like compute shape with sane conditioning
    cam_calib = np.stack([f, np.zeros(M), np.zeros(M)], axis=1)

    # points near the cameras that see them: point j anchored to camera a_j
    anchor = rng.integers(0, M, size=N)
    depth = rng.uniform(5.0, 30.0, size=N)
    dirs = rng.normal(size=(N, 3))
    dirs[:, 2] = np.abs(dirs[:, 2]) + 2.0      # in front of camera (+z)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts_cam = dirs * depth[:, None]
    points = np.einsum("nij,nj->ni", cam_R[anchor], pts_cam) + cam_t[anchor]

    # observations: window of consecutive cameras around the anchor
    obs_cam_l, obs_pt_l, obs_uv_l = [], [], []
    win = np.maximum(1, obs_per_point)
    cam_off = rng.integers(0, 3, size=(N, win)) + np.arange(win)[None, :]
    for w in range(win):
        cams = (anchor + cam_off[:, w]) % M
        pc = np.einsum("nji,nj->ni", cam_R[cams],
                       points - cam_t[cams])  # world -> camera (R^T (p - t))
        z = pc[:, 2]
        ok = z > 0.5
        p = pc[:, :2] / np.where(ok, z, 1.0)[:, None]
        r2 = np.sum(p * p, axis=1)
        in_fov = ok & (r2 < 1.0)
        g = cam_calib[cams, 0] * (1 + cam_calib[cams, 1] * r2 +
                                  cam_calib[cams, 2] * r2 * r2)
        uv = p * g[:, None] + rng.normal(scale=pixel_noise, size=(N, 2))
        obs_cam_l.append(cams[in_fov])
        obs_pt_l.append(np.arange(N)[in_fov])
        obs_uv_l.append(uv[in_fov])
    obs_cam = np.concatenate(obs_cam_l).astype(np.int32)
    obs_pt = np.concatenate(obs_pt_l).astype(np.int32)
    obs_uv = np.concatenate(obs_uv_l)

    # keep only points with >= 2 observations
    counts = np.bincount(obs_pt, minlength=N)
    keep = counts >= 2
    remap = -np.ones(N, dtype=np.int64)
    remap[keep] = np.arange(keep.sum())
    sel = keep[obs_pt]
    obs_pt = remap[obs_pt[sel]].astype(np.int32)
    obs_cam = obs_cam[sel]
    obs_uv = obs_uv[sel]
    points = points[keep]

    # perturb initial points (the optimization has work to do)
    points_init = points + rng.normal(scale=point_noise, size=points.shape)

    return bal.BalProblem(cam_R, cam_t, cam_calib, points_init,
                          obs_cam, obs_pt, obs_uv)


def add_tracks(prob: bal.BalProblem, tracks, seed=0) -> bal.BalProblem:
    """`prob` with one new point per entry of `tracks` (an array of the
    cameras that see it, repeats allowed), placed near the ring's centre,
    with measurements = projections + 1 px noise.  Builds the tracks that
    the generator never makes: longer than any window, seeing one camera
    twice, or many points over one pair of cameras."""
    rng = np.random.default_rng(seed)
    new_pts = [rng.normal(size=3) for _ in tracks]
    obs_cam, obs_pt, obs_uv = [prob.obs_cam], [prob.obs_pt], [prob.obs_uv]
    for i, (cs, p) in enumerate(zip(tracks, new_pts)):
        cs = np.asarray(cs)
        pc = np.einsum("kji,kj->ki", prob.cam_R[cs], p - prob.cam_t[cs])
        if not (pc[:, 2] > 1.0).all():
            raise ValueError(f"track {i}: the point is not in front of "
                             "every camera")
        uv = pc[:, :2] / pc[:, 2:] * prob.cam_calib[cs, :1]
        obs_cam.append(cs.astype(np.int32))
        obs_pt.append(np.full(len(cs), prob.num_points + i, np.int32))
        obs_uv.append(uv + rng.normal(size=uv.shape))
    return bal.BalProblem(
        prob.cam_R, prob.cam_t, prob.cam_calib,
        np.concatenate([prob.points, np.stack(new_pts)]),
        np.concatenate(obs_cam), np.concatenate(obs_pt),
        np.concatenate(obs_uv))
