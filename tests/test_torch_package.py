"""Rules of the gtsam_torch package: it never imports JAX or gtsam_tpu, its
entry points run on CUDA unless asked for the CPU and raise without CUDA,
and its kernel wrappers check what they launch on and never fall back to
the plain version for a tensor that is not on the CPU."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gtsam_torch
from gtsam_torch import _build, config
from gtsam_torch.sfm import ba, ba_kernels, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_imports_neither_jax_nor_gtsam_tpu():
    code = """
import pkgutil, sys
for name in [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gtsam_tpu')]:
    del sys.modules[name]
for name in ('jax', 'jaxlib', 'gtsam_tpu'):
    sys.modules[name] = None          # any import of them now raises
import gtsam_torch
mods = [m.name for m in pkgutil.walk_packages(gtsam_torch.__path__, 'gtsam_torch.')]
for m in mods:
    __import__(m)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gtsam_tpu')
       and sys.modules[m] is not None]
print(len(mods), bad)
assert not bad
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_mods = int(out.stdout.split()[0])
    assert n_mods == len(list(pkgutil.walk_packages(gtsam_torch.__path__,
                                                    "gtsam_torch.")))
    assert n_mods >= 10


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = synthetic.make_bal_problem(6, 40, 3, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ba.ba_optimize(prob)
    with pytest.raises(RuntimeError, match="CUDA"):
        ba.state_from_numpy(prob.cam_R, prob.cam_t, prob.cam_calib,
                            prob.points)
    assert config.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.resolve_device() == torch.device("cuda")
    assert config.default_dtype() == torch.float64


def test_cpu_path_counts_no_launch():
    prob = synthetic.make_bal_problem(6, 40, 3, seed=0)
    ba_kernels.reset_launch_counts()
    _, info = ba.ba_optimize(prob, device="cpu")
    assert np.isfinite(info["error"])
    assert set(ba_kernels.launch_counts()) == {
        "bal_linearize", "bal_error", "ba_point_eliminate",
        "ba_camera_assemble", "ba_pair_assemble", "ba_back_substitute"}
    assert all(n == 0 for n in ba_kernels.launch_counts().values())


def _meta_args(name, K=10, M=3, N=4, P=20):
    """Well-formed arguments of each wrapper, on the meta device."""
    def f(*shape):
        return torch.empty(shape, dtype=torch.float64, device="meta")

    def i(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    return {
        "linearize": (f(M, 3, 3), f(M, 3), f(M, 3), f(N, 3), i(K), i(K),
                      f(K, 2)),
        "error": (f(M, 3, 3), f(M, 3), f(M, 3), f(N, 3), i(K), i(K),
                  f(K, 2)),
        "point_eliminate": (i(N + 1), f(K, 2, 9), f(K, 2, 3), f(K, 2), 1e-4,
                            False),
        "camera_assemble": (i(M + 1), i(K), f(K, 2, 9), f(K, 2), f(K, 9),
                            1e-4, False, f(9 * M, 9 * M)),
        "pair_assemble": (i(N + 1), i(P), i(P), i(K), f(K, 9, 3),
                          f(K, 9, 3), f(9 * M, 9 * M)),
        "back_substitute": (i(N + 1), i(K), f(K, 9, 3), f(M, 9), f(N, 3, 3),
                            f(N, 3)),
    }[name]


WRAPPERS = ["linearize", "error", "point_eliminate", "camera_assemble",
            "pair_assemble", "back_substitute"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_rejects_float32(name):
    args = list(_meta_args(name))
    j = next(k for k, a in enumerate(args)
             if isinstance(a, torch.Tensor) and a.dtype == torch.float64)
    args[j] = args[j].float()
    with pytest.raises(TypeError, match="float64"):
        getattr(ba_kernels, name)(*args)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_rejects_non_contiguous(name):
    args = list(_meta_args(name))
    j = max(k for k, a in enumerate(args)
            if isinstance(a, torch.Tensor) and a.dim() >= 2)
    a = args[j]
    args[j] = torch.empty(tuple(reversed(a.shape)), dtype=a.dtype,
                          device="meta").permute(*reversed(range(a.dim())))
    assert args[j].shape == a.shape and not args[j].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        getattr(ba_kernels, name)(*args)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_never_falls_back_off_the_cpu(name):
    """Well-formed tensors that are not on the CPU go to the kernel path,
    whose device check raises here (meta tensors), instead of running the
    plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ba_kernels, name)(*_meta_args(name))


def test_wrapper_rejects_wrong_shape():
    args = list(_meta_args("back_substitute"))
    args[3] = torch.empty((3, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="shape"):
        ba_kernels.back_substitute(*args)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_refuses_a_cpu_and_device_mix(name):
    """Every argument on the CPU but the last tensor (S for the assembly
    wrappers): the wrapper does not take the plain version, and its device
    check refuses the mix before any launch."""
    args = list(_meta_args(name))
    last = max(k for k, a in enumerate(args) if isinstance(a, torch.Tensor))
    args = [torch.zeros(a.shape, dtype=a.dtype)
            if isinstance(a, torch.Tensor) and k != last else a
            for k, a in enumerate(args)]
    ba_kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="one CUDA device; .* is on cpu"):
        getattr(ba_kernels, name)(*args)
    assert all(n == 0 for n in ba_kernels.launch_counts().values())


def _cpu_args(name):
    """Arguments of each wrapper at the shapes ba_optimize gives it, from a
    small problem, on the CPU; made anew at each call."""
    prob = synthetic.make_bal_problem(6, 40, 3, seed=0)
    plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                                prob.num_points).to("cpu")
    cams, pts = ba.state_from_numpy(prob.cam_R, prob.cam_t, prob.cam_calib,
                                    prob.points, device="cpu")
    uv = torch.as_tensor(prob.obs_uv[plan.order])
    proj = ba._projection_args(plan, cams, pts, uv)
    A_cam, A_pt, b = ba_kernels.linearize_plain(*proj)
    W, WC, corr, C, gl = ba_kernels.point_eliminate_plain(
        plan.pt_ptr, A_cam, A_pt, b, 1e-4, False)
    M = prob.num_cameras
    S = torch.zeros((9 * M, 9 * M), dtype=torch.float64)
    dc = torch.from_numpy(np.random.default_rng(0).normal(size=(M, 9)))
    return {
        "linearize": proj,
        "error": proj,
        "point_eliminate": (plan.pt_ptr, A_cam, A_pt, b, 1e-4, False),
        "camera_assemble": (plan.cam_ptr, plan.cam_obs, A_cam, b, corr, 1e-4,
                            False, S),
        "pair_assemble": (plan.pair_ptr, plan.pair_a, plan.pair_b,
                          plan.obs_cam, WC, W, S),
        "back_substitute": (plan.pt_ptr, plan.obs_cam, W, dc, C, gl),
    }[name]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_on_cpu_is_its_plain_version(name):
    """On CPU tensors a wrapper returns, and writes into its arguments,
    exactly what its plain version does, and counts no launch."""
    ba_kernels.reset_launch_counts()
    args, ref_args = _cpu_args(name), _cpu_args(name)
    got = getattr(ba_kernels, name)(*args)
    ref = getattr(ba_kernels, name + "_plain")(*ref_args)

    def tensors(out):
        return [] if out is None else [out] if isinstance(
            out, torch.Tensor) else list(out)

    assert len(tensors(got)) == len(tensors(ref))
    pairs = list(zip(tensors(got), tensors(ref)))
    pairs += [(a, r) for a, r in zip(args, ref_args)
              if isinstance(a, torch.Tensor)]
    for a, r in pairs:
        assert a.device.type == "cpu" and torch.equal(a, r)
    assert name != "pair_assemble" or args[-1].abs().max() > 0
    assert all(n == 0 for n in ba_kernels.launch_counts().values())


def test_build_targets_hopper():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert path.parent == _build.BUILD_DIR
        assert path == _build.library_path(name)     # stable digest
    assert _build.BUILD_DIR.parts[-2:] == ("build", "gtsam_torch_kernels")
    kernels = {k.source for k in ba_kernels.KERNELS.values()}
    assert kernels == set(_build.SOURCES)
    for k in ba_kernels.KERNELS.values():
        assert callable(getattr(ba_kernels, k.wrapper))
        assert callable(getattr(ba_kernels, k.wrapper + "_plain"))
        path, line = k.replaces.split(":")
        assert os.path.isfile(os.path.join(REPO, path)) and int(line) > 0
