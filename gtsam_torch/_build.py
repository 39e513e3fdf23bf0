"""Build and load the CUDA kernels of gtsam_torch/csrc.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into its own
shared library with a plain C interface, loaded with ctypes.  Libraries are
named by a digest of their sources and flags, so an edited source is never
served a stale build.  Building happens at first use, never at import, and
all missing libraries are compiled in parallel (one nvcc each).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gtsam_torch_kernels"
SOURCES = ("bal_linearize", "ba_point_eliminate", "ba_schur_assemble",
           "ba_back_substitute", "ba_schur_matvec", "pg_between",
           "pg_pose2", "sn_factor", "sn_narrow", "sn_solve", "sn_matvec",
           "sn_qr",
           "dense_factor", "dense_solve", "sp_level", "pcg", "proj_factor")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Test builds: a source compiled again with extra flags into a library of
# its own, which checks load (chip_smoke.py) and the main path never does.
# sn_factor_race: kernel 7 with delays before every flag's publish and
# await in all but a front's first CTA (GT_SN_RACE_DELAYS), so that a
# missing wait shows as other bits.
TEST_BUILDS = {"sn_factor_race": ("sn_factor", ("-DGT_SN_RACE_DELAYS",))}

BUILD_LOG = {}   # source name -> nvcc/ptxas output of the last build here
_LIBS = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of gtsam_torch are "
                       "built with nvcc at first use (set CUDA_HOME)")


def _source(name: str):
    """(the .cu file, the nvcc flags) of a library: a source's own, or a
    test build's (TEST_BUILDS)."""
    src, extra = TEST_BUILDS.get(name, (name, ()))
    return CSRC / f"{src}.cu", NVCC_FLAGS + tuple(extra)


def library_path(name: str) -> Path:
    cu, flags = _source(name)
    h = hashlib.sha1(" ".join(flags).encode())
    h.update(cu.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of `names` (sources, or TEST_BUILDS) that is
    not built yet, all nvcc processes at once.  Returns {name: path};
    raises if any build fails."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
            cu, flags = _source(n)
            cmd = [nvcc, *flags, "-I", str(CSRC), "-o", str(tmp), str(cu)]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build((name,))[name]))
        return _LIBS[name]
