#!/usr/bin/env python3
"""Probe what sets the time of BA's blocked dense Cholesky on one card.

    python3 scripts/port_dense_probe.py [--n N]

Two measurements at BA's n = 15,507 (one JSON line each, with the card's
name and power limit):
  - "trailing": the first trailing update as gtsam_torch.linear.
    dense_blocked does it (cuBLAS products of rank K into the lower
    triangle in column groups of G) on an n x n matrix whose rows are n
    entries apart (odd: 8-byte aligned) and one whose rows are
    _kernels.row_strided (256-byte aligned), for K in 128, 256, 512, 768,
    1024 and G in 1024, 2048: TFLOP/s of all the flops done and of the
    useful ones (the lower triangle only);
  - "kernel10": kernel 10 (csrc/dense_factor.cu) per launch over all
    panels, whole and cut short after each of its phases (staging, the
    tile loop, the inverse's composition) and without its warp-serial tile
    factor and inverse, each variant compiled here with the port's nvcc
    flags into build/dense_probe/ from a copy of the source.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel 10 variants: (text in csrc/dense_factor.cu, its replacement)
CUTS = {
    "full": None,
    "staging only": ("  __syncthreads();\n\n  for (int t = 0; t < kNT; ++t) {",
                     "  __syncthreads();\n  if (n > 0) return;\n"
                     "  for (int t = 0; t < kNT; ++t) {"),
    "up to the tile loop's end": (
        "  // L_D^-1 below the diagonal tiles",
        "  if (n > 0) return;\n  // L_D^-1 below the diagonal tiles"),
    "up to the composition's end": (
        "  // L_D into S's lower triangle",
        "  if (n > 0) return;\n  // L_D into S's lower triangle"),
    "without the tile factor and inverse": (
        "      factor_tile(A + tid_of(t, t) * kTileSz, rinv, o + t * kTile, "
        "info);\n      invert_tile(A + tid_of(t, t) * kTileSz, rinv,\n"
        "                  X + tid_of(t, t) * kTileSz);", ""),
}


def events(torch, fn, reps=3):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return min(out)


def trailing(torch, n, _kernels):
    out = []
    for dt in (torch.float64, torch.float32):
        for layout in ("rows n apart", "row_strided"):
            S = (torch.zeros((n, n), dtype=dt, device="cuda")
                 if layout == "rows n apart"
                 else _kernels.row_strided(n, dt, "cuda").zero_())
            for K in (128, 256, 512, 768, 1024):
                X = torch.randn((n - K, K), dtype=dt, device="cuda")
                for G in (1024, 2048):
                    groups = [(S[j0:, j0:min(j0 + G, n)], X[j0 - K:],
                               X[j0 - K:min(j0 + G, n) - K].mT)
                              for j0 in range(K, n, G)]
                    done = sum(2 * K * c.shape[0] * c.shape[1]
                               for c, _, _ in groups)
                    useful = sum(2 * K * (c.shape[0] * c.shape[1]
                                          - c.shape[1] * (c.shape[1] - 1) / 2)
                                 for c, _, _ in groups)

                    def update():
                        for c, a, b in groups:
                            c.addmm_(a, b, alpha=-1)
                    ms = events(torch, update)
                    out.append({"dtype": str(dt).replace("torch.", ""),
                                "layout": layout, "ld": S.stride(0), "K": K,
                                "G": G, "ms": ms,
                                "tflops": done / ms / 1e9,
                                "useful_tflops": useful / ms / 1e9})
            del S, X
    return out


def kernel10(torch, n, _build):
    src = (_build.CSRC / "dense_factor.cu").read_text()
    build = os.path.join(ROOT, "build", "dense_probe")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for i, (name, cut) in enumerate(CUTS.items()):
        text = src
        if cut is not None:
            if cut[0] not in src:
                raise AssertionError(f"kernel 10 changed: no cut {name!r}")
            text = src.replace(cut[0], cut[1])
        cu = os.path.join(build, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (os.path.join(build, f"v{i}.so"), subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", os.path.join(build, f"v{i}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (_, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    P = -(-n // 128)
    out = {}
    for dt, fn in ((torch.float64, "gt_dense_factor_diag"),
                   (torch.float32, "gt_dense_factor_diag_f32")):
        A = torch.randn((n, 256), dtype=torch.float64, device="cuda")
        S0 = (A @ A.mT / 256).to(dt)
        S0.diagonal().add_(1.0)
        S = S0.clone()
        D = torch.empty((P, 128, 128), dtype=dt, device="cuda")
        info = torch.zeros((), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        res = {}
        for name, (so, _) in procs.items():
            f = getattr(ctypes.CDLL(so), fn)
            f.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4

            def loop():
                S.copy_(S0)
                for k in range(P):
                    if f(n, n, k, S.data_ptr(), D.data_ptr(),
                         info.data_ptr(), stream):
                        raise RuntimeError("kernel 10 launch failed")
            copy = events(torch, lambda: S.copy_(S0))
            res[name] = (events(torch, loop) - copy) / P * 1e3   # us
        out[str(dt).replace("torch.", "")] = res
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=9 * 1723)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_dense_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gtsam_torch import _build, _kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    card = smi[0] if smi else None
    print(json.dumps({"trailing": trailing(torch, a.n, _kernels),
                      "n": a.n, "card": card}), flush=True)
    print(json.dumps({"kernel10_us_per_launch": kernel10(torch, a.n,
                                                         _build),
                      "n": a.n, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
