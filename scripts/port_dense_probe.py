#!/usr/bin/env python3
"""Probe what sets the time of BA's blocked dense Cholesky on one card.

    python3 scripts/port_dense_probe.py [--n N] [--only trailing,kernel10,kernel11]

Three measurements at BA's n = 15,507 (one JSON line each, with the card's
name and power limit):
  - "trailing": the first trailing update as gtsam_torch.linear.
    dense_blocked does it (cuBLAS products of rank K into the lower
    triangle in column groups of G) on an n x n matrix whose rows are n
    entries apart (odd: 8-byte aligned) and one whose rows are
    _kernels.row_strided (256-byte aligned), for K in 128, 256, 512, 768,
    1024 and G in 1024, 2048: TFLOP/s of all the flops done and of the
    useful ones (the lower triangle only);
  - "kernel10": kernel 10 (csrc/dense_factor.cu) per launch over all
    panels, whole, returning at once (the floor that the host's launch
    loop sets), cut short after each of its phases (the staging with
    tile 0's factorization, the tile loop up to tile 3's factorization,
    phase A: the last inverse and sums), and without the diagonal tiles'
    warp-serial factorizations, the row solves, the tile inverses, the U
    lists or the chain's diagonal-tile updates, and with the
    factorizations' columns passed by shuffles, each variant
    compiled here with the port's nvcc flags into build/dense_probe/ from
    a copy of the source;
  - "kernel11": kernel 11 (csrc/dense_solve.cu) forward and backward ms
    per call on the port's factor of a seeded SPD matrix, for each variant
    of CUTS11 (none now: a variant is a list of text replacements, as for
    kernel 10), compiled the same way.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel 10 variants: [(text in csrc/dense_factor.cu, its replacement)]
CUTS = {
    "full": [],
    "returning at once (the launch loop's floor)": [(
        "  if (threadIdx.x < kNT * 8) ready[threadIdx.x] = 0;",
        "  if (n > 0) return;\n"
        "  if (threadIdx.x < kNT * 8) ready[threadIdx.x] = 0;")],
    "staging and tile 0's factorization only": [(
        "  __syncthreads();\n\n  for (int t = 0; t + 1 < kNT; ++t) {",
        "  __syncthreads();\n  if (n > 0) return;\n\n"
        "  for (int t = 0; t + 1 < kNT; ++t) {")],
    "up to tile 3's factorization": [(
        "  run_phase(b, 6, warp, kWarps);   // A",
        "  if (n > 0) return;\n  run_phase(b, 6, warp, kWarps);   // A")],
    "up to phase A's end": [(
        "  run_phase(b, 7, warp, kWarps);   // B",
        "  if (n > 0) return;\n  run_phase(b, 7, warp, kWarps);   // B")],
    # the solves that follow a factorization still get its flags
    "without the diagonal tiles' factorizations": [
        ("      factor_tile(b, 0);",
         "      for (int q = 0; q < 8; ++q) signal(b.ready + q);"),
        ("        factor_tile(b, t + 1);",
         "        for (int q = 0; q < 8; ++q) signal(b.ready + (t + 1) * 8 + q);")],
    "without the row solves": [
        ("      solve_rows<false>(b, i, jb.t);\n", ""),
        ("      solve_rows<true>(b, 1, 0);", "      ;"),
        ("        solve_rows<false>(b, t + 2, t);\n", ""),
        ("        solve_rows<true>(b, t + 2, t + 1);\n", "")],
    "without the tile inverses": [
        ("      invert_tile(b, jb.t);\n", "")],
    "without the U lists": [
        ("      run_phase(b, 2 * t + 1, warp - 2, kWarps - 2);  // U(t)", "")],
    "the columns by shuffles": [(
        "    T lj[kTile];\n    load_below(lt + k * kLtPitch, k, lj);",
        "    T lj[kTile];\n#pragma unroll\n"
        "    for (int j = k + 1; j < kTile; ++j) "
        "lj[j] = __shfl_sync(kFull, l, j);")],
    "without the chain's diagonal-tile updates": [
        ("      update_strip(b, t + 1, t + 1, t, 16 * warp);\n", "")],
}
# kernel 11 variants, the same way (csrc/dense_solve.cu)
CUTS11 = {
    "full": [],
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


def compile_variants(_build, source, cuts):
    """{name: loaded library} of csrc/<source>.cu with each variant's
    replacements, compiled in parallel into build/dense_probe/."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    build = os.path.join(ROOT, "build", "dense_probe")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for i, (name, cut) in enumerate(cuts.items()):
        text = src
        for old, new in cut:
            if old not in text:
                raise AssertionError(f"{source}.cu changed: no cut {name!r}")
            text = text.replace(old, new)
        cu = os.path.join(build, f"{source}_v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(build, f"{source}_v{i}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def kernel10(torch, n, _build):
    libs = compile_variants(_build, "dense_factor", CUTS)
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
        for name, lib in libs.items():
            f = getattr(lib, fn)
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


def kernel11(torch, n, _build, _kernels):
    """Each kernel 11 variant's forward and backward ms (CUDA events) on
    the port's factor of a seeded SPD matrix in BA's layout."""
    from gtsam_torch.linear import dense_blocked, dense_kernels as dk
    libs = compile_variants(_build, "dense_solve", CUTS11)
    out = {}
    for dt, sfx in ((torch.float64, ""), (torch.float32, "_f32")):
        g = torch.Generator("cuda").manual_seed(0)
        A = torch.randn((n, 256), dtype=torch.float64, device="cuda",
                        generator=g)
        S = _kernels.row_strided(n, dt, "cuda")
        S.copy_(A @ A.mT / 256)
        del A
        S.diagonal().add_(1.0)
        L, Dinv, info = dense_blocked.blocked_cholesky(S)
        b = torch.randn(n, dtype=torch.float64, device="cuda",
                        generator=g).to(dt)
        y, x = torch.empty_like(b), torch.empty_like(b)
        word, bits = dk.PENDING[dt]
        stream = torch.cuda.current_stream().cuda_stream
        res = {}
        for name, lib in libs.items():
            calls = {}
            for d, rhs, o in (("forward", b, y), ("backward", y, x)):
                f = getattr(lib, f"gt_dense_{d}{sfx}")
                f.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6

                def call(f=f, rhs=rhs, o=o):
                    o.view(word).fill_(bits)   # the entries unwritten
                    if f(n, L.stride(0), L.data_ptr(), Dinv.data_ptr(),
                         rhs.data_ptr(), o.data_ptr(), None, stream):
                        raise RuntimeError("kernel 11 launch failed")
                calls[d] = call
            calls["forward"]()
            ref = y.clone()
            res[name] = {d: events(torch, c, reps=10)
                         for d, c in calls.items()}
            calls["forward"]()
            res[name]["same_bits"] = bool(torch.equal(y, ref))
        out[str(dt).replace("torch.", "")] = res
        del S, L, Dinv
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=9 * 1723)
    ap.add_argument("--only", default="trailing,kernel10,kernel11",
                    help="comma-separated measurements to run")
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
    only = a.only.split(",")
    if "trailing" in only:
        print(json.dumps({"trailing": trailing(torch, a.n, _kernels),
                          "n": a.n, "card": card}), flush=True)
    if "kernel10" in only:
        print(json.dumps({"kernel10_us_per_launch": kernel10(torch, a.n,
                                                             _build),
                          "n": a.n, "card": card}), flush=True)
    if "kernel11" in only:
        print(json.dumps({"kernel11_ms": kernel11(torch, a.n, _build,
                                                  _kernels),
                          "n": a.n, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
