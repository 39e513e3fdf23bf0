#!/usr/bin/env python3
"""Time gtsam_torch's blocked dense Cholesky and solve on one card, at the
size of BA's reduced camera system at the Ladybug-1723 shape.

    python3 scripts/port_dense_time.py [--root DIR] [--n N] [--reps R]

Imports gtsam_torch from DIR (default: this checkout).  For float64 and
float32 it makes a seeded SPD matrix on the card (A A^T / n + I, unit
diagonal after scaling) in the layout BA uses (_kernels.row_strided), then
times by CUDA events and by device time (torch.profiler): blocked_cholesky
(the matrix restored before each call, outside the timing), kernel 10
alone over every panel, kernel 11's forward and backward solves, and
beside them torch.linalg.cholesky_ex (on a contiguous copy) and the
solve_triangular pair, and the first trailing update's cuBLAS products at
rank 128, 256 and 512 into a row-strided S.  Prints one JSON line with the
card's name and power limit.  Give two roots in turns (A, B, B, A) in one
run to compare two versions on one card.
"""

import argparse
import json
import os
import subprocess
import sys


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--n", type=int, default=9 * 1723)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_dense_time: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.root))
    from torch.profiler import ProfilerActivity, profile

    from gtsam_torch import _kernels
    from gtsam_torch.linear import dense_blocked as db, dense_kernels as dk

    def events(fn, setup, reps):
        out = []
        for _ in range(reps):
            setup()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return out

    def device(fn, setup, reps):
        """Device ms of fn a call: profiled setup + fn, less setup alone."""
        def busy(f):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    f()
                torch.cuda.synchronize()
            return sum(e.self_device_time_total for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA")) / 1e3 / reps
        return busy(lambda: (setup(), fn())) - busy(setup)

    n = a.n
    g = torch.Generator("cuda").manual_seed(0)
    out = {}
    for dt in (torch.float64, torch.float32):
        A = torch.randn((n, n), dtype=torch.float64, device="cuda",
                        generator=g)
        S64 = A @ A.mT / n
        del A
        S64.diagonal().add_(1.0)
        d = S64.diagonal().rsqrt()
        S0 = (S64 * d[:, None] * d[None, :]).to(dt)
        del S64, d
        S = _kernels.row_strided(n, dt, "cuda")     # as BA allocates it
        b = torch.randn(n, dtype=torch.float64, device="cuda",
                        generator=g).to(dt)

        def restore():
            S.copy_(S0)

        r = {}
        r["factorization_ms"] = events(lambda: db.blocked_cholesky(S),
                                       restore, a.reps)
        r["factorization_device_ms"] = device(
            lambda: db.blocked_cholesky(S), restore, a.reps)
        P = dk.panels(n)
        Dinv = torch.empty((P, 128, 128), dtype=dt, device="cuda")
        info = torch.zeros((), dtype=torch.int32, device="cuda")

        def diag_loop():
            for k in range(P):
                dk.factor_diag(S, Dinv, info, k)
        r["kernel10_ms"] = min(events(diag_loop, restore, a.reps)) / P
        r["kernel10_device_ms"] = device(diag_loop, restore, a.reps) / P
        restore()
        L, Dinv, info = db.blocked_cholesky(S)
        if int(info) != 0:
            raise AssertionError(f"blocked_cholesky ({dt}) failed")
        y, x = torch.empty_like(b), torch.empty_like(b)

        def fwd():
            dk.solve_forward(L, Dinv, b, y)

        def bwd():
            dk.solve_backward(L, Dinv, y, x)
        for name, fn in (("forward", fwd), ("backward", bwd)):
            fn()
            r[f"{name}_ms"] = min(events(fn, lambda: None, 5))
            r[f"{name}_device_ms"] = device(fn, lambda: None, 5)
        del L, Dinv
        # cuSOLVER in the column-major transpose view of a contiguous S
        S = torch.empty_like(S0)
        info_t = torch.empty((), dtype=torch.int32, device="cuda")

        def chol():
            torch.linalg.cholesky_ex(S.mT, out=(S.mT, info_t))
        r["cholesky_ex_ms"] = events(chol, restore, a.reps)
        r["cholesky_ex_device_ms"] = device(chol, restore, a.reps)
        bc = b[:, None]
        yl = torch.linalg.solve_triangular(S.mT, bc, upper=False)

        def lib_pair():
            torch.linalg.solve_triangular(S.mT, bc, upper=False)
            torch.linalg.solve_triangular(S, yl, upper=True)
        lib_pair()
        r["solve_triangular_pair_ms"] = min(events(lib_pair, lambda: None, 5))
        rates = {}
        for nb in (128, 256, 512):
            X = torch.randn((n - nb, nb), dtype=dt, device="cuda",
                            generator=g)
            S = _kernels.row_strided(n, dt, "cuda").zero_()
            flops = sum(2 * nb * (n - j0) * (min(j0 + db.GROUP, n) - j0)
                        for j0 in range(nb, n, db.GROUP))

            def update():
                for j0 in range(nb, n, db.GROUP):
                    j1 = min(j0 + db.GROUP, n)
                    S[j0:, j0:j1].addmm_(X[j0 - nb:], X[j0 - nb:j1 - nb].mT,
                                         alpha=-1)
            update()
            ms = min(events(update, lambda: None, a.reps))
            rates[nb] = {"ms": ms, "tflops": flops / ms / 1e9}
        r["trailing_rank_rates"] = rates
        out[str(dt).replace("torch.", "")] = r
        del S, S0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"dense": out, "n": n, "root": a.root,
                      "card": smi[0] if smi else None,
                      "module": db.__file__}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
