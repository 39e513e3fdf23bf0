#!/usr/bin/env python3
"""Drive the gtsam_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py            # full run: needs one NVIDIA card
    python3 chip_smoke.py --quick    # build + kernel checks + a small BA only

Phases (each one raises on failure; the script exits 0 only if all pass):
  1. the card's name and power limit (nvidia-smi) and torch's device name;
  2. build every kernel of gtsam_torch/csrc with nvcc (sm_90a), timed;
  3. a fast first gate: each kernel, and each float32 variant, against its
     plain PyTorch version on the same CUDA tensors at
     make_bal_problem(100, 5000, 4, seed=0) plus tracks that take every
     branch of the kernels (a 200-observation track, a track that sees one
     camera twice, 700 points over one camera pair), with stated
     tolerances; kernel 1 also at make_bal_problem(3, 10, 2) plus one track
     (an odd K below one warp tile; the problem above leaves a partial last
     tile and error block), twice on the same inputs (same bits) and with
     error calls of different K back to back; and small ba_optimize runs, float64 and
     mixed, on the card against the same runs on the CPU;
  4. the main paths: gtsam_torch.sfm.ba.ba_optimize at the Ladybug-1723
     shape (make_bal_problem(1723, 150000, 4, seed=0)) with bench.py's LM
     settings, (a) float64 and (b) mixed precision (dtype=float32,
     mixed_precision=True, as bench.py:68-73 runs the JAX package), each
     held to the C++ GTSAM optimum 329,909 x 1.0001 and run twice for the
     same bits; every kernel's launch count is read from the first run of
     its path alone;
  5. each kernel against its plain version again at the Ladybug shape, on
     the converged state (same tolerances), then its time (CUDA events)
     beside the plain version's time and its bound from this run's shapes,
     and kernel 1's ptxas register and spill lines; two assemblies, two
     calls of kernel 1 and two matvecs on the same inputs must give the
     same bits; the time of the plan build (host and device), of one
     factorization in float64 and in float32, and of the triangular-solve
     pairs;
  6. one profiled run of each main path: device busy time by kernel, and
     the rows of the full-matrix passes (mul, fill, copy, tril); then a
     profile of error calls alone, each of which must be one launch of its
     kernel and no other device work.
The last three lines are the kernels' JSON, the nvidia-smi line and
{"ok": true, "device": {...}}.  Imports neither JAX nor gtsam_tpu.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS = 34e12             # H100 SXM FP64 outside the tensor cores
FP64_TC_FLOPS = 67e12          # H100 SXM FP64 tensor cores (cuSOLVER's DGEMMs)
FP32_FLOPS = 67e12             # H100 SXM FP32 outside the tensor cores
TARGET = 329909.0 * 1.0001     # baselines/reference_cpu.json bal_ladybug x 1.0001
# Kernel source, wrapper, plain version and the JAX routine each replaces
# are read from gtsam_torch.sfm.ba_kernels.KERNELS.
# kernel-vs-plain tolerances, relative to the plain output's largest entry:
# kernel 1 shares the plain version's formulas (FMA contraction only);
# kernels 2, 3 and 4 sum in another (fixed) order than their plain versions:
# kernel 2 per point in row order (a warp butterfly on long tracks), kernel 3
# per cell in 14 interleaved partial sums, and C in kernel 2 is a 3x3 inverse
# that carries its block's condition number into WC and corr, which kernel 3
# then sums; 1e-10 leaves that room at lam = 1.  The float32 variants share
# their float64 kernels' tolerances: a float32 output is held, entry by
# entry, to the plain version's float64 value before rounding, less half an
# f32 ulp of that value (so one rounding, and the same arithmetic error as
# the float64 kernel).  Kernel 5 sums in another order than its plain
# version, with no inverse in it: 1e-12.
TOL = {"bal_linearize": 1e-12, "bal_linearize_f32": 1e-12, "bal_error": 1e-12,
       "ba_point_eliminate": 1e-10, "ba_point_eliminate_f32": 1e-10,
       "ba_camera_assemble": 1e-10, "ba_camera_assemble_f32": 1e-10,
       "ba_pair_assemble": 1e-10, "ba_pair_assemble_f32": 1e-10,
       "ba_back_substitute": 1e-10, "ba_schur_matvec": 1e-12}
# the kernels each main path must launch (a float32 run that stalls may
# launch the float64 ones too)
PATHS = {
    "float64": ("bal_linearize", "bal_error", "ba_point_eliminate",
                "ba_camera_assemble", "ba_pair_assemble",
                "ba_back_substitute"),
    "mixed": ("bal_linearize_f32", "bal_error", "ba_point_eliminate_f32",
              "ba_camera_assemble_f32", "ba_pair_assemble_f32",
              "ba_back_substitute", "ba_schur_matvec")}


def log(*a):
    print(*a, flush=True)


def rel_err(got, ref, ref64=None):
    """(max |got - ref| / max |ref|, max |got - ref|) over tensors.  A
    float32 tensor of `got` is held instead to the float64 tensor at its
    place in `ref64` (the plain version's value before rounding): its error
    there is |got - ref64| less half an f32 ulp of ref64, over max |ref64|.
    The absolute error is always against `ref`."""
    import torch
    worst_rel, worst_abs = 0.0, 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        worst_abs = max(worst_abs, float(torch.max(torch.abs(
            g.double() - r.double()))))
        if g.dtype == torch.float32:
            r = ref64[i]
            r32 = r.float().abs()
            half_ulp = 0.5 * (torch.nextafter(
                r32, torch.full_like(r32, float("inf"))) - r32).double()
            d = float(torch.max(torch.clamp(torch.abs(g.double() - r)
                                            - half_ulp, min=0.0)))
            del r32, half_ulp
        else:
            d = float(torch.max(torch.abs(g - r)))
        scale = max(float(torch.max(torch.abs(r))), 1e-300)
        worst_rel = max(worst_rel, d / scale)
    return worst_rel, worst_abs


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


class Inputs:
    """One problem on the card: plan, state, and for each of float64 and
    float32 Jacobians the linearization, elimination and S buffer."""

    def __init__(self, prob, lam, cams=None, pts=None):
        import torch
        from gtsam_torch.sfm import ba
        self.prob, self.lam = prob, lam
        self.plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt,
                                         prob.num_cameras,
                                         prob.num_points).to("cuda")
        self.uv = torch.as_tensor(prob.obs_uv[self.plan.order],
                                  dtype=torch.float64, device="cuda")
        if cams is None:
            cams, pts = ba.state_from_numpy(prob.cam_R, prob.cam_t,
                                            prob.cam_calib, prob.points,
                                            "cuda")
        self.cams, self.pts = cams, pts
        self.proj = ba._projection_args(self.plan, cams, pts, self.uv)
        self.dc = torch.randn((prob.num_cameras, 9), dtype=torch.float64,
                              device="cuda",
                              generator=torch.Generator("cuda").manual_seed(0))
        self.sys = {dt: self._system(dt)
                    for dt in (torch.float64, torch.float32)}

    def _system(self, dt):
        """The plain versions' linearization and elimination with dt
        Jacobians, a zeroed S of dt, and the scale s (and for float32 the
        damped Hpp) that 3a's plain version gives."""
        import types
        import torch
        from gtsam_torch.sfm import ba_kernels as bk
        d = types.SimpleNamespace()
        d.A_cam, d.A_pt, d.b = bk.linearize_plain(*self.proj, dt)
        d.W, d.WC, d.corr, d.C, d.gl = bk.point_eliminate_plain(
            self.plan.pt_ptr, self.plan.pt_tile, d.A_cam, d.A_pt, d.b,
            self.lam, False)
        n = 9 * self.prob.num_cameras
        d.S = torch.zeros((n, n), dtype=dt, device="cuda")
        d.s, d.Hpp_d = None, None
        d.s, *Hpp_d = bk.camera_assemble_plain(*self._args(
            "ba_camera_assemble", d))[1:]
        d.Hpp_d = Hpp_d[0] if Hpp_d else None
        return d

    def args(self, name):
        """The argument tuple of kernel `name`'s wrapper and plain version
        (the float32 variants and the matvec take the float32 system)."""
        import torch
        f32 = name.endswith("_f32") or name == "ba_schur_matvec"
        return self._args(name, self.sys[torch.float32 if f32
                                         else torch.float64])

    def args64(self, name):
        """For a float32 variant: the same function's arguments in float64
        (the float32 Jacobians upcast, a float64 S), so the plain version
        gives the values its float32 outputs round."""
        import types
        import torch
        if name == "bal_linearize_f32":
            return self.proj + (torch.float64,)
        d32, d64 = self.sys[torch.float32], self.sys[torch.float64]
        d = types.SimpleNamespace(**{**vars(d32), "A_cam": d32.A_cam.double(),
                                     "A_pt": d32.A_pt.double(), "S": d64.S})
        return self._args(name, d)

    def _args(self, name, d):
        p = self.plan
        base = name.removesuffix("_f32")
        return {
            "bal_linearize": self.proj + ((d.A_cam.dtype,)
                                          if name.endswith("_f32") else ()),
            "bal_error": self.proj,
            "ba_point_eliminate": (p.pt_ptr, p.pt_tile, d.A_cam, d.A_pt, d.b,
                                   self.lam, False),
            "ba_camera_assemble": (p.cam_ptr, p.cam_obs, d.A_cam, d.b,
                                   d.corr, p.cell_ptr, p.diag_cell, p.cell_a,
                                   p.cell_b, d.WC, d.W, self.lam, False, d.S),
            "ba_pair_assemble": (p.cell_ptr, p.cell_ca, p.cell_cb, p.cell_a,
                                 p.cell_b, d.WC, d.W, d.s, d.S),
            "ba_back_substitute": (p.pt_ptr, p.pt_tile, p.obs_cam, d.W,
                                   self.dc, d.C, d.gl),
            "ba_schur_matvec": (p.pt_ptr, p.pt_tile, p.obs_cam, p.obs_pt,
                                p.cam_ptr, p.cam_obs, d.W, d.WC, d.Hpp_d,
                                self.dc),
        }[base]

    def shape(self):
        """Counts of the plan that the kernels' work depends on."""
        import numpy as np
        p = self.plan
        cell_ptr = p.cell_ptr.cpu().numpy().astype(np.int64)
        diag = (p.cell_ca == p.cell_cb).cpu().numpy()
        per_cell = np.diff(cell_ptr)
        off_pair = np.repeat(~diag, per_cell)
        tile_rows = np.diff(p.pt_ptr.cpu().numpy()[p.pt_tile.cpu().numpy()])
        return dict(
            P=int(cell_ptr[-1]), U=len(diag), U_diag=int(diag.sum()),
            P_diag=int(per_cell[diag].sum()), P_off=int(off_pair.sum()),
            rows_off=int(np.unique(p.cell_a.cpu().numpy()[off_pair]).size),
            max_cell_off=int(per_cell[~diag].max(initial=0)),
            diag_a_ne_b=int((p.cell_a != p.cell_b).cpu().numpy()[
                ~off_pair].sum()),
            tiles=len(tile_rows), max_tile_rows=int(tile_rows.max()),
            max_track=int(np.diff(p.pt_ptr.cpu().numpy()).max()))

    def work(self, name):
        """(bytes that must move, operations) of one call, counted from this
        problem's plan; each input read once, each output written once.  The
        float32 variants read (and store) their Jacobians and S in 4
        bytes."""
        M, N = self.prob.num_cameras, self.prob.num_points
        K = self.prob.num_observations
        c = self.shape()
        fa = 4 if name.endswith("_f32") else 8   # Jacobians and S
        params = M * (9 + 3 + 3) * 8 + N * 3 * 8
        T = c["tiles"]
        return {
            "bal_linearize": (K * (8 + 16) + params + K * (18 + 6) * fa
                              + K * 2 * 8, K * 110),
            # out: one double (the partials are the kernel's scratch)
            "bal_error": (K * (8 + 16) + params + 8, K * 40),
            # A_cam, A_pt, b and the point CSR and tiles in; W, WC, corr, C,
            # gl out
            "ba_point_eliminate": (K * (18 + 6) * fa + K * 2 * 8
                                   + (N + 1) * 4 + (T + 1) * 4
                                   + K * (27 + 27 + 9) * 8 + N * (9 + 3) * 8,
                                   K * 350 + N * 60),
            # A_cam, b, corr, the camera CSR; the diagonal cells' pairs and
            # the WC and W of every row (each row's pair (k, k) is one);
            # diagonal blocks, s and g out (and Hpp_d for float32)
            "ba_camera_assemble": (K * 18 * fa + K * (2 + 9) * 8 + K * 4
                                   + (M + 1) * 4 + M * 4 + c["U_diag"] * 8
                                   + c["P_diag"] * 8 + K * (27 + 27) * 8
                                   + M * 81 * fa + M * (9 + 9) * 8
                                   + (M * 81 * 8 if fa == 4 else 0),
                                   K * 370 + c["P_diag"] * 81 * 6),
            # the cell CSR, the off-diagonal pairs, WC and W of their rows and
            # s in; each off-diagonal cell out once
            "ba_pair_assemble": ((c["U"] + 1) * 4 + c["U"] * 8
                                 + c["P_off"] * 8
                                 + c["rows_off"] * (27 + 27) * 8 + 9 * M * 8
                                 + (c["U"] - c["U_diag"]) * 81 * fa,
                                 c["P_off"] * 81 * 6),
            # the point CSR and tiles, W and the camera of every row, dc, C
            # and gl in; dl out
            "ba_back_substitute": (K * (27 * 8 + 4) + M * 9 * 8
                                   + N * (9 + 3 + 3) * 8 + (N + 1) * 4
                                   + (T + 1) * 4, K * 54 + N * 15),
            # point pass: the point CSR and tiles, W and the camera of every
            # row, x in, u out; camera pass: the camera CSR, WC and the point
            # of every row, u, Hpp_d and x in, y out
            "ba_schur_matvec": (K * (27 * 8 + 4) + (N + 1) * 4 + (T + 1) * 4
                                + M * 9 * 8 + N * 3 * 8
                                + (M + 1) * 4 + K * (4 + 4 + 27 * 8)
                                + N * 3 * 8 + M * 81 * 8 + M * 9 * 8
                                + M * 9 * 8,
                                K * 54 + K * 54 + M * 81 * 2),
        }[name.removesuffix("_f32")]


def run_pair(name, inp, bk):
    """(kernel outputs, plain outputs, plain outputs in float64 or None) of
    kernel `name` on the same inputs; the assembly kernels' output includes
    all of S, zeroed before each call.  The third is the plain version on
    args64 for a float32 variant."""
    import torch
    outs = []
    wrapper = bk.KERNELS[name].wrapper
    plain = getattr(bk, wrapper + "_plain")
    calls = [(getattr(bk, wrapper), inp.args(name)), (plain, inp.args(name))]
    if name.endswith("_f32"):
        calls.append((plain, inp.args64(name)))
    assemble = name.startswith(("ba_camera_assemble", "ba_pair_assemble"))
    for f, args in calls:
        if assemble:
            args[-1].zero_()
        r = f(*args)
        if assemble:
            r = (args[-1].clone(),) + (r if r is not None else ())
        elif not isinstance(r, tuple):
            r = (r,)
        outs.append(r)
    torch.cuda.synchronize()
    return outs[0], outs[1], outs[2] if len(outs) > 2 else None


def check_kernels(inp, bk, label, names=None):
    """Each kernel of `names` (default: all) against its plain version on the
    same tensors of `inp`; raises on a miss of TOL.  Returns {kernel: max abs
    err}."""
    errs = {}
    for name in names or bk.KERNELS:
        kern, plain, plain64 = run_pair(name, inp, bk)
        rel, ab = rel_err(kern, plain, plain64)
        del kern, plain, plain64
        errs[name] = ab
        log(f"check {label} {name}: max rel err {rel:.3e} "
            f"(tol {TOL[name]:.0e}), max abs err {ab:.3e}")
        if not rel <= TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({label}): {rel:.3e} > {TOL[name]:.0e}")
    return errs


def check_kernel1_repeats(cases, bk, label):
    """Kernel 1 called again on the same inputs gives the same bits (both
    Jacobian dtypes), and error calls on problems of different K, back to
    back on one stream (largest first, so a smaller call may get a reused,
    stale partial buffer), each match the plain version: the completion
    counter resets and no partial of an earlier launch is read."""
    import torch
    for c in cases:
        for f, extra in ((bk.linearize, ()), (bk.linearize, (torch.float32,)),
                         (bk.error, ())):
            a, b = f(*c.proj, *extra), f(*c.proj, *extra)
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{f.__name__}{extra} ({label}): two "
                                     "calls on the same inputs differ")
    order = sorted(cases, key=lambda c: -c.prob.num_observations)
    order += order[::-1]
    got = [bk.error(*c.proj) for c in order]
    for c, g in zip(order, got):
        ref = bk.error_plain(*c.proj)
        rel = abs(float(g) - float(ref)) / max(abs(float(ref)), 1e-300)
        if not rel <= TOL["bal_error"]:
            raise AssertionError(f"bal_error ({label}, back to back, K "
                                 f"{c.prob.num_observations}): {rel:.3e}")
    log(f"kernel 1 ({label}): same bits on repeat; back-to-back error calls "
        f"at K {[c.prob.num_observations for c in order]} match the plain "
        "version")


def ptxas_lines(build_log, kernel):
    """The ptxas `registers` and `spill` lines of the kernel function whose
    name contains `kernel`, from one source's build log."""
    out, fn = [], ""
    for line in build_log.splitlines():
        if ("Compiling entry function" in line
                or "Function properties for" in line):
            fn = line
        elif ("registers" in line or "spill" in line) and kernel in fn:
            out.append(line.strip())
    return out


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    quick = "--quick" in argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from gtsam_torch import LMParams, _build
    from gtsam_torch.sfm import ba, ba_kernels as bk, synthetic

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.time()
    paths = _build.build()
    log(f"build: {time.time() - t0:.3f} s for {len(paths)} libraries")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions, small problem -------------
    torch.manual_seed(0)
    small = synthetic.make_bal_problem(100, 5000, 4, seed=0)
    # the kernel checks move a few points outside the camera ring, behind
    # every camera that sees them, so the cheirality branch runs too
    bad = dataclasses.replace(small, points=small.points.copy())
    first = bad.obs_cam[[int((bad.obs_pt == j).argmax()) for j in range(8)]]
    bad.points[:8] = 3.0 * bad.cam_t[first]
    # tracks the synthetic generator never makes: 200 observations (twice
    # round the ring: kernel 2's cooperative branch, and a != b pairs in
    # diagonal cells), one camera seen twice in a short track, and 700
    # points over cameras 3 and 4 (a long off-diagonal cell; the Ladybug
    # shape's longest has 604 pairs)
    bad = synthetic.add_tracks(
        bad, [np.arange(200) % 100, np.array([1, 1, 2])]
        + [np.array([3, 4])] * 700, seed=0)
    # lam = 1 keeps every damped 3x3 point block well conditioned, so the
    # differences measure the kernels' arithmetic: at lam = 1e-4 a track that
    # sees one camera twice has an unobservable depth (condition ~1e7), and
    # two correct inverses of it differ by ~1e-8 of their largest entry.
    inp = Inputs(bad, 1.0)
    behind = int((bk.linearize_plain(*inp.proj)[2] == -1e3).all(1).sum())
    shape = inp.shape()
    log(f"kernel checks: {behind} observations behind their camera; "
        f"plan {json.dumps(shape)}")
    if behind == 0:
        raise AssertionError("the kernel checks miss the cheirality branch")
    if not (shape["max_tile_rows"] > bk.POINT_TILE_STAGED
            and shape["diag_a_ne_b"] > 0 and shape["max_cell_off"] >= 700):
        raise AssertionError("the kernel checks miss a branch of kernel 2 "
                             "or 3")
    check_kernels(inp, bk, "small")
    # kernel 1's edges: the small problem's K leaves a partial last warp
    # tile and a partial last error block; a 23-observation problem is
    # below one tile, and its odd row count makes the float32 copy-out end
    # on half a 16-byte vector
    tiny = Inputs(synthetic.add_tracks(
        synthetic.make_bal_problem(3, 10, 2, seed=0), [np.arange(3)], seed=0),
        1.0)
    tile, blk = bk.LINEARIZE_TILE_ROWS, bk.ERROR_BLOCK
    K_small, K_tiny = bad.num_observations, tiny.prob.num_observations
    log(f"kernel 1 edges: K {K_small} (tile {tile}: {K_small % tile} rows "
        f"over; error block {blk}: {K_small % blk} over), K {K_tiny}")
    if not (K_small % tile and K_small % blk and K_small > blk
            and K_tiny < tile and K_tiny % 2):
        raise AssertionError("the kernel checks miss a partial tile of "
                             "kernel 1 or an odd K below one tile")
    check_kernels(tiny, bk, "tiny", ("bal_linearize", "bal_linearize_f32",
                                     "bal_error"))
    check_kernel1_repeats([inp, tiny], bk, "small")
    del inp, tiny
    lm_small = LMParams(max_iterations=10)
    for mode, kw in (("float64", {}),
                     ("mixed", dict(dtype=torch.float32,
                                    mixed_precision=True))):
        _, info_gpu = ba.ba_optimize(small, lm_small, device="cuda", **kw)
        _, info_cpu = ba.ba_optimize(small, lm_small, device="cpu", **kw)
        d = abs(info_gpu["error"] - info_cpu["error"]) / info_cpu["error"]
        log(f"small BA {mode}: card {info_gpu['error']!r} cpu "
            f"{info_cpu['error']!r} rel diff {d:.3e} "
            f"({info_gpu['iterations']} iterations, {info_gpu['phases']})")
        if not d <= 1e-6:
            raise AssertionError(f"small BA ({mode}) on the card disagrees "
                                 "with the CPU")

    if quick:
        log(json.dumps({"kernels": [], "quick": True}))
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # -- 4. the main paths at the Ladybug-1723 shape -------------------------
    t0 = time.time()
    prob = synthetic.make_bal_problem(1723, 150000, 4, seed=0)
    log(f"ladybug problem: {prob.num_cameras} cams, {prob.num_points} pts, "
        f"{prob.num_observations} obs (made in {time.time() - t0:.2f} s)")
    lm = LMParams(max_iterations=20, relative_error_tol=1e-6,
                  lambda_policy="conservative", lambda_initial=1e-4,
                  lambda_lower_bound=1e-4)
    modes = {"float64": {},
             "mixed": dict(dtype=torch.float32, mixed_precision=True)}
    runs = {}
    for mode, kw in modes.items():
        outs = []
        for rep in range(2):   # counts from the first; the second for bits
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            bk.reset_launch_counts()
            t0 = time.time()
            vals, info = ba.ba_optimize(prob, lm, verbose=rep == 0,
                                        target_error=TARGET, device="cuda",
                                        **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = bk.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            tries = (launches["ba_point_eliminate"]
                     + launches["ba_point_eliminate_f32"])
            log(f"main path {mode} run {rep + 1}: half-chi2 "
                f"{info['error']!r} (target {TARGET!r}) in "
                f"{info['iterations']} iterations, {tries} tries, phases "
                f"{info['phases']}, wall {wall:.3f} s")
            log(f"  trajectory {info['history']}")
            log(f"  iter_times {info['iter_times']}")
            log(f"  peak device memory {peak / 2**30:.3f} GiB; launches "
                f"{launches}")
            if not info["error"] <= TARGET:
                raise AssertionError(f"BA ({mode}) did not reach {TARGET}: "
                                     f"{info['error']}")
            outs.append((vals, info, launches, wall, peak, tries))
        (v1, i1, *_), (v2, i2, *_) = outs
        same = (i1["history"] == i2["history"]
                and torch.equal(v1["points"], v2["points"])
                and torch.equal(v1["cams"].pose.R, v2["cams"].pose.R))
        log(f"main path {mode}: two runs give the same bits: {same}")
        if not same:
            raise AssertionError(f"two runs of the {mode} main path differ")
        vals, info, launches, wall, peak, tries = outs[0]
        for name in PATHS[mode]:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"{mode} main path")
        runs[mode] = dict(vals=vals, info=info, launches=launches,
                          wall=[o[3] for o in outs], peak=peak, tries=tries)
        del outs, v1, v2
    vals = runs["float64"]["vals"]
    launches = {name: sum(r["launches"][name] for r in runs.values())
                for name in bk.KERNELS}

    # -- 5. kernels against their plain versions, and timed, at the Ladybug
    # shape (the float64 path's converged state; lam = 1 as in phase 3, so
    # conditioning cannot mask a fault; the kernels' work does not depend on
    # lam) ------------------------------------------------------------------
    big = Inputs(prob, 1.0, vals["cams"], vals["points"])
    check = check_kernels(big, bk, "ladybug")
    check_kernel1_repeats([big], bk, "ladybug")
    kernels = []
    for name, kern in bk.KERNELS.items():
        kfn = getattr(bk, kern.wrapper)
        pfn = getattr(bk, kern.wrapper + "_plain")
        args = big.args(name)
        ms = cuda_ms(lambda: kfn(*args), reps=20)
        plain_ms = cuda_ms(lambda: pfn(*args), reps=3, warmup=1)
        nbytes, flops = big.work(name)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP64_FLOPS * 1e3
        tries = {m: r["tries"] for m, r in runs.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gtsam_torch/csrc/{kern.source}.cu",
            "replaces": kern.replaces, "launches": launches[name],
            "max_abs_err": check[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "launches_by_path": {m: r["launches"][name]
                                 for m, r in runs.items()}})
        log(f"time {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms by {kernels[-1]['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); launches "
            f"{kernels[-1]['launches_by_path']} in runs of {tries} tries")
        if kern.source in ("bal_linearize", "ba_back_substitute",
                           "ba_schur_matvec"):
            for line in ptxas_lines(_build.BUILD_LOG.get(kern.source, ""),
                                    name.removesuffix("_f32") + "_kernel"
                                    if kern.source == "bal_linearize"
                                    else "_kernel"):
                log(f"  {name}: {line}")
    n = big.sys[torch.float64].S.shape[0]
    zero_ms = cuda_ms(big.sys[torch.float64].S.zero_, reps=5)
    # no atomics: two assemblies of one try's inputs (lam 1e-4) give the same
    # bits, S included, in both precisions; two matvecs too
    factors = {}
    for dt in (torch.float64, torch.float32):
        d = big.sys[dt]
        outs = []
        for _ in range(2):
            d.S.fill_(float("nan"))
            red = ba.assemble(big.plan, d.A_cam, d.A_pt, d.b, 1e-4, False,
                              d.S)
            outs.append((d.S.clone(),) + tuple(x for x in red
                                                if x is not None))
        same = all(torch.equal(x, y) for x, y in zip(*outs))
        log(f"assembly reproducible ({dt}): {same}")
        if not same:
            raise AssertionError(f"two assemblies ({dt}) of the same inputs "
                                 "differ")
        # the factorization at lam 1e-4 of the converged state, where a 4th
        # iteration would try; then the S of lam = 1 (which factorizes in
        # both precisions) for the timings below
        info_t = torch.empty((), dtype=torch.int32, device="cuda")
        torch.linalg.cholesky_ex(d.S.mT, out=(d.S.mT, info_t))
        log(f"factorization ({dt}) at lam 1e-4, converged state: info "
            f"{int(info_t)}")
        ba.assemble(big.plan, d.A_cam, d.A_pt, d.b, 1.0, False, d.S)
        factors[dt] = d.S.clone()
        if dt == torch.float32:
            mv = big.args("ba_schur_matvec")
            y1, y2 = bk.schur_matvec(*mv), bk.schur_matvec(*mv)
            if not torch.equal(y1, y2):
                raise AssertionError("two matvecs of the same inputs differ")
            log("schur_matvec reproducible: True")
        del outs, red
    # the factorization of one try, on the S that ba.assemble returned
    # (already equilibrated), in each precision; then the triangular-solve
    # pair of one preconditioner application on that factor
    chol_ms, trsv_ms = {}, {}
    rhs = torch.randn(n, dtype=torch.float64, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    for dt, S0 in factors.items():
        S = big.sys[dt].S
        chol_ms[dt] = []
        for _ in range(3):   # each factorization overwrites S: restore, time
            S.copy_(S0)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.linalg.cholesky_ex(S.mT, out=(S.mT, info_t))
            b.record()
            b.synchronize()
            chol_ms[dt].append(a.elapsed_time(b))
        if int(info_t) != 0:
            raise AssertionError(f"the {dt} factorization failed")
        r = rhs.to(dt)
        trsv_ms[dt] = cuda_ms(lambda: ba._cho_solve(S.mT, r), reps=5)
    del factors, S0, S
    chol_bound = max(n ** 3 / 3 / FP64_TC_FLOPS,
                     2 * n * n * 8 / HBM_BYTES_PER_S) * 1e3
    chol32_bound = max(n ** 3 / 3 / FP32_FLOPS,
                       2 * n * n * 4 / HBM_BYTES_PER_S) * 1e3
    proj = big.proj
    del big
    plan_s = []   # the plan as ba_optimize builds it: host rows, device cells
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                             prob.num_points).to("cuda")
        torch.cuda.synchronize()
        plan_s.append(time.time() - t0)
    f64, f32 = torch.float64, torch.float32
    log(json.dumps({"library": {
        "cholesky_ex": {"ms": chol_ms[f64], "n": n, "bound_ms": chol_bound,
                        "calls": runs["float64"]["tries"]},
        "cholesky_ex_f32": {"ms": chol_ms[f32], "n": n,
                            "bound_ms": chol32_bound,
                            "calls": runs["mixed"]["tries"]},
        "solve_triangular_pair": {"ms": trsv_ms[f64],
                                  "calls": runs["float64"]["tries"]},
        "solve_triangular_pair_f32": {
            "ms": trsv_ms[f32],
            "calls": runs["mixed"]["tries"] * (ba.REFINE_IMPLICIT + 1)},
        "S.zero_": {"ms": zero_ms, "bytes": n * n * 8}},
        "main_path": {m: {"wall_s": r["wall"], "plan_s": plan_s,
                          "iterations": r["info"]["iterations"],
                          "tries": r["tries"],
                          "phases": r["info"]["phases"],
                          "half_chi2": r["info"]["error"],
                          "peak_bytes": r["peak"]}
                      for m, r in runs.items()}}))

    # -- 6. where the time goes: one traced run of each main path ------------
    from torch.profiler import ProfilerActivity, profile
    for mode, kw in modes.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            ba.ba_optimize(prob, lm, target_error=TARGET, device="cuda", **kw)
            torch.cuda.synchronize()
            traced_ms = (time.time() - t0) * 1e3
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA")
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        log(json.dumps({"profile": {
            "path": mode, "wall_ms": traced_ms,
            "device_busy_ms": busy if rows else None,
            "idle_share": 1.0 - busy / traced_ms if rows else None,
            "by_kernel_ms": [[k[:80], ms, c] for k, ms, c in rows[:18]]}}))
        # the full-matrix passes around the factorization: elementwise mul
        # (the equilibration, fused into kernel 3 now), fill (S.zero_), the
        # float32 copy of the fallback phase, and tril
        log(json.dumps({"profile_passes": {"path": mode, "rows": [
            [k[:120], ms, c] for k, ms, c in rows
            if any(w in k.lower() for w in ("mul", "fill", "zero", "tril",
                                            "copy"))]}}))
    # the error wrapper alone, at the Ladybug shape: each call must be one
    # launch of its kernel and no other device work
    calls = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            bk.error(*proj)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    log(json.dumps({"profile_error_calls": {
        "calls": calls, "device_rows": [[k[:80], ms, c] for k, ms, c in rows],
        "device_ms_per_call": sum(r[1] for r in rows) / calls}}))
    if not (len(rows) == 1 and "bal_error_kernel" in rows[0][0]
            and rows[0][2] == calls):
        raise AssertionError("an error call is not one launch of its kernel "
                             f"alone: {rows}")

    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
