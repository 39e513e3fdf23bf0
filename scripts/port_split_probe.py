#!/usr/bin/env python3
"""Check and time kernel 7's front kernel split over several CTAs a front
(sn_front_factor's ctas, supernodal_kernels.front_ctas) on one card.

    python3 scripts/port_split_probe.py [--reps N] [--graphs a,b,...]

Builds csrc/sn_factor.cu and its delay-injected test build
(_build.TEST_BUILDS), printing the front kernel's ptxas lines.  Then, for
each graph of --graphs (default sphere,standin,sfm: the 50 x 50 sphere of
scripts/port_sphere_data.py at chordal initialization with force_width=32,
the w10000 stand-in of scripts/port_2d_data.py at LAGO's start, the
dubrovnik-16-22106-shaped graph-form BA of sfm/bal.py::to_graph with
order="amd"), on its plan's wide levels at lam 1 and 1e-4, damping off and
on: the split route against the one-CTA route, bit for bit, twice, and
twice in the delay-injected build (chip_smoke.check_front_split).  Then
each wide level's launch at the plan's CTAs a front and at one, by device
time (torch.profiler, mean of N launches), and their sums, and at the
plan's CTAs into contiguous buffers (L^-1 and At rows W*d and R*d apart,
not the even pitches of supernodal_kernels.front_buffers: even_pitch
replaced by the identity for the call).  Prints one JSON line with the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph(name):
    """(graph, values, the supernodal solver's keywords) of a graph."""
    import chip_smoke as cs
    if name == "sphere":
        graph, vals, _, _ = cs.sphere_graph(50, 50)
        return graph, vals, dict(force_width=32)
    if name == "standin":
        from port_update_probe import _standin
        graph, vals = _standin()
        return graph, vals, {}
    from gtsam_torch.sfm import bal, synthetic
    graph, vals = bal.to_graph(synthetic.make_bal_problem(*cs.SFM_SHAPE,
                                                          seed=0))
    return graph, vals, dict(order=cs.SFM_ORDER)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--graphs", default="sphere,standin,sfm")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_split_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    import chip_smoke as cs
    from gtsam_torch import _build
    from port_update_probe import _contiguous
    from gtsam_torch.linear import supernodal_kernels as K
    _build.build(("sn_factor", "sn_factor_race"))
    ptxas = {n: [line.strip() for line in out.splitlines()
                 if "registers" in line or "spill" in line]
             for n, out in _build.BUILD_LOG.items()}
    out = {}
    for name in a.graphs.split(","):
        graph, vals, kw = _graph(name)
        case = cs.PGCase(graph, vals, 1.0, False, **kw)
        shapes = cs.check_front_split(case, name)
        s = case.s
        wide = [lv for lv in s.dev.levels if lv.narrow is None]
        rows = []
        for (mk, _), lv in zip(case.calls("sn_front_factor", on_path=True),
                               wide):
            args = mk()[:-1]     # into new buffers
            rows.append({"S": lv.S, "Wd": lv.W * s.d, "Rd": lv.R * s.d,
                         "ctas": lv.ctas, "device_ms": cs.device_ms(
                             lambda: K.sn_front_factor(*args, ctas=lv.ctas),
                             reps=a.reps),
                         "one_cta_device_ms": cs.device_ms(
                             lambda: K.sn_front_factor(*args, ctas=1),
                             reps=a.reps),
                         "contiguous_device_ms": cs.device_ms(
                             lambda: _contiguous(K, lambda: K.sn_front_factor(
                                 *args, ctas=lv.ctas)), reps=a.reps)})
            cs.log(f"{name} level {json.dumps(rows[-1])}")
        out[name] = {"levels": rows, "checked": shapes, **{
            f"sum_{k}": sum(r[k] for r in rows)
            for k in ("device_ms", "one_cta_device_ms",
                      "contiguous_device_ms")}}
        del case
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"graphs": out, "ptxas": ptxas,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
