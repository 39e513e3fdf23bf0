#!/usr/bin/env python3
"""Time the BA plan of gtsam_torch at the Ladybug-1723 shape on one card.

    python3 scripts/port_plan_time.py [--root DIR] [--reps N]

Imports gtsam_torch from DIR (default: this checkout), makes
make_bal_problem(1723, 150000, 4, seed=0) and times
BAStructure.build(...).to("cuda") as ba_optimize runs it: the host part and
the device part, ending in torch.cuda.synchronize().  One untimed call
first warms the card up.  Prints one JSON line with the card's name, the
root and the seconds of each call.  Give two roots in turns (A, B, B, A) in
one session to compare two versions on one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_plan_time: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.root))
    from gtsam_torch.sfm import ba, synthetic
    prob = synthetic.make_bal_problem(1723, 150000, 4, seed=0)

    def plan():
        ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                             prob.num_points).to("cuda")
        torch.cuda.synchronize()

    plan()
    secs = []
    for _ in range(a.reps):
        t0 = time.time()
        plan()
        secs.append(time.time() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"plan_s": secs, "root": a.root,
                      "card": smi[0] if smi else None,
                      "module": ba.__file__}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
