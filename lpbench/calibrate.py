"""The readings the limits of a cell's check are set from, in one process:

    python3 -m lpbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault step_noop|half_batch|alter_answer]

For each of ``--seeds``: the program answers every input of the cell's
pool once, at the cell's own size, after one warm call, and the numbers of
the check are read against the reference (the lower readings; with
``--fault``, the program with that fault planted).  For each of
``--control-seeds``: the control, which is the reference itself computed
in TF32 (float32 with TF32-rounded factors; the solver states float32 with
TF32 off), takes the program's place and is read the same way (the upper
readings).  One JSON line a seed.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from . import faults, harness, registry
from .reference import simplex
from .traffic import generate


def control_answers(item, device):
    out = simplex.solve(item["c"], item["A"], item["b"], item["ub"],
                        precision="tf32", device=device)
    return {"status": out["status"], "x": out["x"], "z": out["z"],
            "y": out["y"], "rc": out["rc"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m lpbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", choices=faults.KINDS)
    p.add_argument("--pool", type=int, default=None,
                   help="inputs a seed (default: the traffic's pool)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    cell = registry.cell(args.workload, registry.manifest())
    traffic = dict(cell["traffic"], **{k: cell["config"][k]
                                       for k in ("m", "n", "dtype")})
    entry_mod = registry.module("entries", cell["workload"]["entry"])
    has_y = "dual_viol" in cell["workload"]["limits"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    entry = entry_mod.make(args.device, cell) if seeds else None
    warmed = False
    for kind, seed_list in (("program", seeds), ("control", ctl)):
        for seed in seed_list:
            t0 = time.perf_counter()
            pool = generate.pool(traffic, seed, args.pool)
            refs = harness.references(pool, args.device)
            ctx = (faults.planted(args.fault) if args.fault and
                   kind == "program" else contextlib.nullcontext())
            calls = []
            with ctx:
                for k, item in enumerate(pool):
                    if kind == "program":
                        if not warmed:
                            entry.call(item)
                            warmed = True
                        ans = entry.call(item)
                    else:
                        ans = control_answers(item, args.device)
                        if not has_y:
                            ans.pop("y"), ans.pop("rc")
                    calls.append((k, ans))
            r = harness.readings_of(calls, pool, refs)
            print(json.dumps({"workload": args.workload, "kind": kind,
                              "fault": args.fault if kind == "program"
                              else None, "seed": seed, "readings": r,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
