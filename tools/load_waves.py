#!/usr/bin/env python3
"""Phase 22's waves of concurrent web users, on one tree of the port.

    python3 tools/load_waves.py [--root DIR] [--waves 2]

Serves ``chip_smoke.py``'s phase-22 waves (``LOAD_USERS`` users at once:
the anchors' forms through ``/new`` and two netlib-scale MPS uploads
through ``/load``, then ``/solve``, on ``TestClient``s of one
``init_app()``, the report's history capped at ``LOAD_HISTORY``) from an
empty graph cache, with the ``simplex_tpu_torch`` package of the tree at
DIR (default: this checkout).  Two trees, such as a parent and a change
unpacked with ``git archive``, so serve the same traffic; run them in
turns on one card (parent, change, change, parent) to compare them.
Prints one JSON line: the tree, the card (``nvidia-smi``'s name and power
limit), and for each wave its wall seconds, latencies by kind, captures
and replays a request and the cache's entries.  Exits 1 where a request
got no answer.  Needs a GPU; imports nothing of JAX.  Opens no
``torch.profiler`` session: a tree whose captures may run on several
threads at once hangs after one (ROADMAP.md Queue 3).
"""
import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="the tree whose simplex_tpu_torch serves")
    ap.add_argument("--waves", type=int, default=2)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import simplex_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the waves run on a GPU")
    if not simplex_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"simplex_tpu_torch came from "
                         f"{simplex_tpu_torch.__file__}, not {root}")
    # The waves and their helpers are this checkout's, whatever the tree.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    with tempfile.TemporaryDirectory(prefix="load_waves_") as out_dir:
        os.environ["SIMPLEX_TPU_OUTPUT_DIR"] = out_dir
        os.environ["SIMPLEX_TPU_MAX_HISTORY"] = str(cs.LOAD_HISTORY)
        rec = serve(cs, root, args.waves)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


def serve(cs, root, n_waves):
    """The waves from an empty cache; one record of each."""
    from simplex_tpu_torch.runtime import graphs, kernels
    from simplex_tpu_torch.utils import mps
    from simplex_tpu_torch.web.app import init_app
    from simplex_tpu_torch.web.microweb import TestClient

    kernels.build()
    kernels.library()
    problems, _ = cs.load_problems(mps)
    waves = cs.load_mixes(problems)["waves"]
    app = init_app()
    graphs.clear()
    out = []
    for wave in range(1, n_waves + 1):
        caps, reps, t0 = graphs.CAPTURES, graphs.REPLAYS, time.perf_counter()
        res = cs._users(lambda kind: cs._web_inproc(app, TestClient, kind),
                        waves)
        n = len(res)
        out.append({
            "wave": wave, "wall_s": time.perf_counter() - t0,
            "latency_s": cs._latencies(res),
            "captures_per_request": (graphs.CAPTURES - caps) / n,
            "replays_per_request": (graphs.REPLAYS - reps) / n,
            "cache_entries": len(graphs.stats()),
            "failed": [[kind[:2], o["error"]] for kind, (o, _) in res
                       if o["answer"] is None]})
    return {"root": root, "gpu": cs._gpu_line(), "users": len(waves),
            "waves": out, "ok": not any(w["failed"] for w in out)}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
