#!/usr/bin/env python3
"""What one netlib-scale request costs the web app.

    python3 tools/web_report_size.py [--seed 2] [--device cuda|cpu]

Uploads ``chip_smoke.web_netlib_mps(seed)`` (a netlib-scale MPS file with
bounds, as the web's ``/load`` takes it) to the port's web app through its
in-process client, then posts ``/solve``, and prints one JSON line: the
LP's shape, the bytes of the session cookie that carries the problem, the
seconds of ``/load`` and of ``/solve``, of which the solve itself (the
report's solve record), the solution page's bytes, the number of tableau
tables the saved report holds, and that file's bytes.  The
rest of ``/solve`` is the host's work on the report.  Writes its files to a
temporary directory, removed at the end.  Imports nothing of JAX.
"""
import argparse
import glob
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="web_report_") as out_dir:
        os.environ["SIMPLEX_TPU_OUTPUT_DIR"] = out_dir
        print(json.dumps(measure(args.seed, args.device, out_dir)))
    return 0


def measure(seed, device, out_dir):
    """One ``/load`` and ``/solve`` of the netlib-scale file of ``seed``."""
    from chip_smoke import web_netlib_mps
    from simplex_tpu_torch.config import SolverConfig
    from simplex_tpu_torch.services.storage import StorageService
    from simplex_tpu_torch.utils import mps, profiling
    from simplex_tpu_torch.web.app import init_app
    from simplex_tpu_torch.web.microweb import SignedSession, TestClient

    text = web_netlib_mps(mps, seed)
    lp = mps.parse_mps(text)
    app = init_app(storage=StorageService(out_dir),
                   solver_config=SolverConfig(device=device))
    client = TestClient(app)
    t0 = time.perf_counter()
    r1 = client.post("/load", files={"problem_file": ("netlib.mps", text)})
    t1 = time.perf_counter()
    cookie = len(client._cookies.get(SignedSession.COOKIE, ""))
    r2 = client.post("/solve")
    t2 = time.perf_counter()
    rec = profiling.DEFAULT_METRICS.records[-1]
    solution = max(glob.glob(os.path.join(out_dir, "solucion_*.json")),
                   key=os.path.getmtime)
    with open(solution, encoding="utf-8") as f:
        tables = len(json.load(f)["tablas_intermedias"])
    return {
        "seed": seed, "device": device, "shape": list(lp.A.shape),
        "load_status": r1.status_code, "solve_status": r2.status_code,
        "session_cookie_bytes": cookie, "load_s": t1 - t0,
        "solve_request_s": t2 - t1, "solve_lp_s": rec.wall_s,
        "pivots": rec.iterations, "page_bytes": len(r2.data),
        "tables": tables,
        "solution_file_bytes": os.path.getsize(solution)}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
