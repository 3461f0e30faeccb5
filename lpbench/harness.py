"""The run of one cell in one process: set-up, the window, the metrics, the
check against the reference and the result line.

An entry (``entries/<name>.py``) gives ``make(device, cell)``, an object
with ``spans`` (the program functions a traced run wraps: ``(module,
attr, span, note)``), ``call(item)`` (one call of the program on one input,
returning its answers) and ``release()`` (drop the program's state), and
``LABEL``, what its calls are for the metrics.  An entry that needs more
than one process gives its own ``run``.
"""
from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from . import registry, run as run_mod
from .reference import compare, simplex
from .traffic import generate

# A traced run's profiler reads the window's calls until this many seconds
# have passed (the call that crosses it included): longer, and the host
# events of tens of solves take minutes and gigabytes to read back.
TRACED_S = 10.0


def device_block(args, chips, peak):
    if args.device == "cuda":
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": int(peak)}


def metric_values(cell, record, trace: bool):
    """The cell's metrics read from ``record``: its end-to-end ones in an
    untraced run, its per-layer ones in a traced run.  A reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = registry.module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def references(pool, device):
    """The reference's answer for every input of the pool, in float64."""
    return [simplex.solve(it["c"], it["A"], it["b"], it["ub"],
                          device=device) for it in pool]


def readings_of(calls, pool, refs):
    per = []
    for k, ans in calls:
        r = compare.primal_readings(pool[k], refs[k], ans)
        r["_n"] = len(ans["status"])
        per.append(r)
    return compare.merge(per)


def emit(result: dict, checks: dict) -> None:
    """The last lines of standard error (each number beside its limit) and
    the result line, last on standard output."""
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {k: [c["value"], c["limit"]]
                        for k, c in checks.items()}
    print(json.dumps(result), flush=True)


def run(args, cell, t_proc, entry_mod) -> int:
    from . import trace as trace_mod

    dev = args.device
    cuda = dev == "cuda"
    traffic = dict(cell["traffic"], **{k: cell["config"][k]
                                       for k in ("m", "n", "dtype")})
    workload = cell["workload"]
    if args.trace:
        # CUPTI reports every pass of a WHILE body only in graphs
        # instantiated after the process's first profiler session, so one
        # session with one kernel in it comes before the warm-up captures
        # them; the session that reads the window opens after the warm-up.
        first = trace_mod.start_profiler(cuda)
        if cuda:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        first.__exit__(None, None, None)
    rec = trace_mod.Recorder()
    t_import = time.time()
    pool = generate.pool(traffic, args.seed)
    t_pool = time.time()
    entry = entry_mod.make(dev, cell)
    if args.trace:
        for module, attr, span, note in entry.spans:
            rec.wrap(module, attr, span, note)
    for k in range(workload.get("warm", 1)):
        entry.call(pool[k % len(pool)])
    if cuda:
        torch.cuda.synchronize()
    prof = trace_mod.start_profiler(cuda) if args.trace else None
    setup_s = time.time() - t_proc
    print(f"[setup] {setup_s!r} s: to the harness {t_import - t_proc!r}, "
          f"inputs {t_pool - t_import!r}, warm calls "
          f"{time.time() - t_pool!r}", file=sys.stderr, flush=True)

    from simplex_tpu_torch.runtime import graphs

    captures = graphs.CAPTURES
    calls = []
    span = torch.profiler.record_function("lpbench.window")
    span.__enter__()
    prof_read = None

    def stop_profiler():
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        return trace_mod.read_profile(prof)

    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < args.seconds:
        idx = k % len(pool)
        with rec.call() as crec:
            s = time.perf_counter()
            with torch.profiler.record_function("lpbench.call"):
                ans = entry.call(pool[idx])
            crec["spans"]["call"] = [time.perf_counter() - s]
            crec["traced"] = prof is not None
        calls.append((idx, ans))
        k += 1
        if prof is not None and time.perf_counter() - t0 >= TRACED_S:
            prof_read, prof = stop_profiler(), None
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof_read, prof = stop_profiler(), None
    else:
        span.__exit__(None, None, None)
    # Every graph of the cell is captured in set-up; one captured in the
    # window would put a capture's cost into the measured time.
    per = sorted(c["spans"]["call"][0] for c in rec.calls)
    print(f"[window] {window_s!r} s, {len(calls)} calls (seconds: min "
          f"{per[0]!r}, median {per[len(per) // 2]!r}, max {per[-1]!r}), "
          f"{graphs.CAPTURES - captures} graph captures", file=sys.stderr,
          flush=True)
    rec.unwrap()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    entry.release()
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    record = {"label": entry_mod.LABEL, "window_s": window_s,
              "setup_s": setup_s, "calls": rec.calls,
              "answers": [a for _, a in calls], "profile": prof_read}
    metrics = metric_values(cell, record, bool(args.trace))

    refs = references(pool, dev)
    readings = readings_of(calls, pool, refs)
    correct, checks = compare.judge(readings, workload["limits"])
    bad = run_mod.forbidden_modules()
    if bad:
        print(f"[lpbench] loaded by this process: {', '.join(bad)}",
              file=sys.stderr, flush=True)
        return 3
    attempted = sum(len(a["status"]) for _, a in calls)
    failed = sum(int(np.sum(failed_mask(a))) for _, a in calls)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": device_block(args, cell["entry"]["chips"], peak)}
    if prof_read is not None:
        result["device"]["busy_s"] = prof_read["busy_s"]
        result["device"]["window_s"] = prof_read["window_s"]
        result["breakdown"] = prof_read["breakdown"]
    emit(result, checks)
    return 0


def failed_mask(ans):
    """LPs a call did not answer with a certified optimum."""
    bad = np.asarray(ans["status"]) != 0
    if "certified" in ans:
        bad |= ~np.asarray(ans["certified"], bool)
    return bad
