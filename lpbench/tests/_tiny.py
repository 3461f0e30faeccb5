"""A copy of the benchmark with tiny cells beside the real ones, for the
CPU tests: the same configurations, traffic and workloads at sizes a test
holds, found by name like any other."""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

from lpbench import registry

REPO = os.path.dirname(registry.ROOT)
# cell -> (the real cell it copies, its configuration, its traffic)
TINY = {"tiny.classic": ("batch30x50.classic", "tinybatch", "tiny_classic"),
        "tiny.bounded": ("batch30x50.bounded", "tinybatch", "tiny_bounded"),
        "tiny.dense": ("dense2048.solve", "tinydense", "tiny_dense")}


OUT_OF_MANIFEST = [
    ("batch30x50.bounded", "end_to_end", "lp_rate", "LPs/s", None),
    ("batch30x50.bounded", "per_layer", "certify_s.batch", "s", "lp_rate"),
    ("batch30x50.bounded", "per_layer", "run_s.batch", "s", "lp_rate"),
    ("batch30x50.bounded", "per_layer", "k3_roofline.bounded", "%",
     "lp_rate"),
    ("batch30x50.bounded", "per_layer", "device_idle.batch", "%", "lp_rate"),
    ("dense2048.solve", "end_to_end", "solve_s", "s", None),
    ("dense2048.solve", "per_layer", "loop_s.dense", "s", "solve_s"),
    ("dense2048.solve", "per_layer", "host_s.dense", "s", "solve_s"),
    ("dense2048.solve", "per_layer", "k1_roofline.dense", "%", "solve_s"),
    ("dense2048.solve", "per_layer", "device_idle.dense", "%", "solve_s")]


def _load(p):
    with open(p, encoding="utf-8") as f:
        return json.load(f)


def _dump(p, d):
    with open(p, "w", encoding="utf-8") as f:
        json.dump(d, f, indent=1)


def make(root, batch=16, dense=(24, 20), max_iters=None):
    """Copy ``lpbench`` and ``BENCHMARK.json`` under ``root`` and add the
    tiny cells.  Returns the copy's ``lpbench`` directory."""
    lp = os.path.join(root, "lpbench")
    shutil.copytree(registry.ROOT, lp,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _load(registry.MANIFEST)
    solver = {} if max_iters is None else {"max_iters": max_iters}
    for name, base, m, n in (("tinybatch", "batch30x50", None, None),
                             ("tinydense", "dense2048", *dense)):
        c = _load(os.path.join(lp, "configs", base + ".json"))
        c.update(name=name, solver=dict(c["solver"], **solver))
        if m:
            c.update(m=m, n=n)
        _dump(os.path.join(lp, "configs", name + ".json"), c)
    for name, base, upd in (("tiny_classic", "classic", {"batch": batch}),
                            ("tiny_bounded", "bounded", {"batch": batch}),
                            ("tiny_dense", "dense_le", {})):
        t = _load(os.path.join(lp, "traffic", base + ".json"))
        t.update(pool=2, **upd)
        _dump(os.path.join(lp, "traffic", name + ".json"), t)
    # Cells whose files stay but that are out of BENCHMARK.json (PERF.md,
    # Open questions): their tiny copies get their metrics here.
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for real, kind, name, unit, moves in OUT_OF_MANIFEST:
        if name not in names:
            entry = {"name": name, "unit": unit, "better": "lower",
                     "source": "host_clock", "workloads": []}
            if kind == "end_to_end":
                entry["bound"] = 0.25
            else:
                entry.update(layer=name, moves=moves)
            bench[kind].append(entry)
            names.add(name)
        m = next(m for m in bench[kind] if m["name"] == name)
        m.setdefault("workloads", []).append(real)
    for cell, (real, config, traffic) in TINY.items():
        shutil.copy(os.path.join(lp, "workloads", real + ".json"),
                    os.path.join(lp, "workloads", cell + ".json"))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a CPU test's copy of " + real})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return lp


def env():
    """The environment of a run from the copy: the port importable."""
    e = dict(os.environ)
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    return e


def last_json(stdout: str):
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    return json.loads(lines[-1]) if lines else None


def rng_lps(seed, B, m, n, bounded=False):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (B, m, n))
    b = rng.uniform(1.0, 5.0, (B, m))
    c = rng.uniform(0.1, 1.0, (B, n))
    ub = (np.where(rng.random((B, n)) < 0.6, rng.uniform(1, 3, (B, n)),
                   np.inf) if bounded else None)
    return c, A, b, ub
