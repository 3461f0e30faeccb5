"""Finds every part of a cell by its name: ``<kind>/<name>.json`` for data,
``<kind>/<name>.py`` for code, so that a configuration, a traffic mix, a
workload or a metric is added by adding its file."""
from __future__ import annotations

import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.abspath(__file__))
MANIFEST = os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


def path(kind: str, name: str, ext: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    p = os.path.join(ROOT, kind, name + ext)
    if not os.path.isfile(p):
        raise FileNotFoundError(f"no {kind} named {name!r} ({p})")
    return p


def data(kind: str, name: str) -> dict:
    with open(path(kind, name, ".json"), encoding="utf-8") as f:
        return json.load(f)


def module(kind: str, name: str):
    """The module in ``<kind>/<name>.py`` (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"lpbench.{kind}.{name.replace('.', '_').replace('-', '_')}",
        path(kind, name, ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(p: str = MANIFEST) -> dict:
    with open(p, encoding="utf-8") as f:
        return json.load(f)


def cell(name: str, bench: dict) -> dict:
    """A cell of the manifest with everything its name leads to: its
    manifest entry, its workload file, configuration and traffic, and the
    metrics it reports (``end_to_end`` and ``per_layer`` entries)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    # A metric without a ``workloads`` list: every cell reports an
    # end-to-end one, and a per-layer one goes with the metric it moves.
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return {"entry": entry,
            "workload": data("workloads", name),
            "config": data("configs", entry["config"]),
            "traffic": data("traffic", entry["traffic"]),
            "end_to_end": e2e,
            "per_layer": per_layer}
