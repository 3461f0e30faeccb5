"""What a traced run records: host spans from the benchmark's own wrappers
around the program's module-level functions, and the device's work from
one ``torch.profiler`` session.

CUPTI reports every pass of a WHILE body only in CUDA graphs instantiated
after the process's first profiler session, and the warm-up is where the
graphs are captured: so a session with one kernel in it runs before the
warm-up, and the session that is read covers the window's first calls
(``harness.TRACED_S``).  Only sums are kept: device seconds
by kernel name and the busy union inside the window, and a bounded
breakdown (kernels by name without template arguments); no timeline is
written.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import torch


class Recorder:
    """Host spans of the timed calls.  ``wrap`` puts a timing wrapper
    around ``module.attr``; while a call is open (:meth:`call`), each
    wrapped call adds its host seconds under its span name, and its
    ``note`` hook (``note(rec, args, kwargs, result)``) may add what it
    reads from the call's arguments and result."""

    def __init__(self):
        self.calls = []
        self._open = None
        self._undo = []

    def wrap(self, module: str, attr: str, span: str, note=None):
        mod = importlib.import_module(module)
        real = getattr(mod, attr)
        rec_fn = torch.profiler.record_function

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with rec_fn("lpbench." + span):
                out = real(*args, **kwargs)
            rec = self._open
            if rec is not None:
                rec["spans"].setdefault(span, []).append(
                    time.perf_counter() - t0)
                if note is not None:
                    note(rec, args, kwargs, out)
            return out

        setattr(mod, attr, wrapper)
        self._undo.append((mod, attr, real))

    @contextlib.contextmanager
    def call(self):
        rec = {"spans": {}, "notes": {}}
        self._open = rec
        try:
            yield rec
        finally:
            self._open = None
            self.calls.append(rec)

    def unwrap(self):
        for mod, attr, real in reversed(self._undo):
            setattr(mod, attr, real)
        self._undo.clear()


def start_profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def _short(name: str) -> str:
    """A kernel's name without its return type and template arguments."""
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[:min(cut)] if cut else name).strip()


def read_profile(prof, window_span: str = "lpbench.window", top: int = 10):
    """Device work inside the window span: ``kernels`` (device seconds by
    name), ``busy_s`` (the union of device intervals), ``window_s``, and
    the result line's ``breakdown`` (the ``top`` device operations by
    time, the ``top`` longest idle gaps named by the innermost host span
    they fall in)."""
    events = prof.events()
    cpu_t = torch.autograd.DeviceType.CPU
    cpu = [e for e in events if e.device_type == cpu_t]
    win = [e for e in cpu if e.name == window_span]
    if win:
        w0, w1 = win[0].time_range.start, win[0].time_range.end
    elif events:
        w0 = min(e.time_range.start for e in events)
        w1 = max(e.time_range.end for e in events)
    else:
        return None
    host_names = {e.name for e in cpu}
    kernels, spans = {}, []
    for e in events:
        if e.device_type == cpu_t or e.name in host_names:
            continue      # host ops, and annotations mirrored on the device
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        kernels[e.name] = kernels.get(e.name, 0.0) + (t - s) * 1e-6
        spans.append((s, t))
    busy_us, merged = _union(spans)
    gaps, prev = [], w0
    for s, t in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, t)
    gaps.sort(reverse=True)
    inner = [e for e in cpu if e.time_range.end > w0
             and e.time_range.start < w1 and e.name != window_span]
    idle = []
    for length, s, t in gaps[:top]:
        mid = 0.5 * (s + t)
        covering = [e for e in inner
                    if e.time_range.start <= mid <= e.time_range.end]
        own = [e for e in covering if e.name.startswith("lpbench.")]
        name = "host outside the timed calls"
        if covering:
            best = min(covering, key=lambda e: e.time_range.end
                       - e.time_range.start)
            name = best.name
            if own and best not in own:
                top_own = min(own, key=lambda e: e.time_range.end
                              - e.time_range.start)
                name = f"{top_own.name} > {best.name}"
        idle.append([name, length * 1e-6])
    by_short = {}
    for name, sec in kernels.items():
        short = _short(name)
        by_short[short] = by_short.get(short, 0.0) + sec
    ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:top]
    return {"kernels": kernels, "busy_s": busy_us * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": idle}}
