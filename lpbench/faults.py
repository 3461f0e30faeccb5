"""Faults planted in the program's timed path, to show that the check
catches them (``tests/test_lpbench_faults.py`` on the CPU, ``calibrate.py
--fault`` on the card at a cell's own size).

* ``step_noop``: every pivot step returns the tableau and basis it was
  given (K1's step in the dense loop; K2's and K3's, or their twins, in the
  batched loops), so no solve loop can advance;
* ``half_batch``: the batched solve solves the first half of its batch and
  hands its answers to the second half as well;
* ``alter_answer``: one answer is altered where it is produced (the
  largest variable of the first LP's ``x``, times 1.5, after the
  certifier in the batched entry and in the dense finalize).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib

import numpy as np

KINDS = ("step_noop", "half_batch", "alter_answer")


def _patch(stack, module, attr, make):
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, make(real))
    stack.callback(setattr, mod, attr, real)


def _noop_batched_flags(real, n_state):
    def step(T, basis, *args, **kw):
        state = [a.clone() for a in args[:n_state]]
        out = real(T.clone(), basis.clone(), *state, *args[n_state:], **kw)
        return (T, basis) + tuple(out[2:])
    return step


def _half(real):
    def run_batch(cb, config, *args, **kw):
        B = cb.T0.shape[0]
        h = max(B // 2, 1)
        sub = dataclasses.replace(cb, **{
            f.name: getattr(cb, f.name)[:h]
            for f in dataclasses.fields(cb)
            if getattr(getattr(cb, f.name), "shape", ())[:1] == (B,)})
        res = real(sub, config, *args, **kw)
        idx = np.arange(B) % h
        return dataclasses.replace(res, **{
            f.name: np.asarray(getattr(res, f.name))[idx]
            for f in dataclasses.fields(res)
            if np.ndim(getattr(res, f.name)) and
            np.shape(getattr(res, f.name))[0] == h})
    return run_batch


def _alter_x(x):
    x = np.array(x, np.float64)
    j = int(np.nanargmax(x))
    x[j] *= 1.5
    return x


def _alter_certified(real):
    def certify(*args, **kw):
        res = real(*args, **kw)
        res.x = np.array(res.x)
        res.x[0] = _alter_x(res.x[0])
        return res
    return certify


def _alter_finalize(real):
    def finalize(sf, lp, *args, **kw):
        certified, x_full, duals, reduced = real(sf, lp, *args, **kw)
        if x_full is not None:
            x_full = np.concatenate([_alter_x(x_full[:lp.n_vars]),
                                     x_full[lp.n_vars:]])
        return certified, x_full, duals, reduced
    return finalize


@contextlib.contextmanager
def planted(kind: str):
    """Plant fault ``kind`` in the program for the duration."""
    with contextlib.ExitStack() as stack:
        P = "simplex_tpu_torch."
        if kind == "step_noop":
            # K2 / K3 (and twins): clones take the step, the loop's own
            # state is handed back as it came.  The flags of the step are
            # kept, so the loop believes it advanced.
            for name in ("fused_pivot_step_", "fused_pivot_step_ref"):
                _patch(stack, P + "ops.batched", name,
                       lambda r: _noop_batched_flags(r, 0))
            for name in ("fused_pivot_step_bounded_",
                         "fused_pivot_step_bounded_ref"):
                _patch(stack, P + "ops.batched", name,
                       lambda r: _noop_batched_flags(r, 1))
            _patch(stack, P + "ops.tableau", "pivot_update",
                   lambda r: (lambda T, basis, *a, **k: (T, basis)))
        elif kind == "half_batch":
            _patch(stack, P + "models.batched", "_run_batch", _half)
        elif kind == "alter_answer":
            _patch(stack, P + "models.batched", "certify_uniform_result",
                   _alter_certified)
            _patch(stack, P + "models.dense", "_finalize_on_host",
                   _alter_finalize)
        else:
            raise ValueError(f"no fault named {kind!r}; one of {KINDS}")
        yield
