"""The port's batched stream (``models/batched.py::solve_arrays_stream``).

Each streamed batch must EQUAL the port's own ``solve_arrays`` on that
batch (the same assembly, kernels and certifier: status, pivots, x and z
bit for bit, the certificate), and agree with the JAX stream at the solve
level (status equal, z within 1e-6·(1+|z|)), with certification on and
off, for classic, bounded and mixed streams.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import CPU, MIXED_OPS, random_batch, random_ub, z_close

import simplex_tpu.models.batched as jb
from simplex_tpu.config import SolverConfig as JConfig

import simplex_tpu_torch.models.batched as tb
from simplex_tpu_torch import SolverConfig
from simplex_tpu_torch.runtime import staging

TCFG = SolverConfig(device=CPU)


def _stream(kinds, B=24, seed=0):
    """Batches of ``random_batch`` shape 9x13: ``"le"`` all ``<=``,
    ``"mixed"`` the mixed operators (phase 1), ``"ub"`` all ``<=`` with 60 %
    of the variables bounded (a fifth element)."""
    out = []
    for k, kind in enumerate(kinds):
        ops = MIXED_OPS if kind == "mixed" else None
        c, A, b, ops = random_batch(seed + k, B=B, ops=ops)
        if kind == "ub":
            out.append((c, A, b, ops, random_ub(seed + k, (B, 13), 0.5, 2.0,
                                                frac=0.6)))
        else:
            out.append((c, A, b, ops))
    return out


def _equal(a, b):
    for f in ("status", "pivots", "x", "z", "fun", "basis", "at_upper",
              "certified", "escalated"):
        va, vb = getattr(a, f), getattr(b, f)
        if va is None or vb is None:
            assert va is None and vb is None, f
        else:
            np.testing.assert_array_equal(va, vb, err_msg=f)
    assert a.nit == b.nit


@pytest.mark.parametrize("certify", [True, False])
@pytest.mark.parametrize("kinds", [("le", "le", "le"), ("ub", "ub"),
                                   ("le", "ub", "mixed", "ub")])
def test_stream_equals_solve_arrays(kinds, certify):
    cfg = dataclasses.replace(TCFG, certify=certify)
    batches = _stream(kinds)
    streamed = list(tb.solve_arrays_stream(iter(batches), cfg,
                                           maximize=True))
    assert len(streamed) == len(batches)
    solver = tb.BatchedSimplexSolver(cfg)
    for batch, res in zip(batches, streamed):
        ref = solver.solve_arrays(*batch[:4], maximize=True,
                                  ub=batch[4] if len(batch) > 4 else None)
        _equal(ref, res)
        assert (res.at_upper is not None) == (len(batch) > 4)
        assert (res.certified is not None) == certify
        if certify:
            assert res.certified.all()


@pytest.mark.parametrize("certify", [True, False])
def test_stream_agrees_with_jax(certify):
    batches = _stream(("le", "ub", "mixed"))
    jx = list(jb.solve_arrays_stream(iter(batches),
                                     JConfig(certify=certify)))
    pt = list(tb.solve_arrays_stream(
        iter(batches), dataclasses.replace(TCFG, certify=certify)))
    for a, b in zip(jx, pt):
        np.testing.assert_array_equal(a.status, b.status)
        for za, zb in zip(a.z[a.success], b.z[b.success]):
            assert z_close(za, zb)
        if certify:
            np.testing.assert_array_equal(a.certified, b.certified)


def test_stream_takes_a_maximize_vector_and_an_empty_iterable():
    batches = _stream(("le", "le"), B=8)
    maxi = np.arange(8) % 2 == 0
    got = list(tb.solve_arrays_stream(iter(batches), TCFG, maximize=maxi))
    ref = tb.BatchedSimplexSolver(TCFG).solve_arrays(*batches[1],
                                                     maximize=maxi)
    _equal(ref, got[1])
    assert list(tb.solve_arrays_stream(iter([]), TCFG)) == []


def test_staging_on_the_cpu_pins_nothing_and_waits_for_nothing():
    """``pin_memory`` needs CUDA: on the CPU the arrays become tensors at
    once, in their own dtypes, with no pinned buffer and no event."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    st = staging.stage([a, a > 2], torch.device("cpu"))
    assert not st._pinned and st._event is None
    t, mask = st.tensors()
    assert t.device.type == "cpu" and t.dtype == torch.float32
    assert torch.equal(t, torch.from_numpy(a)) and mask.dtype == torch.bool


def test_stream_rejects_non_finite_data_before_solving():
    c, A, b, ops = _stream(("le",), B=4)[0]
    A = A.copy()
    A[1, 2, 3] = np.nan
    with pytest.raises(ValueError, match="finitos"):
        next(tb.solve_arrays_stream(iter([(c, A, b, ops)]), TCFG))
