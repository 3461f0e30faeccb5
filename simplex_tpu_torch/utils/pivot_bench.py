"""The pivot-rate measurement: pivots/s at a (size+1)² tableau, held against
the card's measured streaming ceiling (port of ``bench.py::_hbm_peak``,
``_median_time``, ``bench_pivot_update`` with its batched sub-benches,
and ``_pallas_stream_gbps``, whose Pallas copy is kernel K4 here:
:func:`hbm_peak`, :func:`median_time`, :func:`bench_pivot_update`,
:func:`k4_stream_gbps`; :func:`chain_time` is bench.py's ``lax.scan``
harness; :func:`rep_times` gives each repetition's seconds).

The per-pivot rank-1 update moves two touches of the tableau (one read,
one write); so does one streaming pass ``T + 1e-7``.  The pivot rate's
``vs_baseline`` is its GB/s over the best in-place stream measured on the
same tableau, by torch's own ``add_`` and by K4.  Everything is timed with
CUDA events on a CUDA device (the host clock on the CPU, which only the
tests use) and reported as the median of ``reps`` chains with its spread
``(max - min) / median``.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.stream_kernel import EPS_ADD, stream_copy_
from ..ops.tableau import pivot_update

# Published device-memory rate (GB/s) of the cards the port is measured on
# (NVIDIA's data sheet: H100 SXM, 80 GB HBM3).  Only this card's figure;
# any other device reports None.
_HBM_PEAK_GBPS = {"H100 80GB HBM3": 3350.0}


def hbm_peak(device) -> Optional[float]:
    """The published memory rate of ``device`` in GB/s, or None (the CPU,
    or a card not in the table)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, gbps in _HBM_PEAK_GBPS.items():
        if key in name:
            return gbps
    return None


def median_time(fn: Callable[[], object], reps: int = 5, device="cuda",
                setup: Optional[Callable[[], object]] = None
                ) -> Tuple[float, float]:
    """Median seconds of ``reps`` calls of ``fn`` and their spread
    ``(max - min) / median``; ``setup``, where given, runs before each call
    and is not timed.

    On a CUDA device each call is bracketed by CUDA events and waited for;
    on the CPU the host clock times it.
    """
    return median_spread(rep_times(fn, reps, device, setup))


def median_spread(ts: Sequence[float]) -> Tuple[float, float]:
    """The median of ``ts`` and their spread ``(max - min) / median``."""
    med = statistics.median(ts)
    spread = (max(ts) - min(ts)) / med if med > 0 else 0.0
    return med, spread


def rep_times(fn: Callable[[], object], reps: int = 5, device="cuda",
              setup: Optional[Callable[[], object]] = None) -> List[float]:
    """The seconds of each of ``reps`` calls of ``fn``, timed as
    :func:`median_time` times them."""
    device = torch.device(device)
    ts = []
    for _ in range(reps):
        if setup is not None:
            setup()
        if device.type == "cuda":
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return ts


def device_name(device) -> str:
    """The card's name, or the device's own for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def pivot_problem(size: int, iters: int) -> Tuple[np.ndarray, np.ndarray]:
    """``bench.py::bench_pivot_update``'s inputs from the same seeds: the
    (size+1)² float32 tableau and ``iters`` pivot positions ``(r, s)`` in
    ``[0, size)``."""
    T = np.random.default_rng(0).normal(size=(size + 1, size + 1)) \
        .astype(np.float32)
    rs = np.random.default_rng(1).integers(0, size, size=(iters, 2)) \
        .astype(np.int64)
    return T, rs


def chain_time(step: Callable[[int], torch.Tensor], iters: int, reps: int,
               device, reset: Callable[[], object]) -> Tuple[float, float]:
    """Seconds a step of a chain and the chains' spread.

    A chain is ``step(0) .. step(iters - 1)`` and a sum of the last step's
    output, so nothing is read back inside it; one warm-up chain, then
    ``reps`` timed ones, each after ``reset`` (not timed).  The sums are
    read once, after the last chain.
    """
    sums = []

    def chain():
        for k in range(iters):
            out = step(k)
        sums.append(out.sum())

    reset()
    chain()                                  # warm-up
    med, spread = median_time(chain, reps, device, setup=reset)
    float(sums[-1])                          # the one host read
    return med / iters, spread


def _stream_gbps(T: torch.Tensor, copy, iters: int, reps: int,
                 inplace: bool) -> Tuple[float, float]:
    """GB/s (one read and one write an element) and spread of ``copy(x,
    out)`` chained over a copy of ``T``: into the same buffer, or from one
    buffer into another and back."""
    A = torch.empty_like(T)
    B = None if inplace else torch.empty_like(T)

    def step(k):
        if inplace:
            return copy(A, A)
        src, dst = (A, B) if k % 2 == 0 else (B, A)
        return copy(src, dst)

    dt, spread = chain_time(step, iters, reps, T.device,
                            reset=lambda: A.copy_(T))
    return 2.0 * T.numel() * T.element_size() / dt / 1e9, spread


def k4_stream_gbps(T: torch.Tensor, iters: int = 64, reps: int = 5,
                   inplace: bool = True) -> Tuple[float, float]:
    """The streaming ceiling by a hand-written kernel: K4 (``out = x +
    1e-7``, one read and one write an element) chained ``iters`` times
    over a copy of ``T``, in place (``out`` is ``x``, the access mode of
    the pivot loop) or between two buffers in turn.  Returns (GB/s,
    spread), the median of ``reps`` chains; it shares nothing with torch's
    own elementwise kernels.  On a CPU tensor the twin runs (tests only).
    """
    return _stream_gbps(T, lambda x, out: stream_copy_(x, out=out), iters,
                        reps, inplace)


def bench_pivot_update(size: int = 10240, iters: int = 64, reps: int = 5,
                       device="cuda", with_batched: bool = True) -> Dict:
    """Steady-state time per rank-1 pivot update on a (size+1)² tableau.

    A chain of ``iters`` pivots at varying positions (the port's
    ``ops/tableau.py::pivot_update``, so kernel K1 on a card) runs from the
    same start tableau ``reps`` times; the positions live on the device, so
    nothing is read back inside a chain, which ends on ``T.sum()`` (the
    counterpart of bench.py's jitted ``lax.scan``).  Four streaming
    ceilings are measured on the same tableau, each a chain of ``iters``
    passes ending on a sum: torch's in-place ``add_``, torch's out-of-place
    ``add(out=)`` between two buffers in turn, and K4 in both modes
    (:func:`k4_stream_gbps`).

    Returns bench.py's record (``metric``, ``value`` in pivots/s, ``unit``,
    ``vs_baseline``, ``detail`` with bench.py's keys, ``pallas_*`` renamed
    ``k4_*``; ``empirical_stream_GBps`` and ``xla_outofplace_GBps`` keep
    their names and hold torch's streams), plus ``tableau`` and ``basis``:
    the state after the last pivot chain, on the device.  The random
    pivots can drive the tableau to inf or NaN; nothing here checks it.

    ``with_batched``: also bench.py's four batched sub-benches
    (``utils/solve_bench.py``): the classic and the bounded 30x50 batch at
    B=1024 and B=16384, under bench.py's ``detail`` keys;
    ``batched_backend`` and the added ``bounded_backend`` name the kernel
    that ran (K2, K3).  A sub-bench that fails fails the whole
    measurement.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_pivot_update: no CUDA device")
    T_np, rs_np = pivot_problem(size, iters)
    T0 = torch.from_numpy(T_np).to(dev)
    basis0 = torch.arange(size, dtype=torch.int64, device=dev)
    rs = torch.from_numpy(rs_np).to(dev)
    T, basis = T0.clone(), basis0.clone()
    pivots = [(rs[i, 0], rs[i, 1]) for i in range(iters)]

    def reset():
        T.copy_(T0)
        basis.copy_(basis0)

    def pivot_step(k):
        pivot_update(T, basis, *pivots[k])
        return T

    dt, dt_spread = chain_time(pivot_step, iters, reps, dev, reset)

    def torch_add(x, out):
        return torch.add(x, EPS_ADD, out=out)

    stream_gbps, st_spread = _stream_gbps(T0, torch_add, iters, reps, True)
    pp_gbps, pp_spread = _stream_gbps(T0, torch_add, iters, reps, False)
    k4_gbps, k4_spread = k4_stream_gbps(T0, iters, reps, inplace=True)
    k4pp_gbps, k4pp_spread = k4_stream_gbps(T0, iters, reps, inplace=False)

    bytes_moved = 2.0 * (size + 1) * (size + 1) * 4  # read + write, f32
    gbps = bytes_moved / dt / 1e9
    ceiling = max(stream_gbps, k4_gbps)
    peak = hbm_peak(dev)
    detail = {
        "per_pivot_ms": dt * 1e3,
        "achieved_GBps": gbps,
        "hbm_peak_GBps": peak,
        "frac_of_hbm_peak": None if peak is None else gbps / peak,
        "empirical_stream_GBps": stream_gbps,
        "xla_outofplace_GBps": pp_gbps,
        "k4_stream_GBps": k4_gbps,
        "k4_outofplace_GBps": k4pp_gbps,
        "ceiling_GBps": ceiling,
        "n_reps": reps,
        "pivot_spread": dt_spread,
        "stream_spread": st_spread,
        "outofplace_spread": pp_spread,
        "k4_stream_spread": k4_spread,
        "k4_outofplace_spread": k4pp_spread,
        "device": device_name(dev),
    }
    if with_batched:
        from .solve_bench import bench_batched_solve, bench_bounded_batched

        bb = bench_batched_solve(reps=max(3, reps - 2), device=dev)
        vb = bench_bounded_batched(reps=max(3, reps - 2), device=dev)
        bb16 = bench_batched_solve(B=16384, reps=3, device=dev)
        vb16 = bench_bounded_batched(B=16384, reps=3, device=dev)
        detail.update({
            "batched_lps_per_sec": bb["value"],
            "batched_backend": bb["detail"]["backend"],
            "batched_n_optimal": bb["detail"]["n_optimal"],
            "batched_spread": bb["detail"]["spread"],
            "bounded_lps_per_sec": vb["value"],
            "bounded_backend": vb["detail"]["backend"],
            "bounded_n_optimal": vb["detail"]["n_optimal"],
            "bounded_spread": vb["detail"]["spread"],
            "batched_lps_per_sec_16k": bb16["value"],
            "batched_16k_spread": bb16["detail"]["spread"],
            "bounded_lps_per_sec_16k": vb16["value"],
            "bounded_16k_spread": vb16["detail"]["spread"],
        })
    return {
        "metric": f"pivots_per_sec_{size}x{size}_f32",
        "value": 1.0 / dt,
        "unit": "pivots/s/chip",
        "vs_baseline": gbps / ceiling,
        "detail": detail,
        "tableau": T,
        "basis": basis,
    }
