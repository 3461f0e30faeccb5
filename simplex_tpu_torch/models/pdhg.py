"""Batched first-order LP solver, PDHG / PDLP-style (port of
``simplex_tpu/models/pdhg.py``).

The same formulation and loop as the JAX module: after ``>=`` rows are
negated to ``<=``, ``min c'x  s.t.  A x (<=|=) b,  x >= 0`` (or
``0 <= x <= ub``) is solved per instance by restarted, averaged
Chambolle-Pock iterations with Ruiz preconditioning, a power-iteration
step size and the PDLP primal weight; convergence is tested in the
original space every ``check_every`` iterations.  Every iteration is two
batched matrix-vector products and elementwise work: plain torch, as it is
plain JAX there (no Pallas kernel).

Differences from the JAX module, all deliberate:

* The ``lax.while_loop`` becomes a host loop over chunks that end on a
  check iteration: the device runs ``check_every`` iterations (41 in the
  first chunk) without a host read, one CUDA graph on the card
  (``runtime/graphs.py``), and the host reads ``all(done)`` once a chunk
  (counted in ``STATE_READS``).  A check runs where the reference
  runs it, after the update of iteration ``k`` when ``k > 0`` and
  ``k % check_every == 0``, and the loop stops at ``k == max_iters`` even
  inside a chunk, so the iteration count is the reference's.
* The power iteration's start vector comes from a ``torch.Generator``
  seeded 0 (:func:`_power_iter_start`): torch cannot draw
  ``jax.random.normal(PRNGKey(0))``'s numbers.
* :class:`PdhgSolver` and :func:`solve_arrays_stream` take ``device``
  ("cuda" by default, raising without a GPU); the stream stages batch k+1
  (pinned buffers, a side stream) before batch k's loop starts
  (``runtime/staging.py``).
* Float32 matrix products run in full float32 (TF32 off on CUDA).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import resolve_dtype, torch_device
from ..core.problem import OP_EQ, OP_GE
from ..runtime import counters, graphs, staging

# Host reads of the loop state since the counter was last reset to 0.
STATE_READS = 0


@dataclasses.dataclass
class PdhgResult:
    x: np.ndarray           # (B, n)
    y: np.ndarray           # (B, m) duals
    objective: np.ndarray   # (B,) c'x in the USER sense
    primal_residual: np.ndarray
    dual_residual: np.ndarray
    gap: np.ndarray
    converged: np.ndarray   # (B,) bool
    iters: int
    solve_time: float = 0.0
    # Filled by solve_arrays_stream(crossover=...): instance index →
    # SimplexResult with the exact vertex recovered by PDHG→simplex
    # crossover (models/crossover.py).
    exact: Optional[dict] = None


def _mv(A, v):
    """``einsum("bmn,bn->bm", A, v)``."""
    return torch.bmm(A, v[:, :, None])[:, :, 0]


def _mtv(A, w):
    """``einsum("bmn,bm->bn", A, w)``."""
    return torch.bmm(w[:, None, :], A)[:, 0, :]


def _power_iter_start(B: int, n: int, dtype, device) -> torch.Tensor:
    """The power iteration's start vector: standard normal (B, n) from a
    generator seeded 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((B, n), generator=gen, dtype=dtype, device=device)


def _power_iter_sigma_max(A, iters: int = 30):
    """Largest singular value per instance via power iteration on A'A; the
    Rayleigh-quotient estimate ``||A v|| / ||v||`` on the normalized last
    iterate is the returned value."""
    B, m, n = A.shape
    v = _power_iter_start(B, n, A.dtype, A.device)
    for _ in range(iters):
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-30)
        v = _mtv(A, _mv(A, v))
    v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-30)
    return torch.linalg.vector_norm(_mv(A, v), dim=1)


def _ruiz_equilibrate(A, iters: int = 8):
    """Batched Ruiz scaling: returns (A_scaled, d_row, d_col) with
    ``A_scaled = diag(d_row) A diag(d_col)`` and near-unit row/col
    inf-norms."""
    B, m, n = A.shape
    d_r = torch.ones((B, m), dtype=A.dtype, device=A.device)
    d_c = torch.ones((B, n), dtype=A.dtype, device=A.device)
    As = A
    for _ in range(iters):
        rn = torch.sqrt(torch.clamp_min(torch.amax(torch.abs(As), dim=2),
                                        1e-12))
        As = As / rn[:, :, None]
        d_r = d_r / rn
        cn = torch.sqrt(torch.clamp_min(torch.amax(torch.abs(As), dim=1),
                                        1e-12))
        As = As / cn[:, None, :]
        d_c = d_c / cn
    return As, d_r, d_c


def _residuals(cs, bounded: bool, x_s, y_s):
    """KKT errors in the ORIGINAL space (x = d_c*x_s, y = d_r*y_s)."""
    A, b, c = cs["A"], cs["b"], cs["c"]
    x = x_s * cs["d_c"]
    y = y_s * cs["d_r"]
    r_p = _mv(A, x) - b
    viol = torch.where(cs["is_eq"], torch.abs(r_p),
                       torch.clamp_min(r_p, 0.0))
    primal = torch.amax(viol, dim=1)
    g = c + _mtv(A, y)
    if bounded:
        # Dual feasibility per bound status; the gap with the finite-ub
        # multiplier terms.
        ub, ub_fin, ub_or_0 = cs["ub"], cs["ub_fin"], cs["ub_or_0"]
        xs = 1e-6 * (1.0 + ub_or_0)
        at_lo = x <= xs
        at_hi = ub_fin & (x >= ub - xs)
        dviol = torch.where(at_lo, torch.clamp_min(-g, 0.0),
                            torch.where(at_hi, torch.clamp_min(g, 0.0),
                                        torch.abs(g)))
        dual = torch.amax(dviol, dim=1)
        lam_u = torch.where(ub_fin, torch.clamp_min(-g, 0.0), 0.0)
        gap = torch.abs((c * x).sum(1) + (b * y).sum(1)
                        + (ub_or_0 * lam_u).sum(1))
    else:
        dual = torch.amax(torch.clamp_min(-g, 0.0), dim=1)
        gap = torch.abs((c * x).sum(1) + (b * y).sum(1))
    return primal, dual, gap


def _kkt(cs, bounded: bool, x_s, y_s):
    primal, dual, gap = _residuals(cs, bounded, x_s, y_s)
    return torch.maximum(torch.maximum(primal, dual), 0.1 * gap)


def _pdhg_chunk(st, cs, static, n_iters: int, check_last: bool):
    """``n_iters`` iterations of :func:`_pdhg_solve`'s loop, and the
    restart / convergence check after the last one when ``check_last``:
    the chunk body that ``runtime/graphs.py`` runs eagerly or replays as
    one CUDA graph.  Returns the new state."""
    tol, bounded = static
    dt = cs["A_s"].dtype
    A_s, c_s, b_s = cs["A_s"], cs["c_s"], cs["b_s"]
    tau, sigma, is_eq = cs["tau"], cs["sigma"], cs["is_eq"]
    x, y, xsum, ysum = st["x"], st["y"], st["xsum"], st["ysum"]
    navg, err_last, done = st["navg"], st["err_last"], st["done"]
    for _ in range(n_iters):
        grad_x = c_s + _mtv(A_s, y)
        if bounded:
            x_new = torch.minimum(torch.clamp_min(x - tau * grad_x, 0.0),
                                  cs["hi_s"])
        else:
            x_new = torch.clamp_min(x - tau * grad_x, 0.0)
        x_bar = 2.0 * x_new - x
        y_new = y + sigma * (_mv(A_s, x_bar) - b_s)
        y_new = torch.where(is_eq, y_new, torch.clamp_min(y_new, 0.0))
        # Freeze converged instances.
        live = (~done)[:, None]
        x = torch.where(live, x_new, x)
        y = torch.where(live, y_new, y)
        xsum = xsum + torch.where(live, x, 0.0)
        ysum = ysum + torch.where(live, y, 0.0)
        navg = navg + (~done).to(dt)
    if check_last:
        nac = torch.clamp_min(navg, 1.0)[:, None]
        x_avg = xsum / nac
        y_avg = ysum / nac
        err_cur = _kkt(cs, bounded, x, y)
        err_avg = _kkt(cs, bounded, x_avg, y_avg)
        avg_better = err_avg < err_cur
        err_best = torch.minimum(err_avg, err_cur)
        # Sufficient decay since the last restart, or stalled: restart
        # from the best candidate and reset the average.
        do = (err_best <= 0.5 * err_last) | (err_best >= err_last)
        x_cand = torch.where(avg_better[:, None], x_avg, x)
        y_cand = torch.where(avg_better[:, None], y_avg, y)
        x = torch.where(do[:, None], x_cand, x)
        y = torch.where(do[:, None], y_cand, y)
        err_last = torch.where(do, err_best, err_last)
        xsum = torch.where(do[:, None], 0.0, xsum)
        ysum = torch.where(do[:, None], 0.0, ysum)
        navg = torch.where(do, 0.0, navg)
        primal, dual, gap = _residuals(cs, bounded, x, y)
        scale = cs["scale"]
        newly = (primal <= tol * scale) & (dual <= tol * scale) & \
            (gap <= 10.0 * tol * scale)
        done = done | newly
    return {"x": x, "y": y, "xsum": xsum, "ysum": ysum, "navg": navg,
            "err_last": err_last, "done": done}


def _pdhg_solve(A, b, c, is_eq, ub=None, max_iters: int = 10000,
                tol: float = 1e-4, check_every: int = 40,
                bounded: bool = False):
    """Core batched restarted-averaged PDHG loop (see the JAX function).

    A: (B, m, n); b: (B, m); c: (B, n); is_eq: (B, m) bool, all on one
    device; ub: (B, n) with +inf where unbounded (``bounded=True``
    activates the box projection).  Each chunk is :func:`_pdhg_chunk`,
    one CUDA graph on the card.  Returns ``(x, y, primal, dual, gap, done,
    iters)`` as tensors, ``iters`` a host int.
    """
    B, m, n = A.shape
    dt, dev = A.dtype, A.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    A_s, d_r, d_c = _ruiz_equilibrate(A)
    b_s = b * d_r
    c_s = c * d_c
    if bounded:
        ub = ub.to(dt)
        ub_s = ub / d_c              # scaled-space box (inf stays inf)
    else:
        ub = torch.full((B, n), float("inf"), dtype=dt, device=dev)
        ub_s = ub
    ub_fin = torch.isfinite(ub)
    ub_or_0 = torch.where(ub_fin, ub, 0.0)
    hi_s = torch.where(ub_fin, ub_s, float("inf"))

    sig_max = _power_iter_sigma_max(A_s)
    base = 0.9 / torch.clamp_min(sig_max, 1e-12)                # (B,)

    # PDLP primal weight, hybrid initialization (see the JAX function).
    w0 = (1e-12 + torch.linalg.vector_norm(c_s, dim=1)) \
        / (1e-12 + torch.linalg.vector_norm(b_s, dim=1))
    mild = (w0 >= 0.1) & (w0 <= 10.0)
    omega0 = torch.where(mild, 1.0, torch.clamp(torch.sqrt(w0), 1e-4, 1e4))

    cs = {"A": A, "b": b, "c": c, "is_eq": is_eq, "d_r": d_r, "d_c": d_c,
          "A_s": A_s, "b_s": b_s, "c_s": c_s, "ub": ub, "ub_fin": ub_fin,
          "ub_or_0": ub_or_0, "hi_s": hi_s,
          "tau": (base / omega0)[:, None], "sigma": (base * omega0)[:, None],
          "scale": 1.0 + torch.maximum(torch.amax(torch.abs(b), dim=1),
                                       torch.amax(torch.abs(c), dim=1))}
    x = torch.zeros((B, n), dtype=dt, device=dev)
    y = torch.zeros((B, m), dtype=dt, device=dev)
    state = {"x": x, "y": y, "xsum": torch.zeros_like(x),
             "ysum": torch.zeros_like(y),
             "navg": torch.zeros((B,), dtype=dt, device=dev),
             "err_last": _kkt(cs, bounded, x, y),
             "done": torch.zeros((B,), dtype=torch.bool, device=dev)}

    k = 0
    with graphs.Loop("pdhg.solve", state, cs,
                     (float(tol), bool(bounded))) as lp:
        while k < max_iters:
            # One chunk: iterations k .. the next check (k' > 0,
            # k' % check_every == 0), or up to the cap.
            k_check = (k // check_every + 1) * check_every
            k_end = min(k_check + 1, max_iters)
            lp.run(_pdhg_chunk, k_end - k, k_end - 1 == k_check)
            k = k_end
            if k > k_check:
                counters.add(globals(), "STATE_READS")
                if bool(lp.state["done"].all()):
                    break
    x, y = state["x"], state["y"]
    primal, dual, gap = _residuals(cs, bounded, x, y)
    return x * d_c, y * d_r, primal, dual, gap, state["done"], k


def _canonical(c, A, b, ops, maximize):
    """Host canonicalization of a batch: min-form costs, ``>=`` rows
    negated to ``<=``.  Returns ``(c, A, b, ops, maximize, c_min, A_n, b_n,
    is_eq)`` (the raw arrays in f64 first)."""
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    ops = np.asarray(ops)
    B, m, n = A.shape
    maxi = np.broadcast_to(np.asarray(maximize, bool), (B,))
    c_min = np.where(maxi[:, None], -c, c)
    flip = (ops == OP_GE)[None, :]
    A_n = np.where(flip[:, :, None], -A, A)
    b_n = np.where(flip, -b, b)
    is_eq = np.broadcast_to((ops == OP_EQ)[None, :], (B, m))
    return c, A, b, ops, maxi, c_min, A_n, b_n, is_eq


def _result(out, c_min, maxi, t0):
    """A :class:`PdhgResult` from ``_pdhg_solve``'s tensors."""
    x, y, primal, dual, gap, done, iters = out
    x = x.cpu().numpy().astype(np.float64)
    obj_min = np.einsum("bn,bn->b", c_min, x)
    return PdhgResult(
        x=x, y=y.cpu().numpy().astype(np.float64),
        objective=np.where(maxi, -obj_min, obj_min) + 0.0,
        primal_residual=primal.cpu().numpy().astype(np.float64),
        dual_residual=dual.cpu().numpy().astype(np.float64),
        gap=gap.cpu().numpy().astype(np.float64),
        converged=done.cpu().numpy(),
        iters=int(iters),
        solve_time=time.perf_counter() - t0,
    )


def _solver_config(config, device: torch.device):
    """The exact engines' config for a PDHG run on ``device``."""
    from ..config import SolverConfig

    if config is None:
        return SolverConfig(device=str(device))
    if torch.device(config.device) != device:
        raise ValueError(f"config.device {config.device!r} differs from "
                         f"device {str(device)!r}")
    return config


def solve_arrays_stream(batches, tol: float = 1e-4, max_iters: int = 20000,
                        dtype=np.float32, maximize=False,
                        crossover: str = "none", config=None, ub=None,
                        device: str = "cuda"):
    """Pipelined PDHG sweep over an iterable of ``(c, A, b, ops)`` batches.

    Same contract as the JAX function: one :class:`PdhgResult` a batch, in
    order; ``crossover`` ``"none"``, ``"unconverged"`` or ``"all"``
    recovers exact vertices (``res.exact``: instance index →
    SimplexResult) through the per-instance crossover or, for 64 or more
    instances or a bounded sweep, one certified batched solve; ``ub`` ((n,)
    shared) adds native box constraints.  Batch k+1 is canonicalized and
    its upload issued (pinned buffers, a side stream) before batch k's loop
    starts.  ``config`` configures the exact engines; its device must be
    ``device``.
    """
    dev = torch_device(device)
    cfg = _solver_config(config, dev)
    np_dt, _ = resolve_dtype(np.dtype(dtype).name)
    bounded = ub is not None and bool(
        np.any(np.isfinite(np.asarray(ub, np.float64))))
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(batch):
        c, A, b, ops, maxi, c_min, A_n, b_n, is_eq = _canonical(*batch,
                                                                 maximize)
        B, _, n = A.shape
        arrays = [A_n.astype(np_dt), b_n.astype(np_dt),
                  c_min.astype(np_dt), np.ascontiguousarray(is_eq)]
        if bounded:
            arrays.append(np.broadcast_to(np.asarray(ub, np.float64),
                                          (B, n)).astype(np_dt))
        return (c, A, b, ops, maxi, c_min), staging.stage(arrays, dev, side)

    it = iter(batches)
    try:
        current = stage(next(it))
    except StopIteration:
        return

    while current is not None:
        (c, A, b, ops, maxi, c_min), staged = current
        t0 = time.perf_counter()
        args = staged.tensors()
        # Stage the NEXT batch before this one's loop starts.
        try:
            current = stage(next(it))
        except StopIteration:
            current = None
        out = _pdhg_solve(*args[:4], ub=args[4] if bounded else None,
                          max_iters=max_iters, tol=tol, bounded=bounded)
        res = _result(out, c_min, maxi, t0)
        del staged, args
        if crossover != "none":
            if crossover == "all":
                idx = list(range(res.x.shape[0]))
            else:
                idx = [int(i) for i in np.nonzero(~res.converged)[0]]
            if len(idx) >= 64 or bounded:
                # Many instances: one certified batched device solve
                # instead of a per-instance loop (see the JAX function).
                # (An empty subset is skipped: the kernels take B >= 1.)
                exact = _crossover_via_batched(
                    c, A, b, ops, maxi, idx, cfg,
                    ub=(ub if bounded else None)) if idx else []
            else:
                from .crossover import crossover_batch

                exact = crossover_batch(c, A, b, ops, maxi, res.x,
                                        indices=idx, config=cfg)
            res.exact = dict(zip(idx, exact))
            for i, r in res.exact.items():
                if r.success:
                    res.x[i] = r.x
                    res.objective[i] = r.z
                    res.converged[i] = True
        yield res


def _crossover_via_batched(c, A, b, ops, maxi, idx, config, ub=None):
    """Exact recovery for MANY selected instances: one batched device
    solve (f64-certified like any batched result) repackaged as
    per-instance :class:`SimplexResult`s."""
    from ..core.problem import STATUS_MESSAGES
    from .batched import BatchedSimplexSolver
    from .dense import SimplexResult

    idx = np.asarray(idx, np.int64)
    # Pad the subset to a multiple of 256 (repeat the last instance), as
    # the JAX function does for its fused kernel; the padded tail is
    # dropped below.
    n_real = idx.shape[0]
    pad = (-n_real) % 256
    idx_p = np.concatenate([idx, np.full(pad, idx[-1])]) if pad else idx
    ub_sub = None
    if ub is not None:
        ub_sub = np.broadcast_to(np.asarray(ub, np.float64),
                                 (A.shape[0], A.shape[2]))[idx_p]
    sub = BatchedSimplexSolver(config).solve_arrays(
        c[idx_p], A[idx_p], b[idx_p], ops, maximize=maxi[idx_p],
        ub=ub_sub)
    out = []
    for k in range(n_real):
        ok = bool(sub.success[k])
        out.append(SimplexResult(
            x=(np.asarray(sub.x[k], np.float64) if ok else None),
            fun=(float(sub.fun[k]) if ok else None),
            status=int(sub.status[k]), success=ok,
            message=STATUS_MESSAGES.get(int(sub.status[k]), ""),
            nit=int(sub.nit),
            basis=(None if sub.basis is None else sub.basis[k]),
            z=(float(sub.z[k]) if ok else None),
            solve_time=sub.solve_time / max(n_real, 1),
        ))
    return out


class PdhgSolver:
    """Batched first-order solver over uniform-shape array batches, on
    ``device`` ("cuda" by default, raising without a GPU)."""

    def __init__(self, tol: float = 1e-4, max_iters: int = 20000,
                 dtype=np.float32, device: str = "cuda"):
        self.tol = tol
        self.max_iters = max_iters
        self.dtype = np.dtype(dtype)
        self.device = device

    def solve_arrays(self, c, A, b, ops, maximize=False,
                     ub=None) -> PdhgResult:
        """``ub`` ((n,) or (B, n), entries in [0, +inf]): native box
        constraints ``0 <= x <= ub`` (see the JAX method)."""
        t0 = time.perf_counter()
        dev = torch_device(self.device)
        _, t_dt = resolve_dtype(self.dtype.name)
        c, A, b, ops, maxi, c_min, A_n, b_n, is_eq = _canonical(
            c, A, b, ops, maximize)
        B, m, n = A.shape
        bounded = ub is not None and bool(
            np.any(np.isfinite(np.asarray(ub, np.float64))))
        ub_dev = None
        if bounded:
            ub_b = np.broadcast_to(np.asarray(ub, np.float64), (B, n))
            if np.any(ub_b < 0):
                raise ValueError("ub debe cumplir ub >= 0.")
            ub_dev = torch.as_tensor(np.array(ub_b), device=dev).to(t_dt)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        out = _pdhg_solve(put(A_n).to(t_dt), put(b_n).to(t_dt),
                          put(c_min).to(t_dt), put(is_eq), ub_dev,
                          max_iters=self.max_iters, tol=self.tol,
                          bounded=bounded)
        return _result(out, c_min, maxi, t0)
