"""The float64 certifier of all-``<=`` batches, with optional upper
bounds: the CUDA kernel's wrapper and its plain twin.

For every instance of a batch of LPs ``min c_min·x  s.t.  A x <= b, 0 <= x
<= ub`` (``b >= 0``; ``c_min = -c`` where the instance maximizes; ``ub``
(n,) or (B, n), entries in [0, +inf], and one ``+inf`` row where the
caller gives none) and the basis and ``at_upper`` (B, >= n) its solve
claims, :func:`certify_le_` checks the KKT system in IEEE float64 against
the exact inputs, as ``models/certify.py::certify_sweep_le_f64`` checks it
with ``ub`` and ``at_upper``:

* the claim: ``status == OPTIMAL`` and every basic column ``0 <= k < n+m``
  (structural ``j < n``, slack ``i`` at ``n + i``);
* the at-upper set: ``at_upper`` where ``ub`` is finite and the column is
  not basic (empty without ``at_upper``), ``u = ub`` there and 0
  elsewhere;
* ``B x_B = b - A u`` and ``Bᵀ y = c_B`` from one LU of the basis matrix
  with partial pivoting (the host copy factors it twice, once for each);
* ``x_B >= -tol (1 + max|b|)``, and ``x_B <= ub_B + tol (1 + max|b|)``
  where the basic column is structural with a finite bound; ``y <= tol (1
  + max|c|)``; on the nonbasic structural columns, ``rc_j = c_min_j - Σ_i
  y_i A_ij <= tol (1 + max|c|)`` at upper, else ``rc_j >= -tol (1 +
  max|c|)`` unless ``ub_j == 0``; ``x_B`` and ``y`` finite, and no exact
  zero pivot.

Without bounds (``ub`` +inf everywhere, no ``at_upper``) the at-upper set
is empty and ``u = 0``, so this is the check of ``certify_sweep_le_f64``
with ``ub=None``, term for term.  The result is ``(certified (B,) bool, x
(B, n) float64, fun (B,) float64)`` on the inputs' device: ``x_j = max(x_B,
0)`` at the basic structural columns, ``ub_j`` at the at-upper ones and 0
elsewhere, ``fun = c_min·x``; both NaN where an instance is not certified.
``A``, ``b``, ``c`` and ``ub`` are read in their own types (float32 or
float64), widened to float64.  ``tol`` is the caller's:
``models/batched.py`` passes the host copy's
(``certify_uniform_result``'s).

* :func:`certify_le_` launches the hand-written kernel
  (``csrc/certify_bounded.cu``; one warp an instance) on CUDA tensors and
  runs the twin on CPU tensors; it raises on anything else, with no
  fallback from the kernel to its twin.
* :func:`certify_le_ref` is the plain PyTorch twin: the kernel's spec,
  step for step, and the CPU path.
"""
from __future__ import annotations

import torch

from ..core.problem import STATUS_OPTIMAL
from ..runtime import counters

# Rows a kernel instance holds: two a lane of its warp.
MAX_ROWS = 64

# Kernel launches since the counter was last reset to 0 (CUDA only).
LAUNCHES_CERT = 0


def _prepare(A, b, c, maximize, basis, status, ub, at_upper):
    """Check the arguments; returns ``(B, m, n, ub)``, ``ub`` one ``+inf``
    row where it is None."""
    if not isinstance(A, torch.Tensor) or A.dim() != 3:
        raise ValueError("A must be a 3-D (B, m, n) tensor")
    B, m, n = A.shape
    if not 1 <= m <= MAX_ROWS or n < 1:
        raise ValueError(f"A must have 1..{MAX_ROWS} rows and a column, got "
                         f"{tuple(A.shape)}")
    if ub is None:
        ub = torch.full((n,), torch.inf, device=A.device)
    for name, v, shapes in (("A", A, [(B, m, n)]), ("b", b, [(B, m)]),
                            ("c", c, [(B, n)]), ("ub", ub, [(n,), (B, n)])):
        if not isinstance(v, torch.Tensor) or tuple(v.shape) not in shapes:
            raise ValueError(f"{name} must be a "
                             f"{' or '.join(map(str, shapes))} tensor")
        if v.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} must be float32 or float64, got "
                            f"{v.dtype}")
    for name, v, dtype in (("maximize", maximize, torch.bool),
                           ("basis", basis, torch.int32),
                           ("status", status, torch.int32)):
        if not isinstance(v, torch.Tensor) or v.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor")
    if maximize.shape != (B,) or status.shape != (B,):
        raise ValueError("maximize and status must be (B,) tensors")
    if basis.dim() != 2 or basis.shape[0] != B or basis.shape[1] < m:
        raise ValueError(f"basis must be (B, >= m) = ({B}, >= {m})")
    args = [("A", A), ("b", b), ("c", c), ("ub", ub), ("maximize", maximize),
            ("basis", basis), ("status", status)]
    if at_upper is not None:
        if not isinstance(at_upper, torch.Tensor) \
                or at_upper.dtype != torch.bool:
            raise TypeError("at_upper must be a bool tensor")
        if at_upper.dim() != 2 or at_upper.shape[0] != B \
                or at_upper.shape[1] < n:
            raise ValueError(f"at_upper must be (B, >= n) = ({B}, >= {n})")
        args.append(("at_upper", at_upper))
    for name, v in args:
        if v.device != A.device:
            raise ValueError(f"{name} is on {v.device}, A on {A.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, m, n, ub


def _factor(A64, basis, status, n):
    """The basis matrix of every instance, factored as the kernels factor
    it: returns ``(LU, perm, diag, ok, is_struct, safe)``.  ``P B = L U``
    with the first largest |entry| of each column as pivot (a NaN wins),
    rows swapped whole (``perm[k]`` is the row of ``B`` at ``k``); ``ok``
    is the claim (OPTIMAL, every basic column in range) with no exact zero
    pivot; ``diag`` is ``U``'s diagonal, 1 where ``ok`` is not;
    ``is_struct``/``safe``: which basic columns are structural, and their
    columns (0 for the slacks)."""
    B, m, _ = A64.shape
    dev, f64 = A64.device, torch.float64
    bidx = basis[:, :m].long()
    ok = ((bidx >= 0) & (bidx < n + m)).all(1) & (status == STATUS_OPTIMAL)
    is_struct = (bidx >= 0) & (bidx < n)
    safe = torch.where(is_struct, bidx, 0)
    rows = torch.arange(m, device=dev)
    gathered = A64.gather(2, safe[:, None, :].expand(B, m, m))
    unit = (rows[None, :, None] == (bidx - n)[:, None, :]).to(f64)
    LU = torch.where(is_struct[:, None, :], gathered, unit)
    perm = rows.expand(B, m).clone()
    inst = torch.arange(B, device=dev)
    for k in range(m):
        a = LU[:, k:, k].abs()
        p = k + torch.where(torch.isnan(a), torch.inf, a).argmax(1)
        for t in (LU, perm):
            tk, tp = t[inst, k].clone(), t[inst, p].clone()
            t[inst, k], t[inst, p] = tp, tk
        piv = LU[:, k, k]
        ok &= piv != 0
        l = LU[:, k + 1:, k] / torch.where(piv == 0, 1.0, piv)[:, None]
        LU[:, k + 1:, k] = l
        LU[:, k + 1:, k + 1:] -= l[:, :, None] * LU[:, k, None, k + 1:]
    diag = torch.where(ok[:, None], LU.diagonal(dim1=1, dim2=2), 1.0)
    return LU, perm, diag, ok, is_struct, safe


def _solve(LU, diag, perm, rhs):
    """``B x = rhs``: ``L z = P rhs``, then ``U x = z``."""
    m = LU.shape[1]
    z = rhs.gather(1, perm)
    for k in range(m):
        z[:, k + 1:] -= LU[:, k + 1:, k] * z[:, k, None]
    for k in reversed(range(m)):
        z[:, k] /= diag[:, k]
        z[:, :k] -= LU[:, :k, k] * z[:, k, None]
    return z


def _solve_t(LU, diag, perm, rhs):
    """``Bᵀ y = rhs``: ``Uᵀ w = rhs``, ``Lᵀ v = w``, ``y = Pᵀ v``."""
    m = LU.shape[1]
    w = rhs.clone()
    for k in range(m):
        w[:, k] /= diag[:, k]
        w[:, k + 1:] -= LU[:, k, k + 1:] * w[:, k, None]
    for k in reversed(range(m)):
        w[:, :k] -= LU[:, k, :k] * w[:, k, None]
    return torch.empty_like(w).scatter_(1, perm, w)


def _at_basic(z, is_struct, safe, n):
    """``(B, n)``: ``z[k]`` at each basic structural column ``safe[k]``
    (the last such ``k``), 0 (or False) elsewhere."""
    slot = torch.where(is_struct, safe, n)  # n: a scratch slot for slacks
    return torch.zeros((z.shape[0], n + 1), dtype=z.dtype,
                       device=z.device).scatter_(1, slot, z)[:, :n]


def certify_le_ref(A, b, c, maximize, basis, status, tol: float, ub=None,
                   at_upper=None):
    """The certificate of every instance in plain PyTorch float64 (the
    module's docstring), in the kernel's order of steps: the basis matrix
    and ``y`` first, then the columns (reduced costs, the at-upper set,
    ``b_eff``), then ``x_B``."""
    B, m, n, ub = _prepare(A, b, c, maximize, basis, status, ub, at_upper)
    f64 = torch.float64
    A64, b64, c64 = A.to(f64), b.to(f64), c.to(f64)
    c_min = torch.where(maximize[:, None], -c64, c64)
    LU, perm, diag, ok, is_struct, safe = _factor(A64, basis, status, n)
    c_B = torch.where(is_struct, c_min.gather(1, safe), 0.0)
    scale = 1.0 + b64.abs().amax(1)
    c_scale = 1.0 + c64.abs().amax(1)
    y = _solve_t(LU, diag, perm, c_B)
    ok &= torch.isfinite(y).all(1) & (y <= tol * c_scale[:, None]).all(1)

    u64 = ub.to(f64).expand(B, n)
    rc = c_min - torch.einsum("bm,bmn->bn", y, A64)
    basic = _at_basic(is_struct, is_struct, safe, n)
    up = (~basic & torch.isfinite(u64) & at_upper[:, :n]
          if at_upper is not None else torch.zeros_like(basic))
    lo_ok = basic | up | (u64 == 0.0) | (rc >= -tol * c_scale[:, None])
    up_ok = ~up | (rc <= tol * c_scale[:, None])
    ok &= (lo_ok & up_ok).all(1)
    u = torch.where(up, u64, 0.0)
    b_eff = b64 - torch.einsum("bmn,bn->bm", A64, u)

    z = _solve(LU, diag, perm, b_eff)
    u_B = torch.where(is_struct, u64.gather(1, safe), torch.inf)
    ok &= torch.isfinite(z).all(1) & (z >= -tol * scale[:, None]).all(1)
    ok &= (~torch.isfinite(u_B) | (z <= u_B + tol * scale[:, None])).all(1)
    xs = torch.where(up, u64,
                     _at_basic(z.clamp_min(0.0), is_struct, safe, n))
    fun = (c_min * xs).sum(1)
    return (ok, torch.where(ok[:, None], xs, torch.nan),
            torch.where(ok, fun, torch.nan))


def certify_le_(A, b, c, maximize, basis, status, tol: float, ub=None,
                at_upper=None):
    """:func:`certify_le_ref` through the kernel on a CUDA tensor (built on
    first use), the twin on a CPU tensor; any other device raises."""
    B, m, n, ub = _prepare(A, b, c, maximize, basis, status, ub, at_upper)
    if A.device.type == "cpu":
        return certify_le_ref(A, b, c, maximize, basis, status, tol, ub,
                              at_upper)
    if A.device.type != "cuda":
        raise ValueError(f"the certifier runs on cuda or cpu tensors, not "
                         f"{A.device}")
    from ..runtime import kernels

    lib = kernels.library()
    dev = A.device
    certified = torch.empty((B,), dtype=torch.bool, device=dev)
    x = torch.empty((B, n), dtype=torch.float64, device=dev)
    fun = torch.empty((B,), dtype=torch.float64, device=dev)
    fn = (lib.certify_le_bounded_f32 if A.dtype == torch.float32
          else lib.certify_le_bounded_f64)
    f64 = [int(t.dtype == torch.float64) for t in (b, c, ub)]
    up_ptr, ld_up = ((None, 0) if at_upper is None
                     else (at_upper.data_ptr(), at_upper.shape[1]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(A.data_ptr(), b.data_ptr(), c.data_ptr(), ub.data_ptr(),
                 *f64, n if ub.dim() == 2 else 0, up_ptr, ld_up,
                 maximize.data_ptr(), basis.data_ptr(), basis.shape[1],
                 status.data_ptr(), B, m, n, float(tol),
                 certified.data_ptr(), x.data_ptr(), fun.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"certify_le launch failed: CUDA error {err}")
    counters.add(globals(), "LAUNCHES_CERT")
    return certified, x, fun
