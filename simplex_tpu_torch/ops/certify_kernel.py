"""The float64 certifier of an all-``<=`` batch: CUDA kernel wrapper and its
plain twin.

For every instance of a batch of LPs ``min c_min·x  s.t.  A x <= b, x >= 0``
(``b >= 0``, no upper bounds; ``c_min = -c`` where the instance maximizes)
and the basis its solve claims, :func:`certify_le_` checks the KKT system in
IEEE float64 against the exact inputs, as
``models/certify.py::certify_sweep_le_f64`` checks it with ``ub=None``:

* the claim: ``status == OPTIMAL`` and every basic column ``0 <= k < n+m``
  (structural ``j < n``, slack ``i`` at ``n + i``);
* ``B x_B = b`` and ``Bᵀ y = c_B`` from one LU of the basis matrix with
  partial pivoting (the host copy factors it twice, once for each);
* ``x_B >= -tol (1 + max|b|)``; ``y <= tol (1 + max|c|)``; the reduced costs
  ``c_min_j - Σ_i y_i A_ij >= -tol (1 + max|c|)`` on the nonbasic structural
  columns; ``x_B`` and ``y`` finite, and no exact zero pivot.

It returns ``(certified (B,) bool, x (B, n) float64, fun (B,) float64)`` on
the inputs' device: ``x_j = max(x_B, 0)`` at the basic structural columns
and 0 elsewhere, ``fun = c_min·x``; both NaN where an instance is not
certified.  ``A``, ``b`` and ``c`` are read in their own types (float32 or
float64), widened to float64.  ``tol`` is the caller's: ``models/batched.py``
passes the host copy's (``certify_uniform_result``'s).

* :func:`certify_le_` launches the hand-written kernel
  (``csrc/certify_le.cu``, one warp an instance) on CUDA tensors and runs
  the twin on CPU tensors; it raises on anything else, with no fallback from
  the kernel to its twin.
* :func:`certify_le_ref` is the plain PyTorch twin: the kernel's spec, step
  for step, and the CPU path.
"""
from __future__ import annotations

import torch

from ..core.problem import STATUS_OPTIMAL
from ..runtime import counters

# Rows a kernel instance holds: two a lane of its warp.
MAX_ROWS = 64

# Kernel launches since the counter was last reset to 0 (CUDA only).
LAUNCHES_CERT = 0


def _prepare(A, b, c, maximize, basis, status):
    """Check the arguments; returns ``(B, m, n)``."""
    if not isinstance(A, torch.Tensor) or A.dim() != 3:
        raise ValueError("A must be a 3-D (B, m, n) tensor")
    B, m, n = A.shape
    if not 1 <= m <= MAX_ROWS or n < 1:
        raise ValueError(f"A must have 1..{MAX_ROWS} rows and a column, got "
                         f"{tuple(A.shape)}")
    for name, v, shape in (("A", A, (B, m, n)), ("b", b, (B, m)),
                           ("c", c, (B, n))):
        if not isinstance(v, torch.Tensor) or tuple(v.shape) != shape:
            raise ValueError(f"{name} must be a {shape} tensor")
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
    for name, v in (("A", A), ("b", b), ("c", c), ("maximize", maximize),
                    ("basis", basis), ("status", status)):
        if v.device != A.device:
            raise ValueError(f"{name} is on {v.device}, A on {A.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, m, n


def certify_le_ref(A, b, c, maximize, basis, status, tol: float):
    """The certificate of every instance in plain PyTorch float64 (the
    module's docstring), in the kernel's order of steps."""
    B, m, n = _prepare(A, b, c, maximize, basis, status)
    f64, dev = torch.float64, A.device
    A64, b64, c64 = A.to(f64), b.to(f64), c.to(f64)
    c_min = torch.where(maximize[:, None], -c64, c64)
    bidx = basis[:, :m].long()
    check = ((bidx >= 0) & (bidx < n + m)).all(1) & (status == STATUS_OPTIMAL)
    is_struct = (bidx >= 0) & (bidx < n)
    safe = torch.where(is_struct, bidx, 0)
    rows = torch.arange(m, device=dev)
    gathered = A64.gather(2, safe[:, None, :].expand(B, m, m))
    unit = (rows[None, :, None] == (bidx - n)[:, None, :]).to(f64)
    LU = torch.where(is_struct[:, None, :], gathered, unit)
    c_B = torch.where(is_struct, c_min.gather(1, safe), 0.0)
    scale = 1.0 + b64.abs().amax(1)
    c_scale = 1.0 + c64.abs().amax(1)

    # P B = L U: the first largest |entry| of the column (a NaN wins), rows
    # swapped whole; an exact zero pivot fails the instance.
    pb = b64.clone()
    perm = rows.expand(B, m).clone()
    inst = torch.arange(B, device=dev)
    ok = check.clone()
    for k in range(m):
        a = LU[:, k:, k].abs()
        p = k + torch.where(torch.isnan(a), torch.inf, a).argmax(1)
        for t in (LU, pb, perm):
            tk, tp = t[inst, k].clone(), t[inst, p].clone()
            t[inst, k], t[inst, p] = tp, tk
        piv = LU[:, k, k]
        ok &= piv != 0
        l = LU[:, k + 1:, k] / torch.where(piv == 0, 1.0, piv)[:, None]
        LU[:, k + 1:, k] = l
        LU[:, k + 1:, k + 1:] -= l[:, :, None] * LU[:, k, None, k + 1:]
    diag = torch.where(ok[:, None], LU.diagonal(dim1=1, dim2=2), 1.0)

    z = pb                                  # L z = P b, then U x_B = z
    for k in range(m):
        z[:, k + 1:] -= LU[:, k + 1:, k] * z[:, k, None]
    for k in reversed(range(m)):
        z[:, k] /= diag[:, k]
        z[:, :k] -= LU[:, :k, k] * z[:, k, None]
    w = c_B                                 # Uᵀ w = c_B, Lᵀ v = w
    for k in range(m):
        w[:, k] /= diag[:, k]
        w[:, k + 1:] -= LU[:, k, k + 1:] * w[:, k, None]
    for k in reversed(range(m)):
        w[:, :k] -= LU[:, k, :k] * w[:, k, None]
    y = torch.empty_like(w).scatter_(1, perm, w)          # y = Pᵀ v

    ok &= torch.isfinite(z).all(1) & torch.isfinite(y).all(1)
    ok &= (z >= -tol * scale[:, None]).all(1)
    ok &= (y <= tol * c_scale[:, None]).all(1)
    rc = c_min - torch.einsum("bm,bmn->bn", y, A64)
    slot = torch.where(is_struct, safe, n)  # n: a scratch slot for slacks
    basic = torch.zeros((B, n + 1), dtype=torch.bool, device=dev) \
        .scatter_(1, slot, True)[:, :n]
    ok &= (basic | (rc >= -tol * c_scale[:, None])).all(1)
    xs = torch.zeros((B, n + 1), dtype=f64, device=dev) \
        .scatter_(1, slot, z.clamp_min(0.0))[:, :n]
    fun = (c_min * xs).sum(1)
    return (ok, torch.where(ok[:, None], xs, torch.nan),
            torch.where(ok, fun, torch.nan))


def certify_le_(A, b, c, maximize, basis, status, tol: float):
    """:func:`certify_le_ref` through the kernel on a CUDA tensor (built on
    first use), the twin on a CPU tensor; any other device raises."""
    B, m, n = _prepare(A, b, c, maximize, basis, status)
    if A.device.type == "cpu":
        return certify_le_ref(A, b, c, maximize, basis, status, tol)
    if A.device.type != "cuda":
        raise ValueError(f"the certifier runs on cuda or cpu tensors, not "
                         f"{A.device}")
    from ..runtime import kernels

    lib = kernels.library()
    dev = A.device
    certified = torch.empty((B,), dtype=torch.bool, device=dev)
    x = torch.empty((B, n), dtype=torch.float64, device=dev)
    fun = torch.empty((B,), dtype=torch.float64, device=dev)
    fn = (lib.certify_le_f32 if A.dtype == torch.float32
          else lib.certify_le_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(A.data_ptr(), b.data_ptr(), c.data_ptr(),
                 int(b.dtype == torch.float64), int(c.dtype == torch.float64),
                 maximize.data_ptr(), basis.data_ptr(), basis.shape[1],
                 status.data_ptr(), B, m, n, float(tol),
                 certified.data_ptr(), x.data_ptr(), fun.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"certify_le launch failed: CUDA error {err}")
    counters.add(globals(), "LAUNCHES_CERT")
    return certified, x, fun
