"""Multi-process runtime on ``torch.distributed`` (port of
``simplex_tpu/parallel/distributed.py``).

One process a rank and one device a rank: a CUDA card under NCCL (the
default), or the CPU under gloo (``device="cpu"``, the multi-rank tests).
The mesh's ``row`` axis carries the per-pivot collectives of
``parallel/sharded.py``; ``batch`` needs none until the results are
gathered.  Every rank stages only its own shard (:func:`put_global`), and
the per-instance results come back whole on every rank.

Bring-up: call :func:`initialize` once a process before any solve, with
arguments or the ``SIMPLEX_TPU_COORDINATOR`` / ``SIMPLEX_TPU_NUM_PROCESSES``
/ ``SIMPLEX_TPU_PROCESS_ID`` variables.  The coordinator is a
``host:port`` (``tcp://`` is assumed) or a ``file://`` path that every rank
can reach; unlike on a TPU pod, nothing is detected, so the process count
and id must be given.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import torch_device
from .sharded import Mesh, _shard, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> bool:
    """Join this process to the process group.

    Returns True when more than one process takes part.  Without a
    coordinator and with at most one process (arguments or env vars) it
    does nothing and returns False, so single-process callers pay nothing;
    a coordinator with one process builds a one-rank group, whose
    collectives still run through the backend.  A second call is a no-op.
    ``device``: ``"cuda"`` (NCCL, on the card ``process_id`` modulo the
    cards present; raises without a GPU) or ``"cpu"`` (gloo).

    Under NCCL it sets ``NCCL_GRAPH_MIXING_SUPPORT=0`` unless the
    environment sets it.  With that support on, NCCL adds an event-record
    and an event-wait node to every call a CUDA graph captures, and a
    WHILE node's body takes neither, so the sharded loop's chunk could not
    be built (``runtime/graphs.py``; CUDA error 1 on four cards).  Off, a
    captured call is kernel and copy nodes only.  NCCL then asks that no
    eager NCCL call follow a graph launch that is still running, and that
    no two graph launches run at once: the solve loops launch one graph a
    chunk on one stream and read its state on the host before any other
    call.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "SIMPLEX_TPU_COORDINATOR")
    env_np = os.environ.get("SIMPLEX_TPU_NUM_PROCESSES")
    env_pid = os.environ.get("SIMPLEX_TPU_PROCESS_ID")
    if num_processes is None and env_np:
        num_processes = int(env_np)
    if process_id is None and env_pid:
        process_id = int(env_pid)

    if not coordinator_address and (num_processes is None
                                    or num_processes <= 1):
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not coordinator_address:
        raise ValueError("more than one process needs a coordinator address")
    num_processes = 1 if num_processes is None else num_processes
    if process_id is None:
        if num_processes > 1:
            raise ValueError("a process id is needed for more than one "
                             "process")
        process_id = 0
    dev = torch_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else process_id % torch.cuda.device_count())
        os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
        backend = "nccl"
    else:
        backend = "gloo"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def make_global_mesh(row: Optional[int] = None, batch: int = 1,
                     devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(batch, row)`` mesh over all ranks.

    ``row`` defaults to the ranks of one host (``LOCAL_WORLD_SIZE``, else
    every rank) that fit ``batch``, so the per-pivot collectives stay on
    the host's links; a larger ``row`` spans hosts, for LPs one host cannot
    hold.  ``devices``: the ranks, as in ``sharded.make_mesh``.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if devices is None else len(devices)
    if row is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        row = min(local, n // max(batch, 1)) or 1
    return make_mesh(batch=batch, row=row, devices=devices)


class NamedSharding(NamedTuple):
    """Where an array's shards go: ``spec`` names, for each dimension, the
    mesh axis that splits it (None: kept whole), as JAX's ``PartitionSpec``;
    ``device`` is this rank's device."""
    mesh: Mesh
    spec: tuple
    device: str = "cuda"


def put_global(x: np.ndarray, sharding: NamedSharding):
    """This rank's shard of the host array ``x`` as a tensor on the
    sharding's device; no process stages another rank's shard."""
    shard = _shard(np.asarray(x), sharding.mesh, sharding.spec)
    return torch.from_numpy(np.ascontiguousarray(shard)).to(
        torch_device(sharding.device))


def solve_arrays_distributed(c, A, b, ops, maximize=True,
                             mesh: Optional[Mesh] = None,
                             dtype=np.float32, tol: float = 1e-6,
                             max_iters: int = 4096,
                             bland_after: int = 1024,
                             refactor_every: int = 64,
                             devex: bool = True, device="cuda"):
    """Row-sharded batched solve across processes.

    The multi-process twin of ``sharded.solve_arrays_sharded`` without
    certification: each rank stages only its shard, and every rank gets
    the same ``{"x", "z", "status", "iters", "mesh", "processes"}``.  Every
    process calls this with the same arrays (each generates or loads the
    same problems).
    """
    from .sharded import solve_arrays_sharded

    if mesh is None:
        mesh = make_global_mesh()
    out = solve_arrays_sharded(
        c, A, b, ops, maximize=maximize, mesh=mesh, dtype=dtype, tol=tol,
        max_iters=max_iters, bland_after=bland_after,
        refactor_every=refactor_every, devex=devex, certify=False,
        device=device)
    out["mesh"] = (mesh.shape["batch"], mesh.shape["row"])
    out["processes"] = dist.get_world_size() if dist.is_initialized() else 1
    return out
