"""Uploads that overlap the device's work: pinned buffers, a side stream.

The streaming sweeps (``models/batched.py::solve_arrays_stream`` and
``models/pdhg.py::solve_arrays_stream``) stage batch k+1 while batch k
solves.  The JAX package gets that overlap from asynchronous dispatch; the
port's solve loops read their state back once a chunk, which blocks the
host, so the overlap is made explicit here:

* :func:`stage` allocates pinned buffers and the device tensors (on a
  CUDA device only: ``pin_memory`` needs CUDA); :meth:`Staged.upload`
  copies the host arrays into the pinned buffers, issues ``non_blocking``
  uploads on a side stream and records an event after them (at once, or
  later where the caller defers it);
* :meth:`Staged.tensors` makes the caller's current stream wait on that
  event and marks each tensor as used on that stream (``record_stream``),
  since the caching allocator made them on the side stream.

On the CPU the upload makes the tensors and there is nothing to wait
for.  The :class:`Staged` object keeps the pinned buffers alive; the caller
drops it once the batch that used it has been solved, after the copy's
event.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


# The most bytes one upload copies: a large array goes up in slabs.
_SLAB_BYTES = 32 << 20


class Staged:
    """Device tensors whose upload may be deferred or still in flight."""

    def __init__(self, tensors: List[torch.Tensor],
                 host: Sequence[torch.Tensor] = (),
                 pinned: Sequence[torch.Tensor] = (),
                 side_stream: Optional["torch.cuda.Stream"] = None,
                 device: Optional[torch.device] = None):
        self._tensors = tensors
        self._host = list(host)         # waiting for upload()
        self._pinned = list(pinned)     # alive until the copies have run
        self._side = side_stream
        self._device = device
        self._event = None

    def upload(self):
        """Issue the upload, once: on CUDA, copy the host arrays into the
        pinned buffers and the buffers into the device tensors on the side
        stream, then record an event; on the CPU, make the tensors."""
        if not self._host:
            return
        host, self._host = self._host, []
        if not self._pinned:
            self._tensors = [h.to(self._device) for h in host]
            return
        self._event = torch.cuda.Event()
        with torch.cuda.stream(self._side):
            # Slab by slab, each upload issued as soon as its pinned copy
            # is done: the first run beside the device's work while the
            # host copies the rest.
            for d, p, h in zip(self._tensors, self._pinned, host):
                n = max(1, _SLAB_BYTES // h.element_size())
                hf, pf, df = h.reshape(-1), p.view(-1), d.view(-1)
                for a in range(0, hf.numel(), n):
                    pf[a:a + n].copy_(hf[a:a + n])
                    df[a:a + n].copy_(pf[a:a + n], non_blocking=True)
            self._event.record()

    def tensors(self) -> List[torch.Tensor]:
        """The tensors, safe to use on the current stream: the upload is
        issued if it was not yet, and the stream waits for its event."""
        self.upload()
        if self._event is not None:
            current = torch.cuda.current_stream(self._tensors[0].device)
            current.wait_event(self._event)
            for t in self._tensors:
                t.record_stream(current)
            self._event = None
        return self._tensors


def stage(arrays: Sequence[np.ndarray], device: torch.device,
          side_stream: Optional["torch.cuda.Stream"] = None,
          defer: bool = False) -> Staged:
    """Upload ``arrays`` (numpy, already in their device dtypes) to
    ``device``.  On a CUDA device the pinned buffers and the device tensors
    are allocated here, and the copies run on ``side_stream`` and return at
    once; elsewhere the tensors are made at once.  With ``defer`` the
    upload waits for :meth:`Staged.upload` (or :meth:`Staged.tensors`):
    the batched stream allocates batch k+1's buffers before batch k's first
    chunk and issues its copies after it."""
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        staged = Staged([], host, device=device)
    else:
        pinned = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                  for h in host]
        with torch.cuda.stream(side_stream):
            dev = [torch.empty(h.shape, dtype=h.dtype, device=device)
                   for h in host]
        staged = Staged(dev, host, pinned, side_stream, device)
    if not defer:
        staged.upload()
    return staged
