"""Device-to-host result copies for the pipelined writer.

Each result tensor of a chunk is copied into pinned host memory with one
non-blocking copy on the current stream, and one CUDA event is recorded
behind the copies.  The writer thread reads the result through
:class:`HostResult`, which waits on that event before it hands out any
array.  The wait is not optional: a non-blocking copy that is read before
its event completes yields whatever the pinned buffer held before, with no
error.  (The JAX package's single-array wire packer, stoat_tpu/pipeline/
fetch.py:63-235, existed for a slow network link to the TPU and is not
ported.)
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["DeviceTables", "HostResult", "fetch_async"]


class DeviceTables:
    """A chunk's -T table view left where it was computed: norm float64
    [S, N, Pmax], used bool [S, N] and kept bool [S, Pmax].  Only the rows
    of the snarls that pass the threshold are gathered on the device and
    copied to the host (norm is 656 MB per chunk of 8,192 snarls at 2,504
    samples and Pmax = 4; users' thresholds keep a few rows)."""

    def __init__(self, norm: torch.Tensor, used: torch.Tensor,
                 kept: torch.Tensor):
        self._tensors = (norm, used, kept)

    def rows(self, snarls: Sequence[int]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(norm, used, kept) of ``snarls``, in that order, on the host.
        Called from the writer thread, it queues the gather on that
        thread's current stream of the device, behind the chunk's work."""
        device = self._tensors[0].device
        idx = torch.as_tensor(list(snarls), dtype=torch.long, device=device)
        return tuple(t.index_select(0, idx).cpu().numpy()
                     for t in self._tensors)


class HostResult(Mapping):
    """Read-only mapping of result key -> numpy array whose device copies
    may still be in flight; the first read waits for them.  ``tables``
    is the chunk's :class:`DeviceTables` (-T), or None."""

    def __init__(self, host: Dict[str, torch.Tensor], event=None,
                 tables: Optional[DeviceTables] = None):
        self._host = host
        self._event = event          # torch.cuda.Event, None for CPU data
        self._ready = event is None
        self._lock = threading.Lock()
        self.tables = tables

    def wait(self) -> None:
        """Block until every copy of this result has landed."""
        with self._lock:
            if not self._ready:
                self._event.synchronize()
                self._ready = True

    def __getitem__(self, key: str) -> np.ndarray:
        self.wait()
        return self._host[key].numpy()

    def __iter__(self) -> Iterator[str]:
        return iter(self._host)

    def __len__(self) -> int:
        return len(self._host)


def fetch_async(out: Dict[str, torch.Tensor],
                tables: Optional[DeviceTables] = None) -> HostResult:
    """Start the host copies of a result dict and return its HostResult
    (carrying ``tables``, which stays on the device).

    CPU tensors are handed over as they are.  CUDA tensors get one pinned
    buffer and one non-blocking copy each on the current stream, then one
    event; the device tensors may be freed at once, because the caching
    allocator only reuses their memory for work queued behind the
    copies on the same stream."""
    devices = {t.device for t in out.values()}
    if len(devices) != 1:
        raise ValueError("result tensors span devices "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type != "cuda":
        return HostResult(dict(out), tables=tables)
    host = {}
    for key, t in out.items():
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        host[key] = buf
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return HostResult(host, event, tables)
