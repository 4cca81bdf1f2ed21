"""The snarl mesh: the devices of a run, and the rule that deals a
chromosome's chunks over them.

The JAX package (stoat_tpu/parallel/mesh.py) split each chunk's snarls
into padded shards so that one XLA program served every device.  Here a
mesh is an ordered tuple of ``torch.device`` (one may appear more than
once), and the runner and the permutation pass run their one-device chunk
loop over it: :func:`steps` deals the chunks, whole and at the one-device
size, to the devices in turn.  Results are independent per snarl, so the
outputs are byte-identical to one device's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, \
    TypeVar

import torch

from stoat_tpu_torch.device import resolve_device

__all__ = ["SnarlMesh", "make_snarl_mesh", "resolve_mesh", "steps"]

T = TypeVar("T")


@dataclass(frozen=True)
class SnarlMesh:
    """The devices that a run deals its chunks over, in order."""

    devices: Tuple[torch.device, ...]

    def __len__(self) -> int:
        return len(self.devices)


def make_snarl_mesh(devices: Optional[Sequence] = None) -> SnarlMesh:
    """A mesh over ``devices`` (names or ``torch.device``; one may be
    named more than once), by default every visible CUDA card.

    Without a card the default raises, as ``device.resolve_device`` does:
    a mesh never quietly becomes the CPU.  A CPU mesh is asked for by
    name, e.g. ``[torch.device("cpu")] * 8``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh over the CUDA devices was requested but no CUDA "
                "device is available; name the mesh's devices to run on "
                "the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return SnarlMesh(tuple(devices))


def resolve_mesh(device, mesh: Optional[SnarlMesh] = None
                 ) -> Optional[SnarlMesh]:
    """The mesh of a run, or None for one device (the rule of
    pipeline/runner.py run_vcf_analysis and pipeline/permutation.py
    run_permutation_test): ``mesh`` when given; else every visible card
    when ``device`` is a bare ``cuda`` (no index) and more than one card
    is visible.  ``cuda:N`` is that card alone and ``cpu`` the CPU
    alone."""
    if mesh is not None:
        return mesh
    if device is not None:
        dev = torch.device(device)
        if (dev.type == "cuda" and dev.index is None
                and torch.cuda.is_available()
                and torch.cuda.device_count() > 1):
            return make_snarl_mesh()
    return None


def steps(chunks: Iterable[T], devices: Sequence[torch.device]
          ) -> Iterator[List[Tuple[torch.device, T]]]:
    """Deal ``chunks`` over ``devices``: each step is the next
    ``len(devices)`` chunks, chunk d of a step paired with ``devices[d]``
    (the last step may be shorter).  One device gives one chunk a
    step."""
    it = iter(chunks)
    while True:
        # zip asks ``devices`` first, so it takes no chunk past a step
        step = list(zip(devices, it))
        if not step:
            return
        yield step
