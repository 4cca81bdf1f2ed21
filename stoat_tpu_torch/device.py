"""Device selection for the port (the counterpart of stoat_tpu/jaxconfig.py).

The device is always explicit.  ``--device cuda`` on a machine without a
CUDA card raises: nothing falls back to the CPU.  Statistics are always
float64, as in the JAX package (which enables x64).  One rule picks the
implementation of every kernel stage: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to its plain PyTorch version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "kernels_enabled"]


def resolve_device(name) -> torch.device:
    """``torch.device`` for ``name`` ("cpu", "cuda", "cuda:N").

    Raises RuntimeError when a CUDA device is asked for and none is
    present, and ValueError for any other device type."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but no CUDA device is available; "
            "pass --device cpu to run the plain PyTorch path")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"device {dev} does not exist: "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


def kernels_enabled(device) -> bool:
    """True when work on ``device`` runs on the hand-written kernels."""
    return torch.device(device).type == "cuda"
