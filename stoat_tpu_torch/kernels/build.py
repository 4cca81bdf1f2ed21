"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``stoat_tpu_torch/csrc/<name>.cu`` has a plain C interface and
compiles, at its first use, into its own shared library under
``build/stoat_tpu_torch/`` at the root of the checkout.  The sources in
the package are the only input: nothing is downloaded, and no PyTorch
header is included (a file that includes them takes minutes to build).
A library's file name carries a hash of its source, of the headers under
``csrc/`` (``*.cuh``, which sources include) and of the flags, so a build
from other sources is never loaded.

Nothing here runs at import time: the CPU tests import every module on a
machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "BuildInfo", "BUILD_LOG", "find_nvcc",
           "load", "build_all"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stoat_tpu_torch"

# -fmad=false keeps every float64 multiply and add separately rounded, as
# the plain PyTorch versions compute them (the Fisher kernel's bitwise
# contract); -Xptxas -v reports registers and spills for each kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildInfo:
    """One kernel library as this process built (or found) it."""

    name: str
    path: str
    seconds: float      # nvcc wall time; 0.0 when the library was cached
    ptxas: str          # nvcc's -Xptxas -v report ("" when cached)


BUILD_LOG: Dict[str, BuildInfo] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME); the CUDA "
        "kernels of stoat_tpu_torch are built from source at first use")


def _build(name: str) -> Path:
    info = BUILD_LOG.get(name)
    if info is not None:                    # built by this process
        return Path(info.path)
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        BUILD_LOG[name] = BuildInfo(name, str(out), 0.0, "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {res.returncode}):\n"
            f"{res.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = BuildInfo(name, str(out), seconds,
                                (res.stdout + res.stderr).strip())
    return out


def build_all(names: Sequence[str]) -> None:
    """Build the named libraries together: one nvcc process per source,
    all started at once (each nvcc runs single-threaded).  Raises the
    first failure once every build has ended."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for future in [pool.submit(_build, name) for name in names]:
            future.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _LIBS[name] = lib
        return lib
