"""Shared kernel-package utilities: device resolution and the CUDA build.

- :func:`resolve_device` turns a ``device`` argument into a
  ``torch.device`` and raises when CUDA is asked for but absent.  Every
  entry point of the port calls it, so nothing carries on on the CPU
  when the caller asked for the card.
- :func:`load_cuda_library` compiles one ``csrc/*.cu`` source with
  ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
  and loads it with ``ctypes``.  The build happens at first use, never at
  import, into ``build/repro_torch_kernels/`` at the checkout root, keyed
  on a hash of the source and the flags.

Kernel wrappers dispatch on the tensor's device: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the kernel or raises.
There is no switch that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Union

import torch

#: nvcc flags for every kernel source: Hopper (``sm_90a``), no fast math
#: (``--use_fast_math`` would change ``tanhf``, ``rsqrtf`` and division).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: the toolkit's nvcc when it is not on ``PATH``
CUDA_HOME_NVCC = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
    "bin" / "nvcc"

#: where built libraries go: ``build/`` at the checkout root (git-ignored)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` naming
    the device when it is a CUDA device and no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                "(pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def find_nvcc() -> str:
    """Path of ``nvcc``: ``PATH`` first, then the CUDA toolkit's own."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME_NVCC.exists():
        nvcc = str(CUDA_HOME_NVCC)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source and need the CUDA toolkit")
    return nvcc


def build_cuda_library(source: Path) -> Path:
    """Compile ``source`` into ``BUILD_DIR`` (skipped when a library for
    the same source bytes and flags exists) and return its path.  A
    failed build raises ``RuntimeError`` carrying nvcc's stderr."""
    source = Path(source)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}_{digest}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent or cut-off
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {source.name} "
                f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_cuda_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``source``; loaded once
    per process."""
    return ctypes.CDLL(str(build_cuda_library(Path(source))))
