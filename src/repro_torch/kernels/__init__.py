"""Shared kernel-package utilities: device resolution and the CUDA build.

- :func:`resolve_device` turns a ``device`` argument into a
  ``torch.device`` and raises when CUDA is asked for but absent.  Every
  entry point of the port calls it, so nothing carries on on the CPU
  when the caller asked for the card.
- :func:`load_cuda_library` compiles one ``csrc/*.cu`` source with
  ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
  and loads it with ``ctypes``.  The build happens at first use, never at
  import, into ``build/repro_torch_kernels/`` at the checkout root, keyed
  on a hash of the flags, the source and every file it can include: the
  other files of its ``csrc/`` directory and of the shared header
  directory ``kernels/common/`` (``INCLUDE_DIRS``), so an edited header
  never leaves a stale library behind.

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
#: (``--use_fast_math`` would change ``tanhf``, ``rsqrtf`` and division),
#: and ptxas's report of registers, shared memory and spills per kernel,
#: which the build keeps beside the library (:func:`build_log`).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: header directories every source may include (``-I``): the Hopper PTX
#: helpers (TMA, ``mbarrier``, ``wgmma``) shared by the kernels
INCLUDE_DIRS = (Path(__file__).resolve().parent / "common",)

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


#: streaming multiprocessors of an H100 SXM, the default of the kernels'
#: launch plans
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_tma_aligned(what: str, **tensors) -> None:
    """TMA (and 16-byte cp.async) reads need each base address and each
    stride of a dimension longer than 1, other than the innermost, to be a
    multiple of 16 bytes.  Raises ``ValueError`` naming ``what`` and the
    tensor; a wrapper never copies an operand to make it so."""
    for name, x in tensors.items():
        nbytes = x.element_size()
        bad = [i for i in range(x.dim() - 1)
               if x.shape[i] > 1 and (x.stride(i) * nbytes) % 16]
        if x.data_ptr() % 16 or bad:
            raise ValueError(
                f"{name} is misaligned for {what}: base {x.data_ptr():#x}, "
                f"strides {x.stride()} (base and strides must be multiples "
                f"of 16 bytes)")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``PATH`` first, then the CUDA toolkit's own."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME_NVCC.exists():
        nvcc = str(CUDA_HOME_NVCC)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source and need the CUDA toolkit")
    return nvcc


def _build_inputs(source: Path) -> list:
    """The source, then every file beside it and under ``INCLUDE_DIRS``,
    in a fixed order: what a build of ``source`` can read."""
    files = [source]
    for root in (source.parent, *INCLUDE_DIRS):
        if root.is_dir():
            files += sorted(f for f in root.rglob("*")
                            if f.is_file() and f != source)
    return files


def _library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _build_inputs(source):
        h.update(b"\0" + f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build_log(source: Path) -> str:
    """What nvcc and ptxas reported while building ``source`` (registers,
    shared memory and spills of each kernel), or "" before the build."""
    log = _library_path(Path(source)).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_cuda_library(source: Path) -> Path:
    """Compile ``source`` into ``BUILD_DIR`` (skipped when a library for
    the same flags and input bytes exists) and return its path; nvcc's
    report goes beside it (:func:`build_log`).  A failed build raises
    ``RuntimeError`` carrying nvcc's stderr."""
    source = Path(source)
    out = _library_path(source)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent or cut-off
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        includes = [f"-I{d}" for d in INCLUDE_DIRS]
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, *includes, "-o", tmp, str(source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {source.name} "
                f"(exit {proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
