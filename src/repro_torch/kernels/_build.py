"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` source compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <name>-<hash>.so <name>.cu

into ``build/repro_torch_kernels/`` at the root of the checkout. The file
name carries a hash of the flags, of the ``.cu`` and of the headers it
includes with ``#include "..."``, so an edited source or header builds
anew, an unchanged one is loaded as it is, and editing one kernel's
source leaves the others' libraries alone. A build happens at first
use; :func:`build_all` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "build_all", "load", "build_dir", "kernel_function"]

_PKG = Path(__file__).resolve().parent
# name -> source, relative to the kernels package
KERNEL_SOURCES = {
    "gossip_schedule": "gossip_mix/csrc/gossip_schedule.cu",
    "gossip_mix": "gossip_mix/csrc/gossip_mix.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "rglru_scan": "rglru_scan/csrc/rglru_scan.cu",
    "auction": "auction/csrc/auction.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return _PKG.parents[2] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from source at first use"
    )


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(src: Path) -> list[Path]:
    """``src`` and every file it includes with ``#include "..."``, the
    includes' own includes too (resolved beside the including file)."""
    found, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for rel in _INCLUDE.findall(path.read_text()):
            todo.append((path.parent / rel).resolve())
    return found


def _digest(src: Path) -> str:
    """Hash of the flags, of ``src`` and of the files it includes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return digest.hexdigest()[:16]


def _target(name: str) -> tuple[Path, Path]:
    src = _PKG / KERNEL_SOURCES[name]
    return src, build_dir() / f"{name}-{_digest(src)}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    src, lib = _target(name)
    if lib.exists():
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp, lib


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, lib = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n{err}{out}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file


def build_all() -> None:
    """Build every kernel library that is not built yet, all nvcc at once."""
    with _lock:
        jobs = {name: _start(name) for name in KERNEL_SOURCES}
        errors = []
        for name, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(name, job)
            except RuntimeError as exc:  # wait for every nvcc before raising
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_target(name)[1]))
            _loaded[name] = lib
        return lib


_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def kernel_function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel ``name``, typed: ``argtypes``
    as given, an ``int`` (the launch's ``cudaError_t``) returned."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn
