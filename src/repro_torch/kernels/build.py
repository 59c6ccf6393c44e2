"""Build and load the hand-written CUDA kernels in ``kernels/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with :mod:`ctypes`; no PyTorch header
is compiled, so a build takes seconds.  Libraries go to ``kernels/_build``
(never committed), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one is reused.  Nothing is built at import: the first launch
of a kernel builds it, or a caller builds all of them up front with
:func:`build` (one ``nvcc`` per source, all started together).  Threads of
one process that first launch the same kernel together (two serving lanes)
build and load it once: :func:`library` holds a lock, and each build
writes a temporary file named by its process and thread.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: every kernel source of the package
SOURCES = ("postings", "level_step", "cooccur", "dot_interaction",
           "flash_decode", "row_topk")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built at first use on a CUDA "
                           "host")
    return str(path)


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    of every shared header (``csrc/*.cuh``) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all running at once.  Returns each compiled source's
    ``nvcc``/``ptxas`` log (registers, shared memory, spills); raises
    with the log of every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    logs: Dict[str, str] = {}
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            # a rebuildable cache, not durable data: the rename only keeps a
            # concurrent loader from seeing a half-written library
            os.replace(tmp, out)  # cooclint: disable=COOC001 -- build cache
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed;
    one build and one handle however many threads ask at once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
