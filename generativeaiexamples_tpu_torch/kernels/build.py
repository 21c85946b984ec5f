"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
Libraries land in ``generativeaiexamples_tpu_torch/build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing here runs at
import time: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"

# Kernel name -> source file under csrc/.
SOURCES = {"paged_attention": "paged_attention.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output of the library's build (``-Xptxas -v``:
    registers, shared memory and spills per kernel), or "" if none."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[list[str]] = None) -> dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns seconds per kernel compiled."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    with _lock:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            log = open(out.with_suffix(".log"), "w")
            procs[name] = (subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / SOURCES[name])],
                stdout=log, stderr=subprocess.STDOUT), tmp, out, log,
                time.monotonic())
        took = {}
        failed = []
        for name, (proc, tmp, out, log, t0) in procs.items():
            rc = proc.wait()
            log.close()
            took[name] = time.monotonic() - t0
            if rc != 0:
                failed.append(f"{name} (nvcc exit {rc}):\n{build_log(name)}")
                continue
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib
