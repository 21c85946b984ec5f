"""ctypes loader for the native top-k kernels, compiled on demand — a copy
of the reference package's ``retrieval/native/`` loader.

The first call compiles ``topk.cpp`` (a CPU kernel: OpenMP over queries,
a bounded heap per query) with g++ into the git-ignored
``generativeaiexamples_tpu_torch/build/``, named by a hash of the source
and the flags, never next to the source; a library already built there
is reused. Without a toolchain the callers fall back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "topk.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libgaietopk-{digest[:16]}.so"


def _compile(lib: Path) -> bool:
    # Built under a private name, then moved into place: processes that
    # compile at once never load a half-written file.
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        logger.info("native topk unavailable (%s); using numpy fallback", exc)
        return False


def load() -> Optional[ctypes.CDLL]:
    """The library, compiling it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _compile(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            # A foreign-arch binary (a build directory copied between
            # hosts): rebuild once before giving up.
            if not _compile(path):
                return None
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                logger.info("native topk load failed: %s", exc)
                return None
        lib.gaie_brute_topk.argtypes = [
            _f32p, ctypes.c_void_p, ctypes.c_void_p, _i64, _i64,
            _f32p, _i64, _i64, ctypes.c_int, _i64p, _f32p]
        lib.gaie_ivf_search.argtypes = [
            _f32p, ctypes.c_void_p, ctypes.c_void_p, _i64,
            _f32p, _i64, _i64p, _i64p,
            _f32p, _i64, _i64, _i64, ctypes.c_int, _i64p, _f32p]
        lib.gaie_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def _opt(arr: Optional[np.ndarray]) -> Optional[ctypes.c_void_p]:
    if arr is None:
        return None
    return arr.ctypes.data_as(ctypes.c_void_p)


def brute_topk(base: np.ndarray, queries: np.ndarray, k: int, metric: int,
               base_sq: Optional[np.ndarray] = None,
               live: Optional[np.ndarray] = None,
               ) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(idx, score) each (Q, k), or None when the native lib is unavailable."""
    lib = load()
    if lib is None:
        return None
    nq, n = queries.shape[0], base.shape[0]
    idx = np.empty((nq, k), np.int64)
    score = np.empty((nq, k), np.float32)
    lib.gaie_brute_topk(base, _opt(base_sq), _opt(live), n, base.shape[1],
                        queries, nq, k, metric, idx, score)
    return idx, score


def ivf_search(base: np.ndarray, centroids: np.ndarray, offsets: np.ndarray,
               items: np.ndarray, queries: np.ndarray, k: int, nprobe: int,
               metric: int, base_sq: Optional[np.ndarray] = None,
               live: Optional[np.ndarray] = None,
               ) -> Optional[tuple[np.ndarray, np.ndarray]]:
    lib = load()
    if lib is None:
        return None
    nq = queries.shape[0]
    idx = np.empty((nq, k), np.int64)
    score = np.empty((nq, k), np.float32)
    lib.gaie_ivf_search(base, _opt(base_sq), _opt(live), base.shape[1],
                        centroids, centroids.shape[0], offsets, items,
                        queries, nq, k, nprobe, metric, idx, score)
    return idx, score
