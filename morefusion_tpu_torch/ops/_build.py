"""Build and load the port's CUDA kernels: plain ``nvcc`` + ``ctypes``.

Every ``.cu`` under ``csrc/`` exposes an ``extern "C"`` launcher, so each
is compiled to an object (one ``nvcc`` a source, all started together) and
the objects are linked into one shared library with a plain C interface
and no PyTorch headers (seconds, where an extension that includes
``torch/extension.h`` takes minutes). The library is built at first use
into ``_build/`` beside the package and rebuilt when a source is newer
than it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libmfk.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: each source to an object
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
#: the objects into the library
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_LOCK = threading.Lock()
_LIB = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build(ptxas_verbose: bool = False):
    """Compile every source to an object, one ``nvcc`` a source, all
    started together, then link the objects into ``LIB_PATH``.

    Returns ``(seconds, the compilers' output)``; raises ``RuntimeError``
    carrying a compiler's output on failure.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    verbose = ["-Xptxas", "-v"] if ptxas_verbose else []
    objs = [os.path.join(work, src.stem + ".o") for src in sources()]
    cmds = [[nvcc(), *COMPILE_FLAGS, *verbose, "-c", "-o", obj, str(src)]
            for obj, src in zip(objs, sources())]
    tmp = os.path.join(work, LIB_PATH.name)
    link = [nvcc(), *LINK_FLAGS, "-o", tmp, *objs]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(cmds)) as pool:
            out = "".join(pool.map(_run, cmds))
        _run(link)
        os.replace(tmp, LIB_PATH)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return time.perf_counter() - t0, out


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources())


def load():
    """The kernel library (built first if missing or stale)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.mfk_min_dist_splits.argtypes = [i32] * 6
            lib.mfk_min_dist_splits.restype = i32
            lib.mfk_min_dist.argtypes = [
                ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr,
                ptr, i32, ptr,
            ]
            lib.mfk_min_dist.restype = i32
            lib.mfk_knn.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr, i32, ptr]
            lib.mfk_knn.restype = i32
            lib.mfk_error_string.argtypes = [i32]
            lib.mfk_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mfk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
