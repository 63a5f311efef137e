"""Build and load the port's CUDA kernels: plain ``nvcc`` + ``ctypes``.

Every ``.cu`` under ``csrc/`` exposes an ``extern "C"`` launcher, so each
is compiled to an object (one ``nvcc`` a source, all started together) and
the objects are linked into one shared library with a plain C interface
and no PyTorch headers (seconds, where an extension that includes
``torch/extension.h`` takes minutes). The library is built at first use
into ``_build/`` beside the package and rebuilt when a source is newer
than it.

This module is the one launch path. Each ``ops/<k>.py`` declares its
launchers' C signatures as :class:`Kernel` handles beside their only
caller, and its public function runs the kernel for CUDA tensors and the
plain version for CPU tensors (:func:`on_card`). The caller allocates the
outputs; a launch runs on the current stream of the tensors' device without
synchronising and raises on a CUDA error. Each public function counts its
launches in its ``launches`` attribute.
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

import torch

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
            _LIB = ctypes.CDLL(str(LIB_PATH))
        return _LIB


class Kernel:
    """A function of the library: its name and its C parameters' ctypes,
    the trailing ``int device, void* stream`` of a launcher included.

    Nothing is built or loaded until the first call, which loads the
    library and sets the function's ``argtypes`` and ``restype``.
    """

    def __init__(self, name, argtypes, restype=ctypes.c_int):
        self.name = name
        self.argtypes = tuple(argtypes)
        self.restype = restype
        self._fn = None

    def function(self):
        """The library's function, its types set."""
        if self._fn is None:
            fn = getattr(load(), self.name)
            fn.argtypes = self.argtypes
            fn.restype = self.restype
            self._fn = fn
        return self._fn

    def __call__(self, device, *args):
        """Launch with ``args``, then ``device``'s index and its current
        stream; raise if the launcher returns a CUDA error."""
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self.function()(*args, device.index, stream)
        if err != 0:
            msg = _ERROR_STRING.function()(err).decode()
            raise RuntimeError(f"{self.name} launch: CUDA error {err} "
                               f"({msg})")


_ERROR_STRING = Kernel("mfk_error_string", [ctypes.c_int], ctypes.c_char_p)


def on_card(t, kernel: str) -> bool:
    """Whether the kernel runs for ``t``: True on ``cuda``, False on
    ``cpu`` (the plain version runs); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no {kernel} kernel for device {t.device}")
    return False
