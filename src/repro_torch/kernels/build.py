"""Build and bind the port's CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` is compiled on first use by ``nvcc`` into
a shared library with a plain C interface under ``build/kernels/`` at the
repository root, and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). The library's file name carries a digest of the source, of
every shared header (``csrc/*.cuh``) and of the flags, so an edited source or
header is rebuilt and a stale library is never loaded; headers are never
build targets themselves. Every C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :class:`CudaKernel` raises when
that is not 0 and counts the launches that went through. Loading and counting
are thread-safe: a serving thread and its caller may reach a kernel first at
the same time, and one ``nvcc`` build and one ``dlopen`` serve both.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["CudaKernel", "build_all", "kernel_names", "library_path", "BUILD_DIR",
           "CSRC_DIR", "NVCC_FLAGS"]

CSRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# sm_90a: Hopper's full instruction set. IEEE float arithmetic throughout
# (no --use_fast_math): the hash kernel's floor() must see the same rounding
# as the reference.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                           "the CUDA kernels need the CUDA toolkit")
    return found


def kernel_names() -> list:
    """The build targets: one library per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file beside the target
    (renamed into place on success, so concurrent processes never load a
    half-written library). Returns (target, tmp, process), process None when
    the library is already built."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, out, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names=None) -> float:
    """Compile every kernel source (or ``names``) with one nvcc per source,
    all started together. Returns the wall seconds it took."""
    names = kernel_names() if names is None else names
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    for n, out, tmp, proc in started:
        _finish(n, out, tmp, proc)
    return time.perf_counter() - t0


# serializes first loads: the build directory and the libraries are shared
# by every kernel object of the process
_LOAD_LOCK = threading.Lock()


class CudaKernel:
    """One C entry point of one kernel library, loaded on first call.

    ``launches`` counts the calls that launched the kernel (status 0); the
    kernels' ``ops`` wrappers call this only for CUDA tensors."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None
        self._count_lock = threading.Lock()

    def _load(self):
        build_all([self.name])
        self._lib = ctypes.CDLL(str(library_path(self.name)))
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = self._lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn = fn               # set last: a reader outside the lock sees it whole

    def __call__(self, *args) -> None:
        if self._fn is None:
            with _LOAD_LOCK:
                if self._fn is None:
                    self._load()
        status = self._fn(*args)
        if status != 0:
            msg = self._lib.kernel_error_string(status).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{status} ({msg})")
        with self._count_lock:
            self.launches += 1
