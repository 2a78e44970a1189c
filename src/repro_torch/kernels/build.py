"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source under ``csrc/`` builds at first use into
``<repo>/build/repro_torch_kernels/lib<name>_<hash>.so``, the hash taken
over the source and the flags, so an edited source never loads a stale
library. ``build_all`` starts one ``nvcc`` per source at once. The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept beside each library as ``<name>_<hash>.log``.
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
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bsr_spmm",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# wall seconds of each nvcc run made by this process (absent: prebuilt)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels build on a machine with the "
                           "CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    hsh = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    hsh.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{hsh.hexdigest()[:12]}.so"


def _start(name: str):
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc, time.perf_counter()


def _finish(name: str, out: Path, tmp: Path, proc, t0: float) -> Path:
    log, _ = proc.communicate()
    out.with_name(out.name[3:-3] + ".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log[-6000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_seconds[name] = time.perf_counter() - t0
    return out


def build_all() -> Dict[str, Path]:
    """Build every missing library, one ``nvcc`` per source, all started
    together; returns {name: library path}."""
    with _lock:
        todo = [n for n in SOURCES if not library_path(n).exists()]
        running = {n: _start(n) for n in todo}
        for n, job in running.items():
            _finish(n, *job)
    return {n: library_path(n) for n in SOURCES}


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the last build of ``name`` ('' when the
    library was built by another process without a log)."""
    out = library_path(name)
    log = out.with_name(out.name[3:-3] + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing); ``declare``
    sets its functions' argtypes/restype once, at load."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            declare(lib)
            _libs[name] = lib
    return lib
