"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with nvcc into ``_build/lib<name>-<hash>.so`` (``sm_90a``), at first use.
The hash is that of the source and of the headers beside it
(``csrc/*.cuh``), so an edited source or header never loads a stale
library. A host source ``csrc/<name>.cpp`` (the JPEG decoder's entropy
stage) builds the same way with the host compiler, hashed alone.
Nothing is built or loaded when a module is imported: the CPU tests
import every module and this machine need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("fused_mean_cov", "fused_mean_cov_backward",
           "furthest_point_sample", "streaming_sample_mean_var",
           "streaming_sample_mean_var_backward")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# compiler messages (ptxas register/shared-memory report) and build
# seconds of the libraries this process built
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _cxx() -> str:
    for cand in ("c++", "g++"):
        found = shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) found")


def _source(name: str) -> str:
    """``csrc/<name>.cu``, else the host source ``csrc/<name>.cpp``."""
    cu = os.path.join(CSRC, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC, f"{name}.cpp")


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    src = _source(name)
    headers = (sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
               if src.endswith(".cu") else [])
    for fname in [os.path.basename(src)] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    src = _source(name)
    compiler = ([_nvcc(), *NVCC_FLAGS] if src.endswith(".cu")
                else [_cxx(), *CXX_FLAGS])
    cmd = [*compiler, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def build(names: Iterable[str] = KERNELS) -> None:
    """Compile every missing library, one compiler per source, all at
    once."""
    started = {n: _start(n) for n in names}
    errors = []
    for name, job in started.items():
        if job is None:
            continue
        proc, tmp, out, t0 = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(_source(name))} failed to "
                          f"build:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders race safely
        BUILD_LOG[name] = (time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (or ``.cpp``), built first if
    needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _LOADED[name] = lib
        return lib
