"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout, and loaded with
``ctypes``; :func:`bind` gives a wrapper one of its C functions with the
signature bound once, and :func:`launch_target` the device and stream a
launch goes to, without building any Python object. The library name
carries a hash of its source and of every
header under ``csrc/`` that the source includes (``#include "..."``,
followed through headers), so an edited source or header is rebuilt and
a stale library is never loaded. Nothing here runs
at import time: the CPU tests import every module of the package on a
host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "kernels"

# kernel library name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "row_gather": "row_gather.cu",
    "row_scatter_add": "row_scatter_add.cu",
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 = found built)
BUILD_SECONDS: Dict[str, float] = {}
# ptxas register / shared-memory report of each build
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> List[Path]:
    """The source of library ``name`` and the local headers it includes,
    directly or through another header, in the order first reached."""
    files: List[Path] = []
    todo = [_PKG / "csrc" / SOURCES[name]]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _compile_cmd(name: str, out: Path):
    src = _PKG / "csrc" / SOURCES[name]
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(src)]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    seconds each build took. Raises on the first failed build."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        procs[name] = (subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_SECONDS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


_bound: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def bind(name: str, symbol: str, argtypes: Sequence[type]):
    """The C function ``symbol`` of library ``name`` (built and loaded
    first if needed) with its argument types bound once and an ``int``
    result: every C entry of the port returns a CUDA error code."""
    fn = _bound.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _bound[(name, symbol)] = fn
    return fn


def launch_target(t: torch.Tensor) -> Tuple[int, int]:
    """``(device ordinal, raw handle of PyTorch's current stream there)``
    for a launch on ``t``'s card. The C entry takes the ordinal and makes
    that device current only when it is not (``csrc/launch.cuh``), so the
    wrapper needs no ``torch.cuda.device`` context and builds no
    ``torch.cuda.Stream`` object."""
    dev = t.get_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
