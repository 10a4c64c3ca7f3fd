"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/repro_torch/<hash>/lib<name>.so csrc/<name>.cu

at first use, from the sources in this checkout only, into
``build/repro_torch/`` at the repository root (listed in ``.gitignore``).
The directory is keyed by a hash of every file under ``csrc/`` and of the
flags, so an edited source rebuilds and an unchanged one loads at once.
All missing libraries are compiled in parallel, one nvcc per source,
under an exclusive lock on ``build/repro_torch/.lock`` (``fcntl``), so
processes that start together (a multi-process fit's coordinator and its
workers, two test runs) never run nvcc into one directory at once: the
first compiles, the others wait and then find the libraries built. A
worker process of a multi-process fit only loads (``load_all``): its
coordinator built before it spawned it, and a library that is missing
then is an error, never a fallback.

No ``--use_fast_math``: the Gumbel noise needs ``logf``, not ``__logf``.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sweep_gauss", "suffstats_labels", "sweep_linear",
           "moments_labels", "loglik_gauss", "assign_gauss", "assign_linear",
           "matmul", "sub_assign_gauss", "sub_assign_linear",
           "fold_partials", "suffstats_dense")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[str, object] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$PATH``, then ``$CUDA_HOME``, then the
    toolkit's default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@contextlib.contextmanager
def _build_lock():
    """An exclusive ``fcntl`` lock on ``BUILD_ROOT/.lock`` for the block."""
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def missing(names: Sequence[str] = SOURCES) -> list:
    """The libraries of ``names`` not built yet."""
    out = build_dir()
    return [n for n in names if not (out / f"lib{n}.so").is_file()]


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all in
    parallel, under the build lock. Returns the seconds each compile took
    (empty when all were built). nvcc's ``-Xptxas -v`` report (registers,
    shared memory, spills) is kept beside each library as
    ``lib<name>.log``."""
    if not missing(names):
        return {}
    with _build_lock():
        return _compile(missing(names))


def _compile(todo: Sequence[str]) -> Dict[str, float]:
    if not todo:
        return {}
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = tempfile.NamedTemporaryFile(dir=out, suffix=".so", delete=False)
        tmp.close()
        cmd = [exe, *NVCC_FLAGS, "-o", tmp.name, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out / f"lib{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def ptxas_report(name: str) -> Optional[str]:
    path = build_dir() / f"lib{name}.log"
    return path.read_text() if path.is_file() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
        _loaded[name] = lib
    return lib


def load_all() -> None:
    """Load every library, and raise if one is not built: a worker process
    of a multi-process fit only loads what its coordinator built."""
    if missing():
        raise RuntimeError(
            f"CUDA kernels {missing()} are not built in {build_dir()}: "
            "a worker process only loads the kernels its coordinator built")
    for name in SOURCES:
        load(name)


def c_function(name: str, symbol: str, signature: str):
    """``symbol`` of library ``name`` with its ctypes signature: one letter
    per argument, ``p`` for a pointer or the stream (``c_void_p``), ``i``
    for an int (``c_int``) and ``l`` for a 64-bit int (``c_longlong``).
    The C function returns its ``cudaGetLastError()``; the returned
    callable raises when that is not 0, so a refused launch never passes
    silently."""
    key = f"{name}:{symbol}"
    if key in _functions:
        return _functions[key]
    lib = load(name)
    fn = getattr(lib, symbol)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "l": ctypes.c_longlong}
    fn.argtypes = [kinds[c] for c in signature]
    fn.restype = ctypes.c_int
    err_str = lib.repro_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p

    def call(*args):
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{symbol}: CUDA error {code} "
                               f"({err_str(code).decode()})")
    _functions[key] = call
    return call
