"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>.so`` beside this file, for ``sm_90a`` (Hopper).  A
library is built at first use and rebuilt when its source is newer than
it; :func:`build_all` starts one ``nvcc`` per source, all at once.  Nothing
here runs at import time: the CPU-only test environment has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
from ctypes import POINTER, c_char_p, c_int, c_int64, c_void_p
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("bloom", "merge", "attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C interface of each library: function -> (argtypes, restype)
SIGNATURES = {
    "bloom": {
        "bloom_probe_launch": ([c_void_p, c_int64, c_void_p, c_int64, c_int,
                                c_void_p, c_int, c_void_p], c_int),
        "bloom_smem_optin": ([c_int, POINTER(c_int)], c_int),
        "bloom_build_launch": ([c_void_p, c_int64, c_void_p, c_int64, c_int,
                                c_int64, c_int, c_int, c_int, c_int64,
                                c_void_p, c_void_p, c_void_p], c_int),
        "bloom_error_string": ([c_int], c_char_p),
    },
    "merge": {
        "merge_pair_launch": ([c_void_p, c_int64, c_void_p, c_int64,
                               c_void_p, c_void_p, c_void_p, c_void_p],
                              c_int),
        "merge_tile_size": ([], c_int),
        "merge_error_string": ([c_int], c_char_p),
    },
    "attention": {
        "flash_attention_launch": ([c_void_p] * 4 + [c_int] * 9 + [c_void_p],
                                   c_int),
        "paged_attention_launch": ([c_void_p] * 8 + [c_int] * 9 + [c_void_p],
                                   c_int),
        "attention_error_string": ([c_int], c_char_p),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# held by every launch-count update and reset: the store's kernels also
# launch from the compaction scheduler's worker threads
COUNT_LOCK = threading.Lock()
# the compiler's register/spill report per source, from the last build
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the repro_torch CUDA kernels")
    return found


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build_all(force: bool = False) -> List[str]:
    """Compile every stale source in parallel; returns the names built.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    names = [n for n in SOURCES if force or _stale(n)]
    if not names:
        return []
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for n in names:
        tmp = BUILD / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        build_logs[n] = out
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def check(name: str, rc: int, what: str) -> None:
    """Raise if a launcher of library ``name`` returned a non-zero
    ``cudaError_t``."""
    if rc != 0:
        msg = getattr(_libs[name], f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
