"""Build and load the port's CUDA kernels.

Each source ops/csrc/<name>.cu is compiled by nvcc for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into its own shared library
with a plain C interface, build/lib<name>.so at the repository root, and
loaded through ctypes.  Libraries are built at first use, from the
repository's sources only; `build()` starts one nvcc per source at once so
that a cold start pays for the slowest file, not the sum.  A library is
rebuilt when any csrc file is newer than it.  Processes that build at
once (ranks that start together) take turns on build/.lock, so one
compiles and the others find its libraries fresh; the lock is released
when its holder dies.  BRIEF_TPU_EXACT_SINE=1
builds separate `_exact` libraries with -DBRIEF_EXACT_SINE.

Host libraries (`host_library`, for native/rans.cpp) are built the same
way with the host compiler (g++ or c++, else nvcc as one) into the same
build/ directory.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only host has no nvcc.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from brief_pytorch_tpu_torch.ops.fast_math import exact_sine

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("fast_math", "fused_train", "fused_train_stream", "fused_decode",
           "fused_siren")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}{'_exact' if exact_sine() else ''}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return out.stat().st_mtime < newest


@contextlib.contextmanager
def _build_lock():
    """Hold build/.lock (an flock: released by the kernel if the holder
    dies, so no stale lock survives a killed build)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are missing or stale, all at once,
    under the build lock.

    Returns nvcc's output per source built (with -Xptxas -v: registers,
    shared memory and spills of each kernel); raises RuntimeError naming
    the source when nvcc fails."""
    with _build_lock():
        return _build(list(names))


def _build(names: List[str]) -> Dict[str, str]:
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        out = lib_path(name)
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if exact_sine():
            cmd.insert(1, "-DBRIEF_EXACT_SINE")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed.

    signatures: C function name -> ctypes argtypes; every function returns
    an int (a cudaError_t, or a count)."""
    key = str(lib_path(name))
    if key not in _LIBS:
        build([name])
        lib = ctypes.CDLL(key)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[key] = lib
    return _LIBS[key]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _host_compiler() -> Optional[List[str]]:
    for cc in ("g++", "c++", "clang++"):
        path = shutil.which(cc)
        if path:
            return [path, "-fPIC"]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if os.path.exists(nvcc):
        return [nvcc, "-Xcompiler", "-fPIC"]
    return None


def host_library(name: str, source: Path) -> Optional[Path]:
    """build/lib<name>.so compiled from a C++ `source` with a plain C
    interface, rebuilt when the source is newer; None when the machine has
    no host compiler.  A compiler that fails raises RuntimeError."""
    out = BUILD / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= source.stat().st_mtime:
        return out
    cc = _host_compiler()
    if cc is None:
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    proc = subprocess.run(cc + ["-O2", "-std=c++17", "-shared", "-o",
                                str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc[0]} failed for {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
