"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use,
one ``nvcc`` process per source:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``build/`` next to this file (listed in ``.gitignore``), under a name
that carries a hash of the sources and flags, so an edited source rebuilds.
The library is loaded with ``ctypes`` and each entry point's argument types
are bound once (:func:`entry`); pointers and the stream are passed as
``c_void_p``. Every C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` raises when that is not 0. A failed build raises.

``nvcc`` is found through ``CUDA_HOME`` (or ``CUDA_PATH``), else on ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or would be) built: the
    name carries a hash of the sources and flags."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every named source that has no up-to-date library, all nvcc
    processes started together. Raises KernelBuildError when any compile
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{stdout}{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees old or new, never half
    if failed:
        raise KernelBuildError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = library_path(name)
            if not out.exists():
                build([name])
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with its argument
    types bound and an int return, built and loaded on first use."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def aligned16(x):
    """``x`` contiguous with a 16-byte aligned data pointer (the kernels load
    rows as 16-byte vectors), copied only when it is not already."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def check(err: int, what: str, refused: str | None = None) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` code returned by a launch.
    An entry point that refuses its shapes returns ``cudaErrorInvalidValue``
    without launching; with ``refused`` (why it would), that code raises
    ValueError with that reason."""
    if err == CUDA_ERROR_INVALID_VALUE and refused:
        raise ValueError(f"{what}: {refused}")
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err} at launch")
