"""The port's XXH3-64 (``csrc/xxh3.c``), built with the host's C compiler at
first import into ``build/`` next to this file (listed in ``.gitignore``)
and loaded with ``ctypes``, as ``ops/kernels/_build.py`` builds and loads
the kernels. The library's name carries a hash of the source and flags, so
an edited source rebuilds; a compile writes a temporary file and renames it,
so concurrent importers see the old library or the new one, never half.

The compiler is ``$CC`` when set, else ``cc`` or ``gcc`` on ``PATH``. When
the library cannot be built or loaded, the import raises: block hashes cross
into KV events and the router, so there is no slower or different fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "xxh3.c"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CFLAGS = ("-O2", "-std=c99", "-shared", "-fPIC")


class HashBuildError(RuntimeError):
    pass


def compiler() -> str:
    found = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not found:
        raise HashBuildError("no C compiler for csrc/xxh3.c (set CC or put cc / gcc on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libxxh3-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([compiler(), *CFLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise HashBuildError(f"building {SOURCE.name} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.xxh3_64.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64]
    lib.xxh3_64.restype = ctypes.c_uint64
    lib.xxh3_token_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.xxh3_token_blocks.restype = ctypes.c_int
    return lib


_lib = _load()


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3-64 of ``data`` (``xxhash.xxh3_64_intdigest(data, seed=seed)``)."""
    return _lib.xxh3_64(data, len(data), seed & 0xFFFFFFFFFFFFFFFF)


def token_blocks(tokens: np.ndarray, block_size: int, salt: int, seed: int,
                 parent: int | None) -> tuple[np.ndarray, np.ndarray]:
    """(block hashes, chained sequence hashes), uint64 each, of the full
    blocks of ``tokens`` (uint32, a multiple of ``block_size`` long) in one
    foreign call; ``parent`` is the sequence hash the first block chains to
    (None: it starts the chain, and a nonzero ``salt`` is prefixed to its
    bytes as a little-endian u64)."""
    tokens = np.ascontiguousarray(tokens, dtype="<u4")
    n = len(tokens) // block_size
    block = np.empty(n, np.uint64)
    seq = np.empty(n, np.uint64)
    if n:
        err = _lib.xxh3_token_blocks(
            tokens.ctypes.data, n, block_size, salt & 0xFFFFFFFFFFFFFFFF, seed & 0xFFFFFFFFFFFFFFFF,
            0 if parent is None else parent, parent is not None, block.ctypes.data, seq.ctypes.data,
        )
        if err:
            raise MemoryError("xxh3_token_blocks: allocation failed")
    return block, seq
