"""ctypes bindings for the native (C++) host library.

The port of the JAX package's ``native.py``: the LBVH radix tree and Morton
sort of ``csrc/lbvh.cpp`` and the PIZ Huffman decode of ``csrc/piz.cpp``
(the port's own copies), compiled with g++ into one shared library. These
are host helpers, not kernels: every entry point returns None where the
library cannot be built (no compiler), and its callers fall back to their
numpy or Python code, which gives the same results.

The library is built at first use into ``build/`` beside this file, with
the JAX package's Makefile flags, named by a hash of the sources, the flags
and the CPU that ``-march=native`` resolves to, so a checkout that moves to
another machine builds its own. ``python -m unityraytracer_tpu_torch.native``
builds it and prints the result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("lbvh.cpp", "piz.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-Wall"]

_lib = None
_load_failed = False
BUILD_LOG = ""


def _cxx() -> Optional[str]:
    return shutil.which("g++")


def _target(cxx: str) -> str:
    """The CPU ``-march=native`` selects here (g++'s resolved -march)."""
    res = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60)
    for ln in res.stdout.splitlines():
        if ln.strip().startswith("-march="):
            return ln.split("=", 1)[1].strip()
    return "unknown"


def library_path(cxx: str) -> Path:
    """Where the library for the current sources, flags and CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + [_target(cxx)]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"liburt_native_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> bool:
    """Compile the library unless the one for these sources exists; load
    it. Returns success (False where there is no g++ or it fails)."""
    global BUILD_LOG, _lib, _load_failed
    cxx = _cxx()
    if cxx is None:
        BUILD_LOG = "g++ not found"
        return False
    path = library_path(cxx)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        res = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp),
             *(str(CSRC / s) for s in SOURCES)],
            capture_output=True, text=True, timeout=600)
        BUILD_LOG = res.stdout + res.stderr
        if verbose or res.returncode != 0:
            sys.stderr.write(BUILD_LOG)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, path)       # atomic: a concurrent build loads either
    _lib, _load_failed = _bind(ctypes.CDLL(str(path))), False
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.urt_radix_tree.argtypes = [p, i64, p, p]
    lib.urt_morton_sort.argtypes = [p, i64, p, p]
    lib.urt_huf_decode.argtypes = [p, i64, i64, p, ctypes.c_int32, p, i64]
    for fn in (lib.urt_radix_tree, lib.urt_morton_sort, lib.urt_huf_decode):
        fn.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None where it cannot be."""
    global _load_failed, BUILD_LOG
    if _lib is None and not _load_failed:
        try:
            ok = build()
        except (OSError, subprocess.SubprocessError) as e:
            BUILD_LOG, ok = f"{type(e).__name__}: {e}", False
        _load_failed = not ok
    return _lib


def available() -> bool:
    return _load() is not None


def radix_tree(keys_sorted: np.ndarray
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Karras radix tree over sorted unique uint64 keys: (left, right) int32
    arrays of length C-1 (child >= C-1 is leaf child - (C-1)), or None
    where the library is unavailable (the caller builds it in numpy)."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys_sorted, np.uint64)
    n = len(keys)
    if n < 2:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    left = np.empty(n - 1, np.int32)
    right = np.empty(n - 1, np.int32)
    if lib.urt_radix_tree(keys.ctypes.data, n, left.ctypes.data,
                          right.ctypes.data) != 0:
        return None
    return left, right


def morton_sort(points01: np.ndarray
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """30-bit Morton codes and their stable argsort for (N, 3) points in
    [0, 1]^3, or None where the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points01, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points of shape {pts.shape}, expected (N, 3)")
    n = len(pts)
    codes = np.empty(n, np.uint64)
    order = np.empty(n, np.int64)
    if lib.urt_morton_sort(pts.ctypes.data, n, codes.ctypes.data,
                           order.ctypes.data) != 0:
        return None
    return codes, order


def huf_decode(blob: bytes, pos: int, n_bits: int, lengths: np.ndarray,
               rlc: int, n_out: int) -> Optional[np.ndarray]:
    """Canonical-Huffman decode of an EXR PIZ symbol stream: ``n_out``
    uint16 symbols from the ``n_bits`` bits at byte ``pos`` of ``blob``, or
    None where the library is unavailable (``models/piz.py`` then decodes
    in Python). Raises ValueError on a corrupt stream."""
    lib = _load()
    if lib is None:
        return None
    lens = np.ascontiguousarray(lengths, np.int32)
    if lens.shape != (65537,):
        raise ValueError(f"code-length table of shape {lens.shape}, "
                         "expected (65537,)")
    if not 0 <= pos <= len(blob) or not 0 <= n_bits <= (len(blob) - pos) * 8:
        raise ValueError("huffman bit range outside the blob")
    data = np.frombuffer(blob, np.uint8)
    out = np.empty(n_out, np.uint16)
    rc = lib.urt_huf_decode(data.ctypes.data, int(pos), int(n_bits),
                            lens.ctypes.data, int(rlc), out.ctypes.data,
                            int(n_out))
    if rc != 0:
        raise ValueError(f"corrupt huffman stream (native rc={rc})")
    return out


if __name__ == "__main__":
    ok = build(verbose=True)
    print(f"native build: {'ok' if ok else 'FAILED'}; available={available()}")
