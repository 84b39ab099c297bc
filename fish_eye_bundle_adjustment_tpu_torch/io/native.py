"""ctypes bindings for the native IO library (native/feba_io.cpp).

The shared library is compiled on demand with the system C++ toolchain and
cached inside the package (keyed by a source hash), so `pip install -e .`
needs no build step and the pure-Python parsers remain the fallback when no
toolchain is available.  Disable with FEBA_NATIVE=0.

The native parser returns ID columns already *interned* (int32 codes into a
first-appearance-ordered unique table) — exactly the factorized form the
problem-assembly join (io/problem.py) consumes, so at benchmark scale
(~1M-row .pho) parse+join drops from seconds of Python-loop time to tens of
milliseconds of C++.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "feba_io.cpp"
_CACHE_DIR = _SRC.parent / "_cache"

_lib = None
_lib_failed = False


class _PhoResult(ctypes.Structure):
    _fields_ = [
        ("n_obs", ctypes.c_int64),
        ("n_targets", ctypes.c_int64),
        ("n_images", ctypes.c_int64),
        ("xy", ctypes.POINTER(ctypes.c_double)),
        ("tgt_idx", ctypes.POINTER(ctypes.c_int32)),
        ("img_idx", ctypes.POINTER(ctypes.c_int32)),
        ("target_blob", ctypes.c_char_p),
        ("target_blob_len", ctypes.c_int64),
        ("image_blob", ctypes.c_char_p),
        ("image_blob_len", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


class _TableResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_unique", ctypes.c_int64),
        ("id_idx", ctypes.POINTER(ctypes.c_int32)),
        ("id_blob", ctypes.c_char_p),
        ("id_blob_len", ctypes.c_int64),
        ("vals", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
    ]


class NativeError(RuntimeError):
    """Parse error reported by the native library."""


def _compile() -> Optional[Path]:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    so_path = _CACHE_DIR / f"feba_io-{tag}.so"
    if so_path.exists():
        return so_path
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temp name + atomic rename (concurrent-safe)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_CACHE_DIR)
    os.close(fd)
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-o",
        tmp,
        str(_SRC),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if os.environ.get("FEBA_NATIVE", "1") == "0":
        _lib_failed = True
        return None
    so = _compile()
    if so is None:
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        _lib_failed = True
        return None
    lib.feba_parse_pho.restype = ctypes.POINTER(_PhoResult)
    lib.feba_parse_pho.argtypes = [ctypes.c_char_p]
    lib.feba_free_pho.argtypes = [ctypes.POINTER(_PhoResult)]
    lib.feba_parse_idtable.restype = ctypes.POINTER(_TableResult)
    lib.feba_parse_idtable.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.feba_free_table.argtypes = [ctypes.POINTER(_TableResult)]
    lib.feba_abi_version.restype = ctypes.c_int32
    if lib.feba_abi_version() != 1:
        _lib_failed = True
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _split_blob(blob: bytes) -> List[str]:
    if not blob:
        return []
    return blob.decode("utf-8").rstrip("\n").split("\n")


def _copy(ptr, n, dtype):
    if n == 0:
        return np.empty(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def parse_pho(path) -> Tuple[List[str], List[str], np.ndarray, np.ndarray, np.ndarray]:
    """-> (uniq_targets, uniq_images, tgt_codes, img_codes, xy).

    Raises NativeError on parse failure, RuntimeError if the library is
    unavailable (callers should check available() first)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    res = lib.feba_parse_pho(str(path).encode())
    if not res:
        raise NativeError(f"{path}: native parser out of memory")
    try:
        r = res.contents
        if r.error:
            raise NativeError(f"{path}: {r.error.decode()}")
        n = int(r.n_obs)
        xy = _copy(r.xy, 2 * n, np.float64).reshape(n, 2)
        tgt = _copy(r.tgt_idx, n, np.int32)
        img = _copy(r.img_idx, n, np.int32)
        uniq_t = _split_blob(ctypes.string_at(r.target_blob, r.target_blob_len))
        uniq_i = _split_blob(ctypes.string_at(r.image_blob, r.image_blob_len))
        return uniq_t, uniq_i, tgt, img, xy
    finally:
        lib.feba_free_pho(res)


def parse_idtable(path, n_num: int) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """-> (uniq_ids, id_codes, vals (n_rows, n_num)) for `id v1..vK` tables
    (.cnt / .cze)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    res = lib.feba_parse_idtable(str(path).encode(), n_num)
    if not res:
        raise NativeError(f"{path}: native parser out of memory")
    try:
        r = res.contents
        if r.error:
            raise NativeError(f"{path}: {r.error.decode()}")
        n = int(r.n_rows)
        vals = _copy(r.vals, n * n_num, np.float64).reshape(n, n_num)
        codes = _copy(r.id_idx, n, np.int32)
        uniq = _split_blob(ctypes.string_at(r.id_blob, r.id_blob_len))
        return uniq, codes, vals
    finally:
        lib.feba_free_table(res)


if __name__ == "__main__":  # `python -m ...io.native` prebuilds the library
    print("native IO:", "available" if available() else "UNAVAILABLE")
