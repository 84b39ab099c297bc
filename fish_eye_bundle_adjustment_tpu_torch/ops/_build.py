"""Build and load the package's CUDA kernels (ops/csrc/*.cu).

``nvcc`` compiles the sources into one shared library with a plain C
interface, at first use, into ``ops/_build/`` (listed in .gitignore),
keyed by a hash of the sources and flags; ``ctypes`` loads it.  The
sources include no PyTorch header, so a build takes seconds.  The JAX
package builds its C++ parser the same way (io/native.py).

Nothing here runs at import: ``load()`` builds on the first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_SRC_DIR = Path(__file__).parent / "csrc"
_BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lib: Optional[ctypes.CDLL] = None
# what the last build printed (the ptxas register / shared-memory report);
# None when the library came from the cache
last_build_log: Optional[str] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fusedmv_abi_version": ([], _I),
    "fusedmv_error_string": ([_I], ctypes.c_char_p),
    "fusedmv_hpp_smem_bytes": ([_I], ctypes.c_size_t),
    "fusedmv_schur_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # acam apt rel imgrow sb fr er ib | G M T W n_pad n_img_pad ne ni |
    # hs de_part di_part de di stream
    "fusedmv_hpp_pass": ([_P] * 8 + [_I] * 8 + [_P] * 6, _I),
    # acam apt rel imgrow arows vpose vi hpi sb fr er ib | G M T W n_pad
    # n_img_pad ne ni with_v with_a with_precond p_rows i_rows | pose_part
    # iop_part out_y p21_part i55_part out_pose out_iop out_p21 out_i55 stream
    "fusedmv_schur_apply": ([_P] * 12 + [_I] * 13 + [_P] * 10, _I),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        shutil.which("nvcc"),
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(_SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"fusedmv-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists already."""
    global last_build_log
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builds are safe
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    last_build_log = proc.stdout + proc.stderr
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        if lib.fusedmv_abi_version() != 1:
            raise RuntimeError("fusedmv library ABI mismatch")
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().fusedmv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
