"""Build and load the package's CUDA kernels (ops/csrc/*.cu).

``nvcc`` compiles each source to an object, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, at first use, into ``ops/_build/`` (listed in
.gitignore), keyed by a hash of the sources and flags; ``ctypes`` loads
it.  The sources include no PyTorch header, so a build takes seconds.
The JAX package builds its C++ parser the same way (io/native.py).

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
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# dynamic shared memory one H100 block may use: the wrappers check against it,
# and K2 is given it to decide whether the band's camera vector fits beside
# the rest
SMEM_LIMIT = 232_448

_lib: Optional[ctypes.CDLL] = None
# what the last build printed (the ptxas register / shared-memory report);
# None when the library came from the cache
last_build_log: Optional[str] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "fusedmv_abi_version": ([], _I),
    "fusedmv_error_string": ([_I], ctypes.c_char_p),
    "fusedmv_hpp_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # T M W ne with_v with_precond smem_limit
    "fusedmv_schur_smem_bytes": ([_I] * 6 + [ctypes.c_size_t], ctypes.c_size_t),
    "fusedmv_occupancy": ([_I, ctypes.c_size_t], _I),
    # acam apt rel imgrow sb fr er ib tie_off col_perm col_off cover_off
    # cover_ids | G M T W n_pad n_img_pad ne ni bf16x2 | hs de_part di_part
    # de_terms de di stream
    "fusedmv_hpp_pass": ([_P] * 13 + [_I] * 9 + [_P] * 7, _I),
    # acam apt rel imgrow arows vpose vi hpi sb fr er ib tie_off col_perm
    # col_off cover_off cover_ids | G M T W n_pad n_img_pad ne ni with_v
    # with_a with_precond p_rows i_rows bf16x2 | smem_limit | pose_part
    # iop_part out_y p21_part i55_part out_pose out_iop out_p21 out_i55 stream
    "fusedmv_schur_apply": ([_P] * 17 + [_I] * 14 + [ctypes.c_size_t] + [_P] * 10, _I),
    # band_part lane_part ib cover_off cover_ids | G W n_img_pad band_rows
    # band_live lane_rows lane_live | band_out lane_out stream
    "fusedmv_reduce": ([_P] * 5 + [_I] * 7 + [_P] * 3, _I),
    "prefix_abi_version": ([], _I),
    "prefix_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # x out | n_chunks d | stream
    "prefix_chunk_f32": ([_P, _P, _I, _I, _P], _I),
    "prefix_chunk_f64": ([_P, _P, _I, _I, _P], _I),
    "streamseg_abi_version": ([], _I),
    "streamseg_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # vals ids r0 r1 s0 | n_blocks S D | row_stride col_stride out_block
    # out_slot out_col | out stream
    "streamseg_span_sum": ([_P] * 5 + [_I] * 3 + [_L] * 5 + [_P, _P], _I),
    "gather_abi_version": ([], _I),
    # idx tab blk | n n_tab c win chunk | out stream
    "gather_rows_f32": ([_P] * 3 + [_I] * 5 + [_P, _P], _I),
    # idx m tab | n n_tab c | out stream
    "gather_contract_f32": ([_P] * 3 + [_I] * 3 + [_P, _P], _I),
    "scatter_abi_version": ([], _I),
    "scatter_max_chunk": ([], _I),
    "scatter_max_table": ([], _I),
    # idx vals | n n_tab c chunk round_bf16 | partials stream
    "scatter_partials_f32": ([_P] * 2 + [_I] * 5 + [_P, _P], _I),
    # partials | n_chunks width | out stream
    "scatter_reduce_f32": ([_P, _I, _I, _P, _P], _I),
    "graphcond_abi_version": ([], _I),
    # stream pred child capture_mode
    "graphcond_begin_if": ([_P, _P, _P, _I], _I),
    "graphcond_end": ([_P], _I),
    "peercoll_abi_version": ([], _I),
    "peercoll_max_ranks": ([], _I),
    # device rank size half_bytes limit_s | comm_out handle_out
    "peercoll_create": ([_I, _I, _I, ctypes.c_size_t, ctypes.c_double,
                         ctypes.POINTER(ctypes.c_void_p), _P], _I),
    # comm handles (size x 64 bytes)
    "peercoll_open": ([_P, ctypes.c_char_p], _I),
    "peercoll_max_grid": ([_P], _I),
    # comm op schedule dtype x x_stride out out_stride n grid stream
    "peercoll_run": ([_P, _I, _I, _I, _P, _L, _P, _L, _L, _I, _P], _I),
    "peercoll_error": ([_P], _I),
    "peercoll_destroy": ([_P], _I),
}
_ABI = {"fusedmv": 5, "prefix": 2, "streamseg": 2, "gather": 1, "scatter": 2,
        "graphcond": 1, "peercoll": 2}


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
    return _BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists already."""
    global last_build_log
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build under a temporary name, then rename: concurrent builds are safe
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        logs = []
        try:
            for src, proc in zip(_sources(), procs):
                out, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src.name} ({proc.returncode}):\n{out}"
                    )
                logs.append(out)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(lib), *map(str, objs)],
            capture_output=True, text=True, timeout=600,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}"
            )
        os.replace(lib, so)
    last_build_log = "".join(logs) + link.stdout + link.stderr
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
        got = {src: getattr(lib, f"{src}_abi_version")() for src in _ABI}
        if got != _ABI:
            raise RuntimeError(f"kernel library ABI mismatch: {got}, want {_ABI}")
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().fusedmv_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
