"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, which ``ctypes`` loads. The library is
built on first CUDA use into ``build/`` beside this package, named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is not. Nothing here runs at import: the CPU test suite
imports every module on a machine with no ``nvcc``.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises when that is non-zero. Each
kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else, so a run can show that its path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {
    "fused_add_ln": 0, "fused_add_ln_bwd": 0, "ln_keep_mask": 0,
    "short_mhsa": 0, "short_mhsa_bwd": 0, "attn_keep_mask": 0,
    "fused_adam": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# dropout arguments: drop flag, 64-bit seed, keep threshold, keep_prob
_DROP = [_I, ctypes.c_ulonglong, ctypes.c_uint, _F]
_SIGNATURES = {
    # x, res, scale, bias, y, mean, rstd, n, h, eps, dropout, dtype, stream
    "nrmt_fused_add_ln": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, *_DROP,
                          _I, _P],
    # dy, x, res, mean, rstd, scale, dx, dres, partials, dscale_dbias,
    # n, h, blocks, dropout, dtype, stream
    "nrmt_fused_add_ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, *_DROP, _I, _P],
    # q, k, v, key_mask, out, u, s, h, n_heads, dropout, dtype, stream
    "nrmt_short_mhsa": [_P, _P, _P, _P, _P, _I, _I, _I, _I, *_DROP, _I, _P],
    # q, k, v, key_mask, do, dq, dk, dv, u, s, h, n_heads, dropout, dtype,
    # stream
    "nrmt_short_mhsa_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            *_DROP, _I, _P],
    # out, n, h, seed, thresh, stream
    "nrmt_ln_keep_mask": [_P, _L, _I, ctypes.c_ulonglong, ctypes.c_uint, _P],
    # out, u, n_heads, s, seed, thresh, stream
    "nrmt_attn_keep_mask": [_P, _L, _I, _I, ctypes.c_ulonglong,
                            ctypes.c_uint, _P],
    # leaves, leaf_group, chunk_leaf, chunk_start, n_leaves, n_chunks,
    # chunk, b1, b2, 1-b1, 1-b2, eps, bc1, bc2, lr0, lr1, stream
    "nrmt_fused_adam": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                        _F, _F, _F, _P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _sources() -> Tuple[List[Path], str]:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return sources, digest.hexdigest()[:16]


def build_library() -> Tuple[Path, str]:
    """Compile and link the kernels if this source set has no library yet.

    Returns the library's path and the compiler's output (``ptxas -v``
    register and shared-memory counts), empty when nothing was built."""
    sources, digest = _sources()
    lib_path = BUILD_DIR / f"libnrmt_kernels_{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return lib_path, "\n".join(log)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.nrmt_error_string.argtypes = [ctypes.c_int]
        lib.nrmt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.nrmt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
