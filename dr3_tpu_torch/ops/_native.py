"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile with nvcc for ``sm_90a`` into one shared library with a
plain C interface, loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds: one nvcc per source, all started
together, then one link. The library is built on first use into ``build/``
at the repository root, named by a hash of the sources and flags, and
reused while they are unchanged. Nothing is built or imported when this
module is imported: the CPU tests import every module of the port.

Each entry point launches on the given stream and returns
``cudaGetLastError()``; :func:`call` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_U64 = ctypes.c_ulonglong
# C signatures of csrc/*.cu's extern "C" entry points; every one returns int
SIGNATURES = {
    "dr3_lk_pyramid": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                       _P, _P, _P, _P],
    "dr3_lk_align": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                     _P, _P, _P, _P],
    "dr3_sample_patches": [_P, _I, _I, _P, _I, _I, _P, _P],
    "dr3_sparse_align": [_P, _I, _I, _P, _I, _I, *[_P] * 8, _F, _P, _P, _I, _I, _I,
                         _P, _P, _P, _P],
    "dr3_corner_response": [_I, _P, _P, _F, _P, _P],
    "dr3_remap": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _F, _P, _P, _P],
    "dr3_warp": [_P, _I, _I, _I, _I, *[_F] * 9, _I, _I, _F, _P, _P, _P],
    "dr3_warp_shortcut_tiles": [*[_F] * 9, _I, _I, _I, _I, _P, _P, _P],
    "dr3_schur_factor": [*[_P] * 10, _I, _I, _P, _P, _P, _P],
    "dr3_schur_blocks": [*[_P] * 7, _I, _P, _P],
    "dr3_schur_mv": [*[_P] * 4, _I, _P, _I, *[_P] * 4, ctypes.c_longlong, _I, _I, _I, _P, _P,
                     _P],
    # graph assembly (csrc/graph_loop.cu): no stream argument but the launch's
    "dr3_gl_info": [ctypes.POINTER(_I)] * 3,
    "dr3_gl_graph_create": [_PP],
    "dr3_gl_graph_destroy": [_P],
    "dr3_gl_add_child": [_P, _P, _P, _PP],
    "dr3_gl_handle": [_P, ctypes.c_uint, ctypes.POINTER(_U64)],
    "dr3_gl_add_cond": [_P, _P, _I, _U64, _PP, _PP],
    "dr3_gl_add_set_cond": [_P, _P, _U64, _P, _I, _PP],
    "dr3_gl_instantiate": [_P, _PP],
    "dr3_gl_exec_destroy": [_P],
    "dr3_gl_launch": [_P, _P],
}

_lib = None
build_info: dict = {}     # path, seconds, cached, ptxas log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of dr3_tpu_torch are "
                       "built with the CUDA toolkit on the machine with the card")


def build() -> Path:
    """Compile csrc/*.cu into build/libdr3_kernels-<hash>.so if that file
    does not exist yet; returns its path. Records the compile time and
    ptxas' register/shared-memory report in ``build_info``."""
    cu = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in cu + sorted(CSRC.glob("*.cuh")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libdr3_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{f.stem}.o") for f in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(f), "-o", o],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for f, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(f, p.returncode, log) for f, p, log in zip(cu, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{f} ({code}):\n{log}" for f, code, log in failed))
        so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(so, out)   # atomic: a concurrent build never sees half a file
    build_info.update(path=str(out), seconds=time.perf_counter() - t0, cached=False,
                      log="".join(logs))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def call(name: str, *args) -> None:
    """Launch entry point ``name`` on the current stream; tensors are passed
    by their data pointer. Raises if the launch reported a CUDA error."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib(), name)(*conv, stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def check(t: torch.Tensor, name: str, dtype, shape=None, device=None) -> None:
    """Validate a kernel argument: CUDA, dtype, contiguity, shape, device."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
