"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
`nvcc` for `sm_90a` into `sie_tpu_torch/build/` (listed in .gitignore). The
library's file name carries a hash of its source, of the headers in
`csrc/` and of the flags, so an edited source is rebuilt and a stale library
is never loaded. Every C entry returns
`cudaGetLastError()` after its launch; `check` turns a non-zero code into
an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: each entry takes device pointers, ints, floats and the
# stream, and returns a cudaError_t as int
_P, _I, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
# host arrays, one entry per bank: device pointers, ints
_PA, _IA = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "shapelet_l1_fwd": {
        # x, s, out, B, C, T, n, L, squared, stream
        "shapelet_l1_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "shapelet_l1_bwd": {
        # x, s, g, workspace, grad_s, B, C, T, n, L, batch_chunk, squared,
        # stream
        "shapelet_l1_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    },
    "shapelet_l1_grouped_fwd": {
        # x, B, C, T, banks, s[], out[], n[], L[], stream
        "shapelet_l1_grouped_fwd": [_P, _I, _I, _I, _I, _PA, _PA, _IA, _IA,
                                    _P],
    },
    "shapelet_l1_grouped_bwd": {
        # x, B, C, T, banks, s[], g[], grad[], workspace, n[], L[],
        # batch_chunk[], stream
        "shapelet_l1_grouped_bwd": [_P, _I, _I, _I, _I, _PA, _PA, _PA, _P,
                                    _IA, _IA, _IA, _P],
    },
    "attention_fwd": {
        # q, k, v, o, lse, seed, BH, T, dk, scale, dropout, thresh,
        # inv_keep, is_bf16, stream
        "attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _U, _F,
                          _I, _P],
        # K9: q, k, v, o, lse, BH, T, dk, scale, stream
        "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    },
    "attention_bwd": {
        # q, k, v, o, dout, lse, delta, dq, dk, dv, seed, BH, T, dk, scale,
        # dropout, thresh, inv_keep, is_bf16, stream
        "attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _F, _I, _U, _F, _I, _P],
        # K10b: q, k, v, o, dout, lse, delta, dk, dv, BH, T, dk, scale,
        # stream
        "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                          _P],
        # K10a: q, k, v, dout, lse, delta, dq, BH, T, dk, scale, stream
        "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built in
# this process, by source name
PTXAS_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Starts nvcc for one source unless its library exists; returns
    (final path, temp path, process) or None."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return path, tmp, proc


def _finish(name: str, job) -> None:
    path, tmp, proc = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    PTXAS_LOG[name] = out
    os.replace(tmp, path)   # atomic: a concurrent process sees old or new


def build(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compiles the given sources, one nvcc each, all started together."""
    with _lock:
        jobs = {n: _start(n) for n in names if n not in _libs}
        errors = []
        for n, job in jobs.items():
            if job is not None:
                try:
                    _finish(n, job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
