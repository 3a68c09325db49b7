"""ctypes bindings for the native .ts scanner (sie_tpu_torch/native/ts_scan.cpp,
the port's copy of the JAX package's), after sie_tpu/data/native.py.

The shared library is built with g++ at first use into
`sie_tpu_torch/build/` (listed in .gitignore), under a name that carries a
hash of the source and the flags, as ops/build.py names the kernels: an
edited source is rebuilt and a stale library never loaded. The flags hold
no `-march=native`, so a library built on one machine runs on another.
Without a compiler the bindings report the library missing and
`data/ts_parser.py` parses in Python. `parse_ts_file_fast` returns the same
TsFile as the Python parser; `files_parsed` counts the files it parsed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "ts_scan.cpp")
BUILD = os.path.join(_PKG, "build")
FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_lib_failed = False
files_parsed = 0   # files parse_ts_file_fast has parsed in this process


def library_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD, f"libts_scan-{digest.hexdigest()[:12]}.so")


def _build(path: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler")
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        subprocess.run([cxx, *FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, path)   # atomic: a concurrent process sees old or new
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.ts_scan_count.restype = ctypes.c_int
            lib.ts_scan_count.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.ts_scan_parse.restype = ctypes.c_int
            lib.ts_scan_parse.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
            _lib = lib
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            _lib_failed = True   # no compiler, or the library does not load
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def parse_ts_file_fast(path: str):
    """The native scanner's counterpart of ts_parser.parse_ts_file: a
    TsFile, or None when the library is missing or the scan fails."""
    global files_parsed
    lib = _load()
    if lib is None:
        return None
    from sie_tpu_torch.data.ts_parser import TsFile

    with open(path, "rb") as f:
        data = f.read()

    # the header's metadata, in Python (a few lines)
    class_labels = None
    is_regression = False
    problem_name = os.path.basename(path)
    equal_length = True
    has_class_label = False
    for raw in data.split(b"\n"):
        line = raw.strip()
        if line.startswith(b"@data") or line.startswith(b"@DATA"):
            break
        if not line.startswith(b"@"):
            continue
        tokens = line.split()
        tag = tokens[0].lower()
        if tag == b"@problemname" and len(tokens) > 1:
            problem_name = tokens[1].decode()
        elif tag == b"@equallength" and len(tokens) > 1:
            equal_length = tokens[1].lower() == b"true"
        elif tag == b"@classlabel":
            has_class_label = len(tokens) > 1 and tokens[1].lower() == b"true"
            if has_class_label:
                class_labels = [t.decode() for t in tokens[2:]]
        elif tag == b"@targetlabel":
            is_regression = len(tokens) > 1 and tokens[1].lower() == b"true"

    n_values = ctypes.c_int64()
    n_fields = ctypes.c_int64()
    n_lines = ctypes.c_int64()
    if lib.ts_scan_count(data, len(data), ctypes.byref(n_values),
                         ctypes.byref(n_fields), ctypes.byref(n_lines)) != 0:
        return None
    values = np.empty(n_values.value, np.float32)
    offsets = np.empty(n_fields.value + 1, np.int64)
    counts = np.empty(n_lines.value, np.int32)
    label_starts = np.empty(n_lines.value, np.int64)
    label_lens = np.empty(n_lines.value, np.int32)
    if lib.ts_scan_parse(data, len(data), values, offsets, counts,
                         label_starts, label_lens) != 0:
        return None

    has_label_field = has_class_label or is_regression
    series: List[List[np.ndarray]] = []
    labels: List[str] = []
    fi = 0
    for li in range(n_lines.value):
        nf = counts[li]
        ndim = nf - 1 if has_label_field else nf
        series.append([values[offsets[fi + d]: offsets[fi + d + 1]]
                       for d in range(ndim)])
        if has_label_field:
            s0 = label_starts[li]
            labels.append(data[s0: s0 + label_lens[li]].decode())
        else:
            labels.append("")
        fi += nf

    n_dims = max((len(s) for s in series), default=1)
    files_parsed += 1
    return TsFile(series=series, labels=labels, class_labels=class_labels,
                  is_regression=is_regression, problem_name=problem_name,
                  equal_length=equal_length, n_dims=n_dims)
