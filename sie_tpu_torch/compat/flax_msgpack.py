"""flax's msgpack checkpoint format, read and written with the standard
library (`struct`), so the port needs neither `msgpack` nor `flax`.

`flax.serialization.to_bytes` writes a state dict as msgpack: maps with
string keys, Python scalars as msgpack scalars, and every array as an
extension of type 1 whose payload is itself msgpack of (shape, dtype name,
C-order bytes); a NumPy scalar is type 3 with the same payload, a complex
number type 2 holding (real, imag). Arrays above 2^30 bytes are split into
chunks under a `__msgpack_chunked_array__` map. `to_bytes` writes the
bytes flax's `to_bytes` writes for the same tree (keys in the tree's
order, the smallest integer, string and container headers, doubles for
floats), and `from_bytes` reads any valid encoding of these types.

Arrays come back as NumPy arrays; `bfloat16`, which NumPy lacks, as a
torch.bfloat16 tensor, and a torch tensor is written as the array of its
dtype.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2 ** 30   # flax's chunk size, below msgpack's 2^31 limit
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------- writing
def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif v >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"),
                                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= limit:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    elif v >= -32:
        out.append(struct.pack("b", v))
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"),
                                 (-0x8000000000000000, 0xD3, ">q")):
            if v >= limit:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _header(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
            fmts: Tuple[str, ...]) -> bytes:
    """A length header: the fix form below fix_max, else the first of the
    (8,) 16 and 32-bit forms that holds n."""
    if n < fix_max:
        return struct.pack("B", fix | n)
    for code, fmt in zip(codes, fmts):
        if n <= (1 << (8 * struct.calcsize(fmt))) - 1:
            return struct.pack("B", code) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_str(s: str, out: List[bytes]) -> None:
    b = s.encode("utf-8")
    out.append(_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB),
                       (">B", ">H", ">I")) + b)


def _pack_bin(b: bytes, out: List[bytes]) -> None:
    n = len(b)
    for limit, code, fmt in ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"),
                             (0xFFFFFFFF, 0xC6, ">I")):
        if n <= limit:
            out.append(struct.pack("B", code) + struct.pack(fmt, n) + b)
            return
    raise OverflowError(f"{n} bytes do not fit msgpack")


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    elif n <= 0xFF:
        head = struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    out.append(head + struct.pack("b", code) + data)


def _array_payload(a) -> bytes:
    """msgpack of (shape, dtype name, C-order bytes), as flax writes it."""
    if torch.is_tensor(a):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            shape, name = tuple(a.shape), "bfloat16"
            raw = a.view(torch.int16).numpy().tobytes()
            return _packb((shape, name, raw))
        a = a.numpy()
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return _packb((tuple(a.shape), a.dtype.name, a.tobytes("C")))


def _pack(x: Any, out: List[bytes]) -> None:
    # exact types first, as msgpack-python's strict_types packer does: a
    # NumPy scalar (np.float64 is a float) goes to its extension
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        _pack_str(x, out)
    elif t is bytes:
        _pack_bin(x, out)
    elif t in (list, tuple):
        out.append(_header(len(x), 0x90, 16, (0xDC, 0xDD), (">H", ">I")))
        for v in x:
            _pack(v, out)
    elif t is dict:
        out.append(_header(len(x), 0x80, 16, (0xDE, 0xDF), (">H", ">I")))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _array_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(x)), out)
    elif t is complex:
        _pack_ext(EXT_COMPLEX, _packb((x.real, x.imag)), out)
    else:
        raise TypeError(f"cannot write {t.__name__} in a flax checkpoint")


def _packb(x: Any) -> bytes:
    out: List[bytes] = []
    _pack(x, out)
    return b"".join(out)


def _chunk_leaves(tree: Any) -> Any:
    """flax's chunking: arrays above MAX_CHUNK_SIZE bytes become a map of
    flat chunks with the shape beside them."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        flat = tree.reshape(-1)
        step = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {_CHUNKED: True,
                "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def to_bytes(tree: Any) -> bytes:
    """The bytes `flax.serialization.to_bytes` writes for a state dict of
    nested dicts with array and scalar leaves."""
    return _packb(_chunk_leaves(tree))


# ---------------------------------------------------------------- reading
class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.unpack("B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self._array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in scalars:
            return self.unpack(scalars[c])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",    # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",    # str
                 0xDC: ">H", 0xDD: ">I",                # array
                 0xDE: ">H", 0xDF: ">I",                # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}    # ext
        if c in sized:
            n = self.unpack(sized[c])
            if c <= 0xC6:
                return self.take(n)
            if 0xD9 <= c <= 0xDB:
                return self.take(n).decode("utf-8")
            if c in (0xDC, 0xDD):
                return self._array(n)
            if c in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self._ext(fixext[c])
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            return _array_from_payload(data)[()]
        if code == EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"unknown msgpack extension type {code}")


def _array_from_payload(data: bytes):
    shape, name, raw = _Reader(data).read()
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape).copy()


def _unchunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def from_bytes(data: bytes) -> Dict[str, Any]:
    """The state dict in bytes that `flax.serialization.to_bytes` (or
    `to_bytes`) wrote: nested dicts of arrays and scalars."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         f"msgpack object")
    return _unchunk_leaves(tree)
