"""Disk-streaming datasets and the device prefetcher, for archives larger
than host memory (counterpart of sie_tpu/data/stream.py).

- `save_memmap_dataset` / `open_memmap_dataset`: each field a raw .npy
  (written in chunks through np.lib.format.open_memmap) plus meta.json,
  the JAX package's layout: a cache that either package writes opens in
  the other. Opening returns an ArrayDataset whose x and padding_mask are
  read-only np.memmap views, so the `Batcher`'s fancy indexing reads only
  a batch's rows off disk.
- `lazy_select` keeps a split's or fold's view lazy: it composes the
  index map, so `x[idx]` resolves to `x_base[base_map[idx]]` at batch-
  gather time instead of materialising the selected rows.
- `prefetch_to_device` keeps `depth` batches ahead on a background
  thread and relays the producer's exceptions to the consumer. On the
  card (`PinnedPut`) each gathered batch is copied into pinned host
  memory and from there, non-blocking, on a side CUDA stream; the
  consumer's stream waits on the copy's event before it reads the batch,
  and the batch's tensors are marked as used on that stream.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
from typing import Callable, Iterable, Iterator, Tuple

import numpy as np
import torch

from sie_tpu_torch.data.loader import ArrayDataset

META_NAME = "meta.json"
_FIELDS = ("x", "y", "padding_mask", "subject_ids")


def save_memmap_dataset(path: str, ds: ArrayDataset,
                        chunk_rows: int = 1024) -> str:
    """Writes `ds` as a directory of raw .npy files + meta.json, the fields
    copied in `chunk_rows` slices (a memmap-backed source never
    materialises). The directory is written under `<path>.tmp.<pid>` and
    renamed into place, so a concurrent run with the same key sees no
    directory or a complete one. Returns `path`."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    staging = f"{path}.tmp.{os.getpid()}"
    os.makedirs(staging, exist_ok=True)
    for name in _FIELDS:
        arr = getattr(ds, name)
        if arr is None:
            continue
        out = np.lib.format.open_memmap(
            os.path.join(staging, f"{name}.npy"), mode="w+",
            dtype=arr.dtype, shape=arr.shape)
        for i in range(0, arr.shape[0], chunk_rows):
            out[i:i + chunk_rows] = arr[i:i + chunk_rows]
        out.flush()
        del out
    meta = {
        "max_seq_len": int(ds.max_seq_len), "enc_in": int(ds.enc_in),
        "num_class": int(ds.num_class), "class_names": list(ds.class_names),
        "original_fs": int(ds.original_fs), "target_fs": int(ds.target_fs),
        "bin_edges": (None if ds.bin_edges is None
                      else np.asarray(ds.bin_edges).tolist()),
    }
    with open(os.path.join(staging, META_NAME), "w") as f:
        json.dump(meta, f)
    try:
        os.rename(staging, path)
    except OSError:
        # a concurrent writer with the same key renamed first; its copy is
        # complete (the rename is its last step)
        shutil.rmtree(staging, ignore_errors=True)
        if not os.path.exists(os.path.join(path, META_NAME)):
            raise
    return path


def open_memmap_dataset(path: str) -> ArrayDataset:
    """An ArrayDataset of read-only memmaps over a directory that
    `save_memmap_dataset` wrote. y is read into memory (N scalars: label
    filtering, class counts and splits scan it)."""
    with open(os.path.join(path, META_NAME)) as f:
        meta = json.load(f)
    arrays = {}
    for name in _FIELDS:
        p = os.path.join(path, f"{name}.npy")
        if os.path.exists(p):
            arrays[name] = np.load(p, mmap_mode="r")
    return ArrayDataset(
        x=arrays["x"],
        y=np.array(arrays["y"]),
        padding_mask=arrays["padding_mask"],
        subject_ids=arrays.get("subject_ids"),
        bin_edges=(None if meta.get("bin_edges") is None
                   else np.asarray(meta["bin_edges"], np.float32)),
        max_seq_len=meta["max_seq_len"], enc_in=meta["enc_in"],
        num_class=meta["num_class"],
        class_names=tuple(meta["class_names"]),
        original_fs=meta["original_fs"], target_fs=meta["target_fs"])


class _IndexedField:
    """Lazy `base[index_map]` view with what the Batcher and the
    experiment's sizing read (`field[idx]`, shape, size, nbytes, dtype):
    `view[idx]` reads only rows `index_map[idx]` of the base."""

    def __init__(self, base, index_map: np.ndarray):
        self._base = base
        self._map = np.asarray(index_map)
        self.dtype = base.dtype
        self.shape = (len(self._map),) + tuple(base.shape[1:])
        self.size = int(np.prod(self.shape, dtype=np.int64))
        self.nbytes = self.size * base.dtype.itemsize
        self.ndim = len(self.shape)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        return np.asarray(self._base[self._map[idx]])

    def __array__(self, dtype=None, copy=None):   # np.asarray materialises
        out = np.asarray(self._base[self._map])
        return out if dtype is None else out.astype(dtype)


def lazy_select(ds: ArrayDataset, idx: np.ndarray) -> ArrayDataset:
    """ArrayDataset.select without materialising the rows: x and
    padding_mask become index-composed views (y and subject_ids are
    selected in memory). lazy_select(lazy_select(ds, a), b) reads
    base[a[b]]."""
    idx = np.asarray(idx)
    wrap = lambda f: (_IndexedField(f._base, f._map[idx])
                      if isinstance(f, _IndexedField)
                      else _IndexedField(f, idx))
    return dataclasses.replace(
        ds, x=wrap(ds.x), y=np.asarray(ds.y)[idx],
        padding_mask=wrap(ds.padding_mask),
        subject_ids=(None if ds.subject_ids is None
                     else np.asarray(ds.subject_ids)[idx]))


class PinnedPut:
    """device_put for `prefetch_to_device` on a card: called on the
    producer thread, it copies a batch of numpy arrays into pinned host
    memory and from there to `device`, non-blocking, on a side stream,
    and returns (tensors, the copy's event). `ready` (on the consumer's
    thread) makes the current stream wait on that event and marks each
    tensor as used by it, so the caching allocator does not hand its
    memory to the side stream while the consumer still reads it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)

    def __call__(self, batch):
        with torch.cuda.stream(self.stream):
            out = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                        .to(self.device, non_blocking=True) for a in batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, item):
        out, event = item
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in out:
            t.record_stream(current)
        return out


def prefetch_to_device(batches: Iterable[Tuple[np.ndarray, ...]],
                       depth: int = 2,
                       device_put: Callable = None,
                       device="cuda") -> Iterator:
    """Iterates `batches` with a background thread staying `depth` ahead,
    each batch put on the device as soon as it is gathered: by
    `device_put` when given (any function of a batch), else through
    pinned memory on a side stream of `device` (`PinnedPut`), which
    needs a card. An exception in the producer re-raises at the
    consumer's next pull; the producer is a daemon thread, so an abandoned
    iterator cannot hold the interpreter at exit."""
    ready = lambda item: item
    if device_put is None:
        device_put = PinnedPut(device)
        ready = device_put.ready
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    _END, _ERR = object(), object()

    def produce():
        try:
            for b in batches:
                q.put(device_put(b))
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            q.put((_ERR, e))

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
            raise item[1]
        yield ready(item)
