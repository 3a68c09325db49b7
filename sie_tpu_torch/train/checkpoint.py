"""Best-model checkpoints and full-state snapshots (counterpart of
sie_tpu/train/checkpoint.py), in flax's msgpack format
(`compat/flax_msgpack.py`), so the two packages read each other's
`checkpoint.msgpack` and `train_state.msgpack`.

- `checkpoint.msgpack` holds {"params": the flax parameter tree,
  "batch_stats": the BatchNorm running statistics under the flax names, {}
  for a model without BatchNorm} (`compat.from_jax.to_jax_variables` of
  the model), and `meta.json` the epoch and validation accuracy it was
  taken at;
- `train_state.msgpack` is the snapshot for resuming exactly, in the
  JAX package's layout: step, params, batch_stats, `opt_state` (optax's
  state tree for the config), the epoch and the early-stopping state
  (`Trainer.state_tree`); the port adds its generators' states under
  `rng` and `augment_rng`, which the JAX package's loader passes over,
  and seeds them from the seed and the step where a file (the JAX
  package's) holds none.

Every write is atomic (a temporary file, then `os.replace`), so a crash
mid-save never leaves a torn file. `save_checkpoint(..., background=True)`
hands the serialise-and-write to one ordered writer thread (one FIFO for
all directories, so the latest save of a directory lands last);
`wait_pending` blocks until the queued saves have landed and re-raises a
write error of that directory. The loaders and the synchronous save call it
first, and an atexit hook drains the queue.
"""

from __future__ import annotations

import atexit
import json
import os
import queue as _queue_mod
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

from sie_tpu_torch.compat import flax_msgpack

CKPT_NAME = "checkpoint.msgpack"
FULL_STATE_NAME = "train_state.msgpack"

_writer_lock = threading.Lock()
_writer: Optional[threading.Thread] = None
_queue: Optional[_queue_mod.Queue] = None
_errors: List[Tuple[str, BaseException]] = []


def checkpoint_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, CKPT_NAME)


def _atomic_write(path: str, data: bytes):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _writer_loop():
    while True:
        ckpt_dir, fn = _queue.get()
        try:
            fn()
        except BaseException as e:   # noqa: BLE001 — re-raised in wait_pending
            _errors.append((ckpt_dir, e))
        finally:
            _queue.task_done()


def _submit(ckpt_dir: str, fn):
    global _writer, _queue
    with _writer_lock:
        if _writer is None:
            _queue = _queue_mod.Queue()
            _writer = threading.Thread(target=_writer_loop, daemon=True)
            _writer.start()
            atexit.register(_drain_at_exit)
    _queue.put((ckpt_dir, fn))


def _drain_at_exit():
    """Finish the queued writes at exit, and report on stderr any write
    error that nobody waited for."""
    _queue.join()
    for ckdir, err in _errors:
        print(f"[sie_tpu_torch.checkpoint] background save for {ckdir!r} "
              f"FAILED and was never awaited: {err!r}", file=sys.stderr)


def wait_pending(ckpt_dir: Optional[str] = None):
    """Block until the queued background saves have landed, then raise the
    first recorded write error of ckpt_dir (of any directory when None)."""
    if _queue is not None:
        _queue.join()
    for idx, (ckdir, err) in enumerate(_errors):
        if ckpt_dir is None or ckdir == ckpt_dir:
            _errors.pop(idx)
            raise RuntimeError(
                f"background checkpoint save for {ckdir!r} failed") from err


def save_checkpoint(ckpt_dir: str, params: Dict[str, Any],
                    batch_stats: Optional[Dict[str, Any]] = None,
                    meta: Any = None, background: bool = False):
    """params and batch_stats: the flax-layout trees of host arrays
    (`to_jax_variables`); batch_stats defaults to the empty collection
    the JAX package writes for models without batch norm."""
    os.makedirs(ckpt_dir, exist_ok=True)

    def do_save():
        payload = {"params": params,
                   "batch_stats": {} if batch_stats is None else batch_stats}
        _atomic_write(checkpoint_path(ckpt_dir),
                      flax_msgpack.to_bytes(payload))
        if meta is not None:
            _atomic_write(os.path.join(ckpt_dir, "meta.json"),
                          json.dumps(meta).encode())

    if not background:
        wait_pending(ckpt_dir)   # never let an older queued save land later
        do_save()
        return
    _submit(ckpt_dir, do_save)


def load_meta(ckpt_dir: str) -> dict:
    path = os.path.join(ckpt_dir, "meta.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_checkpoint(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """{"params": ..., "batch_stats": ...} as flax wrote them, or None."""
    wait_pending(ckpt_dir)
    path = checkpoint_path(ckpt_dir)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return flax_msgpack.from_bytes(f.read())


def has_checkpoint(ckpt_dir: str) -> bool:
    wait_pending(ckpt_dir)
    return os.path.exists(checkpoint_path(ckpt_dir))


# ---- full-state resume --------------------------------------------------

def save_train_state(ckpt_dir: str, trainer, epoch: int, early_state: dict):
    """Snapshot the trainer's whole state with the loop's position, so an
    interrupted run resumes exactly. Under a process mesh every rank takes
    part in gathering the state and process 0 writes it."""
    from sie_tpu_torch.parallel.mesh import is_writer
    payload = dict(trainer.state_tree(), epoch=epoch, early=early_state)
    if not is_writer(getattr(trainer, "mesh", None)):
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    _atomic_write(os.path.join(ckpt_dir, FULL_STATE_NAME),
                  flax_msgpack.to_bytes(payload))


def load_train_state(ckpt_dir: str, trainer) -> Optional[Tuple[int, dict]]:
    """Restores the trainer from the snapshot; (epoch, early-stopping
    state), or None without a snapshot."""
    path = os.path.join(ckpt_dir, FULL_STATE_NAME)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        payload = flax_msgpack.from_bytes(f.read())
    trainer.load_state_tree(payload)
    return int(payload["epoch"]), payload["early"]
