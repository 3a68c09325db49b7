"""Profiler traces, a step timer and NaN checks (counterpart of
sie_tpu/utils/profiling.py and of `jax_debug_nans`).

`trace(log_dir)` wraps a block in a `torch.profiler` trace of the host and
the card, written as a Chrome trace under log_dir when the block exits
(the exception path included); `python -m sie_tpu_torch.run --profile_dir
DIR` wraps training in it, as run.py does with its XProf trace.

`debug_nans()` is the port's `jax.config.update("jax_debug_nans", True)`
(`--debug_nans`): a trainer built while it is on checks every train step
and eval pass for a non-finite value (trainer.py), and on the first one
re-runs that work eagerly under `first_nonfinite_op`, which raises
FloatingPointError naming the first operation whose output holds a NaN or
an infinity, as jax_debug_nans names the primitive.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """`with trace('/tmp/profile'): ...` writes a Chrome trace (host ops and,
    with a card, its kernels) to log_dir/trace-<pid>-<ns>.json; a no-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class StepTimer:
    """Running mean of step wall-times with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt

    @property
    def mean(self) -> float:
        n = max(self.count - self.warmup, 1)
        return self.total / n


def device_busy_ms(prof) -> float:
    """Milliseconds of a finished `torch.profiler.profile` window in which
    the card ran at least one kernel or copy: the union of its device
    events' intervals, so work that overlaps on two streams counts once.
    "Activity Buffer Request" is the profiler's own buffer, not the
    program's."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "Activity Buffer" not in e.name)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def idle_share(prof, wall_ms: float) -> float:
    """The share of wall_ms in which the card ran nothing, from
    `device_busy_ms(prof)`. Raises if the profiler saw no device time or
    more of it than wall_ms: either way the window was not measured."""
    busy = device_busy_ms(prof)
    if not 0.0 < busy <= wall_ms:
        raise RuntimeError(f"the profiler saw {busy:.3f} ms of device time "
                           f"in a {wall_ms:.3f} ms window: no idle share")
    return 1.0 - busy / wall_ms


_DEBUG_NANS = [False]


@contextlib.contextmanager
def debug_nans(enabled: bool = True) -> Iterator[None]:
    """Trainers built inside the block check for non-finite values (on
    when `enabled`); the previous setting returns after it."""
    before = _DEBUG_NANS[0]
    _DEBUG_NANS[0] = bool(enabled)
    try:
        yield
    finally:
        _DEBUG_NANS[0] = before


def debug_nans_enabled() -> bool:
    return _DEBUG_NANS[0]


# outputs that hold whatever the memory held: a kernel fills them later
_UNINITIALISED = {"empty", "empty_like", "new_empty", "empty_strided",
                  "new_empty_strided", "empty_permuted", "resize_"}


class _FirstNonFinite(TorchDispatchMode):
    """Checks the output of every operation but views and allocations,
    forward and backward; the first non-finite one raises
    FloatingPointError naming it."""

    def __init__(self, where: Callable[[], str]):
        super().__init__()
        self.where = where
        self.found: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # a view shows its input's values: the op that made them is earlier
        if self.found is None and not func.is_view and \
                func.overloadpacket.__name__ not in _UNINITIALISED:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.numel() and \
                        (t.is_floating_point() or t.is_complex()) and \
                        not bool(torch.isfinite(t).all()):
                    phase = ("backward" if torch._C._current_graph_task_id()
                             != -1 else "forward")
                    self.found = (f"{self.where()}: the first non-finite "
                                  f"value came from {func} ({phase})")
                    raise FloatingPointError(self.found)
        return out


def first_nonfinite_op(fn: Callable[[], object],
                       where: Callable[[], str]) -> object:
    """Runs fn() eagerly under `torch.autograd.detect_anomaly(check_nan=
    True)` with every operation's output checked; raises FloatingPointError
    naming the first operation that produced a NaN or an infinity
    (`where()` says which step or pass). Returns fn()'s result when none
    did."""
    mode = _FirstNonFinite(where)
    try:
        with torch.autograd.detect_anomaly(check_nan=True), mode:
            return fn()
    except (FloatingPointError, RuntimeError) as e:
        if mode.found is not None:
            raise FloatingPointError(mode.found) from e
        if "returned nan values" in str(e):
            raise FloatingPointError(f"{where()}: {e}") from e
        raise
