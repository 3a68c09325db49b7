"""The benchmark's general machinery: finds a cell's files by the names in
BENCHMARK.json, checks for the cards, runs the cell's loop
(`loops/<loop>.py`, named by its traffic file), reads every metric
through its reader (`metrics/<name>.py`), decides `correct` from the
comparisons the loop made, and prints the result line.

Files of a cell, all found by name under the benchmark's folder:
- `configs/<config>.json` (BENCHMARK.json's `file`): the configuration,
  its program settings under "config", the reference and work modules
  that belong to it under "reference" and "work";
- `traffic/<traffic>.json`: the mix's parameters, "loop" among them;
- `cells/<cell>.json`: the limits of the cell's comparisons;
- `metrics/<metric>.py`: `read(run) -> float or None`.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "sie_tpu")


class Failure(Exception):
    """A run that prints no result."""


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file under the benchmark's folder."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise Failure(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Run:
    """One run of one cell: its files, arguments, and what its loop
    records for the metric readers and the comparison."""

    def __init__(self, bench: Dict, cell: str, args, bench_dir: str,
                 t_start: float):
        self.bench, self.cell, self.args = bench, cell, args
        self.bench_dir, self.t_start = bench_dir, t_start
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell not in cells:
            raise Failure(f"no workload {cell!r} in BENCHMARK.json")
        self.workload = cells[cell]
        entry = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = load_json(os.path.join(ROOT, entry["file"]))
        self.cfg = self.config["config"]
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench_dir, "cells",
                                             cell + ".json"))["limits"]
        self.chips = int(self.workload["chips"])
        self.seed, self.seconds = args.seed, float(args.seconds)
        self.traced = bool(args.trace)
        self.control = args.control
        self.rank, self.world = 0, self.chips
        self.device = None
        self.setup_s: Optional[float] = None
        self.memory_peak_bytes = 0
        self.rec: Dict[str, Any] = {}       # the loop's readings
        self.checks: List[List] = []        # [name, value, limit]
        self.attempted = self.failed = 0
        self.marks: List = []
        from benchmark.trace import Spans
        self.spans = Spans()
        self.trace = None                   # trace.DeviceTrace when traced

    # ---- for the loops -------------------------------------------------
    def module(self, kind: str):
        """The configuration's "reference" or "work" module."""
        return importlib.import_module(
            f"benchmark.{kind}.{self.config[kind]}")

    def program_config(self):
        from sie_tpu_torch.config import Config
        return Config(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in self.cfg.items()})

    def setup_done(self) -> None:
        """The end of set-up. What set-up left is collected and kept out
        of the collector's later passes, so the window's pauses are the
        program's own."""
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_start
        self.mark("setup")
        print("setup split (s from the start): " + ", ".join(
            f"{stage} {t:.3f}" for stage, t in self.marks), file=sys.stderr)

    def span(self, name: str, fn: Callable, *a, **kw):
        t0 = time.perf_counter_ns()
        try:
            return fn(*a, **kw)
        finally:
            self.spans.add(name, t0, time.perf_counter_ns())

    def trace_start(self) -> None:
        """Starts the device trace of a traced run on a card."""
        if self.traced and self.device.type == "cuda":
            from benchmark.trace import DeviceTrace
            self.trace = DeviceTrace()
            self.trace.start(self.device)

    def trace_stop(self) -> None:
        if self.trace is not None:
            self.trace.stop(self.device)

    def check(self, name: str, value: float, where: str = "") -> None:
        """A comparison against the cell's limit for `name`; `where` (the
        leaf or step that gave it) goes to standard error."""
        self.checks.append([name, float(value), float(self.limits[name])])
        if where:
            print(f"{name} at {where}", file=sys.stderr)

    def mark(self, stage: str) -> None:
        """The end of a stage of set-up, for the split printed on
        standard error."""
        self.marks.append((stage, time.perf_counter() - self.t_start))

    # ---- the result -----------------------------------------------------
    @property
    def correct(self) -> bool:
        """Every comparison within its limit, and no request or step
        failed."""
        return (bool(self.checks) and self.attempted > 0 and self.failed == 0
                and all(v <= lim for _, v, lim in self.checks))

    def metric_entries(self) -> List[Dict]:
        kind = "per_layer" if self.traced else "end_to_end"
        return [m for m in self.bench[kind] if applies(m, self.cell)]

    def metrics(self) -> Dict[str, Dict]:
        """Every metric of the cell (end-to-end untraced, per-layer
        traced) its reader finds; none for a control run."""
        out = {}
        if self.control:
            return out
        for m in self.metric_entries():
            reader = load_module(os.path.join(
                self.bench_dir, "metrics", m["name"] + ".py"),
                "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(self)
            if value is None:
                if not self.traced:
                    raise Failure(f"no reading of {m['name']}")
                continue
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def sync(device) -> None:
    """Waits for the card's work (nothing to wait for on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return out[0].split(",")[-1].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_entry(run: Run) -> Dict:
    import torch
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": run.world,
           "memory_peak_bytes": int(run.memory_peak_bytes),
           "power_limit": power_limit() if run.device.type == "cuda"
           else "none"}
    if run.trace is not None:
        dev["busy_s"] = run.rec.get("busy_s", run.trace.busy_s())
        dev["window_s"] = run.rec.get("trace_window_s", run.trace.window_s)
    return dev


def result(run: Run) -> Dict:
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": run.metrics(),
           "device": device_entry(run)}
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps(run.spans)}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in run.checks}
    return out


def parse(argv):
    p = argparse.ArgumentParser(description="Runs one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # used in measuring the benchmark itself, never by its runs
    p.add_argument("--control", action="store_true",
                   help="the reference in the next precision down in the "
                        "program's place: prints the comparisons only")
    # a multi-card cell's other ranks, which rank 0 starts
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    # the benchmark's own tests: the CPU, and a folder of their own files
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--bench", default=None, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def start(argv, t_start: float) -> Run:
    """The run, its loop done, ready for `result`."""
    import torch
    args = parse(argv)
    bench_dir = args.bench or BENCH_DIR
    bench = load_json(os.path.join(args.bench or ROOT, "BENCHMARK.json"))
    run = Run(bench, args.workload, args, bench_dir, t_start)
    run.rank = args.rank
    device = args.device
    if device is None:
        if not torch.cuda.is_available():
            raise Failure("no CUDA device: the benchmark runs on cards only")
        need = 1 if run.control else run.chips
        if torch.cuda.device_count() < need:
            raise Failure(f"{need} cards wanted, "
                          f"{torch.cuda.device_count()} present")
        device = f"cuda:{run.rank}"
    run.device = torch.device(device)
    if run.device.type == "cuda":
        torch.cuda.set_device(run.device)
    if run.chips > 1 and not run.control:     # a control runs on one card
        from sie_tpu_torch.parallel.multihost import (free_port,
                                                      init_distributed)
        if args.coordinator is None:
            args.coordinator = f"localhost:{free_port()}"
            run.workers = start_ranks(argv, run.chips, args.coordinator)
        init_distributed(args.coordinator, run.chips, run.rank,
                         device=run.device)
    loop = importlib.import_module(f"benchmark.loops.{run.traffic['loop']}")
    try:
        loop.run(run)
    finally:
        end_ranks(run)
    return run


def start_ranks(argv, chips: int, coordinator: str) -> List:
    """Ranks 1 .. chips - 1 of a multi-card cell, each a process running
    this cell with its rank; their standard error goes to a temporary
    file, shown if one fails."""
    import tempfile
    out = []
    for rank in range(1, chips):
        err = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(
            [sys.executable, os.path.join(BENCH_DIR, "run.py"), *argv,
             "--rank", str(rank), "--coordinator", coordinator],
            stdout=subprocess.DEVNULL, stderr=err)
        out.append((proc, err))
    return out


def end_ranks(run: Run, timeout: float = 300.0) -> None:
    """Waits for the ranks this process started; ends any still running
    after `timeout` and fails if one did not exit with 0."""
    failed = []
    deadline = time.monotonic() + timeout
    for proc, err in getattr(run, "workers", []):
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc.returncode != 0:
            err.seek(0)
            failed.append(f"rank exited {proc.returncode}: "
                          f"{err.read()[-2000:]}")
        err.close()
    run.workers = []
    if failed:
        raise Failure("; ".join(failed))


def report(run: Run) -> int:
    """Prints the comparisons on standard error and, on rank 0, the result
    line on standard output; 0, or 3 without a line where JAX or the JAX
    package is loaded once the line is built (its readers ran), on every
    rank."""
    line = result(run) if run.rank == 0 else None
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    if line is None:
        return 0
    for name, v, lim in run.checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
