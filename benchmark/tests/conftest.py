"""A tiny benchmark in a temporary folder: BENCHMARK.json with a small
InterpGN configuration, its traffic, cells and every metric reader
copied, run on the CPU through the harness (which skips its look for a
card only when told the device)."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import harness  # noqa: E402

TINY = dict(seq_len=40, enc_in=3, num_shapelet=2, d_model=16, d_ff=32,
            n_heads=2, e_layers=1, amp=False, fused_attention_min_len=0)


def write_tiny(root: str, amp: bool = False, limits=None) -> str:
    """The tiny benchmark under `root`; returns its BENCHMARK.json."""
    for sub in ("configs", "traffic", "cells", "metrics"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    bench = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
    cfg = harness.load_json(os.path.join(
        REPO, "benchmark", "configs", "interpgn-chisco.json"))
    cfg["config"].update(TINY, amp=amp)
    path = os.path.join(root, "configs", "tiny.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    bench["configs"] = [{"name": "tiny", "source": "test", "file": path,
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [
        {"name": "chisco-train", "config": "tiny", "traffic": "t",
         "chips": 1, "why": "test"}]
    files = {
        "traffic/t.json": {"loop": "train", "batch_rows": 4, "rows": 16},
        "cells/chisco-train.json": {"limits": limits or {
            "loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3}}}
    for rel, obj in files.items():
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)
    src = os.path.join(REPO, "benchmark", "metrics")
    for name in os.listdir(src):
        if name.endswith(".py"):
            shutil.copy(os.path.join(src, name),
                        os.path.join(root, "metrics", name))
    out = os.path.join(root, "BENCHMARK.json")
    with open(out, "w") as f:
        json.dump(bench, f)
    return out


def run_tiny(root: str, cell: str, seed: int = 3, trace: int = 0,
             extra=()) -> dict:
    """One run of a tiny cell on the CPU -> the result line."""
    run = harness.start(["--workload", cell, "--seed", str(seed),
                         "--seconds", "0.5", "--trace", str(trace),
                         "--device", "cpu", "--bench", root, *extra],
                        time.perf_counter())
    return harness.result(run)


@pytest.fixture
def tiny(tmp_path):
    write_tiny(str(tmp_path))
    return str(tmp_path)
