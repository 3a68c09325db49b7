"""The harness on the CPU at a tiny size: files found by name, the result
line's keys, no run without a card, and no JAX."""

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import REPO, run_tiny

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
                 "checks"]


def test_new_files_found_by_name(tiny):
    """A configuration, a traffic mix, a cell and a metric dropped in as
    files, named in BENCHMARK.json, run with no edit of the harness."""
    with open(os.path.join(tiny, "metrics", "steps_in_window.py"), "w") as f:
        f.write("def read(run):\n    return run.rec['steps']\n")
    bench_path = os.path.join(tiny, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    cfg = dict(bench["configs"][0], name="tiny2")
    with open(cfg["file"]) as f:
        tiny_cfg = json.load(f)
    tiny_cfg["config"]["num_shapelet"] = 3
    cfg["file"] = os.path.join(tiny, "configs", "tiny2.json")
    with open(cfg["file"], "w") as f:
        json.dump(tiny_cfg, f)
    bench["configs"].append(cfg)
    bench["workloads"].append({"name": "new-cell", "config": "tiny2",
                               "traffic": "t2", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "replayed step",
        "moves": "train_samples_per_s", "workloads": ["new-cell"]})
    bench["end_to_end"][0]["workloads"].append("new-cell")
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    with open(os.path.join(tiny, "traffic", "t2.json"), "w") as f:
        json.dump({"loop": "train", "batch_rows": 2, "rows": 8}, f)
    with open(os.path.join(tiny, "cells", "new-cell.json"), "w") as f:
        json.dump({"limits": {"loss_gap": 1e-4, "grad_gap": 1e-4,
                              "change_gap": 1e-3}}, f)
    line = run_tiny(tiny, "new-cell", trace=1)
    assert line["correct"], line["checks"]
    assert line["metrics"]["steps_in_window"]["value"] >= 1


def test_train_line_has_the_contract_keys(tiny):
    line = run_tiny(tiny, "chisco-train")
    assert list(line) == CONTRACT_KEYS     # checks last
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_samples_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_fcn_cell(tiny):
    """The tiny configuration with the FCN expert (BatchNorm's buffers
    among the state put back before the compared steps)."""
    path = os.path.join(tiny, "configs", "tiny.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["config"].update(dnn_type="FCN", gating_value=1.0)
    with open(path, "w") as f:
        json.dump(cfg, f)
    line = run_tiny(tiny, "chisco-train", trace=1)
    assert line["correct"], line["checks"]
    assert "replay_host_ms.train" in line["metrics"]


def test_reader_loading_jax_gives_no_line(tiny, capsys):
    """A metric reader that loads a module named `jax` after the window:
    the run exits 3 and prints no line."""
    import time
    from benchmark import harness
    with open(os.path.join(tiny, "metrics", "loads_jax.py"), "w") as f:
        f.write("import sys\nimport types\n\n\ndef read(run):\n"
                "    sys.modules['jax'] = types.ModuleType('jax')\n"
                "    return 1.0\n")
    bench_path = os.path.join(tiny, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["end_to_end"].append({
        "name": "loads_jax", "unit": "s", "better": "lower", "bound": 0.1,
        "source": "host_clock", "workloads": ["chisco-train"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    assert "jax" not in sys.modules
    run = harness.start(["--workload", "chisco-train", "--seed", "2",
                         "--seconds", "0.3", "--trace", "0", "--device",
                         "cpu", "--bench", tiny], time.perf_counter())
    capsys.readouterr()
    try:
        assert "jax" not in sys.modules
        rc = harness.report(run)
    finally:
        sys.modules.pop("jax", None)
    assert rc == 3
    captured = capsys.readouterr()
    assert captured.out.strip() == ""
    assert "['jax']" in captured.err


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "chisco-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_run_loads_no_jax(tmp_path):
    """A whole tiny run, then sys.modules by whole top-level names."""
    code = f"""
import sys, time
sys.path.insert(0, {REPO!r})
sys.path.insert(0, {os.path.dirname(__file__)!r})
from conftest import write_tiny
from benchmark import harness
write_tiny({str(tmp_path)!r})
run = harness.start(["--workload", "chisco-train", "--seed", "1",
                     "--seconds", "0.2", "--trace", "0", "--device", "cpu",
                     "--bench", {str(tmp_path)!r}], time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]
                         .replace("'", '"')))
    assert "sie_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "sie_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_benchmark_sources_import_no_jax():
    root = os.path.join(REPO, "benchmark")
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, name)):
                    assert mod.split(".")[0] not in {
                        "jax", "jaxlib", "flax", "sie_tpu"}, (name, mod)


def test_reference_imports_nothing_of_the_program():
    root = os.path.join(REPO, "benchmark", "reference")
    for name in os.listdir(root):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(root, name)):
                assert mod.split(".")[0] not in {"sie_tpu_torch", "sie_tpu",
                                                 "jax"}, (name, mod)
    code = (f"import sys; sys.path.insert(0, {REPO!r}); "
            "import benchmark.reference.interpgn, benchmark.reference.adam; "
            "print(any(m.split('.')[0] == 'sie_tpu_torch' "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "False", out.stderr


@pytest.mark.cuda
def test_cell_on_the_card():
    """Every cell of BENCHMARK.json once, short, on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        if w["chips"] > torch.cuda.device_count():
            continue
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", w["name"],
             "--seed", "2147483700", "--seconds", "2", "--trace", "0"],
            cwd=REPO, capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
