"""The port's program files import nothing of JAX: no `jax`, `jaxlib`,
`flax` or `optax`, and nothing of the JAX package `sie_tpu`, at any place
in the file (imports inside functions included), read from the source so
that lazily imported modules count too. chip_smoke.py and the port's
profiling scripts run on a machine without JAX. Nor `msgpack`: the port
reads and writes flax's checkpoint format with the standard library."""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sie_tpu", "msgpack"}
FILES = sorted(
    [os.path.relpath(p, ROOT) for p in
     glob.glob(os.path.join(ROOT, "sie_tpu_torch", "**", "*.py"),
               recursive=True)
     + glob.glob(os.path.join(ROOT, "scripts", "port_*.py"))]
    + ["chip_smoke.py"])


def _imported(path: str):
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES)
def test_imports_nothing_of_jax(path):
    bad = sorted(m for m in _imported(path)
                 if m.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_the_list_covers_the_port():
    assert "sie_tpu_torch/ops/shapelet_l1.py" in FILES
    assert "scripts/port_profile_kernels.py" in FILES
    for new in ("run.py", "train/experiment.py", "train/checkpoint.py",
                "compat/flax_msgpack.py", "data/preprocess.py", "data/eeg.py",
                "data/provider.py", "utils/shapelet_util.py",
                "serve_http.py", "quant.py", "client.py"):
        assert f"sie_tpu_torch/{new}" in FILES
    assert len(FILES) >= 35
