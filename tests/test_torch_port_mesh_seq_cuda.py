"""Sequence parallelism on the card: two processes that share it over gloo
(tests/torch_port_mesh_worker.py, the launch variables) train a narrow
InterpGN + Transformer over `Mesh((2,), ("seq",))` against one process on
the global batch. Every test here is marked `cuda` and skips without a
card; this file imports no JAX:

    python -m pytest --noconftest tests/test_torch_port_mesh_seq_cuda.py -q

T = 300 in blocks of 150 steps (the backbone's every forward on its block,
with the token embedding's halo; K1/K2 for the banks at the whole T after
the gather, K5/K6 for attention at the whole T), f32, dropout 0, 3 steps
of `train_step` on global batches of 16, gradient_clip 0.05: the losses
(rtol 1e-5, atol 1e-6) and the gathered parameters (rtol 1e-5, atol 1e-6
where every step's gradient is >= 1e-4, else 2.1 lr a step) of the one
process, the limits of tests/test_torch_port_mesh_seq.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sie_tpu_torch.compat.from_jax import (_flatten, to_jax_tree,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.parallel.multihost import free_port
from sie_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_mesh_worker.py")
KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=300, enc_in=8,
          num_class=3, num_shapelet=2, d_model=64, d_ff=128, n_heads=2,
          e_layers=1, amp=False, lr=5e-3, dropout=0.0, seed=0,
          gradient_clip=0.05, batch_size=16)
ROWS, STEPS = 64, 3


def _flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v)
            for k, v in _flatten(tree).items()}


def test_seq_over_two_processes_trains_like_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ROWS, KW["seq_len"], KW["enc_in"])).astype(
        np.float32)
    y = rng.integers(0, KW["num_class"], ROWS).astype(np.int32)
    mask = np.ones((ROWS, KW["seq_len"]), np.float32)
    idx = np.stack([rng.permutation(ROWS)[:KW["batch_size"]]
                    for _ in range(STEPS)]).astype(np.int64)
    w = np.ones((STEPS, KW["batch_size"]), np.float32)
    cfg = Config(**KW)
    init = to_jax_variables(build_model(cfg, "cpu",
                                        torch.Generator().manual_seed(0)))
    np.savez(tmp_path / "vars.npz", **_flat(init["params"], "params/"))
    np.savez(tmp_path / "data.npz", x=x, y=y, mask=mask, idx=idx, w=w)
    spec = [dict(name="seq", cfg=KW, mesh_shape=[2], mesh_axes=["seq"],
                 variables=str(tmp_path / "vars.npz"),
                 data=str(tmp_path / "data.npz"), path="step", beta=1.0,
                 out=str(tmp_path), device="cuda:0")]
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    env = {**os.environ, "SIE_TPU_COORDINATOR": f"localhost:{free_port()}",
           "SIE_TPU_NUM_PROCESSES": "2", "SIE_TPU_BACKEND": "gloo",
           "MESH_WORKER_DEVICE": "cuda:0"}
    procs = [subprocess.Popen([sys.executable, WORKER,
                               str(tmp_path / "spec.json")],
                              env={**env, "SIE_TPU_PROCESS_ID": str(i)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:]
    got = dict(np.load(tmp_path / "seq.npz"))
    block = KW["seq_len"] // 2
    assert got["time_forward"].tolist() == [block] * STEPS
    assert got["time_halo"].tolist() == [block] * STEPS

    t = Trainer(cfg, STEPS, device="cuda",
                generator=torch.Generator().manual_seed(0))
    from sie_tpu_torch.compat.from_jax import load_jax_variables
    load_jax_variables(t.model, init)
    losses, grads = [], []
    for k in range(STEPS):
        i = idx[k]
        losses.append(float(t.train_step((x[i], y[i], mask[i], w[k]),
                                         1.0)[0]))
        grads.append(_flat(to_jax_tree(t.model, {
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in t.model.named_parameters()})))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-6)
    params = _flat(to_jax_variables(t.model)["params"])
    for key, want in params.items():
        a = got["params/" + key]
        sure = np.all([np.abs(g[key]) >= 1e-4 for g in grads], axis=0)
        np.testing.assert_allclose(a[sure], want[sure], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
        assert np.abs(a - want).max() <= STEPS * 2.1 * KW["lr"], key
