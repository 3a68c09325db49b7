"""Training over a process mesh on the CPU, against the JAX package's
single-device Trainer on the global batch: gloo processes started from the
launch variables (tests/torch_port_mesh_worker.py, no JAX in them).

Scenarios, each 3 steps of a global batch of 8 from the JAX package's
initial weights, f32, dropout 0, a small `gradient_clip` so that the clip
acts, the third batch holding 4 real rows and 4 padded ones (weight 0),
which all fall on the second 'data' rank:
- 'data' over 2 processes: InterpGN + Transformer and InterpGN + FCN
  (BatchNorm), through the staged path;
- 'model' over 2 processes: the same two models through `train_step` on
  global batches (the SBM's banks, the attention's heads and the FFN
  split);
- 2 x 2 'data' x 'model' over 4 processes: InterpGN + Transformer.

Limits (f32 summation order; ROADMAP.md §3 lists the gaps seen):
- losses rtol 1e-5, atol 1e-6 at every step, against the JAX trainer and
  the port's one-process run;
- after the first step, every BatchNorm buffer rtol 1e-5, atol 1e-6 of
  the JAX step;
- the parameters whose JAX gradient is >= 1e-4 in magnitude at every
  step so far, after the first step and after the third, rtol 1e-5 and
  atol 1e-6 (Transformer) or 1e-5 (FCN: small conv gradients behind a
  BatchNorm round differently; seen after one step 5.6e-6 at 18 of
  163813 entries of conv2's kernel, after three 8.0e-6 between the
  port's one-process run and JAX and 4.5e-6 between two processes and
  one); every parameter and running statistic within 2.1 lr a step
  (gradients that are 0 in exact arithmetic, as the attention's key
  bias, take Adam moves of +-lr along their rounding noise, in either
  package).
The gathered checkpoint, applied by the JAX model, gives the worker's eval
logits (1e-5), and loaded back into the sharded model gives them bit for
bit.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build_model
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu_torch.compat.from_jax import (_flatten, load_jax_variables,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.parallel.multihost import free_port
from sie_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_mesh_worker.py")
BASE = dict(model="InterpGN", seq_len=24, enc_in=3, num_class=3,
            num_shapelet=2, d_model=16, d_ff=32, n_heads=2, e_layers=1,
            dropout=0.0, amp=False, use_pallas=False,
            fused_attention_min_len=0, lr=5e-3, seed=0, gradient_clip=0.05,
            batch_size=8)
MODELS = {"transformer": dict(BASE, dnn_type="Transformer"),
          "fcn": dict(BASE, dnn_type="FCN")}
N_ROWS, B, STEPS, BETA = 20, 8, 3, 1.0
ATOL = {"Transformer": 1e-6, "FCN": 1e-5}   # parameters after three steps
# name: (model, processes, mesh shape, mesh axes, path)
SCENARIOS = {
    "data_transformer": ("transformer", 2, (2,), ("data",), "staged"),
    "data_fcn": ("fcn", 2, (2,), ("data",), "staged"),
    "model_transformer": ("transformer", 2, (2,), ("model",), "step"),
    "model_fcn": ("fcn", 2, (2,), ("model",), "step"),
    "grid_transformer": ("transformer", 4, (2, 2), ("data", "model"),
                         "step"),
}


def _rows(kw):
    rng = np.random.default_rng(7)
    t = kw["seq_len"]
    y = rng.integers(0, kw["num_class"], N_ROWS).astype(np.int32)
    x = (rng.normal(size=(N_ROWS, t, kw["enc_in"]))
         + 0.7 * y[:, None, None]).astype(np.float32)
    mask = np.ones((N_ROWS, t), np.float32)
    mask[::3, (2 * t) // 3:] = 0.0
    order = rng.permutation(N_ROWS)
    idx, w = [], []
    for k in range(STEPS):
        i = order[k * B:(k + 1) * B]
        wk = np.ones(B, np.float32)
        if len(i) < B:        # the padded final batch: rows 4..7 weigh 0
            wk[len(i):] = 0.0
            i = np.concatenate([i, np.zeros(B - len(i), i.dtype)])
        idx.append(i)
        w.append(wk)
    return SimpleNamespace(x=x, y=y, padding_mask=mask,
                           idx=np.stack(idx).astype(np.int64),
                           w=np.stack(w))


def _batch(rows, k):
    i = rows.idx[k]
    return (rows.x[i], rows.y[i], rows.padding_mask[i], rows.w[k])


def _flat(tree, prefix=""):
    return {prefix + "/".join(k): np.asarray(v)
            for k, v in _flatten(tree).items()}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Per model: the rows, the JAX initial variables (as a file), and the
    JAX trainer's and the port's one-process losses, final variables and
    each step's JAX gradients."""
    root = tmp_path_factory.mktemp("mesh_refs")
    out = {}
    for name, kw in MODELS.items():
        rows = _rows(kw)
        jt = JTrainer(JConfig(**kw), steps_per_epoch=STEPS)
        state = jt.init_state(_batch(rows, 0), seed=0)
        init = {"params": jax.tree.map(np.asarray, state.params),
                "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}
        np.savez(root / f"{name}_vars.npz", **_flat(init["params"], "params/"),
                 **_flat(init["batch_stats"], "batch_stats/"))
        np.savez(root / f"{name}_data.npz", x=rows.x, y=rows.y,
                 mask=rows.padding_mask, idx=rows.idx, w=rows.w)
        grad_fn = jax.jit(jax.grad(lambda p, s, b: jt.loss_fn(
            p, s, b, jnp.float32(BETA), True, jax.random.key(0))[0]))
        jlosses, grads = [], []
        for k in range(STEPS):
            batch = tuple(jnp.asarray(a) for a in _batch(rows, k))
            grads.append(_flat(jax.tree.map(np.asarray, grad_fn(
                state.params, state.batch_stats, batch))))
            state, loss, _ = jt.train_step(state, _batch(rows, k), BETA)
            jlosses.append(float(loss))
            if k == 0:
                first = _flat({"params": state.params,
                               "batch_stats": state.batch_stats})
        final = _flat({"params": state.params,
                       "batch_stats": state.batch_stats})
        cfg = Config(**kw)
        tr = Trainer(cfg, STEPS, model=load_jax_variables(
            build_model(cfg, "cpu"), init), device="cpu")
        plosses = [float(tr.train_step(_batch(rows, k), BETA)[0])
                   for k in range(STEPS)]
        out[name] = SimpleNamespace(
            rows=rows, vars=str(root / f"{name}_vars.npz"),
            data=str(root / f"{name}_data.npz"), init=init, kw=kw,
            jax_losses=jlosses, jax_first=first, jax_final=final,
            grads=grads, port_losses=plosses,
            port_final=_flat(to_jax_variables(tr.model)))
    return out


def _launch(spec, n, tmp_path, tag):
    """Runs n worker processes on `spec` -> nothing; fails with the logs of
    a worker that failed."""
    path = tmp_path / f"{tag}.json"
    path.write_text(json.dumps(spec))
    env = {**os.environ, "SIE_TPU_COORDINATOR": f"localhost:{free_port()}",
           "SIE_TPU_NUM_PROCESSES": str(n), "SIE_TPU_BACKEND": "gloo",
           "OMP_NUM_THREADS": "1"}
    logs = [open(tmp_path / f"{tag}_{i}.log", "wb") for i in range(n)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(path)],
                              env={**env, "SIE_TPU_PROCESS_ID": str(i)},
                              stdout=logs[i], stderr=subprocess.STDOUT)
             for i in range(n)]
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for lg in logs:
            lg.close()
    for i, p in enumerate(procs):
        log = (tmp_path / f"{tag}_{i}.log").read_text()
        assert p.returncode == 0, log[-4000:]


@pytest.fixture(scope="module")
def runs(references, tmp_path_factory):
    """{scenario: the npz process 0 wrote}; also "first_<model>": one step
    over 'data' (2 processes)."""
    tmp = tmp_path_factory.mktemp("mesh_runs")
    by_n = {}
    for name, (model, n, shape, axes, path) in SCENARIOS.items():
        ref = references[model]
        by_n.setdefault(n, []).append(dict(
            name=name, cfg=ref.kw, mesh_shape=list(shape),
            mesh_axes=list(axes), variables=ref.vars, data=ref.data,
            path=path, beta=BETA, out=str(tmp)))
    for model, ref in references.items():
        data = np.load(ref.data)
        one = tmp / f"{model}_one.npz"
        np.savez(one, **{k: data[k] for k in ("x", "y", "mask")},
                 idx=data["idx"][:1], w=data["w"][:1])
        by_n[2].append(dict(name=f"first_{model}", cfg=ref.kw,
                            mesh_shape=[2], mesh_axes=["data"],
                            variables=ref.vars, data=str(one),
                            path="staged", beta=BETA, out=str(tmp)))
    for n, spec in by_n.items():
        _launch(spec, n, tmp, f"procs{n}")
    return {sc["name"]: dict(np.load(tmp / f"{sc['name']}.npz"))
            for spec in by_n.values() for sc in spec}


def _params(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_losses_equal_the_one_device_runs(name, runs, references):
    ref = references[SCENARIOS[name][0]]
    got = runs[name]["losses"]
    np.testing.assert_allclose(got, ref.jax_losses, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref.port_losses, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_parameters_and_batch_stats_equal_the_one_device_runs(name, runs,
                                                              references):
    ref = references[SCENARIOS[name][0]]
    lr = ref.kw["lr"]
    got = runs[name]
    params = _params(got, "params/")
    assert set(params) == set(_params(ref.jax_final, "params/"))
    for want_all in (ref.jax_final, ref.port_final):
        want = _params(want_all, "params/")
        for key, a in params.items():
            sure = np.all([np.abs(g[key]) >= 1e-4 for g in ref.grads],
                          axis=0)
            np.testing.assert_allclose(a[sure], want[key][sure], rtol=1e-5,
                                       atol=ATOL[ref.kw["dnn_type"]],
                                       err_msg=key)
            assert np.abs(a - want[key]).max() <= STEPS * 2.1 * lr, key
        stats = _params(got, "batch_stats/")
        assert set(stats) == set(_params(want_all, "batch_stats/"))
        for key, a in stats.items():
            b = want_all["batch_stats/" + key]
            assert np.abs(a - b).max() <= STEPS * 2.1 * lr, key


def test_the_first_step_equals_the_jax_step(runs, references):
    """One step of each model over 'data' from the same weights, against
    the JAX step, within the limits of the module docstring."""
    for model in MODELS:
        got = runs[f"first_{model}"]
        want = references[model].jax_first
        assert set(got) - {"losses", "logits", "again"} == set(want)
        grads = references[model].grads[0]
        for key, b in want.items():
            param = key.startswith("params/")
            sure = (np.abs(grads[key[len("params/"):]]) >= 1e-4 if param
                    else np.ones(b.shape, bool))
            atol = ATOL[MODELS[model]["dnn_type"]] if param else 1e-6
            np.testing.assert_allclose(got[key][sure], b[sure], rtol=1e-5,
                                       atol=atol, err_msg=key)
            assert np.abs(got[key] - b).max() <= 2.1 * BASE["lr"], key


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gathered_checkpoint_gives_the_logits_in_jax(name, runs, references):
    ref = references[SCENARIOS[name][0]]
    got = runs[name]
    np.testing.assert_array_equal(got["again"], got["logits"])
    variables = {}
    for key, v in got.items():
        if key.startswith(("params/", "batch_stats/")):
            node = variables
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
    if not variables.get("batch_stats"):
        variables.pop("batch_stats", None)
    model = jax_build_model(JConfig(**ref.kw))
    x, mask = ref.rows.x[:8], ref.rows.padding_mask[:8]
    logits, _ = model.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                            train=False)
    np.testing.assert_allclose(np.asarray(logits), got["logits"], rtol=1e-5,
                               atol=1e-5)
