"""Expert parallelism (the 'expert' mesh axis) on the CPU, against the JAX
package's single-device Trainer on the global batch: gloo processes
started from the launch variables (tests/torch_port_mesh_worker.py, no
JAX in them); the references and limits are tests/torch_port_mesh_refs.py.

InterpGN + Transformer with a MoE encoder (`moe_experts` 4), seq_len 24,
f32, dropout 0, 3 steps of a global batch of 8, gradient_clip 0.05:
- 'expert' over 2 processes (2 experts a rank), top_k 1 (staged path)
  and top_k 2 (`train_step`);
- ('data', 'expert') and ('expert', 'model') 2 x 2 over 4 processes,
  top_k 1 (the latter splits d_ff too);
each held as tests/test_torch_port_mesh_seq.py holds its runs: losses,
parameters, the first step's summed gradients against `jax.grad`, the
gathered checkpoint through the JAX model. The load-balance loss of a
train-mode forward from the trained weights equals the JAX model's sown
`moe_aux` (rtol 1e-5). A mesh whose 'expert' size does not divide the
experts raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_mesh_refs as R
from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build_model
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.parallel.mesh import Mesh, shard_params

MOE = dict(R.BASE, dnn_type="Transformer", moe_experts=4)
MODELS = {"top1": dict(MOE, moe_top_k=1), "top2": dict(MOE, moe_top_k=2)}
# name: (model, processes, mesh shape, mesh axes, path)
SCENARIOS = {
    "expert_top1": ("top1", 2, (2,), ("expert",), "staged"),
    "expert_top2": ("top2", 2, (2,), ("expert",), "step"),
    "data_expert_top1": ("top1", 4, (2, 2), ("data", "expert"), "step"),
    "expert_model_top1": ("top1", 4, (2, 2), ("expert", "model"), "step"),
}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    root = tmp_path_factory.mktemp("expert_refs")
    return {name: R.reference(name, kw, root) for name, kw in MODELS.items()}


@pytest.fixture(scope="module")
def runs(references, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_runs")
    by_n = {}
    for name, (model, n, shape, axes, path) in SCENARIOS.items():
        by_n.setdefault(n, []).append(R.scenario(
            name, references[model], shape, axes, path, tmp))
    for n, spec in by_n.items():
        R.launch(spec, n, tmp, f"procs{n}")
    return {name: dict(np.load(tmp / f"{name}.npz")) for name in SCENARIOS}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_trains_like_one_device(name, runs, references):
    R.assert_trains_like(runs[name], references[SCENARIOS[name][0]], 1e-6)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_first_step_gradients_equal_jax_grad(name, runs, references):
    R.assert_grads_equal_jax(runs[name],
                             references[SCENARIOS[name][0]].grads[0])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gathered_checkpoint_gives_the_logits_in_jax(name, runs, references):
    ref = references[SCENARIOS[name][0]]
    got = runs[name]
    np.testing.assert_array_equal(got["again"], got["logits"])
    np.testing.assert_allclose(R.jax_logits(got, ref.kw, ref.rows),
                               got["logits"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_aux_loss_equals_the_jax_one(name, runs, references):
    ref = references[SCENARIOS[name][0]]
    got = runs[name]
    params = {}
    for key, v in R.params_of(got, "params/").items():
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    model = jax_build_model(JConfig(**ref.kw))
    _, sown = model.apply({"params": params}, jnp.asarray(ref.rows.x[:8]),
                          jnp.asarray(ref.rows.padding_mask[:8]), train=True,
                          rngs={"dropout": jax.random.key(0)},
                          mutable=["losses"])
    want = sum(float(np.sum(s)) for s in jax.tree.leaves(sown["losses"]))
    np.testing.assert_allclose(float(got["aux"]), want, rtol=1e-5)


def test_experts_that_do_not_split_raise():
    mesh = Mesh((3,), ("expert",), devices=["cpu"] * 3)
    model = build_model(Config(**MODELS["top1"]), "cpu",
                        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="do not split"):
        shard_params(model, mesh)
