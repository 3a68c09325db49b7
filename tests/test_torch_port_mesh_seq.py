"""Sequence parallelism (the 'seq' mesh axis) on the CPU, against the JAX
package's single-device Trainer on the global batch: gloo processes
started from the launch variables (tests/torch_port_mesh_worker.py, no
JAX in them); the references and limits are tests/torch_port_mesh_refs.py.

- 'seq' over 2 processes: InterpGN + Transformer (staged path) and
  InterpGN + FCN (`train_step` on global batches), seq_len 24, f32,
  dropout 0, 3 steps of a global batch of 8, gradient_clip 0.05: losses
  (rtol 1e-5, atol 1e-6) and parameters (atol 1e-6, FCN 1e-5) equal the
  JAX trainer's and the port's one-process run, and one step from the
  same weights equals the JAX step, BatchNorm buffers within rtol 1e-5,
  atol 1e-6 (after three steps the port's one process and JAX differ by
  up to 2.8e-5 in FCN's running means, along the parameters' 8.0e-6, so
  the buffers are held there, as tests/test_torch_port_mesh_dist.py
  holds them, within 2.1 lr a step);
- ('seq', 'model') 2 x 2 over 4 processes: InterpGN + Transformer, held
  the same way;
- in each of those runs the backbone trains on time blocks: every
  forward sees 12 of the 24 steps, and takes its halos (the token
  embedding's one, FCN's three VALID convs') of 12-step blocks;
- the first step's gradients, summed over the mesh and gathered to the
  flax layout, equal `jax.grad` of the JAX loss on the global batch leaf
  by leaf within 1e-5 x the leaf's max |g|;
- the gathered checkpoint, applied by the JAX model, gives the worker's
  eval logits (1e-5), and loaded back gives them bit for bit;
- one MoE layer with its input time-sharded over ('data', 'seq') 2 x 2
  (the JAX package's tests/test_moe.py case, capacity_factor 2.0, top 1;
  and capacity_factor 1.0, top 2, with a router skewed to expert 0 so
  that tokens overflow the capacity) gives the JAX layer's outputs within
  1e-5;
- a time axis that the 'seq' size does not divide raises ValueError.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_port_mesh_refs as R
from sie_tpu.models.moe import MoEFFN as JMoEFFN
from sie_tpu_torch.parallel.mesh import Mesh, shard_batch

MODELS = {"transformer": dict(R.BASE, dnn_type="Transformer"),
          "fcn": dict(R.BASE, dnn_type="FCN")}
ATOL = {"Transformer": 1e-6, "FCN": 1e-5}
# name: (model, processes, mesh shape, mesh axes, path)
SCENARIOS = {
    "seq_transformer": ("transformer", 2, (2,), ("seq",), "staged"),
    "seq_fcn": ("fcn", 2, (2,), ("seq",), "step"),
    "seq_model_transformer": ("transformer", 4, (2, 2), ("seq", "model"),
                              "step"),
}
# a backbone forward's `comm.halo_seq` calls: the token embedding's
# circular pad; FCN's three VALID convs
HALOS = {"Transformer": 1, "FCN": 3}
MOE = {"cf2_top1": dict(capacity_factor=2.0, top_k=1),
       "cf1_top2_skewed": dict(capacity_factor=1.0, top_k=2)}
D, F, E, T = 8, 16, 4, 12


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_refs")
    return {name: R.reference(name, kw, root) for name, kw in MODELS.items()}


def _moe_cases(root):
    """Per MoE case: the JAX layer's variables (file), input (file) and
    output on the whole input."""
    out = {}
    x = np.random.default_rng(5).normal(size=(4, T, D)).astype(np.float32)
    np.savez(root / "moe_x.npz", x=x)
    for name, kw in MOE.items():
        m = JMoEFFN(D, F, E, **kw)
        params = jax.tree.map(np.asarray, m.init(jax.random.key(0),
                                                 jnp.asarray(x))["params"])
        if "skewed" in name:
            params["router"]["bias"] = params["router"]["bias"] + np.array(
                [2.0, 0.0, 0.0, 0.0], np.float32)
        np.savez(root / f"moe_{name}.npz", **R.flat(params))
        y = m.apply({"params": params}, jnp.asarray(x), train=False)
        out[name] = dict(variables=str(root / f"moe_{name}.npz"),
                         want=np.asarray(y))
    return out


@pytest.fixture(scope="module")
def runs(references, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_runs")
    by_n = {}
    for name, (model, n, shape, axes, path) in SCENARIOS.items():
        by_n.setdefault(n, []).append(R.scenario(
            name, references[model], shape, axes, path, tmp))
    for model, ref in references.items():    # one step over 'seq'
        data = np.load(ref.data)
        one = tmp / f"{model}_one.npz"
        np.savez(one, **{k: data[k] for k in ("x", "y", "mask")},
                 idx=data["idx"][:1], w=data["w"][:1])
        sc = R.scenario(f"first_{model}", ref, (2,), ("seq",), "staged",
                        tmp)
        by_n[2].append(dict(sc, data=str(one)))
    moe = _moe_cases(tmp)
    for name, kw in MOE.items():
        by_n[4].append(dict(kind="moe", name=f"moe_{name}",
                            moe=dict(d_model=D, d_ff=F, n_experts=E, **kw),
                            mesh_shape=[2, 2], mesh_axes=["data", "seq"],
                            variables=moe[name]["variables"],
                            data=str(tmp / "moe_x.npz"), out=str(tmp)))
    for n, spec in by_n.items():
        R.launch(spec, n, tmp, f"procs{n}")
    got = {name: dict(np.load(tmp / f"{name}.npz"))
           for name in list(SCENARIOS) + [f"first_{m}" for m in MODELS]}
    for name in MOE:
        y = np.zeros_like(moe[name]["want"])
        for rank in range(4):
            part = np.load(tmp / f"moe_{name}_{rank}.npz")
            i, j = int(part["data"]), int(part["seq"])
            b, t = part["y"].shape[:2]
            y[i * b:(i + 1) * b, j * t:(j + 1) * t] = part["y"]
        got[f"moe_{name}"] = dict(y=y, want=moe[name]["want"])
    return got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_trains_like_one_device(name, runs, references):
    ref = references[SCENARIOS[name][0]]
    R.assert_trains_like(runs[name], ref, ATOL[ref.kw["dnn_type"]])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_backbone_trains_on_time_blocks(name, runs, references):
    kw = references[SCENARIOS[name][0]].kw
    R.assert_time_blocks(runs[name], kw["seq_len"], 2, HALOS[kw["dnn_type"]])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_the_first_step_equals_the_jax_step(model, runs, references):
    ref = references[model]
    R.assert_first_step_like(runs[f"first_{model}"], ref,
                             ATOL[ref.kw["dnn_type"]])


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


@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_layer_with_time_sharded_input_equals_jax(name, runs):
    got = runs[f"moe_{name}"]
    np.testing.assert_allclose(got["y"], got["want"], rtol=1e-5, atol=1e-5)


def test_time_not_divisible_by_seq_raises():
    mesh = Mesh((2,), ("seq",), devices=["cpu", "cpu"])
    x = np.zeros((4, 845, 3), np.float32)
    with pytest.raises(ValueError, match="divisible by 2"):
        shard_batch((x, np.zeros(4)), mesh)
