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
- 'pipe' over 2 processes: InterpGN + Transformer through `train_step`
  on global batches. As in the JAX Trainer the axis shards nothing, so
  each rank trains the whole batch as one process does: losses and
  parameters equal a worker's run without a mesh bit for bit (the same
  process settings, so the same summation order).

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
bit. The first step's gradients, summed over the mesh (before the clip)
and gathered to the flax layout, equal `jax.grad` of the JAX loss on the
global batch leaf by leaf within 1e-5 x the leaf's max |g|
(tests/torch_port_mesh_refs.py `assert_grads_equal_jax`): Adam's update
hides a gradient counted a constant number of times, this does not.
"""

import numpy as np
import pytest

import torch_port_mesh_refs as R

BASE, STEPS, BETA = R.BASE, R.STEPS, R.BETA
MODELS = {"transformer": dict(BASE, dnn_type="Transformer"),
          "fcn": dict(BASE, dnn_type="FCN")}
ATOL = {"Transformer": 1e-6, "FCN": 1e-5}   # parameters after three steps
# name: (model, processes, mesh shape, mesh axes, path)
SCENARIOS = {
    "data_transformer": ("transformer", 2, (2,), ("data",), "staged"),
    "data_fcn": ("fcn", 2, (2,), ("data",), "staged"),
    "model_transformer": ("transformer", 2, (2,), ("model",), "step"),
    "model_fcn": ("fcn", 2, (2,), ("model",), "step"),
    "grid_transformer": ("transformer", 4, (2, 2), ("data", "model"),
                         "step"),
    "pipe_transformer": ("transformer", 2, (2,), ("pipe",), "step"),
}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Per model: the rows, the JAX initial variables (as a file), and the
    JAX trainer's and the port's one-process losses, final variables and
    each step's JAX gradients (tests/torch_port_mesh_refs.py)."""
    root = tmp_path_factory.mktemp("mesh_refs")
    return {name: R.reference(name, kw, root) for name, kw in MODELS.items()}


@pytest.fixture(scope="module")
def runs(references, tmp_path_factory):
    """{scenario: the npz process 0 wrote}; also "first_<model>": one step
    over 'data' (2 processes)."""
    tmp = tmp_path_factory.mktemp("mesh_runs")
    by_n = {}
    for name, (model, n, shape, axes, path) in SCENARIOS.items():
        by_n.setdefault(n, []).append(R.scenario(
            name, references[model], shape, axes, path, tmp))
    for model, ref in references.items():
        data = np.load(ref.data)
        one = tmp / f"{model}_one.npz"
        np.savez(one, **{k: data[k] for k in ("x", "y", "mask")},
                 idx=data["idx"][:1], w=data["w"][:1])
        by_n[2].append(dict(R.scenario(f"first_{model}", ref, (2,),
                                       ("data",), "staged", tmp),
                            data=str(one)))
    by_n[2].append(R.scenario("alone_transformer", references["transformer"],
                              (), (), "step", tmp))
    for n, spec in by_n.items():
        R.launch(spec, n, tmp, f"procs{n}")
    return {sc["name"]: dict(np.load(tmp / f"{sc['name']}.npz"))
            for spec in by_n.values() for sc in spec}


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
    params = R.params_of(got, "params/")
    assert set(params) == set(R.params_of(ref.jax_final, "params/"))
    for want_all in (ref.jax_final, ref.port_final):
        want = R.params_of(want_all, "params/")
        for key, a in params.items():
            sure = np.all([np.abs(g[key]) >= 1e-4 for g in ref.grads],
                          axis=0)
            np.testing.assert_allclose(a[sure], want[key][sure], rtol=1e-5,
                                       atol=ATOL[ref.kw["dnn_type"]],
                                       err_msg=key)
            assert np.abs(a - want[key]).max() <= STEPS * 2.1 * lr, key
        stats = R.params_of(got, "batch_stats/")
        assert set(stats) == set(R.params_of(want_all, "batch_stats/"))
        for key, a in stats.items():
            b = want_all["batch_stats/" + key]
            assert np.abs(a - b).max() <= STEPS * 2.1 * lr, key


def test_the_first_step_equals_the_jax_step(runs, references):
    """One step of each model over 'data' from the same weights, against
    the JAX step, within the limits of the module docstring."""
    for model in MODELS:
        got = runs[f"first_{model}"]
        want = references[model].jax_first
        assert set(k for k in got if not k.startswith("grads/")) - \
            R.RUN_OUTPUTS == set(want)
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
    np.testing.assert_allclose(R.jax_logits(got, ref.kw, ref.rows),
                               got["logits"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_first_step_gradients_equal_jax_grad(name, runs, references):
    R.assert_grads_equal_jax(runs[name],
                             references[SCENARIOS[name][0]].grads[0])


def test_pipe_trains_as_one_process_bit_for_bit(runs):
    got, want = runs["pipe_transformer"], runs["alone_transformer"]
    assert set(got) == set(want)
    for key in ("losses", "logits") + tuple(
            k for k in want if k.startswith(("params/", "grads/"))):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
