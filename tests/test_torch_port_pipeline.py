"""The GPipe executor (sie_tpu_torch/parallel/pipeline.py) over gloo
processes on the CPU, against sie_tpu.parallel.pipeline on the 8-device
virtual CPU mesh of tests/conftest.py, at tests/test_pipeline.py's
shapes: d_model 16, d_ff 32, H 2, e_layers 4, x (8, 12, 16), f32,
dropout 0.

- `stack_stage_params`: the JAX package's (S, L/S, ...) layout and its
  ValueError;
- the forward of JAX's `pipelined_encoder_apply` and of the sequential
  encoder, for (S, M) = (2, 4) and (4, 2) over 'pipe', and ('data',
  'pipe') 2 x 2 at M 2, at atol/rtol 1e-5; every 'pipe' rank holds the
  output;
- the stage and input gradients of sum(sin(out)) against `jax.grad` of
  JAX's pipelined loss, per leaf within 1e-5 x the leaf's max |g| (a
  leaf whose max |g| is below 1e-6 of the tree's, the attention's key
  bias, is rounding noise in both packages: within 1e-5 x the tree's);
  under 'data', summed over the 'data' ranks; each stage's gradient
  comes from one copy of the cotangent (parallel/comm.py's rule);
- the stages gathered back (`gather_stage_params`) equal the loaded
  tree;
- a microbatch count that does not divide the batch: ValueError;
- the MoE encoder (e_layers 2, 4 experts, top 1) over 2 stages: the
  eval output against JAX's pipeline, and in training the output and
  aux against JAX's `return_aux` (rtol 1e-5); training without the aux
  raises ValueError matching "load-balance";
- at dropout 0.1, identical microbatches come out different (each
  microbatch draws its own masks).

One spawn of 2 processes and one of 4 run every scenario
(tests/torch_port_mesh_worker.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import torch_port_mesh_refs as R
from sie_tpu.config import Config as JConfig
from sie_tpu.models.layers import Encoder as JEncoder
from sie_tpu.parallel import pipeline as jpipe
from sie_tpu_torch.config import Config
from sie_tpu_torch.parallel import pipeline as ppipe

DENSE = dict(d_model=16, d_ff=32, n_heads=2, e_layers=4, dropout=0.0,
             amp=False)
MOE = dict(d_model=16, d_ff=32, n_heads=2, e_layers=2, dropout=0.0,
           amp=False, moe_experts=4, moe_top_k=1, use_fused_attention=False)
# name: (processes, mesh shape, mesh axes, microbatches, data axis)
MESHES = {"pipe2_m4": (2, (2,), ("pipe",), 4, None),
          "pipe4_m2": (4, (4,), ("pipe",), 2, None),
          "data2_pipe2_m2": (4, (2, 2), ("data", "pipe"), 2, "data")}


def _encoder(kw, x):
    cfg = JConfig(**kw)
    enc = JEncoder(cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.e_layers,
                   cfg.dropout, cfg.activation, moe_experts=cfg.moe_experts,
                   moe_top_k=cfg.moe_top_k)
    params = enc.init(jax.random.key(0), x, train=False)["params"]
    return cfg, enc, jax.tree.map(np.asarray, params)


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The JAX outputs and gradients, and the port's runs of every
    scenario (rank -> npz contents, by scenario name)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 12, 16)),
                    jnp.float32)
    cfg, enc, params = _encoder(DENSE, x)
    np.savez(tmp / "dense_vars.npz", **R.flat(params))
    np.savez(tmp / "x.npz", x=np.asarray(x))
    out = {"params": params, "seq": np.asarray(enc.apply(
        {"params": params}, x, train=False)), "x": np.asarray(x)}
    by_n = {2: [], 4: []}
    for name, (n, shape, axes, m, data) in MESHES.items():
        mesh = _jmesh(shape, axes)
        apply = lambda p, xx: jpipe.pipelined_encoder_apply(
            cfg, p, xx, mesh, n_microbatches=m, data_axis=data)
        # the output and the gradients of sum(sin(out)) in one program
        y, grads = jax.jit(lambda p, xx: (lambda o, vjp: (o, vjp(
            jnp.cos(o))))(*jax.vjp(apply, p, xx)))(params, x)
        out[name] = np.asarray(y)
        out[name + "_grads"] = jax.tree.map(np.asarray, grads)
        by_n[n].append(dict(kind="pipeline", name=name, cfg=DENSE,
                            mesh_shape=list(shape), mesh_axes=list(axes),
                            n_micro=m, data_axis=data, grads=True,
                            variables=str(tmp / "dense_vars.npz"),
                            data=str(tmp / "x.npz"), out=str(tmp)))
    # MoE: the eval pipeline and the training one with its aux
    xm = jnp.asarray(np.random.default_rng(0).normal(size=(4, 8, 16))
                     .astype(np.float32))
    mcfg, menc, mparams = _encoder(MOE, xm)
    np.savez(tmp / "moe_vars.npz", **R.flat(mparams))
    np.savez(tmp / "xm.npz", x=np.asarray(xm))
    mesh = _jmesh((2,), ("pipe",))
    out["moe_eval"] = np.asarray(jpipe.pipelined_encoder_apply(
        mcfg, mparams, xm, mesh, n_microbatches=2))
    y, aux = jpipe.pipelined_encoder_apply(
        mcfg, mparams, xm, mesh, n_microbatches=2, train=True,
        return_aux=True)
    out["moe_train"], out["moe_aux"] = np.asarray(y), float(aux)
    out["moe_params"], out["moe_x"] = mparams, np.asarray(xm)
    for name, train in (("moe_eval", False), ("moe_train", True)):
        by_n[2].append(dict(kind="pipeline", name=name, cfg=MOE,
                            mesh_shape=[2], mesh_axes=["pipe"], n_micro=2,
                            train=train, return_aux=train,
                            variables=str(tmp / "moe_vars.npz"),
                            data=str(tmp / "xm.npz"), out=str(tmp)))
    for rate in (0.0, 0.1):
        by_n[2].append(dict(kind="pipeline", name=f"dropout_{rate}",
                            cfg=dict(DENSE, dropout=rate), mesh_shape=[2],
                            mesh_axes=["pipe"], n_micro=4, train=True,
                            repeat=True,
                            variables=str(tmp / "dense_vars.npz"),
                            data=str(tmp / "x.npz"), out=str(tmp)))
    R.launch_together([(spec, n, f"procs{n}") for n, spec in by_n.items()],
                      tmp)
    for n, spec in by_n.items():
        for sc in spec:
            out["port_" + sc["name"]] = [dict(np.load(
                tmp / f"{sc['name']}_{r}.npz")) for r in range(n)]
    return out


def _output(ranks):
    """The global output: every 'pipe' rank's rows equal, 'data' blocks
    in order."""
    by_data = {}
    for r in ranks:
        d = int(r["data"])
        if d in by_data:
            np.testing.assert_array_equal(r["out"], by_data[d])
        by_data[d] = r["out"]
    return np.concatenate([by_data[d] for d in sorted(by_data)])


def test_stack_stage_params_layout():
    x = jnp.zeros((8, 12, 16), jnp.float32)
    _, _, params = _encoder(DENSE, x)
    layers = [params[f"layer_{i}"] for i in range(4)]
    got = ppipe.stack_stage_params(layers, 2)
    want = jpipe.stack_stage_params(layers, 2)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape[:2] == (2, 2)
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got["norm1"]["scale"][1, 0],
                                  layers[2]["norm1"]["scale"])
    with pytest.raises(ValueError, match="do not split"):
        ppipe.stack_stage_params(layers, 3)
    with pytest.raises(ValueError, match="do not split"):
        jpipe.stack_stage_params(layers, 3)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_forward_equals_jax_and_the_sequential_encoder(name, refs):
    got = _output(refs["port_" + name])
    np.testing.assert_allclose(got, refs[name], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, refs["seq"], atol=1e-5, rtol=1e-5)


def _assert_leafwise(got, want):
    top = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for key, w in want.items():
        scale = float(np.abs(w).max())
        if scale < 1e-6 * top:
            scale = top
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5 * scale,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_stage_and_input_gradients_equal_jax_grad(name, refs):
    ranks = refs["port_" + name]
    want_params, want_x = refs[name + "_grads"]
    got = {}
    for r in ranks:
        for key, v in R.params_of(r, "grads/").items():
            if key.startswith("norm/") and int(r["pipe"]) != 0:
                np.testing.assert_array_equal(
                    v, [q for q in ranks if int(q["data"]) == int(r["data"])
                        and int(q["pipe"]) == 0][0]["grads/" + key])
                continue
            got[key] = got.get(key, 0) + v
    _assert_leafwise(got, R.flat(want_params))
    xgrad = sum(r["xgrad"] for r in ranks)
    for r in ranks:          # the input's gradient lands on stage 0
        if int(r["pipe"]) != 0:
            assert not np.any(r["xgrad"])
    _assert_leafwise({"x": xgrad}, {"x": np.asarray(want_x)})


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gathered_stages_equal_the_loaded_tree(name, refs):
    got = R.params_of(refs["port_" + name][0], "gathered/")
    want = R.flat(refs["params"])
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)


def test_a_batch_that_does_not_split_into_microbatches_raises(refs):
    from types import SimpleNamespace
    mesh = SimpleNamespace(size=lambda a: 2, index=lambda a: 0)
    stage = ppipe.encoder_stage(Config(**DENSE), 2)
    x = torch.from_numpy(refs["x"].copy())
    with pytest.raises(ValueError, match="microbatch"):
        ppipe.pipelined_encoder_apply(Config(**DENSE), stage, x, mesh,
                                      n_microbatches=3)
    # 12 rows split into 4 microbatches, but not 6 rows of a 'data' rank
    with pytest.raises(ValueError, match="microbatch"):
        ppipe.pipelined_encoder_apply(Config(**DENSE), stage,
                                      torch.cat([x, x[:4]]), mesh,
                                      n_microbatches=4, data_axis="data")
    jmesh = _jmesh((4,), ("pipe",))
    with pytest.raises(ValueError, match="microbatch"):
        jpipe.pipelined_encoder_apply(JConfig(**DENSE), refs["params"],
                                      jnp.asarray(refs["x"]), jmesh,
                                      n_microbatches=3)


def test_moe_pipeline_equals_jax_with_its_aux(refs):
    np.testing.assert_allclose(_output(refs["port_moe_eval"]),
                               refs["moe_eval"], atol=1e-5, rtol=1e-5)
    ranks = refs["port_moe_train"]
    np.testing.assert_allclose(_output(ranks), refs["moe_train"],
                               atol=1e-5, rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(float(r["aux"]), refs["moe_aux"],
                                   rtol=1e-5)


def test_moe_training_without_the_aux_raises(refs):
    from types import SimpleNamespace
    cfg = Config(**MOE)
    mesh = SimpleNamespace(size=lambda a: 2, index=lambda a: 0)
    x = torch.from_numpy(refs["moe_x"].copy())
    with pytest.raises(ValueError, match="load-balance"):
        ppipe.pipelined_encoder_apply(cfg, ppipe.encoder_stage(cfg, 2), x,
                                      mesh, n_microbatches=2, train=True)
    with pytest.raises(ValueError, match="load-balance"):
        jpipe.pipelined_encoder_apply(JConfig(**MOE), refs["moe_params"],
                                      jnp.asarray(refs["moe_x"]),
                                      _jmesh((2,), ("pipe",)),
                                      n_microbatches=2, train=True)


def test_microbatches_draw_their_own_dropout_masks(refs):
    for rate in (0.0, 0.1):
        out = _output(refs[f"port_dropout_{rate}"])
        mbs = out.reshape(4, 2, *out.shape[1:])
        same = [np.array_equal(mbs[i], mbs[j])
                for i in range(4) for j in range(i + 1, 4)]
        # the same input rows in every microbatch
        assert all(same) if rate == 0.0 else not any(same)
