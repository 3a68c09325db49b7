"""The port's reference-checkpoint import and export against the JAX
package's, on the CPU.

For each model the port has (SBM with its linear, bilinear and attention
heads; LTS; InterpGN + FCN, + Transformer, + TimesNet and + PatchTST;
the DNN Transformer and ResNet; EEGCNN), seeded flax variables (BatchNorm statistics made
non-trivial) go through `sie_tpu.compat.torch_export.export_state_dict`
into a reference-layout state_dict, saved as a `checkpoint.pth`. The port
imports it into a model built from other weights: its eval logits equal
the JAX model's at those variables within 1e-4 (f32 summation order, the
limit of tests/test_torch_port_models.py), and its own export is the JAX
exporter's key for key and bit for bit. A `module.` prefix is stripped,
missing and mismatched keys raise, the TimesNet and PatchTST converters
read back what the port writes as the JAX package's do, the JAX
package's extra backbones raise naming ROADMAP.md, and
`--import_torch_ckpt` reproduces the exporting run's test accuracy through `python -m sie_tpu_torch.run --device cpu`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.compat.torch_export import export_state_dict as jax_export
from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu_torch import run as port_run
from sie_tpu_torch.compat.from_jax import (load_jax_variables,
                                           to_jax_variables)
from sie_tpu_torch.compat.torch_export import export_state_dict
from sie_tpu_torch.compat.torch_import import (TorchImportError,
                                               convert_state_dict,
                                               load_into_model)
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.synthetic import write_synthetic_uea
from sie_tpu_torch.models.registry import build_model
from test_torch_port_backbones import _stats_like

F32_TOL = 1e-4
BASE = dict(seq_len=40, enc_in=3, num_class=3, num_shapelet=2, d_model=16,
            n_heads=2, e_layers=2, d_ff=32, dropout=0.0, amp=False,
            use_pallas=False, seed=0)
CASES = {
    "sbm_linear": dict(model="SBM", sbm_cls="linear"),
    "sbm_bilinear": dict(model="SBM", sbm_cls="bilinear"),
    "sbm_attention": dict(model="SBM", sbm_cls="attention"),
    "lts": dict(model="LTS", distance_func="sqeuclidean"),
    "interpgn_fcn": dict(model="InterpGN", dnn_type="FCN"),
    "interpgn_transformer": dict(model="InterpGN", dnn_type="Transformer"),
    "dnn_transformer": dict(model="DNN", dnn_type="Transformer"),
    "dnn_resnet": dict(model="DNN", dnn_type="ResNet"),
    "interpgn_timesnet": dict(model="InterpGN", dnn_type="TimesNet",
                              seq_len=24, d_model=8, d_ff=8, top_k=2,
                              num_kernels=3),
    "interpgn_patchtst": dict(model="InterpGN", dnn_type="PatchTST"),
    "eegcnn": dict(model="EEGCNN", seq_len=60, enc_in=4, eegcnn_cnn_f1=4,
                   eegcnn_cnn_f2=2, eegcnn_kernel1=8, eegcnn_kernel2=5,
                   eegcnn_pool1=2, eegcnn_pool2=3, eegcnn_n_heads=2,
                   eegcnn_d_ff=16, eegcnn_dropout1=0.0, eegcnn_dropout2=0.0,
                   eegcnn_layers=2),
}


def _jax_setup(kw):
    """(JAX model, its seeded variables as numpy, BatchNorm statistics
    made non-trivial)."""
    jmodel = jax_build(JConfig(**kw))
    x = jnp.zeros((2, kw["seq_len"], kw["enc_in"]), jnp.float32)
    mask = jnp.ones((2, kw["seq_len"]), jnp.float32)
    init = jax.jit(jmodel.init, static_argnames=("train",))
    variables = jax.tree.map(np.asarray, init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x,
        mask, train=False))
    stats = variables.get("batch_stats", {})
    return jmodel, {"params": variables["params"],
                    "batch_stats": _stats_like(stats,
                                               np.random.default_rng(2))}


def _batch(kw, b=4):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, kw["seq_len"], kw["enc_in"])).astype(np.float32)
    return x, np.ones((b, kw["seq_len"]), np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_reproduces_the_jax_model_and_export_matches(case, tmp_path):
    kw = dict(BASE, **CASES[case])
    jmodel, variables = _jax_setup(kw)
    sd = jax_export(variables, JConfig(**kw))
    path = str(tmp_path / "checkpoint.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    cfg = Config(**kw)
    port = build_model(cfg, "cpu", torch.Generator().manual_seed(7))
    unused = load_into_model(port, cfg, path)
    assert unused == []   # BN's num_batches_tracked is dropped silently
    x, mask = _batch(kw)
    want, _ = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                           train=False)
    port.eval()
    with torch.inference_mode():
        got, _ = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    mine = export_state_dict(to_jax_variables(port), cfg)
    assert list(mine) == list(sd)
    for k in sd:
        assert mine[k].dtype == sd[k].dtype and mine[k].shape == sd[k].shape
        np.testing.assert_array_equal(mine[k], sd[k], err_msg=k)


def test_module_prefix_is_stripped_and_keys_are_checked():
    kw = dict(BASE, **CASES["interpgn_transformer"])
    _jmodel, variables = _jax_setup(kw)
    cfg = Config(**kw)
    sd = jax_export(variables, JConfig(**kw))
    template = to_jax_variables(build_model(cfg, "cpu"))
    plain, _ = convert_state_dict(sd, cfg, template)
    prefixed, unused = convert_state_dict(
        {"module." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        cfg, template)
    assert unused == []
    for a, b in zip(jax.tree.leaves(plain), jax.tree.leaves(prefixed)):
        np.testing.assert_array_equal(a, b)
    missing = dict(sd)
    missing.pop("deep_model.projection.weight")
    with pytest.raises(KeyError, match="deep_model.projection.weight"):
        convert_state_dict(missing, cfg, template)
    bigger = {"params": dict(template["params"], extra={"kernel": np.zeros(
        (2, 2), np.float32)}), "batch_stats": {}}
    with pytest.raises(TorchImportError, match="did not cover"):
        convert_state_dict(sd, cfg, bigger)
    wrong = dict(sd)
    wrong["sbm.shapelets.0.weights"] = np.zeros((1, 1, 1), np.float32)
    with pytest.raises(TorchImportError, match="shape mismatch"):
        convert_state_dict(wrong, cfg, template)
    extra = dict(sd, **{"sbm.unknown.weight": np.zeros(2, np.float32)})
    _, unused = convert_state_dict(extra, cfg, template)
    assert unused == ["sbm.unknown.weight"]


@pytest.mark.parametrize("dnn", ["TimesNet", "PatchTST"])
def test_timesnet_and_patchtst_converters_round_trip_through_both_packages(
        dnn):
    """A port model's export reads back through the port's importer and
    the JAX package's into the same tree, its own variables."""
    from sie_tpu.compat.torch_import import convert_state_dict as jax_convert
    kw = dict(BASE, model="InterpGN", dnn_type=dnn, seq_len=24, top_k=2,
              num_kernels=3)
    cfg = Config(**kw)
    port = build_model(cfg, "cpu", torch.Generator().manual_seed(11))
    template = to_jax_variables(port)
    sd = export_state_dict(template, cfg)
    if dnn == "TimesNet":   # the reference's per-branch Conv2d kernels
        assert [sd[f"deep_model.model.0.conv.0.kernels.{k}.weight"].shape
                for k in range(3)] == [(32, 16, 1, 1), (32, 16, 3, 3),
                                       (32, 16, 5, 5)]
    mine, unused = convert_state_dict(sd, cfg, template)
    theirs, _ = jax_convert(sd, JConfig(**kw), template)
    assert unused == []
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(mine),
            jax.tree_util.tree_leaves_with_path(theirs)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(mine),
            jax.tree_util.tree_leaves_with_path(template)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dnn", ["Autoformer", "FEDformer", "ETSformer",
                                 "Pyraformer", "Crossformer"])
def test_unported_backbones_raise_naming_the_roadmap(dnn):
    """The JAX package's extra backbones, which the reference has no
    checkpoint.pth layout for: the importer has no converter for them and
    raises, as the JAX package's does. (Building one raised naming
    ROADMAP.md while the port lacked them; InterpGN with each now builds
    on the CPU and loads the JAX package's weights leaf for leaf.)"""
    cfg = Config(**dict(BASE, model="InterpGN", dnn_type=dnn, c_out=3,
                        moving_avg=5))
    jcfg = JConfig(**dict(BASE, model="InterpGN", dnn_type=dnn, c_out=3,
                          moving_avg=5, use_pallas=False))
    x = jnp.zeros((2, cfg.seq_len, cfg.enc_in), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jax_build(jcfg).init({"params": jax.random.key(0),
                                      "dropout": jax.random.key(1)}, x,
                                     jnp.ones(x.shape[:2]), train=False))
    rng = np.random.default_rng(2)
    variables = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), dict(shapes))
    model = load_jax_variables(build_model(cfg, "cpu"), variables)
    back = to_jax_variables(model)
    for key in variables:
        for a, b in zip(jax.tree.leaves(back[key]),
                        jax.tree.leaves(variables[key])):
            np.testing.assert_array_equal(a, b)
    sd = {"sbm.shapelets.0.weights": np.zeros((2, 3, 4), np.float32),
          "sbm.output_layer.weight": np.zeros((3, 2), np.float32)}
    with pytest.raises(TorchImportError, match="no torch importer"):
        convert_state_dict(sd, cfg, {"params": {}, "batch_stats": {}})


def test_cli_import_reproduces_the_exporting_run(tmp_path, capsys):
    write_synthetic_uea(str(tmp_path), "Toy", n_train=24, n_test=12,
                        n_dims=3, length=30, n_classes=2, seed=9)
    common = ["--device", "cpu", "--data", "UEA", "--data_root",
              str(tmp_path), "--dataset", "Toy", "--model", "InterpGN",
              "--dnn_type", "Transformer", "--num_shapelet", "2",
              "--d_model", "16", "--d_ff", "32", "--n_heads", "2",
              "--e_layers", "1", "--batch_size", "8", "--train_epochs", "2",
              "--log_interval", "1", "--seed", "0",
              "--result_dir", str(tmp_path / "result"),
              "--cache_dir", str(tmp_path / "cache")]
    pth = str(tmp_path / "ck.pth")
    first = port_run.main(common + ["--checkpoint_dir", str(tmp_path / "a"),
                                    "--export_torch_ckpt", pth])
    assert f"torch checkpoint exported to {pth}" in capsys.readouterr().out
    again = port_run.main(common + ["--checkpoint_dir", str(tmp_path / "b"),
                                    "--import_torch_ckpt", pth])
    out = capsys.readouterr().out
    assert "imported torch checkpoint" in out and "Epoch" not in out
    assert again[0][2]["accuracy"] == first[0][2]["accuracy"]
    assert again[0][1] == pytest.approx(first[0][1], abs=1e-6)
