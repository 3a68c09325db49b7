"""The port's device meshes (sie_tpu_torch/parallel/) against the JAX
package's, in one process on the CPU:

- `make_mesh`: the shapes, axis names, None and ValueError of
  sie_tpu.parallel.mesh.make_mesh on the 8 virtual CPU devices of
  tests/conftest.py, over eight "cpu" devices;
- `params_partition_specs` over the port's flax-layout parameters equals
  the JAX package's rules on the same tree, for InterpGN + Transformer,
  LTS, EEGCNN and a MoE encoder, under ('data', 'model'), ('data',
  'expert', 'model'), ('data', 'expert') and ('expert', 'model');
- `host_fold_slice` over the JAX package's cases;
- `init_distributed` without the launch variables is a no-op; every
  axis of the JAX CLI ('pipe' too) builds a `Mesh` and passes the
  command line, where an unknown axis name, or fewer names than the mesh
  has dimensions, raises ValueError; 'seq', 'expert' and 'pipe' meshes
  serve one step equal to the predictor without a mesh; a batch that
  does not split over 'data', or a time axis over 'seq', raises;
- `Predictor(mesh=...)` over two "cpu" devices gives the predictor's
  outputs without a mesh bit for bit at 1, 5, 64 and 70 rows (a chunk of
  64 and a remainder).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.parallel import mesh as jax_mesh
from sie_tpu.parallel.multihost import host_fold_slice as jax_fold_slice
from sie_tpu_torch import run as port_run
from sie_tpu_torch.compat.from_jax import to_jax_params
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.parallel import mesh as port_mesh
from sie_tpu_torch.parallel.multihost import host_fold_slice, init_distributed
from sie_tpu_torch.serve import Predictor

TINY = dict(seq_len=24, enc_in=3, num_class=3, num_shapelet=2, d_model=16,
            d_ff=32, n_heads=2, e_layers=1, dropout=0.0,
            fused_attention_min_len=0, seed=0)


@pytest.mark.parametrize("shape", [(4, 2), (8,), (2, 4), (), (1,), (1, 1),
                                   (16,), (4, 4)], ids=str)
def test_make_mesh_equals_the_jax_one(shape):
    assert jax.device_count() == 8
    try:
        want = jax_mesh.make_mesh(JConfig(mesh_shape=shape))
    except ValueError:
        with pytest.raises(ValueError, match="needs"):
            port_mesh.make_mesh(Config(mesh_shape=shape), devices=["cpu"] * 8)
        return
    got = port_mesh.make_mesh(Config(mesh_shape=shape), devices=["cpu"] * 8)
    if want is None:
        assert got is None
        return
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert got.shape == dict(want.shape)


def test_a_process_mesh_needs_its_processes():
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        port_mesh.make_mesh(Config(mesh_shape=(2,)))
    assert port_mesh.make_mesh(Config(mesh_shape=(1,))) is None


def _spec_tree_equal(got, want, path=()):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _spec_tree_equal(got[k], want[k], path + (k,))
        return
    assert tuple(got) == tuple(want), (path, got, want)


SPEC_MODELS = {
    "interpgn_transformer": dict(TINY, model="InterpGN",
                                 dnn_type="Transformer"),
    "lts": dict(TINY, model="LTS"),
    "eegcnn": dict(TINY, model="EEGCNN", eegcnn_n_heads=2, eegcnn_d_ff=32,
                   target_timepoints=250, seq_len=250, enc_in=8),
    "moe": dict(TINY, model="InterpGN", dnn_type="Transformer",
                moe_experts=4),
}


@pytest.mark.parametrize("axes", [("data", "model"),
                                  ("data", "expert", "model"),
                                  ("data", "expert"), ("expert", "model")],
                         ids=str)
@pytest.mark.parametrize("name", sorted(SPEC_MODELS))
def test_partition_specs_equal_the_jax_rules(name, axes):
    params = to_jax_params(build_model(Config(**SPEC_MODELS[name]), "cpu"))
    mesh = SimpleNamespace(axis_names=axes)
    want = jax_mesh.params_partition_specs(params, mesh)
    got = port_mesh.params_partition_specs(params, mesh)
    _spec_tree_equal(got, want)
    if "model" in axes and name != "eegcnn":
        sbm = got.get("sbm", got)
        assert tuple(sbm["shapelets_0"]) == ("model", None, None)


@pytest.mark.parametrize("n_folds,hosts", [(5, 2), (8, 4), (3, 4), (7, 3),
                                           (1, 1), (6, 6), (3, 2)])
def test_host_fold_slices_equal_the_jax_ones(n_folds, hosts):
    seen = []
    for pi in range(hosts):
        sl = host_fold_slice(n_folds, pi, hosts)
        assert sl == jax_fold_slice(n_folds, pi, hosts)
        seen.extend(range(n_folds)[sl])
    assert seen == list(range(n_folds))


def test_init_distributed_is_a_noop_without_the_launch(monkeypatch):
    monkeypatch.delenv("SIE_TPU_COORDINATOR", raising=False)
    assert init_distributed() is False
    assert init_distributed(coordinator_address="localhost:1",
                            num_processes=1) is False
    assert host_fold_slice(5) == slice(0, 5)


@pytest.mark.parametrize("axis", ["pipe"])
def test_unported_axes_raise(axis, tmp_path):
    """No axis is left unported: 'pipe' builds and passes the command
    line (the JAX CLI takes it, `run.py:165-171`); what still raises is
    an axis name no mesh knows, or too few names."""
    mesh = port_mesh.Mesh((2, 2), ("data", axis), devices=["cpu"] * 4)
    assert (mesh.size(axis), mesh.size("data")) == (2, 2)
    port_run.check_mesh_args(port_run.get_args(
        ["--mesh", "2x2", "--mesh_axes", f"data,{axis}"]))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        port_mesh.Mesh((2, 2), ("data", "stage"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        port_run.check_mesh_args(port_run.get_args(
            ["--mesh", "2x2", "--mesh_axes", "data,stage"]))
    with pytest.raises(ValueError, match="axis names"):
        port_run.check_mesh_args(port_run.get_args(
            ["--mesh", "2x2", "--mesh_axes", axis]))
    # an axis of one member is no parallelism: accepted
    port_mesh.Mesh((2, 1), ("data", axis), devices=["cpu"] * 2)


@pytest.mark.parametrize("axis", ["seq", "expert", "pipe"])
def test_seq_and_expert_meshes_build_and_serve_a_step(axis):
    mesh = port_mesh.Mesh((2, 2), ("data", axis), devices=["cpu"] * 4)
    assert mesh.size(axis) == 2
    args = port_run.get_args(["--mesh", "2x2", "--mesh_axes",
                              f"data,{axis}"])
    port_run.check_mesh_args(args)
    cfg = Config(**TINY, model="InterpGN", dnn_type="Transformer",
                 moe_experts=4 if axis == "expert" else 0)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(5))
    variables = {"params": to_jax_params(model)}
    x = np.random.default_rng(2).normal(
        size=(6, TINY["seq_len"], TINY["enc_in"])).astype(np.float32)
    want = Predictor(cfg, variables, device="cpu").predict(x)
    got = Predictor(cfg, variables, mesh=mesh).predict(x)
    np.testing.assert_array_equal(got.logits, want.logits)


def test_a_time_axis_splits_over_seq_or_raises():
    mesh = port_mesh.Mesh((2,), ("seq",), devices=["cpu", "cpu"])
    assert port_mesh.seq_block(24, mesh) == slice(0, 12)
    with pytest.raises(ValueError, match="divisible by 2"):
        port_mesh.seq_block(845, mesh)
    x, y = np.zeros((4, 24, 3)), np.zeros(4)
    got = port_mesh.shard_batch((x, y), mesh)
    assert got[0].shape == (4, 12, 3) and got[1].shape == (4,)


def test_a_batch_splits_over_data_or_raises():
    mesh = port_mesh.Mesh((2,), ("data",), devices=["cpu", "cpu"])
    assert port_mesh.data_block(8, mesh) == slice(0, 4)
    with pytest.raises(ValueError, match="does not split"):
        port_mesh.data_block(7, mesh)
    rows = np.arange(8)
    assert isinstance(port_mesh.shard_batch((rows,), mesh),
                      port_mesh.LocalBatch)
    assert port_mesh.shard_batch((rows,), None)[0] is rows
    assert not port_mesh.mesh_spans_processes(mesh)


@pytest.fixture(scope="module")
def predictors():
    cfg = Config(**TINY, model="InterpGN", dnn_type="Transformer")
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    variables = {"params": to_jax_params(model)}
    mesh = port_mesh.make_mesh(cfg.replace(mesh_shape=(2,)),
                               devices=["cpu", "cpu"])
    return (Predictor(cfg, variables, device="cpu", max_batch=64),
            Predictor(cfg, variables, max_batch=64, mesh=mesh))


@pytest.mark.parametrize("rows", [1, 5, 64, 70])
def test_mesh_predictor_equals_the_plain_one(predictors, rows):
    plain, meshed = predictors
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, TINY["seq_len"], TINY["enc_in"])).astype(
        np.float32)
    want, got = plain.predict(x), meshed.predict(x)
    assert meshed._bucket(rows) % 2 == 0
    for field in ("logits", "probs", "classes", "eta", "p", "d",
                  "shapelet_preds", "dnn_preds"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
