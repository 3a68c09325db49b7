"""The port's EEGCNN against the JAX package's, at the same flax weights
and batch_stats (carried over by `load_jax_variables`), on the CPU: eval
logits from the running statistics; train-mode logits and the moved
statistics (JAX `mutable=["batch_stats"]`, dropout 0).

Cases: every pooling (none, mean, sum, top); 0, 1 and 2 encoder layers;
d_model equal to F2 (no projection) and not; an even temporal kernel
(flax's SAME puts (k - 1) // 2 taps before the input); padding masks with
padded tails; and the `eegcnn_*` defaults at enc_in 8, seq_len 200
(d_model 512, so `cnn_projection` is on). f32 and amp. Limits are those of
tests/test_torch_port_backbones.py: logits 1e-4 (f32) and 5e-2 with the
same argmax (bf16); statistics 1e-5 (f32) and 5e-3 (bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu_torch.compat.from_jax import load_jax_variables, to_jax_variables
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.eegcnn import reduced_length
from sie_tpu_torch.models.layers import same_pads
from sie_tpu_torch.models.registry import build_model
from test_torch_port_backbones import (_assert_logits, _assert_stats,
                                       _stats_like)

SMALL = dict(model="EEGCNN", seq_len=60, enc_in=4, num_class=3,
             eegcnn_cnn_f1=4, eegcnn_cnn_f2=2, eegcnn_kernel1=8,
             eegcnn_kernel2=5, eegcnn_pool1=2, eegcnn_pool2=3,
             eegcnn_n_heads=2, eegcnn_d_ff=16, eegcnn_dropout1=0.0,
             eegcnn_dropout2=0.0, use_pallas=False, seed=0)
CASES = {
    "mean_projected": dict(SMALL, eegcnn_layers=2, d_model=16,
                           eegcnn_pooling="mean"),
    "none_width_f2": dict(SMALL, eegcnn_layers=2, d_model=8,
                          eegcnn_pooling=None),
    "sum_no_encoder": dict(SMALL, eegcnn_layers=0, eegcnn_pooling="sum"),
    "top_one_layer": dict(SMALL, eegcnn_layers=1, d_model=16,
                          eegcnn_pooling="top"),
    "defaults": dict(model="EEGCNN", seq_len=200, enc_in=8, num_class=3,
                     eegcnn_dropout1=0.0, eegcnn_dropout2=0.0,
                     use_pallas=False, seed=0),
}


def _batch(kw, seed=0, b=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, kw["seq_len"], kw["enc_in"])).astype(np.float32)
    t = kw["seq_len"]
    lengths = np.array([t, (3 * t) // 4, t // 2, t // 5])[:b]
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eegcnn_matches_jax(case, amp):
    kw = dict(CASES[case], amp=amp)
    jmodel = jax_build(JConfig(**kw))
    x, mask = _batch(kw)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    init = jax.jit(jmodel.init, static_argnames=("train",))
    variables = jax.tree.map(np.asarray, init(jax.random.key(0), xj, mj,
                                              train=False))
    variables["batch_stats"] = _stats_like(variables["batch_stats"],
                                           np.random.default_rng(1))
    port = load_jax_variables(build_model(Config(**kw), "cpu"), variables)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    apply = jax.jit(jmodel.apply, static_argnames=("train", "mutable"))

    want, _ = apply(variables, xj, mj, train=False)
    with torch.inference_mode():
        got, info = port.eval()(xt, mt)
    _assert_logits(got.numpy(), np.asarray(want), amp)
    assert info.loss.shape == (1,) and float(info.loss[0]) == 0.0

    (want, _), new = apply(variables, xj, mj, train=True,
                           mutable=("batch_stats",))
    got, _ = port.train()(xt, mt)
    _assert_logits(got.detach().numpy(), np.asarray(want), amp)
    _assert_stats(to_jax_variables(port)["batch_stats"],
                  jax.tree.map(np.asarray, new["batch_stats"]), amp)


def test_same_padding_splits_as_flax():
    """flax's stride-1 SAME: k - 1 taps, (k - 1) // 2 before the input,
    for every kernel size the temporal convs can take."""
    for k in range(1, 130):
        lo, hi = same_pads((k,))
        want = jax.lax.padtype_to_pads((50,), (k,), (1,), "SAME")[0]
        assert (lo, hi) == tuple(want), k
    assert same_pads((3, 4)) == (1, 2, 1, 1)   # last axis first
    assert reduced_length(Config(**CASES["defaults"])) == 20
