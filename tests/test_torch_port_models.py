"""sie_tpu_torch models vs the JAX package at the same flax-initialised
weights (carried over by `load_jax_params`), on the CPU.

Tolerances: f32 (amp=False) 1e-4 abs, from f32 summation order; bf16
(amp=True) 5e-2 abs plus the same argmax, from bf16 rounding at different
places inside fused operations (a bf16 ulp of an O(1) activation is 2^-8)."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.models.sbm import PredicateAttention as JPredicateAttention
from sie_tpu_torch.compat.from_jax import ParamLoadError, load_jax_params
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.models.sbm import PredicateAttention

F32_TOL, BF16_TOL = 1e-4, 5e-2

BASE = dict(seq_len=40, enc_in=3, num_class=3, num_shapelet=2, d_model=32,
            n_heads=4, e_layers=2, d_ff=64, dropout=0.0, use_pallas=False,
            dnn_type="Transformer", seed=0)


def _jax_variables(cfg_kw, seed=0):
    jcfg = JConfig(**cfg_kw)
    model = jax_build(jcfg)
    x = jnp.zeros((2, jcfg.seq_len, jcfg.enc_in), jnp.float32)
    mask = jnp.ones((2, jcfg.seq_len), jnp.float32)
    variables = model.init({"params": jax.random.key(seed),
                            "dropout": jax.random.key(seed + 1)},
                           x, mask, train=False)
    return model, jax.tree.map(np.asarray, variables)


def _pair(cfg_kw, x, gating_values=(None,)):
    """[(port logits, port info, JAX logits, JAX info)] at one set of
    weights, one entry per gating value."""
    model, variables = _jax_variables(cfg_kw)
    mask = np.ones(x.shape[:2], np.float32)
    apply = jax.jit(model.apply, static_argnames=("train", "gating_value"))
    port = load_jax_params(build_model(Config(**cfg_kw), "cpu"),
                           variables["params"])
    out = []
    for gv in gating_values:
        jl, jinfo = apply(variables, jnp.asarray(x), jnp.asarray(mask),
                          train=False, gating_value=gv)
        with torch.inference_mode():
            tl, tinfo = port(torch.from_numpy(x), torch.from_numpy(mask),
                             gating_value=gv)
        out.append((tl.numpy(), tinfo, np.asarray(jl), jinfo))
    return out


def _x(seed=0, b=4):
    return np.random.default_rng(seed).normal(
        size=(b, BASE["seq_len"], BASE["enc_in"])).astype(np.float32)


def _assert_logits(got, want, amp):
    assert got.dtype == np.float32 and got.shape == want.shape
    tol = BF16_TOL if amp else F32_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    top2 = np.sort(want, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol    # rows without a near-tie
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


CASES = {
    "transformer": dict(model="DNN"),
    "transformer_fused": dict(model="DNN", fused_attention_min_len=0),
    "sbm_linear": dict(model="SBM", sbm_cls="linear"),
    "sbm_bilinear": dict(model="SBM", sbm_cls="bilinear"),
    "sbm_attention": dict(model="SBM", sbm_cls="attention"),
    "lts": dict(model="LTS", distance_func="sqeuclidean"),
    "interpgn": dict(model="InterpGN"),
}


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(case, amp):
    kw = dict(BASE, amp=amp, **CASES[case])
    [(got, tinfo, want, jinfo)] = _pair(kw, _x(1))
    _assert_logits(got, want, amp)
    if kw["model"] != "DNN":
        # predicates and distances are float32 in both packages
        np.testing.assert_allclose(tinfo.p.numpy(), np.asarray(jinfo.p),
                                   atol=1e-5)
        np.testing.assert_allclose(tinfo.d.numpy(), np.asarray(jinfo.d),
                                   atol=1e-5)
        np.testing.assert_allclose(tinfo.loss.numpy(),
                                   np.asarray(jinfo.loss), atol=1e-5)


@pytest.mark.parametrize("case", ["sbm_linear", "lts"])
def test_predicates_with_and_without_gradient_agree(case):
    """Inference takes the hard reductions (rbf of the min distance, the
    min); with a gradient the straight-through ones. Same values: the
    straight-through terms add soft - soft = 0."""
    kw = dict(BASE, amp=False, **CASES[case])
    model = build_model(Config(**kw), "cpu", torch.Generator().manual_seed(5))
    x = torch.from_numpy(_x(6))
    with torch.no_grad():
        p_hard, d_hard = model.predicates(x)
    p_ste, d_ste = model.predicates(x)
    assert p_ste.requires_grad and not p_hard.requires_grad
    np.testing.assert_allclose(p_ste.detach().numpy(), p_hard.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(d_ste.detach().numpy(), d_hard.numpy())


def test_interpgn_gate_and_hard_gating():
    kw = dict(BASE, model="InterpGN", amp=False)
    x = _x(2, b=6)
    for got, tinfo, want, jinfo in _pair(kw, x, (None, 0.0, 0.5)):
        _assert_logits(got, want, False)
        np.testing.assert_allclose(tinfo.eta.numpy(), np.asarray(jinfo.eta),
                                   atol=1e-5)
        np.testing.assert_allclose(tinfo.dnn_preds.numpy(),
                                   np.asarray(jinfo.dnn_preds), atol=F32_TOL)


def test_fused_gate_takes_the_kernel_branch(monkeypatch):
    import sie_tpu_torch.models.layers as layers_mod
    model = build_model(Config(**dict(BASE, model="DNN",
                                      fused_attention_min_len=0)), "cpu")
    layer = model.backbone.encoder.layers[0].attention
    assert layer.uses_kernel(40, 40, 8)
    assert not layer.uses_kernel(40, 40, 256)   # dk > 128
    assert not build_model(Config(**dict(BASE, model="DNN")), "cpu") \
        .backbone.encoder.layers[0].attention.uses_kernel(40, 40, 8)
    calls = []
    real = layers_mod.fused_attention
    monkeypatch.setattr(layers_mod, "fused_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        for b in (1, 2):   # b=1 folds heads into a view: must stay contiguous
            model(torch.from_numpy(_x(3, b=b)))
    assert len(calls) == 2 * BASE["e_layers"]


@pytest.mark.parametrize("amp", [False, True])
def test_predicate_attention_chunking_matches(amp):
    """Query chunking (used above 2048 features, F=7320 at the flagship)
    against the JAX module with a lowered threshold."""
    f = 40
    dt = jnp.bfloat16 if amp else jnp.float32
    jmod = JPredicateAttention(f, 16, dtype=dt, chunk=8, chunk_threshold=16)
    x = np.random.default_rng(4).random(size=(3, f)).astype(np.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(0),
                                                jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x))
                      .astype(jnp.float32))
    port = PredicateAttention(f, torch.bfloat16 if amp else torch.float32,
                              torch.Generator().manual_seed(0), chunk=8,
                              chunk_threshold=16)
    load_jax_params(port, params)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-2 if amp else 1e-5)


def test_load_rejects_missing_and_extra_leaves():
    kw = dict(BASE, model="InterpGN", amp=False)
    _, variables = _jax_variables(kw)
    params = variables["params"]
    port = build_model(Config(**kw), "cpu")
    missing = {k: v for k, v in params.items()}
    missing["sbm"] = {k: v for k, v in params["sbm"].items()
                      if k != "shapelets_0"}
    with pytest.raises(ParamLoadError, match="no flax leaf filled"):
        load_jax_params(port, missing)
    extra = dict(params, extra_leaf=np.zeros(3, np.float32))
    with pytest.raises(ParamLoadError, match="extra_leaf"):
        load_jax_params(port, extra)
    wrong = dict(params)
    wrong["sbm"] = dict(params["sbm"],
                        shapelets_0=np.zeros((1, 1, 1), np.float32))
    with pytest.raises(ParamLoadError, match="shape"):
        load_jax_params(port, wrong)


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("use_fused", [False, True])
def test_use_flash_attention_builds_and_matches_jax(use_fused, amp):
    """The JAX package takes its stock flash kernel only on a TPU and
    otherwise the fused gate or the XLA branch; the port takes the flag and
    the same two branches (min_len 0 puts T=40 through the fused one)."""
    kw = dict(BASE, model="InterpGN", amp=amp, use_flash_attention=True,
              use_fused_attention=use_fused, fused_attention_min_len=0)
    layer = build_model(Config(**kw), "cpu").deep_model.encoder.layers[0] \
        .attention
    assert layer.uses_kernel(40, 40, 8) == use_fused
    [(got, tinfo, want, jinfo)] = _pair(kw, _x(4))
    _assert_logits(got, want, amp)
    # the gate reads the expert's bf16 predictions under amp
    np.testing.assert_allclose(tinfo.eta.numpy(), np.asarray(jinfo.eta),
                               atol=BF16_TOL if amp else 1e-5)


def test_unported_parts_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(Config(**dict(BASE, model="DNN", dnn_type="PatchTST")),
                    "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(Config(**dict(BASE, model="DNN", dnn_type="TimesNet")),
                    "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(Config(**dict(BASE, model="DNN", moe_experts=2)), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(Config(**dict(BASE, model="DNN",
                                  attention_variant="prob")), "cpu")


def test_port_imports_no_jax():
    """The port imports neither jax nor the JAX package (checked in a fresh
    interpreter, since this test process has both loaded)."""
    code = ("import sys, sie_tpu_torch, sie_tpu_torch.serve, "
            "sie_tpu_torch.ops.build, sie_tpu_torch.train.trainer; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'sie_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
