"""sie_tpu_torch's grouped shapelet-bank path (`fuse_short_banks`: the plain
versions of K3 and K4, the autograd wrapper and the SBM's gate) vs the JAX
package on the CPU: `l1_sliding_distance_grouped` and its custom VJP with
the Pallas kernels in interpret mode, and the SBM / InterpGN modules with
the same flag at the same flax weights. The CUDA kernels themselves are
held against K1 and K2 on the card by tests/test_torch_port_kernels.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.ops.pallas.shapelet_pallas import (
    l1_sliding_distance_grouped as jax_grouped)
from sie_tpu_torch.compat.from_jax import load_jax_params
from sie_tpu_torch.config import Config
from sie_tpu_torch.models import sbm as sbm_mod
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance_bwd,
                                           l1_sliding_distance_grouped,
                                           l1_sliding_distance_grouped_bwd,
                                           l1_sliding_distance_plain)

FWD_TOL = 1e-5    # f32 distances: summation order (scan vs Pallas taps)
GRAD_TOL = 1e-5   # x max|want|: f32 sums of B * W terms in another order
F32_TOL = 1e-4    # f32 logits, as tests/test_torch_port_models.py

# (B, C, T, ((n, L) of each bank, ascending L))
CASES = {
    # the JAX package's own grouped test (tests/test_pallas_kernel.py)
    "jax_test": (3, 7, 60, ((4, 5), (3, 11), (2, 23))),
    # the flagship's six length fractions at T=40, small B, C and n
    "flagship_like": (2, 2, 40, tuple((3, max(3, int(np.ceil(f * 40))))
                                      for f in (0.05, 0.1, 0.2, 0.3, 0.5,
                                                0.8))),
}


def _inputs(case, seed=0):
    b, c, t, spec = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    banks = [rng.normal(size=(n, c, l)).astype(np.float32) for n, l in spec]
    return x, banks


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_path_and_gradients_match_pallas_interpret(case):
    """Forward and the bank gradients of sum(sin(d)) against the Pallas
    grouped kernels' custom VJP in interpret mode."""
    x, banks = _inputs(case)
    tb = [torch.from_numpy(s).requires_grad_() for s in banks]
    outs = l1_sliding_distance_grouped(torch.from_numpy(x), tb)
    sum(d.sin().sum() for d in outs).backward()

    jx, jb = jnp.asarray(x), tuple(jnp.asarray(s) for s in banks)
    want = jax_grouped(jx, jb, True)
    jgrads = jax.grad(lambda bs: sum(jnp.sum(jnp.sin(d)) for d in
                                     jax_grouped(jx, bs, True)))(jb)
    for d, w, s in zip(outs, want, banks):
        assert d.shape == (x.shape[0], s.shape[0], x.shape[1],
                           x.shape[2] - s.shape[2] + 1)
        np.testing.assert_allclose(d.detach().numpy(), np.asarray(w),
                                   atol=FWD_TOL, rtol=0)
    for t, w in zip(tb, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()))


def test_plain_versions_are_the_per_bank_ones():
    """K3's and K4's plain versions are K1's and K2's, bank by bank; the
    gradient of x is None, as for K1."""
    x, banks = _inputs("jax_test", seed=3)
    tx = torch.from_numpy(x).requires_grad_()
    tb = [torch.from_numpy(s).requires_grad_() for s in banks]
    outs = l1_sliding_distance_grouped(tx, tb)
    rng = np.random.default_rng(4)
    gs = [torch.from_numpy(rng.normal(size=d.shape).astype(np.float32))
          for d in outs]
    torch.autograd.backward(outs, gs)
    assert tx.grad is None
    direct = l1_sliding_distance_grouped_bwd(tx.detach(),
                                             [s.detach() for s in tb], gs)
    for s, d, g, gr, t in zip(banks, outs, gs, direct, tb):
        assert torch.equal(d, l1_sliding_distance_plain(torch.from_numpy(x),
                                                        torch.from_numpy(s)))
        want = l1_sliding_distance_bwd(torch.from_numpy(x),
                                       torch.from_numpy(s), g)
        assert torch.equal(gr, want) and torch.equal(t.grad, want)


def test_only_some_banks_need_a_gradient():
    x, banks = _inputs("jax_test", seed=5)
    tb = [torch.from_numpy(s) for s in banks]
    tb[1].requires_grad_()
    sum(d.sum() for d in l1_sliding_distance_grouped(
        torch.from_numpy(x), tb)).backward()
    assert tb[0].grad is None and tb[2].grad is None
    assert tb[1].grad is not None and tb[1].grad.shape == tb[1].shape


def test_wrapper_rejects_what_the_kernels_do_not_take():
    x, banks = _inputs("jax_test")
    tx, tb = torch.from_numpy(x), [torch.from_numpy(s) for s in banks]
    with pytest.raises(ValueError, match="ascending"):
        l1_sliding_distance_grouped(tx, tb[::-1])
    with pytest.raises(ValueError, match="2 to 8"):
        l1_sliding_distance_grouped(tx, tb[:1])
    with pytest.raises(ValueError, match="2 to 8"):
        l1_sliding_distance_grouped(tx, [tb[0]] * 9)
    with pytest.raises(ValueError):
        l1_sliding_distance_grouped(tx, [tb[0], tb[1][:, :3]])   # two C
    with pytest.raises(ValueError):
        l1_sliding_distance_grouped(tx, [tb[0], torch.zeros(2, 7, 61)])
    with pytest.raises(ValueError, match="one output gradient per bank"):
        l1_sliding_distance_grouped_bwd(tx, tb, [])
    before = (l1_sliding_distance_grouped.launches,
              l1_sliding_distance_grouped_bwd.launches)
    outs = l1_sliding_distance_grouped(tx, tb)
    l1_sliding_distance_grouped_bwd(tx, tb, [torch.ones_like(d)
                                             for d in outs])
    assert (l1_sliding_distance_grouped.launches,
            l1_sliding_distance_grouped_bwd.launches) == before   # the CPU


# ------------------------------------------------------------------ models
BASE = dict(data="UEA", dataset="toy", seq_len=40, enc_in=3, num_class=3,
            num_shapelet=2, d_model=16, n_heads=2, e_layers=1, d_ff=32,
            dropout=0.0, amp=False, dnn_type="Transformer", seed=0)


def _jax_pair(kw, x, monkeypatch):
    """(port model, flax params, JAX logits, JAX info) at one set of flax
    weights; the JAX package runs its grouped Pallas kernel in interpret
    mode."""
    jcfg = JConfig(use_pallas=True, **kw)
    model = jax_build(jcfg)
    mask = jnp.ones(x.shape[:2], jnp.float32)
    with monkeypatch.context() as m:
        m.setenv("SIE_TPU_PALLAS_INTERPRET", "1")
        variables = model.init({"params": jax.random.key(0),
                                "dropout": jax.random.key(1)},
                               jnp.asarray(x), mask, train=False)
        logits, info = model.apply(variables, jnp.asarray(x), mask,
                                   train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    port = load_jax_params(build_model(Config(**kw), "cpu"), params)
    return port, params, np.asarray(logits), info


@pytest.mark.parametrize("model", ["SBM", "InterpGN"])
def test_fused_models_match_the_jax_package(model, monkeypatch):
    """The port and the JAX package with fuse_short_banks=True at the same
    flax weights; one checkpoint serves the port fused and unfused (the
    flag adds no parameters)."""
    kw = dict(BASE, model=model, fuse_short_banks=True)
    if model == "SBM":
        kw["shapelet_lengths"] = (0.1, 0.3)   # tests/test_pallas_kernel.py
    x = np.random.default_rng(7).normal(size=(4, 40, 3)).astype(np.float32)
    port, params, want, jinfo = _jax_pair(kw, x, monkeypatch)
    unfused = load_jax_params(build_model(Config(**dict(
        kw, fuse_short_banks=False)), "cpu"), params)
    calls = []
    real = sbm_mod.l1_sliding_distance_grouped
    monkeypatch.setattr(sbm_mod, "l1_sliding_distance_grouped",
                        lambda *a: calls.append(len(a[1])) or real(*a))
    with torch.inference_mode():
        got, info = port(torch.from_numpy(x),
                         torch.ones(x.shape[:2]))
    assert calls == [len(kw.get("shapelet_lengths",
                                Config().shapelet_lengths))]
    with torch.inference_mode():
        got_unfused, _ = unfused(torch.from_numpy(x), torch.ones(x.shape[:2]))
    assert len(calls) == 1 and torch.equal(got, got_unfused)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(info.p.numpy(), np.asarray(jinfo.p),
                               atol=1e-5)
    np.testing.assert_allclose(info.d.numpy(), np.asarray(jinfo.d),
                               atol=1e-5)


def _model_pair(seed=0, **kw):
    cfg = dict(BASE, model="InterpGN", **kw)
    fused = build_model(Config(fuse_short_banks=True, **cfg), "cpu",
                        torch.Generator().manual_seed(seed))
    plain = build_model(Config(**cfg), "cpu",
                        torch.Generator().manual_seed(seed))
    return fused, plain


@pytest.mark.parametrize("sbm_cls", ["linear", "bilinear", "attention"])
def test_fused_equals_unfused_on_the_cpu(sbm_cls):
    """Same weights, fused and per-bank: the same logits, predicates and
    distances, and the same gradients in training mode, bit for bit (the
    plain versions are the per-bank ones)."""
    fused, plain = _model_pair(sbm_cls=sbm_cls)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(3, 40, 3)).astype(np.float32))
    with torch.inference_mode():
        (lf, inf_f), (lp, inf_p) = fused(x), plain(x)
    assert torch.equal(lf, lp) and torch.equal(inf_f.p, inf_p.p)
    assert torch.equal(inf_f.d, inf_p.d)
    grads = []
    for m in (fused.train(), plain.train()):
        out, info = m(x)
        (out.square().sum() + info.loss.sum()).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def _grouped_calls(monkeypatch, cfg_kw, model="SBM"):
    """The bank counts of each grouped launch one forward makes."""
    calls = []
    real = sbm_mod.l1_sliding_distance_grouped
    monkeypatch.setattr(sbm_mod, "l1_sliding_distance_grouped",
                        lambda *a: calls.append(tuple(s.shape[-1]
                                                      for s in a[1]))
                        or real(*a))
    kw = {**BASE, "model": model, "fuse_short_banks": True, **cfg_kw}
    m = build_model(Config(**kw), "cpu")
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, kw["seq_len"], kw["enc_in"])).astype(np.float32))
    with torch.inference_mode():
        m(x)
    return calls


def test_gate_takes_the_per_bank_path_where_the_jax_package_does(
        monkeypatch):
    # all six stride-1 euclidean banks: one grouped launch, ascending L
    assert _grouped_calls(monkeypatch, {}) == [(3, 4, 8, 12, 20, 32)]
    # sqeuclidean: per bank
    assert _grouped_calls(monkeypatch, dict(distance_func="sqeuclidean"),
                          "LTS") == []
    # LTS folds cosine to euclidean, as in the JAX package
    assert _grouped_calls(monkeypatch, dict(distance_func="cosine"),
                          "LTS") != []
    # the SBM keeps cosine: per bank
    assert _grouped_calls(monkeypatch, dict(distance_func="cosine")) == []
    # fuse_short_banks off: per bank
    assert _grouped_calls(monkeypatch, dict(fuse_short_banks=False)) == []
    # one stride-1 bank (T >= 3000: stride log2(L), 1 only for L = 3)
    long_kw = dict(seq_len=3000, enc_in=1, num_shapelet=1)
    assert _grouped_calls(monkeypatch, dict(
        long_kw, shapelet_lengths=(0.001, 0.002, 0.01))) == []
    # two stride-1 banks beside a strided one: those two grouped
    assert _grouped_calls(monkeypatch, dict(
        long_kw, shapelet_lengths=(0.001, 0.0005, 0.01))) == [(3, 3)]
    # nine stride-1 banks: more than one launch's bank table holds; the
    # grouped op refuses them rather than splitting them
    nine = tuple(0.05 * (i + 1) for i in range(9))
    with pytest.raises(ValueError, match="2 to 8 banks"):
        _grouped_calls(monkeypatch, dict(shapelet_lengths=nine))


def test_mixed_strides_fused_equal_unfused():
    fused, plain = _model_pair(seq_len=3000, enc_in=1, num_shapelet=1,
                               shapelet_lengths=(0.001, 0.0005, 0.01))
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, 3000, 1)).astype(np.float32))
    with torch.inference_mode():
        (lf, inf_f), (lp, inf_p) = fused(x), plain(x)
    assert torch.equal(lf, lp) and torch.equal(inf_f.d, inf_p.d)
