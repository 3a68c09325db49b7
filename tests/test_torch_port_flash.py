"""The port's flash attention (sie_tpu_torch/ops/flash.py: K9, K10b, K10a)
against the JAX package's stock flash kernels, on the CPU.

The JAX package reaches them through `FullAttentionLayer._flash`
(sie_tpu/models/layers.py:119-134), which calls
jax.experimental.pallas.ops.tpu.flash_attention; here they run in Pallas's
TPU interpret mode (`force_tpu_interpret_mode`). The layer's flash branch
asks `jax.default_backend() == "tpu"`; the tests that need it replace the
module's `jax`, for the test only, by a proxy whose `default_backend()` is
"tpu" (`tpu_backend`), and the port's branch is forced the same way
through `layers.on_accelerator`. Init runs inside the interpret context
too, since the flash branch runs at init. On the CPU the port's wrappers
take their plain versions; the CUDA kernels are held against those on the
card (tests/test_torch_port_flash_cuda.py, chip_smoke.py phase 42).

Tolerances, x the reference's max |value|: the forward 1e-2 and each
gradient 1.5e-2 (measured at most 6.2e-3 and 8.7e-3 over the six cases:
one or two bf16 ulps, 2^-8, of the largest values; the stock kernel
rounds its unnormalised probabilities against a running max over 128-key
blocks, the plain version against the row max). The layer and the model
take test_torch_port_models.py's bf16 limit, 5e-2 abs on logits and
outputs, and 5e-2 x max |g| on each gradient leaf; the key bias's
gradient is 0 in exact arithmetic (a shift of every score of a row) and
only rounding noise, and is not compared, as chip_smoke.py does not.
The JAX calls are jitted: eager dispatch beside the interpreter's
callbacks can deadlock."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import sie_tpu.models.layers as jlayers
import sie_tpu_torch.models.layers as layers_mod
from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.train.trainer import make_loss_fn as jax_loss_fn
from sie_tpu_torch.compat.from_jax import load_jax_params, to_jax_tree
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import FullAttentionLayer
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.ops import flash
from sie_tpu_torch.train.trainer import Trainer

FWD_TOL, GRAD_TOL = 1e-2, 1.5e-2   # x max |want|, the op
BF16_TOL = 5e-2                  # the layer and the model
OPS = torch.ops.sie_tpu_torch


class _TpuJax:
    """`jax` with `default_backend()` saying "tpu"."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def tpu_backend(monkeypatch):
    """The JAX layer's flash gate open (its module's `jax` replaced, put
    back after the test) and the port's forced (`on_accelerator`)."""
    monkeypatch.setattr(jlayers, "jax", _TpuJax())
    monkeypatch.setattr(layers_mod, "on_accelerator", lambda x: True)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _fold(a):
    """(B, T, H, dk) numpy -> (B * H, T, dk) bf16 tensor, the layer's
    fold."""
    b, t, h, dk = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                            .reshape(b * h, t, dk)).to(torch.bfloat16)


def _unfold(a, h):
    """(B, T, H, dk) jax array -> (B * H, T, dk) f32 numpy."""
    a = np.asarray(a.astype(jnp.float32))
    b, t, _, dk = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, t, dk)


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float32) - want).max())


# ---- (i) the op against the stock kernels ---------------------------------
@pytest.mark.parametrize("dk,t", [(64, 105), (64, 200), (128, 105),
                                  (128, 200), (256, 105), (256, 200)])
def test_op_matches_the_stock_flash_kernels(dk, t):
    """K9's and K10's plain versions, through `flash_attention` and its
    backward (K10b then K10a), against `_flash` and its VJP, the stock
    kernels in interpret mode: T under one 128 block and T not a multiple
    of 128 (padded by the JAX package, masked here)."""
    b, h = 2, 2
    q, k, v, do = _normal(t + dk, *[(b, t, h, dk)] * 4)
    layer = jlayers.FullAttentionLayer(h * dk, h, dtype=jnp.bfloat16,
                                       use_flash=True)
    f = lambda q, k, v: layer.apply({}, q, k, v, dk,
                                    method=jlayers.FullAttentionLayer._flash)
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(do)

    with pltpu.force_tpu_interpret_mode():
        out, grads = jax.jit(fwd_bwd)(*(jnp.asarray(z, jnp.bfloat16)
                                        for z in (q, k, v, do)))
    tq, tk, tv = (_fold(z).requires_grad_() for z in (q, k, v))
    got = flash.flash_attention(tq, tk, tv, 1.0 / dk ** 0.5)
    got.backward(_fold(do))
    want = _unfold(out, h)
    assert got.dtype == torch.bfloat16
    err = _max_err(got.detach().float(), want)
    assert err <= FWD_TOL * np.abs(want).max(), err
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), grads):
        w = _unfold(w, h)
        err = _max_err(g.float(), w)
        assert g.dtype == torch.bfloat16
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err)


def test_plain_versions_are_chunked_exactly():
    """Chunks of query rows give the unchunked values (the softmax is over
    keys), and the op's CPU implementation is the plain version."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in
                   _normal(3, *[(2, 70, 64)] * 4))
    out = flash.flash_attention_plain(q, k, v, 0.125)
    assert torch.equal(out, flash.flash_attention_plain(q, k, v, 0.125,
                                                        chunk=16))
    delta = flash.flash_delta_plain(out, do)
    whole = flash.flash_attention_bwd_plain(q, k, v, do, delta, 0.125)
    for a, c in zip(whole, flash.flash_attention_bwd_plain(
            q, k, v, do, delta, 0.125, chunk=16)):
        torch.testing.assert_close(a, c, rtol=0, atol=2 ** -8 * float(
            a.float().abs().max()))
    got, lse = OPS.flash_fwd(q, k, v, 0.125, True)
    assert torch.equal(got, out)
    torch.testing.assert_close(lse, flash.flash_lse_plain(q, k, 0.125,
                                                          chunk=16))
    assert OPS.flash_fwd(q, k, v, 0.125, False)[1].shape == (0,)
    torch.library.opcheck(OPS.flash_fwd.default, (q, k, v, 0.125, True))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    z = lambda *s, dt=torch.bfloat16: torch.zeros(s, dtype=dt)
    for bad in ((z(2, 8, 32),) * 3, (z(2, 8, 64, dt=torch.float32),) * 3,
                (z(2, 8, 64), z(2, 9, 64), z(2, 8, 64)),
                (z(2, 64, 8).transpose(1, 2),) * 3):
        with pytest.raises(ValueError):
            flash.flash_attention(*bad, 0.125)


# ---- (ii) the attention layer ---------------------------------------------
def test_layer_flash_branch_matches_jax(tpu_backend, monkeypatch):
    """The port's FullAttentionLayer(use_flash=True) with its branch forced
    against the JAX layer's flash branch, at the same weights: output and
    every parameter gradient of sum(out * r)."""
    b, t, d, h = 2, 130, 128, 2
    x, r = _normal(11, (b, t, d), (b, t, d))
    jl = jlayers.FullAttentionLayer(d, h, dtype=jnp.bfloat16, use_flash=True)
    jx = jnp.asarray(x)
    out = lambda p: jl.apply({"params": p}, jx, jx, jx).astype(jnp.float32)
    with pltpu.force_tpu_interpret_mode():   # jitted, as in the model test
        params = jax.jit(lambda: jl.init(jax.random.key(0), jx, jx,
                                         jx)["params"])()
        want = np.asarray(jax.jit(out)(params))
        grads = jax.jit(jax.grad(lambda p: jnp.sum(out(p) * r)))(params)
    port = load_jax_params(FullAttentionLayer(
        d, h, torch.bfloat16, torch.Generator(), use_flash=True,
        use_fused=True, fused_min_len=0), jax.tree.map(np.asarray, params))
    calls = []
    monkeypatch.setattr(layers_mod, "flash_attention",
                        lambda *a: calls.append(1) or flash.flash_attention(*a))
    tx = torch.from_numpy(x)
    got = port(tx, tx, tx)
    assert calls == [1]   # ahead of the fused branch
    assert _max_err(got.detach().float(), want) <= BF16_TOL
    (got.float() * torch.from_numpy(r)).sum().backward()
    mine = to_jax_tree(port, {n: p.grad for n, p in port.named_parameters()})
    for name, leaf in [(n, l) for n in ("query", "key", "value", "out")
                       for l in ("kernel", "bias")
                       if (n, l) != ("key", "bias")]:   # 0 but for rounding
        w = np.asarray(grads[name][leaf])
        err = _max_err(mine[name][leaf], w)
        assert err <= BF16_TOL * np.abs(w).max(), (name, leaf, err)


# ---- (iii) a narrow InterpGN + Transformer --------------------------------
KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=100, enc_in=3,
          num_class=3, num_shapelet=2, d_model=128, n_heads=2, e_layers=2,
          d_ff=128, dropout=0.0, amp=True, use_pallas=False,
          use_fused_attention=False, use_flash_attention=True, seed=0)


def test_interpgn_with_the_flag_matches_jax(tpu_backend, monkeypatch):
    """Logits in eval, and one training step's loss and gradients (the
    trainers' loss functions), against the JAX model whose flash branch
    runs the stock kernels in interpret mode; every attention layer of the
    port takes its flash branch."""
    b = 4
    x, = _normal(21, (b, KW["seq_len"], KW["enc_in"]))
    y = np.random.default_rng(22).integers(0, 3, b).astype(np.int32)
    mask, w = np.ones((b, KW["seq_len"]), np.float32), np.ones(b, np.float32)
    jm = jax_build(JConfig(**KW))
    batch = tuple(jnp.asarray(a) for a in (x, y, mask, w))
    # jitted: eager dispatch beside the interpreter's callbacks can deadlock
    loss_fn = jax_loss_fn(JConfig(**KW), jm.apply)
    with pltpu.force_tpu_interpret_mode():
        params = jax.jit(lambda x, m: jm.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x,
            m, train=False)["params"])(batch[0], batch[2])
        want_logits, _ = jax.jit(lambda p, x, m: jm.apply(
            {"params": p}, x, m, train=False))(params, batch[0], batch[2])
        (want_loss, _), grads = jax.jit(lambda p: jax.value_and_grad(
            loss_fn, has_aux=True)(p, {}, batch, 1.0, True,
                                   jax.random.key(2)))(params)
        jax.block_until_ready(grads)
    params = jax.tree.map(np.asarray, params)
    cfg = Config(**KW)
    port = load_jax_params(build_model(cfg, "cpu"), params)
    calls = []
    monkeypatch.setattr(layers_mod, "flash_attention",
                        lambda *a: calls.append(1) or flash.flash_attention(*a))
    with torch.no_grad():
        logits, _ = port.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    want_logits = np.asarray(want_logits.astype(jnp.float32))
    assert _max_err(logits.float(), want_logits) <= BF16_TOL
    np.testing.assert_array_equal(logits.float().argmax(-1).numpy(),
                                  want_logits.argmax(-1))
    trainer = Trainer(cfg, 1, model=port.train(), device="cpu")
    loss, _ = trainer.loss_fn(trainer.model, trainer._device_batch(
        (x, y, mask, w)), 1.0, None)
    loss.backward()
    assert calls == [1] * (2 * KW["e_layers"])
    assert abs(loss.item() - float(want_loss)) <= BF16_TOL * abs(
        float(want_loss))
    mine = to_jax_tree(port, {n: p.grad for n, p in port.named_parameters()})
    flat = lambda t: {"/".join(str(k.key) for k in path): np.asarray(g)
                      for path, g in jax.tree_util.tree_leaves_with_path(t)}
    mine, theirs = flat(mine), flat(grads)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        if k.endswith("/key/bias"):
            continue   # 0 in exact arithmetic: only rounding noise
        scale = max(float(np.abs(theirs[k]).max()), 1e-6)
        assert _max_err(mine[k], theirs[k]) <= BF16_TOL * scale, k


# ---- (iv) the gate ----------------------------------------------------------
def _jax_branch(use_flash, use_fused, causal, bf16, rate, train, t, dk,
                on_tpu, max_len=4096, min_len=256):
    """sie_tpu/models/layers.py:150-161, with equal query and key
    lengths T."""
    use_flash = (use_flash and not causal and bf16
                 and (rate == 0.0 or not train) and dk in (64, 128, 256)
                 and on_tpu)
    use_fused = (use_fused and not use_flash and not causal
                 and (max_len == 0 or t <= max_len) and t >= min_len
                 and dk <= 128)
    return "flash" if use_flash else "fused" if use_fused else "plain"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_gate_is_the_jax_packages(dtype, train, causal, monkeypatch):
    """The port's branch (flash, fused or plain) equals the JAX expression
    for every dk in 32/64/256, T in 105/845/17984, use_fused on and off,
    on the card and off it, with attention dropout 0.1 (rate 0 in eval)."""
    on_card = [True]
    monkeypatch.setattr(layers_mod, "on_accelerator", lambda x: on_card[0])
    x = torch.zeros(1)
    for use_fused in (False, True):
        layer = FullAttentionLayer(64, 1, dtype, torch.Generator(),
                                   use_fused=use_fused, use_flash=True,
                                   attention_dropout=0.1, causal=causal)
        layer.train(train)
        for dk in (32, 64, 256):
            for t in (105, 845, 17984):
                for on_card[0] in (True, False):
                    got = ("flash" if layer.uses_flash(t, t, dk, x) else
                           "fused" if layer.uses_kernel(t, t, dk) else
                           "plain")
                    want = _jax_branch(True, use_fused, causal,
                                       dtype == torch.bfloat16, 0.1, train,
                                       t, dk, on_card[0])
                    assert got == want, (use_fused, dk, t, on_card[0])


def test_cross_attention_and_cpu_tensors_never_take_flash(monkeypatch):
    """Unequal query and key lengths take another branch, and so does a
    CPU tensor under the real `on_accelerator`."""
    layer = FullAttentionLayer(64, 1, torch.bfloat16, torch.Generator(),
                               use_flash=True)
    assert not layer.uses_flash(845, 845, 64, torch.zeros(1))
    monkeypatch.setattr(layers_mod, "on_accelerator", lambda x: True)
    assert layer.uses_flash(845, 845, 64, torch.zeros(1))
    assert not layer.uses_flash(845, 844, 64, torch.zeros(1))


# ---- an exported flash model keeps its kernel --------------------------------
def test_export_keeps_the_flash_op(monkeypatch):
    """torch.export of a tiny flash-gated layer holds sie_tpu_torch::flash_fwd
    (on the card the kernel's launch); the program gives the eager output."""
    monkeypatch.setattr(layers_mod, "on_accelerator", lambda x: True)
    layer = FullAttentionLayer(64, 1, torch.bfloat16,
                               torch.Generator().manual_seed(0),
                               use_flash=True).eval()

    class Self(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attention = layer

        def forward(self, x):
            return self.attention(x, x, x)

    x = torch.from_numpy(_normal(31, (2, 40, 64))[0])
    with torch.no_grad():
        prog = torch.export.export(Self().eval(), (x,))
        want = Self().eval()(x)
    targets = {str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"}
    assert "sie_tpu_torch.flash_fwd.default" in targets, targets
    assert torch.equal(prog.module()(x), want)
