"""The extra layer families of the port (sie_tpu_torch/models/extra:
autoformer, fourier, etsformer, pyraformer, crossformer, conv_blocks,
multiwavelet; and `ConvLayer` of models/layers.py) against the JAX
package's modules, on the CPU, at the same weights (the port's draw as a
flax tree by `to_jax_params`, whose leaves and shapes equal the flax
init's, loaded back by `load_jax_variables`: every leaf consumed once,
every parameter filled), on the same numpy-seeded inputs.

Tolerances: 1e-5 abs where only f32 sums differ in order; 1e-4 abs where
the path runs FFTs (pocketfft in both, different plans); f32 gradients
within 1e-4 of each leaf's largest. The host-side tables (frequency modes,
pyramid masks, refer points, filter banks, next_fast_len) are equal, and
the port's scipy stand-ins equal scipy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.models import layers as jlayers
from sie_tpu.models.extra import autoformer as ja
from sie_tpu.models.extra import conv_blocks as jc
from sie_tpu.models.extra import crossformer as jx
from sie_tpu.models.extra import etsformer as je
from sie_tpu.models.extra import fourier as jf
from sie_tpu.models.extra import multiwavelet as jm
from sie_tpu.models.extra import pyraformer as jp
from sie_tpu_torch.compat.from_jax import (batch_stats_buffers,
                                           load_jax_variables, to_jax_params,
                                           to_jax_tree)
from sie_tpu_torch.models import layers as players
from sie_tpu_torch.models.extra import autoformer as pa
from sie_tpu_torch.models.extra import conv_blocks as pc
from sie_tpu_torch.models.extra import crossformer as px
from sie_tpu_torch.models.extra import etsformer as pe
from sie_tpu_torch.models.extra import fourier as pf
from sie_tpu_torch.models.extra import multiwavelet as pm
from sie_tpu_torch.models.extra import pyraformer as pp

FWD, FFT, GRAD = 1e-5, 1e-4, 1e-4

# the JAX package caches its filter banks as jnp constants; made first
# inside a jit trace, the cache would hold a tracer
jm._bank.cache_clear()
for _base, _k in (("legendre", 4), ("legendre", 3), ("chebyshev", 3)):
    jm._bank(_base, _k)


def _np(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(jmod, port, *args, **kw):
    """The port's own draw as flax variables, with the leaves and shapes of
    jmod's init (traced by eval_shape: a compiled flax init costs seconds
    here); loaded back into the port by `load_jax_variables`, which
    consumes every leaf once."""
    params, stats = to_jax_params(port), batch_stats_buffers(port)
    v = {"params": params} if params else {}
    if stats:
        v["batch_stats"] = to_jax_tree(port, stats)
    want = jax.eval_shape(functools.partial(jmod.init, **kw),
                          {"params": jax.random.key(1),
                           "dropout": jax.random.key(2)}, *args)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), dict(t))
    assert shapes(want) == shapes(v)
    return v


def _load(port, variables):
    load_jax_variables(port, {"params": variables.get("params", {}),
                              "batch_stats": variables.get("batch_stats",
                                                           {})})
    return port


def _first(t):
    return t[0] if isinstance(t, tuple) else t


def _pair(jmod, port, args, atol, jkw=None, train=False, grads=False):
    """The forward of both at the same weights within atol; with `grads`,
    also the f32 gradients of a fixed projection of the output, each leaf
    within GRAD of its largest entry, floored at 1e-2 of the model's
    largest (an attention key bias, or the auto-correlation's query and
    key biases, have a zero gradient up to rounding: the softmax ignores
    a shift shared by every key or delay). One jitted JAX
    program each way. Returns the flax variables."""
    jkw = jkw or {}
    jargs = tuple(map(jnp.asarray, args))
    v = _init(jmod, port, *jargs, **jkw)
    _load(port, v)
    mutable = ["batch_stats"] if train else False
    fwd = lambda p: _first(_first(jmod.apply({**v, "params": p}, *jargs,
                                             **jkw, mutable=mutable)))
    params = v.get("params", {})
    w = _np(7, *jax.eval_shape(fwd, params).shape)

    def loss(p):
        o = fwd(p)
        return jnp.sum(o * w), o

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    port.train(train)
    port.zero_grad()
    got = _first(port(*map(torch.from_numpy, args)))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol, rtol=0)
    if grads:
        (got * torch.from_numpy(w)).sum().backward()
        mine = to_jax_tree(port, {n: torch.zeros_like(p) if p.grad is None
                                  else p.grad
                                  for n, p in port.named_parameters()})
        fw = dict(jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jgrads))[0])
        fg = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
        assert fw.keys() == fg.keys()
        floor = 1e-2 * max(float(np.abs(a).max()) for a in fw.values())
        for k in fw:
            top = max(float(np.abs(fw[k]).max()), floor)
            np.testing.assert_allclose(fg[k], fw[k], atol=GRAD * top, rtol=0,
                                       err_msg=str(k))
    return v


G = lambda: torch.Generator().manual_seed(0)


# ------------------------------------------------------------ autoformer
@pytest.mark.parametrize("kernel", [1, 5, 25])
def test_moving_avg_and_decompositions(kernel):
    x = _np(0, 2, 30, 3)
    np.testing.assert_allclose(
        pa.moving_avg(torch.from_numpy(x), kernel).numpy(),
        np.asarray(ja.moving_avg(jnp.asarray(x), kernel)), atol=FWD)
    for a, b in zip(pa.series_decomp(torch.from_numpy(x), kernel),
                    ja.series_decomp(jnp.asarray(x), kernel)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD)
    for a, b in zip(pa.series_decomp_multi(torch.from_numpy(x), (kernel, 3)),
                    ja.series_decomp_multi(jnp.asarray(x), (kernel, 3))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("s", [24, 16, 30])
def test_auto_correlation(train, s):
    """Batch-shared delays in training, per-row ones in eval; keys and
    values padded or cut to the query length."""
    q, k, v = _np(1, 2, 24, 2, 4), _np(2, 2, s, 2, 4), _np(3, 2, s, 2, 4)
    want, _ = jax.jit(functools.partial(
        ja.AutoCorrelation(factor=2).apply, {}, train=train))(
        *map(jnp.asarray, (q, k, v)))
    got = pa.auto_correlation(*map(torch.from_numpy, (q, k, v)), 2, train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FFT)


@pytest.mark.parametrize("mechanism,cross", [
    ("auto", False), ("fourier", False), ("fourier", True),
    ("wavelet", False), ("wavelet", True)])
def test_correlation_layers(mechanism, cross):
    lq, lk = 24, (16 if cross else 24)
    args = (_np(4, 2, lq, 16), _np(5, 2, lk, 16), _np(6, 2, lk, 16))
    if mechanism == "auto":
        jmod = ja.AutoCorrelationLayer(16, 2, factor=1)
        port = pa.AutoCorrelationLayer(16, 2, G(), factor=1)
    else:
        jmod = ja.SpectralAttentionLayer(16, 2, mechanism=mechanism,
                                         cross=cross)
        port = pa.SpectralAttentionLayer(16, 2, G(), lq, lk,
                                         mechanism=mechanism, cross=cross)
    _pair(jmod, port, args, FFT, grads=True)


@pytest.mark.parametrize("attention", ["auto", "fourier"])
def test_autoformer_encoder_and_decoder(attention):
    kw = dict(d_ff=32, n_heads=2, moving_avg_kernel=5, dropout=0.0,
              activation="gelu", factor=1, attention=attention)
    x = _np(7, 2, 24, 16)
    _pair(ja.AutoformerEncoder(16, n_layers=2, **kw),
          pa.AutoformerEncoder(16, G(), 24, n_layers=2, **kw), (x,), FFT)
    dec, trend = _np(8, 2, 16, 16), _np(9, 2, 16, 3)
    jd = ja.AutoformerDecoder(16, 3, n_layers=1, **kw)
    pd = pa.AutoformerDecoder(16, 3, G(), 16, 24, n_layers=1, **kw)
    v = _init(jd, pd, *map(jnp.asarray, (dec, x, trend)))
    _load(pd, v).eval()
    want = jax.jit(jd.apply)(v, *map(jnp.asarray, (dec, x, trend)))
    got = pd(*map(torch.from_numpy, (dec, x, trend)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=FFT)


# ------------------------------------------------------------ fourier
@pytest.mark.parametrize("seq_len,modes,method,seed", [
    (24, 4, "random", 0), (96, 64, "random", 3), (33, 8, "lowest", 0)])
def test_frequency_modes_are_the_jax_draw(seq_len, modes, method, seed):
    assert pf.get_frequency_modes(seq_len, modes, method, seed) == \
        jf.get_frequency_modes(seq_len, modes, method, seed)


@pytest.mark.parametrize("activation", ["tanh", "softmax"])
def test_fourier_blocks(activation):
    q, k = _np(10, 2, 24, 2, 8), _np(11, 2, 20, 2, 8)
    _pair(jf.FourierBlock(16, 16, 24, modes=6, n_heads=2),
          pf.FourierBlock(16, 16, 24, G(), modes=6, n_heads=2), (q,), FFT)
    jmod = jf.FourierCrossAttention(16, 16, 24, 20, modes=6,
                                    activation=activation, n_heads=2)
    port = pf.FourierCrossAttention(16, 16, 24, 20, G(), modes=6,
                                    activation=activation, n_heads=2)
    _pair(jmod, port, (q, k), FFT, grads=True)
    qw, kw = _np(12, 2, 16, 8, 2), _np(13, 2, 12, 8, 2)
    _pair(jf.FourierCrossAttentionW(16, 16, 4, activation),
          pf.FourierCrossAttentionW(16, 16, 4, activation), (qw, kw), FFT)


# ------------------------------------------------------------ etsformer
def test_next_fast_len_is_scipys():
    from scipy.fftpack import next_fast_len
    for n in list(range(1, 400)) + [1689, 4097, 10007, 65537, 123457]:
        assert pe.next_fast_len(n) == next_fast_len(n), n


@pytest.mark.parametrize("m", [24, 1])
def test_conv1d_fft(m):
    f, g = _np(14, 2, 24, 3, 4), _np(15, 1, m, 3, 1)
    np.testing.assert_allclose(
        pe.conv1d_fft(torch.from_numpy(f), torch.from_numpy(g)).numpy(),
        np.asarray(je.conv1d_fft(jnp.asarray(f), jnp.asarray(g))), atol=FFT)


def test_exponential_smoothing_growth_level_damping():
    vals, aux = _np(16, 2, 20, 2, 4), _np(17, 2, 20, 2, 4)
    _pair(je.ExponentialSmoothing(4, 2, 0.0, prepend_v0=True),
          pe.ExponentialSmoothing(4, 2, G(), 0.0, prepend_v0=True),
          (vals,), FFT)
    _pair(je.ExponentialSmoothing(4, 2, 0.0), pe.ExponentialSmoothing(
        4, 2, G(), 0.0), (vals, aux), FFT)
    x = _np(18, 2, 20, 16)
    _pair(je.GrowthLayer(16, 2, 0.0), pe.GrowthLayer(16, 2, G(), 0.0), (x,),
          FFT, grads=True)
    level, growth, season = _np(19, 2, 20, 3), x, _np(20, 2, 20, 16)
    _pair(je.LevelLayer(16, 3, 0.0), pe.LevelLayer(16, 3, G(), 0.0),
          (level, growth, season), FFT)
    _pair(je.DampingLayer(6, 2, 0.0), pe.DampingLayer(6, 2, G(), 0.0),
          (_np(21, 2, 1, 16),), FWD)


@pytest.mark.parametrize("t", [20, 21])
def test_fourier_layer(t):
    x = _np(22, 2, t, 16)
    _pair(je.FourierLayer(16, 5, 3), pe.FourierLayer(5, 3), (x,), FFT)
    xt = torch.from_numpy(x).requires_grad_()
    pe.FourierLayer(5, 3)(xt).square().sum().backward()
    want = jax.jit(jax.grad(lambda z: jnp.sum(
        je.FourierLayer(16, 5, 3).apply({}, z) ** 2)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               atol=FFT * float(np.abs(want).max()))


def test_ets_encoder_and_decoder():
    kw = dict(d_model=16, nhead=2, c_out=3, pred_len=4, k=2,
              dim_feedforward=32, dropout=0.0)
    res, level = _np(23, 2, 20, 16), _np(24, 2, 20, 3)
    jkw = dict(kw, seq_len=20)    # the JAX layer's field, read by nothing
    jenc = je.ETSEncoder(layers=(jkw, jkw))
    penc = pe.ETSEncoder((kw, kw), G())
    v = _init(jenc, penc, jnp.asarray(res), jnp.asarray(level))
    _load(penc, v).eval()
    want = jax.jit(jenc.apply)(v, jnp.asarray(res), jnp.asarray(level))
    got = penc(torch.from_numpy(res), torch.from_numpy(level))
    flat = lambda t: [t[0]] + list(t[1]) + list(t[2])
    for a, b in zip(flat(got), flat(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=FFT)
    gs = [np.asarray(g) for g in want[1]]
    ss = [np.asarray(s) for s in want[2]]
    jdec = je.ETSDecoder(16, 2, 3, 4, n_layers=2, dropout=0.0)
    pdec = pe.ETSDecoder(16, 2, 3, 4, G(), n_layers=2, dropout=0.0)
    v = _init(jdec, pdec, gs, ss)
    _load(pdec, v).eval()
    for a, b in zip(pdec([torch.from_numpy(g) for g in gs],
                         [torch.from_numpy(s) for s in ss]),
                    jax.jit(jdec.apply)(v, gs, ss)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=FWD)


def test_transform_augment_statistics():
    """The augmentation's arithmetic on a generator's draws: x scaled and
    shifted per channel and jittered per element (no model calls it; the
    JAX package draws from jax.random)."""
    x = torch.ones(4000, 3)
    g = torch.Generator().manual_seed(0)
    out = pe.transform_augment(x, 0.1, g)
    g = torch.Generator().manual_seed(0)
    scale = torch.randn(3, generator=g) * 0.1 + 1.0
    shift = torch.randn(3, generator=g) * 0.1
    jitter = torch.randn(4000, 3, generator=g) * 0.1
    torch.testing.assert_close(out, x * scale + shift + jitter)


# ------------------------------------------------------------ pyraformer
@pytest.mark.parametrize("t,window,inner", [(32, (4, 4), 5), (20, (2, 2), 3),
                                            (96, (4, 4), 5)])
def test_pyramid_tables(t, window, inner):
    jmask, jsizes = jp.get_mask(t, window, inner)
    pmask, psizes = pp.get_mask(t, window, inner)
    assert psizes == jsizes and (pmask == jmask).all()
    assert (pp.refer_points(psizes, window)
            == jp.refer_points(jsizes, window)).all()


@pytest.mark.parametrize("train", [False, True])
def test_bottleneck_with_batch_stats(train):
    x = _np(25, 3, 32, 16)
    jmod = jp.BottleneckConstruct(16, (4, 4), 4)
    port = pp.BottleneckConstruct(16, (4, 4), 4, G())
    v = _init(jmod, port, jnp.asarray(x))
    v["batch_stats"] = jax.tree.map(
        lambda a: a + np.float32(0.3), v["batch_stats"])
    _load(port, v)
    if train:
        want, upd = jax.jit(functools.partial(
            jmod.apply, train=True, mutable=["batch_stats"]))(
                v, jnp.asarray(x))
        port.train()
    else:
        want, upd = jax.jit(jmod.apply)(v, jnp.asarray(x)), v
        port.eval()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD)
    moved = to_jax_tree(port, dict(port.named_buffers()))
    for a, b in zip(jax.tree.leaves(moved),
                    jax.tree.leaves(upd["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=FWD)


def test_pyraformer_encoder():
    x = _np(26, 2, 32, 3)
    jmod = jp.PyraformerEncoder(32, 16, 2, 32, e_layers=2)
    port = pp.PyraformerEncoder(32, 16, 2, 32, 3, G(), e_layers=2,
                                dropout=0.1)
    _pair(jmod, port, (x,), FWD, grads=True)


# ------------------------------------------------------------ crossformer
@pytest.mark.parametrize("seg", [6, 5])
def test_seg_merging_and_scale_block(seg):
    x = _np(27, 2, 3, seg, 16)
    _pair(jx.SegMerging(16, 2), px.SegMerging(16, 2, G()), (x,), FWD)
    kw = dict(win_size=2, d_model=16, n_heads=2, d_ff=32, depth=1,
              dropout=0.0, seg_num=-(-seg // 2), factor=2)
    _pair(jx.ScaleBlock(**kw), px.ScaleBlock(**kw, g=G()), (x,), FWD)


def test_crossformer_encoder_and_decoder():
    x = _np(28, 2, 3, 4, 16)
    blocks = (dict(win_size=1, d_model=16, n_heads=2, d_ff=32, depth=1,
                   dropout=0.0, seg_num=4, factor=2),
              dict(win_size=2, d_model=16, n_heads=2, d_ff=32, depth=1,
                   dropout=0.0, seg_num=2, factor=2))
    jenc, penc = jx.CrossformerEncoder(blocks=blocks), \
        px.CrossformerEncoder(blocks, G())
    v = _init(jenc, penc, jnp.asarray(x))
    _load(penc, v).eval()
    scales = jax.jit(jenc.apply)(v, jnp.asarray(x))
    for a, b in zip(penc(torch.from_numpy(x)), scales):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=FWD)
    layer = dict(seg_len=6, d_model=16, n_heads=2, d_ff=32, dropout=0.0,
                 seg_num=2, factor=2)
    dec = _np(29, 2, 3, 2, 16)
    jdec = jx.CrossformerDecoder(layers=(layer,) * 3)
    pdec = px.CrossformerDecoder((layer,) * 3, G())
    sc = [np.asarray(s) for s in scales]
    v = _init(jdec, pdec, jnp.asarray(dec), sc)
    _load(pdec, v).eval()
    np.testing.assert_allclose(
        pdec(torch.from_numpy(dec), [torch.from_numpy(s) for s in sc])
        .detach().numpy(),
        np.asarray(jax.jit(jdec.apply)(v, jnp.asarray(dec), sc)),
        atol=FWD)


# ------------------------------------------------------------ conv blocks
@pytest.mark.parametrize("version", [1, 2])
def test_inception_blocks(version):
    x = _np(30, 2, 5, 7, 3)
    jcls = jc.InceptionBlockV1 if version == 1 else jc.InceptionBlockV2
    pcls = pc.InceptionBlockV1 if version == 1 else pc.InceptionBlockV2
    _pair(jcls(4, num_kernels=4), pcls(3, 4, G(), num_kernels=4), (x,), FWD)


def test_conv_layer_distils_as_jax():
    x = _np(31, 2, 11, 8)
    for train in (False, True):
        _pair(jlayers.ConvLayer(8), players.ConvLayer(8, torch.float32, G()),
              (x,), FWD, jkw=dict(train=train), train=train)


# ------------------------------------------------------------ multiwavelet
@pytest.mark.parametrize("base,k", [("legendre", 4), ("legendre", 3),
                                    ("chebyshev", 3)])
def test_filter_bank_equals_the_scipy_one(base, k):
    """The bank from numpy's leggauss equals the JAX package's from
    scipy.special.roots_legendre."""
    for a, b in zip(pm.get_filter(base, k), jm.get_filter(base, k)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    for a, b in zip(pm._bank(base, k), jm._bank(base, k)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_leggauss_is_roots_legendre():
    from scipy.special import roots_legendre
    for k in range(1, 12):
        for a, b in zip(np.polynomial.legendre.leggauss(k),
                        roots_legendre(k)):
            np.testing.assert_allclose(a, b, atol=1e-14)


@pytest.mark.parametrize("n", [16, 12])
def test_sparse_kernel_and_mwt_block(n):
    x = _np(32, 2, n, 2, 4)
    _pair(jm.SparseKernelFT1d(4, 5, 2), pm.SparseKernelFT1d(4, 5, G(), 2),
          (x,), FFT)
    _pair(jm.MWT_CZ1d(4, 5, 0, 2), pm.MWT_CZ1d(G(), 4, 5, 0, 2), (x,), FFT)
