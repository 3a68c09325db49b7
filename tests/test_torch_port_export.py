"""The forward kernels as registered ops and the ahead-of-time programs,
on the CPU: the ops' CPU implementations equal the plain versions and pass
`torch.library.opcheck`; the autograd functions built on them give the
plain gradients; `Predictor.export_stablehlo` writes torch.export programs
whose graphs hold the `sie_tpu_torch::` ops, and `CompiledPredictor`
serving them matches the JAX package's `CompiledPredictor` on its own
artifact of the same weights (f32 1e-4, bf16 5e-2 on logits); the
manifest's keys; a platform mismatch raises; an int8 predictor exports
with its int8 state; a fresh process serves the artifact with
`sie_tpu_torch.ops` and `sie_tpu_torch.serve` and no model code; and over
HTTP a per-request gating value is refused, the batcher's cap is the
largest bucket."""

import functools
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.serve import CompiledPredictor as JCompiled
from sie_tpu.serve import Predictor as JPredictor
from sie_tpu_torch import quant
from sie_tpu_torch.config import Config
from sie_tpu_torch.ops.attention import (attention_bwd_plain,
                                         attention_lse_plain, attention_plain,
                                         fused_attention)
from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                           l1_sliding_distance_bwd_plain,
                                           l1_sliding_distance_grouped,
                                           l1_sliding_distance_plain)
from sie_tpu_torch.serve import CompiledPredictor, Predictor
from sie_tpu_torch.serve_http import PredictorServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = torch.ops.sie_tpu_torch
BASE = dict(model="InterpGN", seq_len=24, enc_in=3, num_class=4,
            num_shapelet=2, d_model=16, d_ff=32, n_heads=2, e_layers=1,
            dropout=0.0, use_pallas=False, seed=0)
CONFIGS = {"fcn": dict(BASE, dnn_type="FCN", amp=False),
           "transformer_amp": dict(BASE, dnn_type="Transformer", amp=True,
                                   fused_attention_min_len=0),
           "fused_banks": dict(BASE, dnn_type="FCN", amp=False,
                               fuse_short_banks=True)}
TOL = {"fcn": 1e-4, "transformer_amp": 5e-2, "fused_banks": 1e-4}
# the ops each exported graph holds
GRAPH_OPS = {"fcn": {"l1_fwd"}, "transformer_amp": {"l1_fwd",
                                                    "attention_fwd"},
             "fused_banks": {"l1_grouped_fwd"}}


@functools.lru_cache(maxsize=None)
def _init(name):
    cfg = JConfig(**CONFIGS[name])
    v = jax.device_get(jax_build(cfg).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, 24, 3)), jnp.ones((2, 24)), train=False))
    out = {"params": v["params"]}
    if v.get("batch_stats"):
        rng = np.random.default_rng(5)
        out["batch_stats"] = jax.tree.map(
            lambda a: (np.abs(rng.normal(size=a.shape)) + 0.5).astype(
                np.float32), v["batch_stats"])
    return cfg, out


def _normal(seed, *shapes, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
            for s in shapes]


def _x(b, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 24, 3)).astype(
        np.float32)


# ---- the registered ops ----------------------------------------------------
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_l1_op_is_the_plain_version(metric):
    x, s = _normal(0, (3, 4, 30), (5, 4, 7))
    got = OPS.l1_fwd(x, s, metric)
    torch.testing.assert_close(got, l1_sliding_distance_plain(x, s, metric),
                               rtol=0, atol=0)
    torch.library.opcheck(OPS.l1_fwd.default, (x, s, metric))


def test_grouped_op_is_the_plain_version():
    x, s1, s2 = _normal(1, (2, 3, 20), (4, 3, 3), (2, 3, 9))
    got = OPS.l1_grouped_fwd(x, [s1, s2])
    for g, s in zip(got, (s1, s2)):
        torch.testing.assert_close(g, l1_sliding_distance_plain(x, s),
                                   rtol=0, atol=0)
    torch.library.opcheck(OPS.l1_grouped_fwd.default, (x, [s1, s2]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_op_is_the_plain_version(dtype, rate):
    q, k, v = _normal(2, (4, 16, 8), (4, 16, 8), (4, 16, 8), dtype=dtype)
    seed = torch.tensor([7], dtype=torch.int32) if rate else None
    out, lse = OPS.attention_fwd(q, k, v, 0.25, rate, seed, True)
    torch.testing.assert_close(out, attention_plain(q, k, v, 0.25, rate, 7),
                               rtol=0, atol=0)
    torch.testing.assert_close(lse, attention_lse_plain(q, k, 0.25),
                               rtol=0, atol=0)
    assert OPS.attention_fwd(q, k, v, 0.25, rate, seed,
                             False)[1].shape == (0,)
    torch.library.opcheck(OPS.attention_fwd.default,
                          (q, k, v, 0.25, rate, seed, True))


def test_autograd_functions_give_the_plain_gradients():
    x, s, g = _normal(3, (2, 3, 25), (4, 3, 6), (2, 4, 3, 20))
    s.requires_grad_(True)
    (l1_sliding_distance(x, s) * g).sum().backward()
    torch.testing.assert_close(s.grad,
                               l1_sliding_distance_bwd_plain(x, s, g),
                               rtol=0, atol=0)
    x, s1, s2 = _normal(4, (2, 3, 25), (4, 3, 3), (2, 3, 8))
    s1.requires_grad_(True)
    s2.requires_grad_(True)
    d1, d2 = l1_sliding_distance_grouped(x, (s1, s2))
    (d1.sum() + 2.0 * d2.sum()).backward()
    torch.testing.assert_close(s1.grad, l1_sliding_distance_bwd_plain(
        x, s1, torch.ones_like(d1)), rtol=0, atol=0)
    torch.testing.assert_close(s2.grad, l1_sliding_distance_bwd_plain(
        x, s2, torch.full_like(d2, 2.0)), rtol=0, atol=0)
    q, k, v, do = _normal(5, *[(2, 12, 4)] * 4)
    for t in (q, k, v):
        t.requires_grad_(True)
    (fused_attention(q, k, v, 0.5, 0.1, 3) * do).sum().backward()
    want = attention_bwd_plain(q.detach(), k.detach(), v.detach(), do, 0.5,
                               0.1, 3)
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


# ---- ahead-of-time programs ------------------------------------------------
@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{config name: (port Predictor, its artifact dir, the JAX package's
    artifact dir)}, buckets (1, 4), from the same weights."""
    out = {}
    for name in CONFIGS:
        jcfg, variables = _init(name)
        tmp = tmp_path_factory.mktemp(name)
        tp = Predictor(Config(**CONFIGS[name]), variables, device="cpu",
                       max_batch=4, temperature=1.3)
        tp.export_stablehlo(str(tmp / "port"), batch_sizes=(1, 3))
        jp = JPredictor(jcfg, variables, max_batch=4, temperature=1.3)
        jp.export_stablehlo(str(tmp / "jax"), batch_sizes=(1, 3))
        out[name] = tp, str(tmp / "port"), str(tmp / "jax")
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compiled_predictor_matches_jax(exported, name):
    tp, port_dir, jax_dir = exported[name]
    cp, jcp = CompiledPredictor(port_dir, device="cpu"), JCompiled(jax_dir)
    for b in (1, 3, 9):           # one bucket, a padded one, chunks of 4
        x = _x(b, seed=b)
        got, want = cp.predict(x), jcp.predict(x)
        np.testing.assert_allclose(got.logits, want.logits, atol=TOL[name])
        np.testing.assert_allclose(got.p, want.p, atol=TOL[name])
        np.testing.assert_allclose(got.probs, want.probs, atol=TOL[name])
        np.testing.assert_array_equal(got.classes, want.classes)
        live = tp.predict(x)
        np.testing.assert_array_equal(got.logits, live.logits)
    assert cp.predict(_x(0)).logits.shape == (0, 4)
    graph = cp.programs[4].graph_module.code
    ops = {o for o in ("l1_fwd", "l1_grouped_fwd", "attention_fwd")
           if f"torch.ops.sie_tpu_torch.{o}" in graph}
    assert ops == GRAPH_OPS[name]


def test_manifest_keys_and_files(exported):
    _tp, port_dir, jax_dir = exported["fcn"]
    with open(os.path.join(port_dir, "manifest.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax_dir, "manifest.json")) as f:
        want = json.load(f)
    assert set(got) == set(want)
    assert got["platform"] == "cpu" and got["buckets"] == [1, 4]
    assert {k: got[k] for k in got if k != "platform"} == \
        {k: want[k] for k in want if k != "platform"}
    assert sorted(os.listdir(port_dir)) == ["bucket_1.pt2", "bucket_4.pt2",
                                            "manifest.json"]


def test_platform_mismatch_raises(exported, tmp_path, monkeypatch):
    _tp, port_dir, _ = exported["fcn"]
    with open(os.path.join(port_dir, "manifest.json")) as f:
        manifest = json.load(f)
    d = tmp_path / "cuda_artifact"
    d.mkdir()
    (d / "manifest.json").write_text(json.dumps(dict(manifest,
                                                     platform="cuda")))
    with pytest.raises(RuntimeError, match="exported for 'cuda'"):
        CompiledPredictor(str(d), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledPredictor(port_dir)     # the default is the card


def test_quantised_predictor_exports_int8(tmp_path):
    _, variables = _init("transformer_amp")
    qv = dict(variables, params=quant.quantize_params(variables["params"],
                                                      min_size=64))
    tp = Predictor(Config(**CONFIGS["transformer_amp"]), qv, device="cpu",
                   max_batch=4)
    tp.export_stablehlo(str(tmp_path), batch_sizes=(4,))
    cp = CompiledPredictor(str(tmp_path), device="cpu")
    state = cp.programs[4].state_dict
    assert sum(v.dtype == torch.int8 for v in state.values()) >= 4
    x = _x(4, seed=3)
    np.testing.assert_array_equal(cp.predict(x).logits,
                                  tp.predict(x).logits)


def test_fresh_process_serves_without_model_code(exported):
    tp, port_dir, _ = exported["transformer_amp"]
    x = _x(3, seed=12)
    want = tp.predict(x).logits
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import sie_tpu_torch.ops
        from sie_tpu_torch.serve import CompiledPredictor
        cp = CompiledPredictor({port_dir!r}, device="cpu")
        x = np.random.default_rng(12).normal(size=(3, 24, 3)).astype(
            np.float32)
        out = cp.predict(x)
        assert not [m for m in sys.modules
                    if m.startswith("sie_tpu_torch.models")]
        assert "jax" not in sys.modules
        np.save(sys.stdout.buffer, out.logits)
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    import io
    np.testing.assert_array_equal(np.load(io.BytesIO(r.stdout)), want)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("window", [0.0, 100.0])
def test_aot_over_http_refuses_gating(exported, window):
    tp, port_dir, _ = exported["fcn"]
    srv = PredictorServer(CompiledPredictor(port_dir, device="cpu"),
                          max_request_rows=16, batch_window_ms=window)
    assert srv._coalesce_cap == 4
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz") as r:
            h = json.loads(r.read())
        assert h["serving"] == "stablehlo-aot" and h["max_batch"] == 4
        with urllib.request.urlopen(base + "/config") as r:
            assert json.loads(r.read())["buckets"] == [1, 4]
        x = _x(3, seed=4)
        code, out = _post(base + "/predict", {"x": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(np.asarray(out["logits"], np.float32),
                                   tp.predict(x).logits, atol=1e-5)
        code, err = _post(base + "/predict", {"x": x.tolist(),
                                              "gating_value": 0.5})
        assert code == 400 and "baked" in err["error"]
        code, err = _post(base + "/predict", {"x": x.tolist(),
                                              "gating_value": [0.5]})
        assert code == 400 and "number or null" in err["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
