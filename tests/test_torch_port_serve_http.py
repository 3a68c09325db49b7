"""sie_tpu_torch.serve_http on the CPU, mirroring tests/test_serve_http.py:
health, config, JSON / x_b64 / npz requests, the gating override,
validation errors, concurrency, the metrics text, micro-batching
(coalescing, gating groups, error isolation, the union of `fields`),
`fields` and `default_fields`. Across the packages: sie_tpu.client against
the port's server and the port's client against sie_tpu.serve_http, at the
same outputs within the f32 limits, and the /metrics texts of the two
servers equal after the same request sequence."""

import base64
import contextlib
import io
import json
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sie_tpu import serve_http as jax_http
from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.serve import Predictor as JPredictor
from sie_tpu_torch import client as port_client
from sie_tpu_torch import serve_http
from sie_tpu_torch.config import Config
from sie_tpu_torch.serve import Predictor
from sie_tpu_torch.serve_http import PredictorServer

KW = dict(model="InterpGN", dnn_type="FCN", seq_len=24, enc_in=3,
          num_class=4, num_shapelet=2, d_model=16, d_ff=32, n_heads=2,
          e_layers=1, dropout=0.0, amp=False, use_pallas=False, seed=0)
DNN = dict(model="DNN", dnn_type="FCN", seq_len=24, enc_in=3, num_class=4,
           dropout=0.0, amp=False, use_pallas=False, seed=0)
TOL = 1e-4     # f32 logits, port vs JAX (summation order)
WIRE = 1e-5    # the same predictor through the wire and directly


def _variables(kw):
    v = jax_build(JConfig(**kw)).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, 24, 3)), jnp.ones((2, 24)), train=False)
    v = jax.device_get(v)
    out = {"params": v["params"]}
    if v.get("batch_stats"):
        out["batch_stats"] = v["batch_stats"]
    return out


@contextlib.contextmanager
def serving(srv):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module")
def variables():
    return _variables(KW)


@pytest.fixture(scope="module")
def server(variables):
    pred = Predictor(Config(**KW), variables, device="cpu")
    with serving(PredictorServer(pred, max_request_rows=16)) as base:
        yield base, pred, pred.cfg


@pytest.fixture(scope="module")
def batched_server():
    pred = Predictor(Config(**DNN), _variables(DNN), device="cpu")
    srv = PredictorServer(pred, max_request_rows=64, batch_window_ms=150.0)
    with serving(srv) as base:
        yield base, pred, pred.cfg, srv


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_npz(url, arrays, accept="application/x-npz"):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(
        url, data=buf.getvalue(),
        headers={"Content-Type": "application/x-npz", "Accept": accept})
    try:
        with urllib.request.urlopen(req) as r:
            body = r.read()
            if "npz" in (r.headers.get("Content-Type") or ""):
                with np.load(io.BytesIO(body), allow_pickle=False) as z:
                    return r.status, {k: z[k] for k in z.files}
            return r.status, json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _rows(b, seed):
    return np.random.default_rng(seed).normal(size=(b, 24, 3)).astype("<f4")


def _concurrently(fns):
    threads = [threading.Thread(target=f) for f in fns]
    [t.start() for t in threads]
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_healthz_and_config(server):
    base, _pred, cfg = server
    code, h = _get(base + "/healthz")
    assert code == 200 and h["status"] == "ok" and h["serving"] == "live"
    assert h["num_class"] == cfg.num_class and h["quantized"] is False
    code, c = _get(base + "/config")
    assert code == 200 and c["model"] == "InterpGN"
    assert _get(base + "/nope")[0] == 404


def test_predict_json_and_b64_match_direct(server):
    base, pred, _cfg = server
    x = _rows(3, 0)
    direct = pred.predict(x)
    code, out = _post(base + "/predict", {"x": x.tolist()})
    assert code == 200 and "eta" in out
    np.testing.assert_allclose(np.asarray(out["logits"], np.float32),
                               direct.logits, atol=WIRE)
    assert out["classes"] == direct.classes.tolist()
    code, out = _post(base + "/predict", {
        "x_b64": base64.b64encode(x.tobytes()).decode(),
        "shape": list(x.shape)})
    assert code == 200
    np.testing.assert_allclose(np.asarray(out["logits"], np.float32),
                               direct.logits, atol=WIRE)


def test_predict_npz_binary_roundtrip(server):
    base, pred, _cfg = server
    x = _rows(3, 11)
    direct = pred.predict(x)
    code, out = _post_npz(base + "/predict", {"x": x})
    assert code == 200 and isinstance(out["eta"], np.ndarray)
    np.testing.assert_allclose(out["logits"], direct.logits, atol=WIRE)
    np.testing.assert_array_equal(out["classes"], direct.classes)
    code, jout = _post_npz(base + "/predict", {"x": x}, accept="*/*")
    assert code == 200 and isinstance(jout["logits"], list)
    mask = np.ones((3, 24), np.float32)
    code, out = _post_npz(base + "/predict",
                          {"x": x, "padding_mask": mask,
                           "gating_value": np.float32(np.nan)})
    assert code == 200
    np.testing.assert_allclose(
        out["logits"], pred.predict(x, mask, gating_value=None).logits,
        atol=WIRE)


def test_gating_value_override(server):
    base, pred, _cfg = server
    x = _rows(2, 2)
    code, out = _post(base + "/predict", {"x": x.tolist(),
                                          "gating_value": 0.5})
    assert code == 200
    np.testing.assert_allclose(np.asarray(out["logits"], np.float32),
                               pred.predict(x, gating_value=0.5).logits,
                               atol=WIRE)


def test_validation_errors(server):
    base, _pred, cfg = server
    ok = np.zeros((1, cfg.seq_len, cfg.enc_in), np.float32)
    assert _post(base + "/predict", {})[0] == 400
    assert _post(base + "/predict", {"x": [[1.0]]})[0] == 400
    bad = ok.copy()
    bad[0, 0, 0] = np.nan
    assert _post(base + "/predict", {"x": bad.tolist()})[0] == 400
    big = np.zeros((17, cfg.seq_len, cfg.enc_in), np.float32)
    assert _post(base + "/predict", {"x": big.tolist()})[0] == 400
    assert _post(base + "/predict", {"x_b64": "AAAA"})[0] == 400
    code, err = _post(base + "/predict", {"x": ok.tolist(),
                                          "gating_value": [0.5]})
    assert code == 400 and "number or null" in err["error"]
    assert _post(base + "/nothere", {"x": ok.tolist()})[0] == 404
    req = urllib.request.Request(
        base + "/predict", data=b"not an npz",
        headers={"Content-Type": "application/x-npz"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400 and \
        "invalid npz" in json.loads(ei.value.read())["error"]


def test_concurrent_requests(server):
    base, pred, _cfg = server
    x = _rows(2, 3)
    want = pred.predict(x).classes.tolist()
    results = []
    _concurrently([lambda: results.append(
        _post(base + "/predict", {"x": x.tolist()}))] * 6)
    assert len(results) == 6
    assert all(code == 200 and out["classes"] == want
               for code, out in results)


def test_metrics_endpoint(server):
    base, _pred, cfg = server
    assert _post(base + "/predict",
                 {"x": np.zeros((2, 24, 3)).tolist()})[0] == 200
    _post(base + "/predict", {})
    with urllib.request.urlopen(base + "/metrics") as r:
        assert "text/plain" in r.headers["Content-Type"]
        text = r.read().decode()
    metrics = dict(line.rsplit(" ", 1) for line in text.splitlines()
                   if line.strip() and not line.startswith("#"))
    metrics = {k: float(v) for k, v in metrics.items()}
    assert metrics["sie_tpu_requests_total"] >= 2
    assert metrics["sie_tpu_rows_total"] >= 2
    assert metrics['sie_tpu_errors_total{code="400"}'] >= 1
    assert metrics['sie_tpu_request_seconds_bucket{le="+Inf"}'] == \
        metrics["sie_tpu_requests_total"]
    assert metrics["sie_tpu_request_seconds_sum"] > 0


def test_micro_batching_coalesces_and_matches_direct(batched_server):
    base, pred, _cfg, srv = batched_server
    xs = [_rows(2, 40 + i) for i in range(6)]
    _post(base + "/predict", {"x": xs[0].tolist()})
    before = srv.batched_dispatches
    results = [None] * 6

    def hit(i):
        results[i] = _post(base + "/predict", {"x": xs[i].tolist()})

    _concurrently([lambda i=i: hit(i) for i in range(6)])
    for i in range(6):
        assert results[i][0] == 200
        np.testing.assert_allclose(
            np.asarray(results[i][1]["logits"], np.float32),
            pred.predict(xs[i]).logits, atol=WIRE)
    assert srv.batched_dispatches - before < 6


def test_micro_batching_gating_groups_and_errors(batched_server):
    base, pred, _cfg, _srv = batched_server
    x = _rows(2, 1)
    results = {}
    _concurrently([
        lambda: results.update(plain=_post(base + "/predict",
                                           {"x": x.tolist()})),
        lambda: results.update(gated=_post(base + "/predict",
                                           {"x": x.tolist(),
                                            "gating_value": 0.5})),
        lambda: results.update(bad=_post(base + "/predict",
                                         {"x": [[1.0]]}))])
    assert results["plain"][0] == 200 and results["gated"][0] == 200
    assert results["bad"][0] == 400
    np.testing.assert_allclose(
        np.asarray(results["plain"][1]["logits"], np.float32),
        pred.predict(x).logits, atol=WIRE)
    np.testing.assert_allclose(
        np.asarray(results["gated"][1]["logits"], np.float32),
        pred.predict(x, gating_value=0.5).logits, atol=WIRE)


def test_fields_and_default_fields(server):
    _base, pred, _cfg = server
    x = _rows(2, 14)
    srv = PredictorServer(pred, max_request_rows=16,
                          default_fields={"probs"})
    with serving(srv) as base:
        code, out = _post(base + "/predict", {"x": x.tolist()})
        assert code == 200 and set(out) == {"probs", "classes"}
        code, out = _post(base + "/predict",
                          {"x": x.tolist(), "fields": ["logits"]})
        assert code == 200 and set(out) == {"logits", "classes"}
        code, out = _post(base + "/predict",
                          {"x": x.tolist(), "fields": ["all"]})
        assert {"logits", "probs", "eta", "p", "d"} <= set(out)
        code, out = _post(base + "/predict", {"x": x.tolist(),
                                              "fields": None})
        assert "p" in out and "logits" in out
        code, out = _post_npz(base + "/predict",
                              {"x": x, "fields": np.asarray(["eta"])})
        assert code == 200 and set(out) == {"eta", "classes"}
        code, err = _post(base + "/predict",
                          {"x": x.tolist(), "fields": ["nope"]})
        assert code == 400 and "unknown fields" in err["error"]
    with pytest.raises(ValueError, match="unknown default_fields"):
        PredictorServer(pred, default_fields={"nope"})


def test_fields_union_through_micro_batcher(server):
    _base, pred, _cfg = server
    srv = PredictorServer(pred, max_request_rows=16, batch_window_ms=150.0)
    xs = [_rows(2, 21 + i) for i in range(3)]
    payloads = [{"x": xs[0].tolist(), "fields": ["probs"]},
                {"x": xs[1].tolist(), "fields": ["eta"]},
                {"x": xs[2].tolist()}]
    with serving(srv) as base:
        _post(base + "/predict", {"x": xs[0].tolist()})
        before = srv.batched_dispatches
        results = [None] * 3

        def hit(i):
            results[i] = _post(base + "/predict", payloads[i])

        _concurrently([lambda i=i: hit(i) for i in range(3)])
        assert srv.batched_dispatches - before < 3
    assert set(results[0][1]) == {"probs", "classes"}
    assert set(results[1][1]) == {"eta", "classes"}
    assert "p" in results[2][1] and "logits" in results[2][1]
    np.testing.assert_allclose(np.asarray(results[1][1]["eta"], np.float32),
                               pred.predict(xs[1]).eta, atol=WIRE)


@pytest.mark.parametrize("client_of", ["jax", "port"])
@pytest.mark.parametrize("encoding", ["auto", "npz"])
def test_clients_cross_both_servers(variables, client_of, encoding):
    """The JAX package's client against the port's server, and the port's
    client against the JAX package's server."""
    from sie_tpu import client as jax_client
    jpred = JPredictor(JConfig(**KW), variables)
    tpred = Predictor(Config(**KW), variables, device="cpu")
    if client_of == "jax":
        mod, srv, other = jax_client, PredictorServer(tpred), jpred
    else:
        mod, srv, other = port_client, jax_http.PredictorServer(jpred), tpred
    with serving(srv) as base:
        c = mod.InferenceClient(base, json_threshold_rows=2,
                                encoding=encoding)
        assert c.health()["status"] == "ok"
        assert c.config()["model"] == "InterpGN"
        for b in (2, 5):
            x = _rows(b, 50 + b)
            out, want = c.predict(x), other.predict(x)
            np.testing.assert_allclose(out.logits, want.logits, atol=TOL)
            np.testing.assert_allclose(out.p, want.p, atol=TOL)
            np.testing.assert_array_equal(out.classes, want.classes)
        out = c.predict(_rows(2, 9), gating_value=None, fields=["probs"])
        assert out.logits is None and out.probs.shape == (2, 4)
        with pytest.raises(mod.ServerError) as ei:
            c.predict(np.zeros((1, 5, 5), np.float32))
        assert ei.value.status == 400
        assert "sie_tpu_requests_total" in c.metrics()


def test_metrics_texts_equal_across_servers(variables, monkeypatch):
    """The same request sequence gives the same /metrics text from both
    servers; each server's clock is replaced by one that advances 4 ms a
    reading, so the latency histogram is the same too."""
    def clock():
        t = [0.0]

        def perf_counter():
            t[0] += 0.004
            return t[0]
        return types.SimpleNamespace(perf_counter=perf_counter,
                                     monotonic=__import__("time").monotonic)

    monkeypatch.setattr(serve_http, "time", clock())
    monkeypatch.setattr(jax_http, "time", clock())
    texts = []
    for srv in (PredictorServer(Predictor(Config(**KW), variables,
                                          device="cpu"),
                                max_request_rows=16),
                jax_http.PredictorServer(JPredictor(JConfig(**KW), variables),
                                         max_request_rows=16)):
        with serving(srv) as base:
            assert _post(base + "/predict",
                         {"x": _rows(3, 1).tolist()})[0] == 200
            assert _post_npz(base + "/predict", {"x": _rows(2, 2)})[0] == 200
            assert _post(base + "/predict", {})[0] == 400
            assert _post(base + "/predict",
                         {"x": np.zeros((17, 24, 3)).tolist()})[0] == 400
            with urllib.request.urlopen(base + "/metrics") as r:
                texts.append(r.read().decode())
    assert texts[0] == texts[1]
    assert "sie_tpu_requests_total 4\n" in texts[0]
    assert 'sie_tpu_errors_total{code="400"} 2' in texts[0]
