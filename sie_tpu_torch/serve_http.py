"""HTTP inference server over `sie_tpu_torch.serve.Predictor` (counterpart
of sie_tpu/serve_http.py, with its wire API byte for byte: endpoints, JSON
keys, the x_b64 and npz formats, `fields` and `default_fields`, error codes
and bodies, and the Prometheus metric names with their `sie_tpu_` prefix,
so existing clients and scrapers work unchanged). Standard library only
(http.server), so a serving host needs this package and a bundle directory:

    python -m sie_tpu_torch.serve_http --bundle ./bundle --port 8723

Endpoints:

- `GET /healthz`  -> {"status": "ok", ...model/bundle facts}
- `GET /config`   -> the bundle's full config JSON
- `GET /metrics`  -> Prometheus text format: request/row/error counters
  and a request-latency histogram (scrape-ready)
- `POST /predict` -> body {"x": [[[...]]], "padding_mask"?: [[...]],
  "gating_value"?: float|null} (x: (B, seq_len, enc_in) nested lists, or a
  base64 little-endian f32 buffer as {"x_b64": ..., "shape": [B, T, C]}
  for bulk traffic). Response: logits/probs/classes (+ eta/p/d for
  InterpGN) as JSON lists.
- binary bulk path: `POST /predict` with `Content-Type: application/x-npz`
  and an uncompressed `np.savez` body (keys `x` (B, T, C) f32, optional
  `padding_mask` (B, T), optional 0-d `gating_value` — NaN means JSON
  null). With `Accept: application/x-npz` the response is an npz of the
  same output arrays; npz is a straight buffer copy both ways, where
  JSON lists cost host time per element. Errors are always JSON.
- response projection: an optional `fields` key (JSON list of strings, or
  a string array in the npz body) keeps only the named output arrays —
  e.g. `["probs"]` drops the (B, 7320) InterpGN p/d interpretability
  tensors a monitoring client never reads. `classes` is always included.
- server-level default projection (`--default_fields probs`): applied when
  a request carries NO `fields` key. A request overrides the default with
  its own `fields` list, or asks for everything with `fields: ["all"]`
  (JSON `fields: null` also means everything).

Serving behaviour comes from the Predictor: bucket-padded batches,
chunking above max_batch, the forward under `torch.inference_mode()` on
`--device` (default the card; `--device cpu` runs the kernels' plain
versions). Requests are serialised through one lock; run replicas behind a
load balancer to scale hosts. `--warmup` runs the common buckets before
the socket opens, which builds the kernels and initialises cuBLAS and
cuDNN. `--stablehlo DIR` serves a `Predictor.export_stablehlo` directory
(`torch.export` programs) through `CompiledPredictor`.

Dynamic micro-batching (`--batch_window_ms`): instead of one device
dispatch per request, concurrent requests queue for up to the window and
are coalesced into ONE predict call (grouped by gating_value, capped at
the Predictor's max_batch), then the outputs are split back per request.
Small-request traffic rides the larger bucket; a lone request pays at most
the window in added latency. Off by default.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import math
import queue as _queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from sie_tpu_torch.serve import (CompiledPredictor, Predictor,
                                 config_to_json)

_MISSING = object()


def _decode_x(payload: dict, seq_len: int, enc_in: int) -> np.ndarray:
    if "x_b64" in payload:
        shape = payload.get("shape")
        if not (isinstance(shape, list) and len(shape) == 3):
            raise ValueError("x_b64 requires 'shape': [B, T, C]")
        buf = base64.b64decode(payload["x_b64"])
        x = np.frombuffer(buf, dtype="<f4").reshape(shape)
    elif "x" in payload:
        x = np.asarray(payload["x"], np.float32)
    else:
        raise ValueError("body must contain 'x' or 'x_b64'")
    if x.ndim != 3 or x.shape[1:] != (seq_len, enc_in):
        raise ValueError(
            f"x must be (B, {seq_len}, {enc_in}); got {tuple(x.shape)}")
    if not np.isfinite(x).all():
        raise ValueError("x contains non-finite values")
    return np.ascontiguousarray(x, np.float32)


NPZ_CONTENT_TYPES = ("application/x-npz", "application/octet-stream")

_RESPONSE_FIELDS = {"logits", "probs", "classes", "eta", "p", "d",
                    "shapelet_preds", "dnn_preds"}


def _decode_npz_body(body: bytes) -> dict:
    """npz request body -> the same payload dict the JSON route builds.

    `gating_value` rides as a 0-d float array; NaN encodes JSON null
    (explicitly disable hard gating) since npz has no null.
    """
    try:
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            payload = {k: z[k] for k in z.files}
    except Exception as e:   # zipfile/np.load raise several types
        raise ValueError(f"invalid npz body: {e}") from None
    if "gating_value" in payload:
        try:
            g = float(payload["gating_value"])
        except (TypeError, ValueError):
            raise ValueError("npz gating_value must be a 0-d number "
                             "(NaN for null)") from None
        payload["gating_value"] = None if math.isnan(g) else g
    return payload


def _encode_npz(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                    5.0, 10.0)


class _Pending:
    """One queued request inside the micro-batcher."""

    __slots__ = ("x", "mask", "gating", "fields", "event", "out", "err")

    def __init__(self, x, mask, gating, fields=None):
        self.x, self.mask, self.gating = x, mask, gating
        self.fields = fields   # set of output names, or None = all
        self.event = threading.Event()
        self.out = None
        self.err = None


class PredictorServer:
    """Owns the Predictor + a lock; builds the request handler class."""

    def __init__(self, predictor: Predictor, max_request_rows: int = 4096,
                 batch_window_ms: float = 0.0,
                 default_fields: Optional[set] = None):
        self.predictor = predictor
        self.max_request_rows = max_request_rows
        if default_fields is not None:
            default_fields = {str(f) for f in default_fields}
            unknown = default_fields - _RESPONSE_FIELDS
            if unknown:
                raise ValueError(f"unknown default_fields {sorted(unknown)}; "
                                 f"valid: {sorted(_RESPONSE_FIELDS)}")
        self.default_fields = default_fields
        self.lock = threading.Lock()
        self.batch_window = batch_window_ms / 1e3
        self.batched_dispatches = 0     # predict calls made by the batcher
        # live Predictor has .max_batch; CompiledPredictor's cap is its
        # largest exported bucket
        self._coalesce_cap = getattr(
            predictor, "max_batch", None) or predictor.manifest["buckets"][-1]
        if self.batch_window > 0:
            self._bq: _queue_mod.Queue = _queue_mod.Queue()
            threading.Thread(target=self._batcher_loop, daemon=True).start()
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._rows = 0
        self._errors = {"400": 0, "500": 0}
        self._latency_sum = 0.0
        self._latency_buckets = [0] * (len(_LATENCY_BUCKETS) + 1)

    def _record(self, rows: int, seconds: float):
        with self._stats_lock:
            self._requests += 1
            self._rows += rows
            self._latency_sum += seconds
            for i, edge in enumerate(_LATENCY_BUCKETS):
                if seconds <= edge:
                    self._latency_buckets[i] += 1
                    break
            else:
                self._latency_buckets[-1] += 1

    def _record_error(self, code: int):
        with self._stats_lock:
            key = str(code)
            self._errors[key] = self._errors.get(key, 0) + 1

    def metrics_text(self) -> str:
        with self._stats_lock:
            lines = [
                "# TYPE sie_tpu_requests_total counter",
                f"sie_tpu_requests_total {self._requests}",
                "# TYPE sie_tpu_rows_total counter",
                f"sie_tpu_rows_total {self._rows}",
                "# TYPE sie_tpu_errors_total counter",
            ]
            for code, n in sorted(self._errors.items()):
                lines.append(f'sie_tpu_errors_total{{code="{code}"}} {n}')
            lines.append("# TYPE sie_tpu_request_seconds histogram")
            cum = 0
            for edge, n in zip(_LATENCY_BUCKETS, self._latency_buckets):
                cum += n
                lines.append(
                    f'sie_tpu_request_seconds_bucket{{le="{edge}"}} {cum}')
            cum += self._latency_buckets[-1]
            lines.append(f'sie_tpu_request_seconds_bucket{{le="+Inf"}} {cum}')
            lines.append(f"sie_tpu_request_seconds_sum {self._latency_sum}")
            lines.append(f"sie_tpu_request_seconds_count {self._requests}")
            return "\n".join(lines) + "\n"

    # ---- request handling ------------------------------------------------
    @property
    def _is_aot(self) -> bool:
        return isinstance(self.predictor, CompiledPredictor)

    def _shape(self):
        if self._is_aot:
            m = self.predictor.manifest
            return m["seq_len"], m["enc_in"]
        return self.predictor.cfg.seq_len, self.predictor.cfg.enc_in

    def handle_predict(self, payload: dict) -> dict:
        """JSON-list response body (back-compat API)."""
        return {k: v.tolist()
                for k, v in self.handle_predict_arrays(payload).items()}

    def handle_predict_arrays(self, payload: dict) -> dict:
        seq_len, enc_in = self._shape()
        x = _decode_x(payload, seq_len, enc_in)
        if x.shape[0] > self.max_request_rows:
            raise ValueError(f"batch {x.shape[0]} exceeds the server limit "
                             f"{self.max_request_rows}; split the request")
        mask = payload.get("padding_mask")
        if mask is not None:
            mask = np.asarray(mask, np.float32)
            if mask.shape != x.shape[:2]:
                raise ValueError(
                    f"padding_mask must be {x.shape[:2]}; got {mask.shape}")
        gating = payload.get("gating_value", _MISSING)
        if gating is not _MISSING and gating is not None \
                and not isinstance(gating, (int, float)):
            raise ValueError("gating_value must be a number or null")
        if self._is_aot and gating is not _MISSING:
            raise ValueError("gating_value is baked into StableHLO "
                             "artifacts at export time and cannot be "
                             "overridden per request")
        if "fields" in payload:
            fields = payload["fields"]          # explicit: overrides default
        else:
            fields = (None if self.default_fields is None
                      else sorted(self.default_fields))
        keep = None
        if fields is not None:
            try:
                keep = {str(f) for f in np.ravel(fields)}
            except TypeError:
                raise ValueError("fields must be a list of strings") \
                    from None
            if "all" in keep:     # explicit opt-out of the server default
                keep = None
        if keep is not None:
            unknown = keep - _RESPONSE_FIELDS
            if unknown:
                raise ValueError(
                    f"unknown fields {sorted(unknown)}; "
                    f"valid: {sorted(_RESPONSE_FIELDS)} or ['all']")
            keep.add("classes")   # rows anchor — always present
        if self.batch_window > 0:
            # the batcher fetches the UNION of the window's fields; this
            # request's own projection is applied below
            out = self._predict_batched(x, mask, gating, keep)
        else:
            out = self._predict_now(x, mask, gating, keep)
        resp = {"logits": np.asarray(out.logits),
                "probs": np.asarray(out.probs),
                "classes": np.asarray(out.classes)}
        for k in ("eta", "p", "d", "shapelet_preds", "dnn_preds"):
            v = getattr(out, k)
            if v is not None:
                resp[k] = np.asarray(v)
        if keep is not None:
            resp = {k: v for k, v in resp.items() if k in keep}
        return resp

    def _predict_now(self, x, mask, gating, fields=None):
        with self.lock:
            kw = {}
            if fields is not None and not self._is_aot:
                # live Predictor: projected-out tensors are never fetched
                # from the device (serve.Predictor.predict fields)
                kw["fields"] = fields
            if gating is _MISSING:
                return self.predictor.predict(x, mask, **kw)
            return self.predictor.predict(x, mask, gating_value=gating,
                                          **kw)

    # ---- dynamic micro-batching -------------------------------------------
    def _predict_batched(self, x, mask, gating, fields=None):
        if mask is None:
            mask = np.ones(x.shape[:2], np.float32)
        p = _Pending(x, mask, gating, fields)
        self._bq.put(p)
        if not p.event.wait(timeout=600.0):
            raise RuntimeError("micro-batcher timed out")
        if p.err is not None:
            raise p.err
        return p.out

    def _batcher_loop(self):
        while True:
            group = [self._bq.get()]
            rows = group[0].x.shape[0]
            deadline = time.monotonic() + self.batch_window
            while rows < self._coalesce_cap:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._bq.get(timeout=remaining)
                except _queue_mod.Empty:
                    break
                group.append(nxt)
                rows += nxt.x.shape[0]
            # one predict per distinct gating value in the window.
            # handle_predict validates gating hashability before enqueue;
            # guard anyway — an exception ABOVE any try would kill the
            # batcher thread and hang the server
            try:
                by_gating: dict = {}
                for p in group:
                    by_gating.setdefault(p.gating, []).append(p)
            except Exception as e:   # noqa: BLE001 — worker loop
                for p in group:
                    p.err = e
                    p.event.set()
                continue
            for gating, ps in by_gating.items():
                try:
                    xs = np.concatenate([p.x for p in ps])
                    ms = np.concatenate([p.mask for p in ps])
                    # fetch the union of the group's projections; any
                    # request wanting everything (fields=None) disables it
                    fields = None
                    if all(p.fields is not None for p in ps):
                        fields = set().union(*(p.fields for p in ps))
                    out = self._predict_now(xs, ms, gating, fields)
                    self.batched_dispatches += 1
                    lo = 0
                    for p in ps:
                        b = p.x.shape[0]
                        sl = {f: (None if getattr(out, f) is None else
                                  np.asarray(getattr(out, f))[lo:lo + b])
                              for f in out.__dataclass_fields__}
                        p.out = type(out)(**sl)
                        lo += b
                except Exception as e:   # noqa: BLE001 — worker loop
                    for p in ps:
                        p.err = e
                finally:
                    for p in ps:
                        p.event.set()

    def health(self) -> dict:
        if self._is_aot:
            m = dict(self.predictor.manifest)
            return {"status": "ok", "serving": "stablehlo-aot",
                    "model": m.get("model"), "dnn_type": m.get("dnn_type"),
                    "num_class": m["num_class"], "seq_len": m["seq_len"],
                    "enc_in": m["enc_in"], "max_batch": m["buckets"][-1],
                    "temperature": m.get("temperature", 1.0)}
        cfg = self.predictor.cfg
        return {"status": "ok", "serving": "live",
                "model": cfg.model, "dnn_type": cfg.dnn_type,
                "num_class": cfg.num_class, "seq_len": cfg.seq_len,
                "enc_in": cfg.enc_in, "max_batch": self.predictor.max_batch,
                "temperature": self.predictor.temperature,
                "quantized": self.predictor.quantized}

    # ---- wiring ----------------------------------------------------------
    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):   # quiet by default
                pass

            def _send(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, server.health())
                elif self.path == "/config":
                    if server._is_aot:
                        self._send(200, dict(server.predictor.manifest))
                    else:
                        self._send(200, json.loads(
                            config_to_json(server.predictor.cfg)))
                elif self.path == "/metrics":
                    body = server.metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def _send_npz(self, arrays: dict):
                body = _encode_npz(arrays)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npz")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                t0 = time.perf_counter()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    ctype = (self.headers.get("Content-Type") or ""
                             ).split(";")[0].strip().lower()
                    if ctype in NPZ_CONTENT_TYPES:
                        payload = _decode_npz_body(body)
                    else:
                        payload = json.loads(body or b"{}")
                    accept = (self.headers.get("Accept") or "").lower()
                    want_npz = any(t in accept for t in NPZ_CONTENT_TYPES)
                    arrays = server.handle_predict_arrays(payload)
                    server._record(int(arrays["classes"].shape[0]),
                                   time.perf_counter() - t0)
                    if want_npz:
                        self._send_npz(arrays)
                    else:
                        self._send(200, {k: v.tolist()
                                         for k, v in arrays.items()})
                except (ValueError, KeyError, TypeError) as e:
                    # errors count toward requests_total + the latency
                    # histogram too (Prometheus convention: errors_total
                    # is a subset, error rate = errors/requests <= 1)
                    server._record(0, time.perf_counter() - t0)
                    server._record_error(400)
                    self._send(400, {"error": str(e)})
                except Exception as e:        # noqa: BLE001 — serving loop
                    server._record(0, time.perf_counter() - t0)
                    server._record_error(500)
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8723
              ) -> ThreadingHTTPServer:
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        httpd.serve_forever()
        return httpd


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle",
                     help="serving bundle dir (--export_bundle)")
    src.add_argument("--stablehlo",
                     help="ahead-of-time artifact dir (--export_stablehlo); "
                          "the port's artifacts are torch.export programs, "
                          "served by CompiledPredictor — no model code or "
                          "weight file loaded")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8723)
    p.add_argument("--max_batch", type=int, default=256)
    p.add_argument("--max_request_rows", type=int, default=4096)
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="coalesce concurrent requests for up to this many "
                        "ms into one device batch (dynamic micro-batching;"
                        " 0 = off)")
    p.add_argument("--warmup", type=int, nargs="*", default=[1, 32],
                   help="batch sizes to pre-compile before accepting traffic")
    p.add_argument("--default_fields", default="",
                   help="comma-separated response fields served when a "
                        "request has no 'fields' key (e.g. 'probs' skips "
                        "the bulk interpretability-tensor fetch); empty = "
                        "serve everything. Requests override with their "
                        "own fields or ['all']")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card; raises without one) or 'cpu' "
                        "(the kernels' plain PyTorch versions)")
    args = p.parse_args(argv)

    if args.stablehlo:
        predictor = CompiledPredictor(args.stablehlo, device=args.device)
    else:
        predictor = Predictor.load_bundle(args.bundle,
                                          max_batch=args.max_batch,
                                          device=args.device)
        if args.warmup:
            predictor.warmup(batch_sizes=tuple(args.warmup))
    src_dir = args.stablehlo or args.bundle
    default_fields = {t.strip() for t in args.default_fields.split(",")
                      if t.strip()} or None
    server = PredictorServer(predictor, args.max_request_rows,
                             batch_window_ms=args.batch_window_ms,
                             default_fields=default_fields)
    print(f"serving {src_dir} on http://{args.host}:{args.port}",
          flush=True)
    server.serve(args.host, args.port)


if __name__ == "__main__":
    main()
