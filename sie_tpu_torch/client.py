"""Thin stdlib client for the sie_tpu HTTP inference API, as served by
`python -m sie_tpu_torch.serve_http` and `python -m sie_tpu.serve_http`
alike (a copy of sie_tpu/client.py: numpy and the standard library only).

Lets a consumer process hit a serving host without importing torch or the
model code —

    from sie_tpu_torch.client import InferenceClient
    c = InferenceClient("http://host:8723")
    print(c.health())
    out = c.predict(x)            # x: (B, seq_len, enc_in) np.ndarray
    out.classes, out.probs        # same PredictOutput-shaped fields

Bulk payloads go base64 (the server's x_b64 fast path) above
`json_threshold_rows`; below it, plain JSON lists keep requests
human-debuggable. `InferenceClient(..., encoding="npz")` switches to the
server's binary npz path (raw f32 buffers both directions — no JSON/b64
encode of the tensors at all), the fastest transport for bulk traffic.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

_MISSING = object()


class ServerError(RuntimeError):
    """Non-2xx response; carries the HTTP status and server error text."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


@dataclasses.dataclass
class ClientPredictOutput:
    classes: np.ndarray
    # logits/probs are None only when a `fields` projection excluded them
    logits: Optional[np.ndarray] = None
    probs: Optional[np.ndarray] = None
    eta: Optional[np.ndarray] = None
    p: Optional[np.ndarray] = None
    d: Optional[np.ndarray] = None
    shapelet_preds: Optional[np.ndarray] = None
    dnn_preds: Optional[np.ndarray] = None


class InferenceClient:
    def __init__(self, base_url: str, timeout: float = 630.0,
                 json_threshold_rows: int = 8, encoding: str = "auto"):
        if encoding not in ("auto", "json", "b64", "npz"):
            raise ValueError(f"unknown encoding {encoding!r}")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.json_threshold_rows = json_threshold_rows
        self.encoding = encoding

    # ---- transport -------------------------------------------------------
    @staticmethod
    def _raise_server_error(e: urllib.error.HTTPError):
        try:
            msg = json.loads(e.read()).get("error", "")
        except Exception:   # noqa: BLE001 — best-effort error body
            msg = ""
        raise ServerError(e.code, msg) from None

    def _request(self, path: str, payload: Optional[dict] = None) -> dict:
        url = self.base_url + path
        data = None
        headers = {}
        if payload is not None:
            data = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=data, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            self._raise_server_error(e)

    # ---- API -------------------------------------------------------------
    def health(self) -> dict:
        return self._request("/healthz")

    def config(self) -> dict:
        return self._request("/config")

    def metrics(self) -> str:
        with urllib.request.urlopen(self.base_url + "/metrics",
                                    timeout=self.timeout) as r:
            return r.read().decode()

    def _request_npz(self, x, padding_mask, gating_value, fields) -> dict:
        arrays = {"x": x}
        if padding_mask is not None:
            arrays["padding_mask"] = np.asarray(padding_mask, np.float32)
        if gating_value is not _MISSING:
            arrays["gating_value"] = np.float32(
                np.nan if gating_value is None else gating_value)
        if fields is not None:
            arrays["fields"] = np.asarray(list(fields))
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        req = urllib.request.Request(
            self.base_url + "/predict", data=buf.getvalue(),
            headers={"Content-Type": "application/x-npz",
                     "Accept": "application/x-npz"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                body = r.read()
                if "npz" in (r.headers.get("Content-Type") or ""):
                    with np.load(io.BytesIO(body),
                                 allow_pickle=False) as z:
                        return {k: z[k] for k in z.files}
                return json.loads(body)
        except urllib.error.HTTPError as e:
            self._raise_server_error(e)

    def predict(self, x: np.ndarray,
                padding_mask: Optional[np.ndarray] = None,
                gating_value=_MISSING,
                fields: Optional[list] = None) -> ClientPredictOutput:
        """`fields`: optional list of output names to return (server-side
        response projection; `classes` always comes back)."""
        x = np.ascontiguousarray(np.asarray(x, dtype="<f4"))
        if x.ndim != 3:
            raise ValueError(f"x must be (B, T, C); got {x.shape}")
        if self.encoding == "npz":
            resp = self._request_npz(x, padding_mask, gating_value, fields)
        else:
            if self.encoding == "b64" or (
                    self.encoding == "auto"
                    and x.shape[0] > self.json_threshold_rows):
                payload = {"x_b64": base64.b64encode(x.tobytes()).decode(),
                           "shape": list(x.shape)}
            else:
                payload = {"x": x.tolist()}
            if padding_mask is not None:
                payload["padding_mask"] = np.asarray(
                    padding_mask, np.float32).tolist()
            if gating_value is not _MISSING:
                payload["gating_value"] = gating_value
            if fields is not None:
                payload["fields"] = list(fields)
            resp = self._request("/predict", payload)
        fields = {f.name for f in dataclasses.fields(ClientPredictOutput)}
        out = {k: np.asarray(v, np.float32) for k, v in resp.items()
               if k in fields}
        out["classes"] = np.asarray(resp["classes"], np.int64)
        return ClientPredictOutput(**out)
