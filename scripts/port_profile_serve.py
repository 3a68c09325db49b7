"""Where a served request's time goes in sie_tpu_torch, on one CUDA card.

    python scripts/port_profile_serve.py [--rows 1,5,64] [--repeats 5]
                                         [--no-profile] [--out DIR]
    python scripts/port_profile_serve.py --bundle DIR [--http]
                                         [--repeats 5]
    python scripts/port_profile_serve.py --stablehlo DIR [--repeats 5]

Without --bundle: builds the flagship InterpGN (bench.py's configuration,
weights from seed 0) behind `Predictor` on the card (max_batch 64), warms
up, then times `--repeats` requests of each size in `--rows` with the host
clock and prints each size's times and median. Unless `--no-profile`, it
then profiles one request of the largest size with torch.profiler and
prints the device busy time and the ops by device time; `--out` also
writes the Chrome trace there.

With --bundle DIR (a `--export_bundle` directory, f32 or int8): splits
one 64-row request of random rows through `Predictor.load_bundle` into
its stages, each ended by a synchronisation, medians of `--repeats`: pad,
host-to-device copy, forward (its device time by kind: K1, K5, GEMMs,
other, from torch.profiler), fetch to the host, softmax and argmax. With
--http the same request also goes through the port's HTTP server
(`serve_http.PredictorServer` in this process, on a local port) as npz
both ways, split into the client's encode, the server's decode, its
predict, its encode, the client's decode, and the rest of the round trip
(socket and HTTP framing). Both print the request's median ms when
it runs on the calling thread and when each request runs on a new thread
(as `ThreadingHTTPServer` runs each request).

With --stablehlo DIR (a `--export_stablehlo` directory with bucket 64):
the same 64-row and 5-row requests through `CompiledPredictor`, on the
calling thread and on new threads, and the npz HTTP split. Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

MAX_BATCH = 64

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def median_ms(fn, repeats: int) -> float:
    """Median host ms of fn() over `repeats` calls, each ended by a
    synchronisation."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def kernel_kind(name: str) -> str:
    low = name.lower()
    if "shapelet" in low:
        return "K1"
    if "attn" in low:
        return "K5"
    if "gemm" in low or "cutlass" in low or "sm90_" in low:
        return "GEMMs"
    return "other"


def bundle_stages(pred, x: np.ndarray, repeats: int) -> float:
    """Prints the stages of one request of x through `pred`; returns its
    whole median ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sie_tpu_torch.serve import _INFO_FIELDS, _pad, _softmax_probs
    b = x.shape[0]
    mask = np.ones(x.shape[:2], np.float32)
    xp, mp = _pad(x, mask, pred._bucket(b))
    dev = pred.device
    state = {}

    def copy():
        state["x"] = torch.from_numpy(xp).to(dev)
        state["m"] = torch.from_numpy(mp).to(dev)

    def forward():
        with torch.inference_mode():
            state["out"] = pred.model(state["x"], state["m"],
                                      gating_value=pred.cfg.gating_value)

    def fetch():
        logits, info = state["out"]
        state["host"] = [logits.float()[:b].cpu().numpy()] + [
            getattr(info, k).float()[:b].cpu().numpy()
            for k in _INFO_FIELDS if getattr(info, k) is not None]

    def post():
        _softmax_probs(state["host"][0], pred.temperature)
        np.argmax(state["host"][0], -1)

    copy(), forward(), fetch()
    ms = {"pad": median_ms(lambda: _pad(x, mask, pred._bucket(b)), repeats),
          "host-to-device copy": median_ms(copy, repeats),
          "forward": median_ms(forward, repeats),
          "fetch": median_ms(fetch, repeats),
          "softmax, argmax": median_ms(post, repeats)}
    whole = median_ms(lambda: pred.predict(x), repeats)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    kinds: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "Activity Buffer" not in \
                e.key:
            k = kernel_kind(e.key)
            kinds[k] = kinds.get(k, 0.0) + e.self_device_time_total / 1e3
    print(f"request of {b} rows through the bundle: {whole:.3f} ms "
          f"(median of {repeats}); stages: " + ", ".join(
              f"{k} {v:.3f}" for k, v in ms.items()))
    print("forward device ms by kind: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(kinds.items(),
                                          key=lambda kv: -kv[1])))
    return whole


def http_stages(pred, x: np.ndarray, repeats: int, inproc: float) -> None:
    """Prints the stages of one npz request of x through the HTTP server
    (in this process, on a local port)."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    from sie_tpu_torch import serve_http
    spent: dict = {}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + 1e3 * (
                    time.perf_counter() - t0)
        return run

    srv = serve_http.PredictorServer(pred)
    srv.handle_predict_arrays = timed("server predict (validation + "
                                      "Predictor.predict)",
                                      srv.handle_predict_arrays)
    decode, encode = serve_http._decode_npz_body, serve_http._encode_npz
    serve_http._decode_npz_body = timed("server decode", decode)
    serve_http._encode_npz = timed("server encode", encode)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
    rows = {}
    try:
        for i in range(repeats + 1):
            spent.clear()
            t0 = time.perf_counter()
            buf = io.BytesIO()
            np.savez(buf, x=x)
            t1 = time.perf_counter()
            req = urllib.request.Request(
                url, data=buf.getvalue(),
                headers={"Content-Type": "application/x-npz",
                         "Accept": "application/x-npz"})
            with urllib.request.urlopen(req) as r:
                body = r.read()
            t2 = time.perf_counter()
            with np.load(io.BytesIO(body)) as z:
                {k: z[k] for k in z.files}
            t3 = time.perf_counter()
            if i == 0:
                continue                     # warm-up
            server = sum(spent.values())
            row = {"client encode": 1e3 * (t1 - t0), **spent,
                   "client decode": 1e3 * (t3 - t2),
                   "socket and HTTP framing": 1e3 * (t2 - t1) - server,
                   "whole": 1e3 * (t3 - t0)}
            for k, v in row.items():
                rows.setdefault(k, []).append(v)
    finally:
        serve_http._decode_npz_body, serve_http._encode_npz = decode, encode
        httpd.shutdown()
        httpd.server_close()
    print(f"npz request of {len(x)} rows over HTTP (median of {repeats}; "
          f"predict alone {inproc:.3f} ms): " + ", ".join(
              f"{k} {float(np.median(v)):.3f}" for k, v in rows.items()))


def thread_ms(pred, x: np.ndarray, repeats: int) -> None:
    """Prints the median ms of pred.predict(x) on the calling thread and
    on a new thread each."""
    import threading
    same = [median_ms(lambda: pred.predict(x), 1) for _ in range(repeats)]
    fresh = []
    for _ in range(repeats):
        th = threading.Thread(target=lambda: fresh.append(
            median_ms(lambda: pred.predict(x), 1)))
        th.start()
        th.join()
    print(f"request of {len(x)} rows: {float(np.median(same)):.3f} ms on "
          f"the calling thread, {float(np.median(fresh)):.3f} ms on a new "
          f"thread each (medians of {repeats}; new threads: "
          + ", ".join(f"{t:.3f}" for t in fresh) + ")")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1,5,64")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--bundle", default=None)
    ap.add_argument("--http", action="store_true")
    ap.add_argument("--stablehlo", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import flagship_config
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.serve import Predictor

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.bundle:
        pred = Predictor.load_bundle(args.bundle, max_batch=MAX_BATCH)
        x = np.random.default_rng(0).normal(
            size=(MAX_BATCH, pred.cfg.seq_len, pred.cfg.enc_in)).astype(
                np.float32)
        pred.warmup((MAX_BATCH,))
        inproc = bundle_stages(pred, x, args.repeats)
        for rows in (x, x[:5]):
            thread_ms(pred, rows, args.repeats)
        if args.http:
            http_stages(pred, x, args.repeats, inproc)
        return
    if args.stablehlo:
        from sie_tpu_torch.serve import CompiledPredictor
        cp = CompiledPredictor(args.stablehlo)
        m = cp.manifest
        x = np.random.default_rng(0).normal(
            size=(MAX_BATCH, m["seq_len"], m["enc_in"])).astype(np.float32)
        cp.predict(x)
        for rows in (x, x[:5]):
            thread_ms(cp, rows, args.repeats)
        http_stages(cp, x, args.repeats,
                    median_ms(lambda: cp.predict(x), args.repeats))
        return
    cfg = flagship_config()
    pred = Predictor.from_module(
        cfg, build_model(cfg, "cuda", torch.Generator().manual_seed(0)),
        device="cuda", max_batch=MAX_BATCH)
    rng = np.random.default_rng(0)
    sizes = [int(r) for r in args.rows.split(",")]
    xs = {b: rng.normal(size=(b, cfg.seq_len, cfg.enc_in)).astype(np.float32)
          for b in sizes}
    for b in sizes:
        for _ in range(2):
            pred.predict(xs[b])
    for b in sizes:
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            pred.predict(xs[b])
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"request of {b} rows, ms: "
              + ", ".join(f"{t:.3f}" for t in times)
              + f"; median {float(np.median(times)):.3f}")
    if args.no_profile:
        return

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = xs[max(sizes)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(x)
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # kernel and copy rows only: operator rows repeat their kernels' time;
    # "Activity Buffer Request" is the profiler's own buffer, not the model's
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and "Activity Buffer" not in e.key) / 1e3
    print(f"profiled request of {len(x)} rows: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms (idle share {max(0.0, 1 - busy / wall):.3f})")
    print(events.table(sort_by="self_device_time_total", row_limit=30))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "serve_trace.json"))


if __name__ == "__main__":
    main()
