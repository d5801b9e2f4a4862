"""Native (C++) HTTP front-end: correctness against the Python server.

Per-request work lives in native/httpserve.cpp; Python only runs the
batched decode.  Served captions must equal the offline decoder's, and
the error surface (400/404/501/stats) must behave like the Python
front-end's where the contract overlaps.
"""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data.feature_store import FeatureStore
from lrcn_jax.models import lrcn
from lrcn_jax.native import httpserve_library
from lrcn_jax.serve import CaptionService

pytestmark = pytest.mark.skipif(httpserve_library() is None,
                                reason="native httpserve unavailable")


@pytest.fixture(scope="module")
def frontend():
    from lrcn_jax.serve.native_http import NativeFrontend

    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    feats = {100 + i: np.abs(rng.standard_normal(
        cfg.cnn_feature_dim)).astype(np.float32) for i in range(12)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                        max_words=8, decode_batch=8,
                        compute_dtype=jnp.float32)
    svc.warmup()
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=64,
                        wait_ms=2)
    yield fe, svc
    fe.stop()
    svc.close()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def test_native_healthz_and_routes(frontend):
    fe, _ = frontend
    status, out = _request(fe.port, "GET", "/healthz")
    assert status == 200 and out["ok"] and out["frontend"] == "native"
    status, _ = _request(fe.port, "GET", "/nope")
    assert status == 404


def test_native_captions_match_service(frontend):
    fe, svc = frontend
    expected = svc.caption_ids([100, 101, 102])

    status, out = _request(fe.port, "POST", "/v1/caption", {"id": 100})
    assert status == 200 and out["captions"] == expected[:1]

    status, out = _request(fe.port, "POST", "/v1/caption",
                           {"ids": [100, 101, 102]})
    assert status == 200 and out["captions"] == expected


def test_native_error_surface(frontend):
    fe, _ = frontend
    status, out = _request(fe.port, "POST", "/v1/caption", {"id": 99999})
    assert status == 400 and "unknown image id" in out["error"]
    status, out = _request(fe.port, "POST", "/v1/caption", {"wrong": 1})
    assert status == 400
    # feature-row validation happens in the C++ parser
    status, out = _request(fe.port, "POST", "/v1/caption",
                           {"features": [[0.1] * 5]})
    assert status == 400 and "dims" in out["error"]
    status, out = _request(fe.port, "POST", "/v1/caption",
                           {"features": [0.1] * 8})   # flat, not rows
    assert status == 400
    status, out = _request(fe.port, "POST", "/v1/caption",
                           {"features": []})
    assert status == 400
    # image bodies are the Python server's job
    status, out = _request(fe.port, "POST", "/v1/caption",
                           {"image_b64": "abcd"})
    assert status == 501 and "python" in out["error"]


def test_native_feature_requests_match_service(frontend):
    """Raw fc7 rows through the C++ parser + grouped feature dispatch
    must produce exactly what ``caption_features`` produces (the Python
    server's contract for the same body)."""
    fe, svc = frontend
    rng = np.random.default_rng(11)
    rows = np.abs(rng.standard_normal((5, 8))).astype(np.float32)
    expected = svc.caption_features(list(rows))

    status, out = _request(fe.port, "POST", "/v1/caption",
                           {"features": [r.tolist() for r in rows]})
    assert status == 200 and out["captions"] == expected

    # un-normalized rows normalize server-side (reference lrcn.jl:597);
    # a power-of-two scale keeps the normalized row bit-identical
    status, out = _request(fe.port, "POST", "/v1/caption",
                           {"features": [(rows[0] * 8.0).tolist()]})
    assert status == 200 and out["captions"] == expected[:1]

    # /stats counts them
    _, st = _request(fe.port, "GET", "/stats")
    assert st["feat_items"] >= 6


def test_native_mixed_id_and_feature_burst(frontend):
    """Concurrent id and feature requests in the same pull window serve
    correctly (they split into a rows dispatch and a feats dispatch)."""
    fe, svc = frontend
    rng = np.random.default_rng(12)
    rows = np.abs(rng.standard_normal((3, 8))).astype(np.float32)
    want_feat = svc.caption_features(list(rows))
    want_ids = svc.caption_ids([100, 105])

    results = {}
    barrier = threading.Barrier(5)

    def by_id(k, image_id, want):
        barrier.wait(timeout=30)
        status, out = _request(fe.port, "POST", "/v1/caption",
                               {"id": image_id})
        results[k] = (status, out["captions"], [want])

    def by_feat(k, row, want):
        barrier.wait(timeout=30)
        status, out = _request(fe.port, "POST", "/v1/caption",
                               {"features": [row.tolist()]})
        results[k] = (status, out["captions"], [want])

    threads = ([threading.Thread(target=by_id, args=(f"i{j}", i, w),
                                 daemon=True)
                for j, (i, w) in enumerate(zip([100, 105], want_ids))]
               + [threading.Thread(target=by_feat, args=(f"f{j}", r, w),
                                   daemon=True)
                  for j, (r, w) in enumerate(zip(rows, want_feat))])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 5
    for status, got, want in results.values():
        assert status == 200 and got == want


def test_native_image_requests_match_service():
    """Base64 image bodies: C++ decodes the base64, the image thread
    feeds the service's VGG encode stage; captions must equal
    ``caption_image_bytes`` (the Python server's contract).  Bad bytes
    get a 400; bad base64 is rejected in the C++ parser."""
    import base64
    import io

    from PIL import Image

    from lrcn_jax.models import vgg as vgg_mod
    from lrcn_jax.serve.native_http import NativeFrontend

    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(3), cfg)
    vgg_params = vgg_mod.init_vgg_params(
        jax.random.PRNGKey(4), width_multiplier=0.05,
        fc_dim=cfg.cnn_feature_dim)
    svc = CaptionService(cfg, params, vocab, vgg_params=vgg_params,
                         beam_width=2, max_words=8, decode_batch=4,
                         encode_batch=2, compute_dtype=jnp.float32)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=8,
                        wait_ms=2)
    try:
        rng = np.random.default_rng(9)
        blobs = []
        for _ in range(2):
            img = Image.fromarray(
                rng.integers(0, 255, (240, 260, 3)).astype(np.uint8))
            buf = io.BytesIO()
            img.save(buf, format="JPEG")
            blobs.append(buf.getvalue())
        want = svc.caption_image_bytes(blobs)

        status, out = _request(
            fe.port, "POST", "/v1/caption",
            {"image_b64": base64.b64encode(blobs[0]).decode()})
        assert status == 200 and out["captions"] == want[:1]

        status, out = _request(
            fe.port, "POST", "/v1/caption",
            {"images_b64": [base64.b64encode(b).decode()
                            for b in blobs]})
        assert status == 200 and out["captions"] == want

        # valid base64, invalid image bytes -> 400 from the image thread
        status, out = _request(
            fe.port, "POST", "/v1/caption",
            {"image_b64": base64.b64encode(b"not a jpeg").decode()})
        assert status == 400 and "decode image" in out["error"]

        # invalid base64 -> 400 from the C++ parser
        status, out = _request(fe.port, "POST", "/v1/caption",
                               {"image_b64": "!!!not-base64!!!"})
        assert status == 400 and "base64" in out["error"]

        _, st = _request(fe.port, "GET", "/stats")
        assert st["img_items"] >= 4
    finally:
        fe.stop()
        svc.close()


def test_native_features_only_service_without_store():
    """A features-only deployment (external encoder, no feature store)
    serves raw-feature requests natively; id requests get a 400."""
    from lrcn_jax.serve.native_http import NativeFrontend

    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(2), cfg)
    svc = CaptionService(cfg, params, vocab, beam_width=2, max_words=8,
                         decode_batch=8, compute_dtype=jnp.float32)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=8,
                        wait_ms=2)
    try:
        rng = np.random.default_rng(13)
        row = np.abs(rng.standard_normal(8)).astype(np.float32)
        want = svc.caption_features([row])
        status, out = _request(fe.port, "POST", "/v1/caption",
                               {"features": [row.tolist()]})
        assert status == 200 and out["captions"] == want
        status, out = _request(fe.port, "POST", "/v1/caption", {"id": 1})
        assert status == 400 and "feature store" in out["error"]
    finally:
        fe.stop()
        svc.close()


def test_native_concurrent_clients_coalesce(frontend):
    fe, svc = frontend
    expected = {i: svc.caption_ids([100 + (i % 12)])[0] for i in range(12)}
    results = {}
    barrier = threading.Barrier(32)   # overlap the burst so requests
    # genuinely coexist in the C++ queue (coalescing is the assertion)

    def client(i):
        barrier.wait(timeout=30)
        status, out = _request(fe.port, "POST", "/v1/caption",
                               {"id": 100 + (i % 12)})
        results[i] = (status, out["captions"][0])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 32
    for i, (status, caption) in results.items():
        assert status == 200
        assert caption == expected[i % 12]

    status, stats = _request(fe.port, "GET", "/stats")
    assert status == 200
    assert stats["frontend"] == "native"
    assert stats["items"] >= 32
    # coalescing: strictly fewer device batches than items
    assert stats["batches"] < stats["items"], stats


def _raw_request(port, raw: bytes) -> bytes:
    import socket

    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        s.sendall(raw)
        out = b""
        s.settimeout(10)
        try:
            while b"\r\n\r\n" not in out or True:
                chunk = s.recv(4096)
                if not chunk:
                    break
                out += chunk
                if b"\r\n\r\n" in out:
                    # got headers + (short) body; enough for the asserts
                    break
        except TimeoutError:
            pass
        return out
    finally:
        s.close()


def test_native_survives_malformed_requests(frontend):
    """Regression: these exact payloads used to std::terminate the whole
    process (uncaught stoll/stoul in detached threads)."""
    fe, _ = frontend
    # out-of-range integer id
    status, out = _request(fe.port, "POST", "/v1/caption",
                           {"id": 99999999999999999999999})
    assert status == 400
    # bare-sign id (raw body: json.dumps would reject it)
    body = b'{"id": -}'
    raw = (b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n"
           b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n"
           + body)
    assert b"400" in _raw_request(fe.port, raw).split(b"\r\n")[0]
    # garbage Content-Length
    raw = (b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n"
           b"Content-Length: abc\r\n\r\n")
    assert b"400" in _raw_request(fe.port, raw).split(b"\r\n")[0]
    # chunked transfer encoding: refused, not desynced
    raw = (b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n"
           b"Transfer-Encoding: chunked\r\n\r\n"
           b"9\r\n{\"id\": 5}\r\n0\r\n\r\n")
    assert b"501" in _raw_request(fe.port, raw).split(b"\r\n")[0]
    # the server is still alive and serving
    status, out = _request(fe.port, "GET", "/healthz")
    assert status == 200 and out["ok"]


def test_native_pump_survives_decode_failure(frontend, monkeypatch):
    """A failing device batch 500s its requests; the pump keeps serving."""
    fe, svc = frontend

    real = svc._decode_rows_fn
    calls = {"n": 0}

    def failing(rows):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device failure")
        return real(rows)

    monkeypatch.setattr(svc, "_decode_rows_fn", failing)
    status, out = _request(fe.port, "POST", "/v1/caption", {"id": 100})
    assert status == 500 and "decode failed" in out["error"]
    status, out = _request(fe.port, "POST", "/v1/caption", {"id": 100})
    assert status == 200 and len(out["captions"]) == 1


def test_native_slow_header_connection_is_released():
    """A client that starts a request and then trickles (or stops
    sending) header bytes must be disconnected once the request timeout
    passes — otherwise n_threads such clients pin every connection
    thread forever and all real clients get 503 (slowloris)."""
    import socket
    import time

    from lrcn_jax.serve.native_http import NativeFrontend

    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    feats = {100 + i: np.abs(rng.standard_normal(
        cfg.cnn_feature_dim)).astype(np.float32) for i in range(4)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                         max_words=8, decode_batch=4,
                         compute_dtype=jnp.float32,
                         request_timeout_s=2.0)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=8)
    try:
        s = socket.create_connection(("127.0.0.1", fe.port), timeout=30)
        # request line arrives, then the headers stall
        s.sendall(b"POST /v1/caption HTTP/1.1\r\nX-Slow: ")
        s.settimeout(20)
        t0 = time.monotonic()
        closed = False
        try:
            while time.monotonic() - t0 < 15:
                if s.recv(4096) == b"":
                    closed = True
                    break
        except TimeoutError:
            pass
        s.close()
        # request timeout 2s + SO_RCVTIMEO poll 5s -> released well
        # before the 15s observation window ends
        assert closed, "slow-header connection still held after 15s"
        # the server is alive and serving afterwards
        status, out = _request(fe.port, "POST", "/v1/caption",
                               {"id": 100})
        assert status == 200 and len(out["captions"]) == 1
    finally:
        fe.stop()
        svc.close()


def test_native_finalize_failure_fails_fast(frontend, monkeypatch):
    """When finalize blows up on the batch just popped from `pending`,
    its requests must get their 500 immediately — not sit out the full
    request timeout for a C++-side 504 (the pre-fix behavior: the
    except block failed every batch EXCEPT the popped one)."""
    import time

    fe, svc = frontend
    real = fe._respond_raw
    calls = {"n": 0}

    def failing(preqs, pslots, raw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected finalize failure")
        return real(preqs, pslots, raw)

    monkeypatch.setattr(fe, "_respond_raw", failing)
    t0 = time.monotonic()
    status, out = _request(fe.port, "POST", "/v1/caption", {"id": 100})
    elapsed = time.monotonic() - t0
    assert status == 500 and "decode failed" in out["error"]
    # the fix turns a request_timeout_s (60 s) 504 cliff into ~1 s
    assert elapsed < 5.0, f"stranded for {elapsed:.1f}s"
    status, out = _request(fe.port, "POST", "/v1/caption", {"id": 100})
    assert status == 200 and len(out["captions"]) == 1


def test_native_burst_grouped_decode_matches(frontend):
    """A burst larger than one compiled batch drains through the scanned
    multi-batch dispatch (service._rows_search_scan) — token-exact with
    the per-batch path."""
    fe, svc = frontend
    ids = [100 + (i % 12) for i in range(20)]    # decode_batch=8 -> g=3
    expected = svc.caption_ids(ids)              # per-batch path
    status, out = _request(fe.port, "POST", "/v1/caption", {"ids": ids})
    assert status == 200
    assert out["captions"] == expected

    # unit-level: grouped issue == per-batch issue, bit-exact
    rows = [int(r) for r in svc.store.rows(ids)]
    grouped = svc._decode_finalize(svc._decode_rows_grouped(rows))
    singles = []
    b = svc.decode_batch
    for i in range(0, len(rows), b):
        singles.extend(svc._decode_finalize(
            svc._decode_rows_fn(rows[i:i + b])))
    assert grouped == singles


def test_serve_next_fill_window_semantics():
    """Direct unit test of ``lrcn_serve_next``'s fill window (the pump's
    arrival forecast): a pull ends EARLY once ``min_n`` items are queued,
    a partial batch drains only when ``fill_ms`` closes, and
    ``fill_ms=0`` drains on first arrival (the pre-window behavior).

    Drives a raw server (no pump) so the pull timing is observable."""
    import ctypes
    import time

    lib = httpserve_library()
    h = lib.lrcn_serve_start(b"127.0.0.1", 0, 16, 256, 30000)
    assert h
    port = lib.lrcn_serve_port(h)
    LL = ctypes.c_longlong

    # before lrcn_serve_ready the caption endpoint must 503 (the
    # pre-registration window would otherwise enqueue RAW ids that a
    # pump with a registered id->row map would read as store rows)
    status, out = _request(port, "POST", "/v1/caption", {"id": 0})
    assert status == 503 and "warming up" in out["error"]
    lib.lrcn_serve_ready(h)

    def clients(n, start_id):
        threads = [threading.Thread(
            target=_request, args=(port, "POST", "/v1/caption",
                                   {"id": start_id + i}), daemon=True)
            for i in range(n)]
        for t in threads:
            t.start()
        return threads

    def pull(max_n, wait_ms, fill_ms, min_n):
        ids = (LL * max_n)()
        reqs = (LL * max_n)()
        slots = (LL * max_n)()
        t0 = time.perf_counter()
        n = lib.lrcn_serve_next(h, ids, reqs, slots, None, None, max_n,
                                wait_ms, fill_ms, min_n)
        return n, time.perf_counter() - t0, reqs, slots

    def respond(n, reqs, slots):
        lib.lrcn_serve_respond(
            h, (LL * n)(*reqs[:n]), (LL * n)(*slots[:n]),
            (ctypes.c_char_p * n)(*([b"ok ."] * n)), n)

    def wait_queued(k, timeout=15.0):
        """Poll /stats until k items are queued (no fixed sleeps)."""
        import time as _t
        deadline = _t.time() + timeout
        while _t.time() < deadline:
            _, st = _request(port, "GET", "/stats")
            if st["queue"] >= k:
                return
            _t.sleep(0.02)
        raise AssertionError(f"queue never reached {k}")

    try:
        # forecast satisfied -> early exit, far before the 2 s window
        ts = clients(5, 0)
        wait_queued(5)
        n, dt, reqs, slots = pull(64, 1000, 2000, 5)
        assert n == 5 and dt < 1.0, (n, dt)
        respond(n, reqs, slots)

        # forecast NOT met -> the partial batch drains at the deadline
        ts += clients(2, 10)
        wait_queued(2)
        n, dt, reqs, slots = pull(64, 1000, 600, 5)
        assert n == 2, n
        assert 0.5 <= dt < 2.0, dt   # waited the window out
        respond(n, reqs, slots)

        # late arrivals END the window early (the closed-loop refill)
        ts += clients(1, 20)
        wait_queued(1)
        late = threading.Timer(0.2, lambda: ts.extend(clients(4, 30)))
        late.start()
        n, dt, reqs, slots = pull(64, 1000, 3000, 5)
        late.join()
        assert n == 5 and dt < 2.0, (n, dt)   # not the 3 s deadline
        respond(n, reqs, slots)

        # fill_ms=0: first arrival drains immediately even under-forecast
        ts += clients(3, 40)
        wait_queued(3)
        n, dt, reqs, slots = pull(64, 1000, 0, 8)
        assert n == 3 and dt < 1.0, (n, dt)
        respond(n, reqs, slots)

        # min_n=0 (no forecast) skips the window instead of hoping
        # for max_n — pre-fix this burned the whole 2 s window
        ts += clients(2, 50)
        wait_queued(2)
        n, dt, reqs, slots = pull(64, 1000, 2000, 0)
        assert n == 2 and dt < 1.0, (n, dt)
        respond(n, reqs, slots)

        for t in ts:
            t.join(timeout=10)
    finally:
        lib.lrcn_serve_stop(h)


def test_capacity_driver_smoke_closed_and_open_loop():
    """The committed serving numbers come from bench_serve_capacity.py +
    native/loadgen.cpp; smoke both loops here (tiny model, 1 s points)
    so the measurement tooling can't rot under the benchmarks."""
    import importlib.util
    import os

    from lrcn_jax.native import loadgen_binary
    from lrcn_jax.serve.native_http import NativeFrontend

    exe = loadgen_binary()
    if exe is None:
        pytest.skip("loadgen unavailable")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench_serve_capacity",
        os.path.join(root, "benchmarks", "bench_serve_capacity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    # the driver's own service: its store ids match loadgen's id stream
    svc = mod.build_service(tiny=True)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=32,
                        wait_ms=2)
    try:
        def stats_fn():
            _, st = _request(fe.port, "GET", "/stats")
            return st

        closed = mod.sweep(exe, fe.port, "native", [8], 1.0, 1, stats_fn)
        assert closed[0]["errors"] == 0
        assert closed[0]["captions_per_s"] > 0
        assert closed[0]["server_side_rate"] > 0

        open_ = mod.rate_sweep(exe, fe.port, "native", [50], 16, 1.0, 1)
        r = open_[0]
        assert r["errors"] == 0
        # every scheduled slot fired and completed (the wrk2 contract)
        assert r["scheduled"] > 0 and r["completion"] >= 0.99
        assert r["p99_ms"] > 0
    finally:
        fe.stop()
        svc.close()


def test_capacity_driver_image_mode_smoke(tmp_path):
    """The image-body loadgen mode behind the committed image-path
    numbers: closed-loop base64-image requests against a tiny
    encoder-bearing service must complete error-free."""
    import importlib.util
    import os

    from PIL import Image

    from lrcn_jax.native import loadgen_binary
    from lrcn_jax.serve.native_http import NativeFrontend

    exe = loadgen_binary()
    if exe is None:
        pytest.skip("loadgen unavailable")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench_serve_capacity",
        os.path.join(root, "benchmarks", "bench_serve_capacity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    img_path = str(tmp_path / "body.jpg")
    rng = np.random.default_rng(7)
    Image.fromarray(rng.integers(0, 255, (240, 320, 3)).astype(
        np.uint8)).save(img_path, format="JPEG", quality=90)

    svc = mod.build_service(tiny=True, with_encoder=True, encode_batch=2)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=16,
                        wait_ms=2)
    try:
        def stats_fn():
            _, st = _request(fe.port, "GET", "/stats")
            return st

        res = mod.sweep(exe, fe.port, "native", [2], 1.0, 1, stats_fn,
                        img_path=img_path)
        assert res[0]["errors"] == 0
        assert res[0]["captions_per_s"] > 0
        assert res[0]["server_side_rate"] > 0    # img_items moved
    finally:
        fe.stop()
        svc.close()


def test_image_traffic_does_not_starve_id_path():
    """Pump/image-thread isolation: with the image thread saturated by
    closed-loop image posts (its decode now runs in C++ threads outside
    the GIL), concurrent id requests must all succeed promptly — the
    regression this guards is image decode holding the GIL and starving
    the id pump (VERDICT r4 weak #5)."""
    import base64
    import io
    import time

    from PIL import Image

    from lrcn_jax.models import vgg as vgg_mod
    from lrcn_jax.serve.native_http import NativeFrontend

    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(3), cfg)
    vgg_params = vgg_mod.init_vgg_params(
        jax.random.PRNGKey(4), width_multiplier=0.05,
        fc_dim=cfg.cnn_feature_dim)
    rng = np.random.default_rng(5)
    feats = {i: np.abs(rng.standard_normal(cfg.cnn_feature_dim))
             .astype(np.float32) for i in range(8)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    svc = CaptionService(cfg, params, vocab, store=store,
                         vgg_params=vgg_params, beam_width=2,
                         max_words=8, decode_batch=4, encode_batch=2,
                         compute_dtype=jnp.float32)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=16,
                        wait_ms=2)
    stop = threading.Event()
    try:
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (320, 400, 3)).astype(
            np.uint8)).save(buf, format="JPEG", quality=90)
        body = {"image_b64": base64.b64encode(buf.getvalue()).decode()}
        # warm both paths (compiles happen before the clock starts)
        assert _request(fe.port, "POST", "/v1/caption", body)[0] == 200
        assert _request(fe.port, "POST", "/v1/caption",
                        {"id": 0})[0] == 200

        img_errors = []

        def image_hammer():
            while not stop.is_set():
                status, _ = _request(fe.port, "POST", "/v1/caption", body)
                if status != 200:
                    img_errors.append(status)
                    return

        hammers = [threading.Thread(target=image_hammer, daemon=True)
                   for _ in range(3)]
        for t in hammers:
            t.start()
        time.sleep(0.5)           # image thread saturated
        lat = []
        for k in range(10):
            t0 = time.monotonic()
            status, out = _request(fe.port, "POST", "/v1/caption",
                                   {"id": k % 8})
            lat.append(time.monotonic() - t0)
            assert status == 200, f"id request failed under image load"
        stop.set()
        for t in hammers:
            t.join(timeout=30)
        assert not img_errors, f"image request failed: {img_errors}"
        # generous CPU-CI bound: starvation (the failure this catches)
        # parks id requests behind multi-second image decode batches
        assert max(lat) < 5.0, f"id path starved: max {max(lat):.2f}s"
    finally:
        stop.set()
        fe.stop()
        svc.close()


def test_mixed_id_feature_traffic_keeps_inflight_bounded():
    """Sustained MIXED id+feature traffic: each pump cycle that pulls
    both kinds issues TWO dispatches (one grouped id, one grouped
    feature).  The regression this guards: retiring only ONE in-flight
    dispatch per cycle lets the pending queue grow by one net per cycle
    — unbounded in-flight depth and runaway latency.  The pump must retire
    down to its budget every cycle, keeping the in-flight high water at
    max_inflight + the (at most 2) same-cycle issues."""
    import time

    from lrcn_jax.serve.native_http import NativeFrontend

    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(5)
    feats = {i: np.abs(rng.standard_normal(cfg.cnn_feature_dim))
             .astype(np.float32) for i in range(8)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                         max_words=8, decode_batch=4,
                         compute_dtype=jnp.float32)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=24,
                        wait_ms=2)
    stop = threading.Event()
    errors = []

    def hammer(kind, seed):
        # np.random.Generator is NOT thread-safe — each hammer owns one
        trng = np.random.default_rng(seed)
        k = 0
        while not stop.is_set():
            body = ({"id": k % 8} if kind == "id" else
                    {"features":
                     [np.abs(trng.standard_normal(8)).tolist()]})
            status, _ = _request(fe.port, "POST", "/v1/caption", body)
            if status != 200:
                errors.append((kind, status))
                return
            k += 1

    try:
        # warm both paths so compiles don't hide the steady state
        assert _request(fe.port, "POST", "/v1/caption",
                        {"id": 0})[0] == 200
        assert _request(fe.port, "POST", "/v1/caption",
                        {"features":
                         [np.ones(8).tolist()]})[0] == 200
        threads = [threading.Thread(target=hammer, args=(kind, 100 + i),
                                    daemon=True)
                   for i, kind in enumerate(("id", "feat") * 4)]
        for t in threads:
            t.start()
        time.sleep(4.0)   # hundreds of mixed pump cycles on CPU
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        bound = fe._max_inflight + 2
        assert fe.pending_hwm <= bound, (
            f"pump in-flight queue grew to {fe.pending_hwm} "
            f"(budget {fe._max_inflight}): mixed traffic is not "
            f"retiring one dispatch per issue")
    finally:
        stop.set()
        fe.stop()
        svc.close()


def test_native_frontend_on_mesh_matches_single_device():
    """The native pump end to end OVER HTTP on a sharded service: the
    grouped drain dispatches (G, B) indices P(None, 'data') against the
    replicated table (serve/service.py:_decode_rows_grouped) and every
    caption equals the single-device service's."""
    from lrcn_jax.parallel.mesh import make_mesh
    from lrcn_jax.serve.native_http import NativeFrontend

    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    feats = {100 + i: np.abs(rng.standard_normal(
        cfg.cnn_feature_dim)).astype(np.float32) for i in range(12)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    mesh = make_mesh((4, 1))
    svc = CaptionService(cfg, params, vocab, store=store, mesh=mesh,
                        beam_width=2, max_words=8, decode_batch=8,
                        compute_dtype=jnp.float32)
    single = CaptionService(cfg, params, vocab, store=store,
                           beam_width=2, max_words=8, decode_batch=8,
                           compute_dtype=jnp.float32)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=16,
                        wait_ms=2)
    try:
        status, out = _request(fe.port, "POST", "/v1/caption", {"id": 100})
        assert status == 200
        assert out["captions"] == single.caption_ids([100])

        # a multi-batch burst in one request exercises the grouped
        # scanned drain (2 compiled batches in one dispatch)
        ids = [100 + (i % 12) for i in range(20)]
        status, out = _request(fe.port, "POST", "/v1/caption",
                               {"ids": ids})
        assert status == 200
        assert out["captions"] == single.caption_ids(ids)
    finally:
        fe.stop()
        svc.close()
        single.close()


def test_native_trickling_header_connection_is_released():
    """A client that keeps SENDING header bytes — each arriving inside
    the SO_RCVTIMEO window, so the n<0 branch never runs — must still be
    disconnected at the request deadline (regression: the deadline was
    only checked on recv timeout, so an active trickler bypassed it)."""
    import socket
    import time

    from lrcn_jax.serve.native_http import NativeFrontend

    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    feats = {100 + i: np.abs(rng.standard_normal(
        cfg.cnn_feature_dim)).astype(np.float32) for i in range(4)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                         max_words=8, decode_batch=4,
                         compute_dtype=jnp.float32,
                         request_timeout_s=2.0)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=8)
    try:
        s = socket.create_connection(("127.0.0.1", fe.port), timeout=30)
        s.sendall(b"POST /v1/caption HTTP/1.1\r\nX-Slow: ")
        s.setblocking(False)
        t0 = time.monotonic()
        closed = False
        while time.monotonic() - t0 < 15:
            try:
                s.sendall(b"y")      # one byte well inside SO_RCVTIMEO
            except OSError:          # server closed on us mid-send
                closed = True
                break
            try:
                if s.recv(4096) == b"":
                    closed = True
                    break
            except BlockingIOError:
                pass
            time.sleep(0.5)
        s.close()
        assert closed, "trickling-header connection still held after 15s"
        # capacity intact: a real request on a fresh connection works
        status, out = _request(fe.port, "POST", "/v1/caption",
                               {"id": 100})
        assert status == 200 and out["captions"]
    finally:
        fe.stop()
        svc.close()
