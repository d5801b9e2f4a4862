"""Online serving subsystem: dynamic batching + HTTP front-end.

New surface beyond the reference (which only generates offline,
lrcn.jl:127-160): requests must coalesce into fixed-shape batched
dispatches and produce exactly the captions the offline decoder would.
"""

import base64
import http.client
import io
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data.feature_store import FeatureStore
from lrcn_jax.decode.beam import beam_search
from lrcn_jax.decode.writer import caption_to_line
from lrcn_jax.models import lrcn
from lrcn_jax.serve import CaptionService, DynamicBatcher, make_server

import jax


# --- DynamicBatcher unit tests -----------------------------------------


def test_batcher_coalesces_concurrent_requests():
    seen_batches = []

    def fn(items):
        seen_batches.append(len(items))
        time.sleep(0.01)            # give stragglers time to queue
        return [x * 2 for x in items]

    b = DynamicBatcher(fn, max_batch=8, max_wait_ms=50.0)
    try:
        futs = []
        threads = [threading.Thread(
            target=lambda i=i: futs.append((i, b.submit(i))))
            for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = {i: f.result(timeout=5) for i, f in futs}
        assert results == {i: i * 2 for i in range(16)}
        snap = b.stats.snapshot()
        assert snap["requests"] == 16
        # coalescing actually happened (16 sequential dispatches would
        # mean the batcher is broken)
        assert snap["batches"] < 16, seen_batches
        assert max(seen_batches) > 1
        assert all(n <= 8 for n in seen_batches)
    finally:
        b.close()


def test_batcher_propagates_errors_and_keeps_serving():
    def fn(items):
        if any(x < 0 for x in items):
            raise ValueError("negative")
        return items

    b = DynamicBatcher(fn, max_batch=1, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError):
            b.submit(-1).result(timeout=5)
        assert b.submit(7).result(timeout=5) == 7
        assert b.stats.errors == 1
    finally:
        b.close()


def test_batcher_backpressure_sheds_load():
    from lrcn_jax.serve.batcher import BatcherOverloaded

    release = threading.Event()
    entered = threading.Event()

    def slow(items):
        entered.set()
        release.wait(5)
        return items

    b = DynamicBatcher(slow, max_batch=1, max_wait_ms=1.0, max_queue=2)
    try:
        f0 = b.submit(0)
        assert entered.wait(5)                   # item 0 now in flight
        futs = [f0, b.submit(1), b.submit(2)]    # queue == max_queue
        with pytest.raises(BatcherOverloaded):
            b.submit(99)
        assert b.stats.shed == 1
        release.set()
        assert [f.result(timeout=5) for f in futs] == [0, 1, 2]
    finally:
        release.set()
        b.close()


def test_batcher_resolve_tolerates_concurrent_cancel():
    """A cancel landing between the dispatcher's cancelled() check and
    its set_result must not raise InvalidStateError out of the
    dispatcher/collector thread (that would wedge the service — every
    later request would time out).  ``_resolve`` is the guard; exercise
    both of its racy outcomes deterministically."""
    from concurrent.futures import Future

    from lrcn_jax.serve.batcher import _resolve

    # outcome 1: future already cancelled -> drop silently
    fut = Future()
    fut.cancel()
    _resolve(fut, result=1)
    _resolve(fut, exc=RuntimeError("x"))
    assert fut.cancelled()

    # outcome 2: state changed after the cancelled() check (simulated by
    # an already-resolved future) -> InvalidStateError swallowed
    fut2 = Future()
    fut2.set_result("first")
    _resolve(fut2, result="second")
    _resolve(fut2, exc=RuntimeError("x"))
    assert fut2.result(timeout=1) == "first"

    # end-to-end: a batch full of cancels mid-flight never kills the
    # dispatcher; the batcher keeps serving afterwards
    release = threading.Event()

    def slow(items):
        release.wait(5)
        return items

    b = DynamicBatcher(slow, max_batch=4, max_wait_ms=20.0)
    try:
        futs = [b.submit(i) for i in range(4)]
        time.sleep(0.05)            # let the dispatcher pick them up
        for f in futs:
            f.cancel()
        release.set()
        time.sleep(0.1)
        assert b.submit(42).result(timeout=5) == 42
    finally:
        release.set()
        b.close()


def test_batcher_result_count_mismatch_is_an_error():
    b = DynamicBatcher(lambda items: [], max_batch=4, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="0 results"):
            b.submit(1).result(timeout=5)
    finally:
        b.close()


# --- CaptionService ----------------------------------------------------


@pytest.fixture(scope="module")
def tiny_model():
    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, vocab, params


def _make_store(cfg, n=12):
    rng = np.random.default_rng(5)
    feats = {100 + i: np.abs(rng.standard_normal(
        cfg.cnn_feature_dim)).astype(np.float32) for i in range(n)}
    feats = {k: v / v.sum() for k, v in feats.items()}
    return FeatureStore.from_dict(feats, normalized=True)


def test_service_matches_offline_decoder(tiny_model):
    cfg, vocab, params = tiny_model
    store = _make_store(cfg)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                        max_words=8, decode_batch=4,
                        compute_dtype=jnp.float32)
    try:
        svc.warmup()
        ids = store.ids()[:6]
        served = svc.caption_ids(ids)
        # offline ground truth: the same jitted beam search, full batch
        feats = jnp.asarray(np.stack([store.get(i) for i in ids]))
        tokens, _ = beam_search(params, feats, beam_width=2, max_words=8,
                                compute_dtype=jnp.float32)
        offline = [caption_to_line(np.asarray(tokens)[i], vocab)
                   for i in range(len(ids))]
        assert served == offline
        # the HBM-resident-table path must be bit-identical to host
        # gather + upload
        plain = CaptionService(cfg, params, vocab, store=store,
                              beam_width=2, max_words=8, decode_batch=4,
                              compute_dtype=jnp.float32,
                              resident_store=False)
        try:
            assert plain.caption_ids(ids) == served
        finally:
            plain.close()
    finally:
        svc.close()


def test_service_burst_depth_configurable(tiny_model):
    """`max_burst_groups` overrides MAX_DECODE_GROUPS: a backlog deeper
    than the default 4 batches drains in ONE grouped dispatch with
    output identical to the per-batch path."""
    cfg, vocab, params = tiny_model
    store = _make_store(cfg)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                        max_words=8, decode_batch=2,
                        compute_dtype=jnp.float32, max_burst_groups=6)
    try:
        assert svc.MAX_DECODE_GROUPS == 6
        svc.warmup()
        ids = [store.ids()[i % len(store.ids())] for i in range(11)]
        rows = [int(r) for r in store.rows(ids)]
        grouped = svc._decode_finalize(svc._decode_rows_grouped(rows))
        assert grouped == svc.caption_ids(ids)
    finally:
        svc.close()
    with pytest.raises(ValueError, match="max_burst_groups"):
        CaptionService(cfg, params, vocab, store=store, beam_width=2,
                       max_words=8, decode_batch=2,
                       compute_dtype=jnp.float32, max_burst_groups=0)


def test_feature_path_bursts_beyond_one_batch(tiny_model):
    """The Python decode batcher drains feature backlogs through the
    grouped scanned dispatch: a burst deeper than ``decode_batch``
    coalesces past one compiled batch, with output identical to the
    offline decoder (the asymmetry the id path / native front-end
    already closed)."""
    cfg, vocab, params = tiny_model
    svc = CaptionService(cfg, params, vocab, beam_width=2, max_words=8,
                        decode_batch=2, max_wait_ms=150.0,
                        compute_dtype=jnp.float32)
    try:
        svc.warmup()
        rng = np.random.default_rng(11)
        feats = np.abs(rng.standard_normal(
            (7, cfg.cnn_feature_dim))).astype(np.float32)
        feats /= feats.sum(axis=1, keepdims=True)
        tokens, _ = beam_search(params, jnp.asarray(feats), beam_width=2,
                                max_words=8, compute_dtype=jnp.float32)
        offline = [caption_to_line(np.asarray(tokens)[i], vocab)
                   for i in range(len(feats))]

        # deterministic: the grouped dispatch itself matches offline
        grouped = svc._decode_finalize(
            svc._decode_feats_grouped(feats, normalized=True))
        assert grouped == offline

        # end to end: concurrent caption_features calls coalesce into
        # batches bigger than one compiled decode batch
        results = {}

        def client(i):
            results[i] = svc.caption_features([feats[i]])[0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(feats))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert [results[i] for i in range(len(feats))] == offline
        stats = svc.stats()["decode"]
        # 7 requests + 1 warmup submit; a per-batch drain would need
        # >= ceil(7/2)+1 = 5 batches, the burst drain far fewer
        assert stats["batches"] <= 4, stats
        assert stats["mean_batch_size"] > 1.0, stats
    finally:
        svc.close()


def test_service_concurrent_requests_batch(tiny_model):
    cfg, vocab, params = tiny_model
    store = _make_store(cfg)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                        max_words=8, decode_batch=8, max_wait_ms=100.0,
                        compute_dtype=jnp.float32)
    try:
        svc.warmup()
        results = {}

        def client(i):
            results[i] = svc.caption_ids([100 + (i % 12)])[0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 24
        stats = svc.stats()["decode_ids"]   # id requests -> resident stage
        # 24 concurrent requests (+1 warmup) must coalesce
        assert stats["batches"] < 25, stats
        assert stats["mean_batch_size"] > 1.0, stats
    finally:
        svc.close()


def test_service_on_mesh_matches_single_device(tiny_model):
    """Batch-sharded serving over the virtual mesh == single-device."""
    from lrcn_jax.parallel.mesh import make_mesh

    cfg, vocab, params = tiny_model
    store = _make_store(cfg)
    mesh = make_mesh((4, 1))
    ids = store.ids()[:8]

    sharded = CaptionService(cfg, params, vocab, store=store, mesh=mesh,
                            beam_width=2, max_words=8, decode_batch=8,
                            compute_dtype=jnp.float32)
    single = CaptionService(cfg, params, vocab, store=store,
                           beam_width=2, max_words=8, decode_batch=8,
                           compute_dtype=jnp.float32)
    try:
        sharded.warmup()
        assert sharded.caption_ids(ids) == single.caption_ids(ids)
        # burst absorption under the mesh: a backlog spanning multiple
        # compiled batches drains through the grouped scanned dispatch
        # (idx sharded P(None, 'data')) and stays token-exact
        burst = [store.ids()[i % len(store.ids())] for i in range(20)]
        assert sharded.caption_ids(burst) == single.caption_ids(burst)
        rows = [int(r) for r in store.rows(burst)]
        grouped = sharded._decode_finalize(
            sharded._decode_rows_grouped(rows))
        assert grouped == single.caption_ids(burst)
        # same for the raw-feature grouped path (feats shard
        # P(None, 'data') under the mesh)
        feats = np.stack([store.get(i) for i in burst])
        feats_grouped = sharded._decode_finalize(
            sharded._decode_feats_grouped(feats, normalized=True))
        assert feats_grouped == single.caption_features(list(feats))
    finally:
        sharded.close()
        single.close()

    with pytest.raises(ValueError, match="divisible"):
        CaptionService(cfg, params, vocab, store=store, mesh=mesh,
                       decode_batch=6, compute_dtype=jnp.float32)


# --- HTTP end-to-end ---------------------------------------------------


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


def test_http_server_end_to_end(tiny_model):
    cfg, vocab, params = tiny_model
    store = _make_store(cfg)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                        max_words=8, decode_batch=4,
                        compute_dtype=jnp.float32)
    server = make_server(svc, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        svc.warmup()
        status, health = _request(port, "GET", "/healthz")
        assert status == 200 and health["ok"]

        status, out = _request(port, "POST", "/v1/caption", {"id": 100})
        assert status == 200
        assert out["captions"] == svc.caption_ids([100])

        status, out = _request(port, "POST", "/v1/caption",
                               {"ids": [101, 102]})
        assert status == 200 and len(out["captions"]) == 2

        feats = store.get(103).tolist()
        status, out = _request(port, "POST", "/v1/caption",
                               {"features": [feats]})
        assert status == 200
        assert out["captions"] == svc.caption_ids([103])

        # bad requests are 4xx with an error body, and the server survives
        status, out = _request(port, "POST", "/v1/caption", {"wrong": 1})
        assert status == 400 and "error" in out
        status, out = _request(port, "POST", "/v1/caption",
                               {"id": 999999})
        assert status in (400, 500) and "error" in out
        status, _ = _request(port, "GET", "/nope")
        assert status == 404

        status, stats = _request(port, "GET", "/stats")
        assert status == 200
        # id requests ride the HBM-resident-table stage, raw features
        # the upload stage
        assert stats["decode_ids"]["requests"] >= 4, stats
        assert stats["decode"]["requests"] >= 1, stats
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_http_backpressure_and_timeout_statuses():
    """503 on shed load, 504 on device-wait timeout — server survives.

    Uses a stub service (make_handler is duck-typed) so the error paths
    trigger deterministically without a slow device.
    """
    from concurrent.futures import TimeoutError as FuturesTimeout

    from lrcn_jax.serve.batcher import BatcherOverloaded

    class StubService:
        def caption_ids(self, ids):
            if ids[0] == 1:
                raise BatcherOverloaded("decode: queue full")
            if ids[0] == 2:
                raise FuturesTimeout()
            return ["a caption ."] * len(ids)

        def stats(self):
            return {"decode": {}}

    server = make_server(StubService(), host="127.0.0.1", port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, out = _request(port, "POST", "/v1/caption", {"id": 1})
        assert status == 503 and "queue full" in out["error"]
        status, out = _request(port, "POST", "/v1/caption", {"id": 2})
        assert status == 504 and "timed out" in out["error"]
        status, out = _request(port, "POST", "/v1/caption", {"id": 3})
        assert status == 200 and out["captions"] == ["a caption ."]
    finally:
        server.shutdown()
        server.server_close()


def test_http_image_path_with_tiny_vgg(tiny_model, monkeypatch):
    """caption-by-image through the encode stage (width-scaled VGG)."""
    from PIL import Image

    from lrcn_jax.models import vgg as vgg_mod

    cfg, vocab, params = tiny_model
    vgg_params = vgg_mod.init_vgg_params(
        jax.random.PRNGKey(1), width_multiplier=0.05,
        fc_dim=cfg.cnn_feature_dim)
    svc = CaptionService(cfg, params, vocab, vgg_params=vgg_params,
                        beam_width=2, max_words=8, decode_batch=4,
                        encode_batch=2, compute_dtype=jnp.float32)
    server = make_server(svc, host="127.0.0.1", port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        rng = np.random.default_rng(9)
        img = Image.fromarray(
            rng.integers(0, 255, (240, 260, 3)).astype(np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        blob = base64.b64encode(buf.getvalue()).decode()
        status, out = _request(port, "POST", "/v1/caption",
                               {"image_b64": blob})
        assert status == 200
        assert len(out["captions"]) == 1
        assert out["captions"][0].endswith(".")
        stats = svc.stats()
        assert stats["encode"]["requests"] == 1
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_feature_dim_validated_before_batching(tiny_model):
    """A wrong-width feature row must fail ITS OWN request (ValueError ->
    HTTP 400), not poison a coalesced batch or compile a new shape."""
    cfg, vocab, params = tiny_model
    svc = CaptionService(cfg, params, vocab, beam_width=2, max_words=6,
                        decode_batch=4, compute_dtype=jnp.float32)
    try:
        with pytest.raises(ValueError, match="dims"):
            svc.caption_features([np.zeros(3, np.float32)])
        # the service still works for valid rows afterwards
        out = svc.caption_features(
            [np.zeros(cfg.cnn_feature_dim, np.float32)])
        assert len(out) == 1
    finally:
        svc.close()


def test_caption_features_normalizes_raw_fc7(tiny_model):
    """`caption_features` takes RAW fc7 rows (serve/http.py docs), but
    beam_search expects L1-normalized features (lrcn.jl:597) and every
    other entry point normalizes — raw input must be normalized inside,
    and pre-normalized input must be a no-op (fc7 is post-ReLU)."""
    cfg, vocab, params = tiny_model
    svc = CaptionService(cfg, params, vocab, beam_width=2, max_words=8,
                        decode_batch=4, compute_dtype=jnp.float32)
    try:
        rng = np.random.default_rng(11)
        raw = [np.abs(rng.standard_normal(cfg.cnn_feature_dim))
               .astype(np.float32) * 40.0 for _ in range(3)]
        normalized = [r / r.sum() for r in raw]
        assert svc.caption_features(raw) \
            == svc.caption_features(normalized)
        # and it matches the offline decoder fed normalized features
        feats = jnp.asarray(np.stack(normalized + [normalized[0]]))
        tokens, _ = beam_search(params, feats, beam_width=2, max_words=8,
                                compute_dtype=jnp.float32)
        offline = [caption_to_line(np.asarray(tokens)[i], vocab)
                   for i in range(3)]
        assert svc.caption_features(raw) == offline
    finally:
        svc.close()


def test_http_body_size_cap():
    from lrcn_jax.serve.http import MAX_BODY_BYTES

    class Stub:
        def caption_ids(self, ids):
            return ["x ."]

        def stats(self):
            return {}

    server = make_server(Stub(), host="127.0.0.1", port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/v1/caption", body=b"",
                     headers={"Content-Type": "application/json",
                              "Content-Length": str(MAX_BODY_BYTES + 1)})
        resp = conn.getresponse()
        assert resp.status == 413
        # the body was never read -> the server must not pretend the
        # keep-alive stream is still in sync
        assert resp.getheader("Connection") == "close"
        conn.close()
    finally:
        server.shutdown()
        server.server_close()


def test_http_keepalive_survives_unread_body_replies():
    """HTTP/1.1 keep-alive: replies sent before the request body was
    read (404 on a POSTed path) must not desync the connection — the
    server drains the unread body and the SAME connection keeps
    serving.  Regression for the protocol_version='HTTP/1.1' switch."""

    class Stub:
        def caption_ids(self, ids):
            return ["x ." for _ in ids]

        def stats(self):
            return {}

    server = make_server(Stub(), host="127.0.0.1", port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        # a successful POST FIRST: its body count must not leak into the
        # next request's drain arithmetic (regression: _body_read
        # persisted across keep-alive requests, so the 404 below
        # under-drained by the previous body's length and desynced)
        conn.request("POST", "/v1/caption", body=json.dumps({"id": 1}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())
        # GET after POST: stale count must not force Connection: close
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Connection") != \
            "close"
        resp.read()
        # 404 with an unread body: server drains it, connection survives
        conn.request("POST", "/nope",
                     body=json.dumps({"pad": "y" * 2048}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        # SAME connection: the next request must parse cleanly
        for _ in range(3):
            conn.request("POST", "/v1/caption",
                         body=json.dumps({"id": 1}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200 and body["captions"] == ["x ."]
        conn.close()
    finally:
        server.shutdown()
        server.server_close()


def test_close_resolves_queued_futures():
    """close() must not leave queued requests hanging for their full
    client timeout."""
    import time as _time

    release = threading.Event()

    def slow(items):
        release.wait(5)
        return items

    b = DynamicBatcher(slow, max_batch=1, max_wait_ms=1.0)
    try:
        b.submit(0)
        queued = [b.submit(i) for i in range(1, 4)]
        release.set()
        t0 = _time.monotonic()
        b.close()
        # every queued future resolves promptly (result or 'closed' error)
        for f in queued:
            try:
                f.result(timeout=1)
            except RuntimeError as e:
                assert "closed" in str(e)
        assert _time.monotonic() - t0 < 5
    finally:
        release.set()


def test_timed_out_requests_are_cancelled(tiny_model):
    """Futures the client gave up on are cancelled and skipped at drain
    time — the device never dispatches dead work."""
    from concurrent.futures import TimeoutError as FuturesTimeout

    cfg, vocab, params = tiny_model
    store = _make_store(cfg)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                        max_words=6, decode_batch=4,
                        compute_dtype=jnp.float32,
                        request_timeout_s=0.0)   # give up immediately
    try:
        with pytest.raises(FuturesTimeout):
            svc.caption_ids([100, 101])
        # wait for the dispatcher to see (and drop) the cancelled items
        time.sleep(0.3)
        svc.request_timeout_s = 60.0
        out = svc.caption_ids([100])             # service still healthy
        assert len(out) == 1
    finally:
        svc.close()


def test_service_bf16_table_matches_f32_fed_search(tiny_model):
    """bf16 compute: the bf16-resident table (halved upload + HBM) is
    token-identical to feeding f32 rows into the same bf16 search —
    the search's first use of features is the cast to compute_dtype."""
    cfg, vocab, params = tiny_model
    store = _make_store(cfg)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                         max_words=8, decode_batch=4,
                         compute_dtype=jnp.bfloat16)
    try:
        svc.warmup()
        assert svc._table.dtype == jnp.bfloat16
        ids = store.ids()[:6]
        served = svc.caption_ids(ids)
        feats = jnp.asarray(np.stack([store.get(i) for i in ids]))
        tokens, _ = beam_search(params, feats, beam_width=2, max_words=8,
                                compute_dtype=jnp.bfloat16)
        offline = [caption_to_line(np.asarray(tokens)[i], vocab)
                   for i in range(len(ids))]
        assert served == offline
    finally:
        svc.close()


def test_make_caption_service_from_cli_args(tiny_model, tmp_path):
    """The serve command's service factory (everything cmd_serve does
    before binding a port): checkpoint + flags -> a working service,
    --mesh N -> an (N, 1) data mesh with token-exact captions, and a
    clear refusal when neither features nor an encoder is given."""
    from lrcn_jax import cli
    from lrcn_jax.train.checkpoint import save_checkpoint

    cfg, vocab, params = tiny_model
    store = _make_store(cfg)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, params, vocab, cfg)
    feats_dir = str(tmp_path / "feats")
    store.save(feats_dir)

    common = ["serve", "--loadfile", ckpt, "--features", feats_dir,
              "--beam_width", "2", "--generate", "8",
              "--decode-batch", "8", "--compute-dtype", "float32"]
    svc = cli.make_caption_service(cli.build_parser().parse_args(common))
    try:
        base = svc.caption_ids([100, 101])
        assert len(base) == 2 and all(isinstance(c, str) for c in base)
    finally:
        svc.close()

    svc_mesh = cli.make_caption_service(
        cli.build_parser().parse_args(common + ["--mesh", "4"]))
    try:
        assert svc_mesh.mesh.devices.shape == (4, 1)
        assert svc_mesh.caption_ids([100, 101]) == base
    finally:
        svc_mesh.close()

    with pytest.raises(SystemExit, match="caption by"):
        cli.make_caption_service(
            cli.build_parser().parse_args(["serve", "--loadfile", ckpt]))
