"""Fuzz BOTH HTTP front-ends.

The native (C++) hand-rolled parser runs in detached threads where any
uncaught path is process-fatal (three such bugs were found by review in
round 3: uncaught stoll/stoul on malformed numbers).  The pure-Python
server rides the stdlib parser but adds its own framing discipline
(keep-alive body drains, HTTP/0.9 refusal, Content-Length validation).
The regression tests replay specific crash payloads; this sweep covers
the input space: mutated request lines, header garbage, hostile
Content-Length values, truncated bodies, pipelined requests, and raw
binary noise — thousands of deterministic-seeded requests against each
live server.

Invariants asserted, identically for both:
- the server survives everything (a /healthz probe passes at the end);
- every byte stream the server sends back parses as HTTP/1.1 with a
  3-digit status code (no half-written, unframed, or desynced
  responses);
- well-formed requests interleaved with the garbage still serve.
"""

import json
import socket
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

N_REQUESTS = 10000
N_CLIENTS = 16
# the Python server burns a GIL-bound thread per connection; a smaller
# deterministic sweep keeps the suite's wall clock sane while covering
# every mutation class (seeds differ per client, classes are uniform)
N_REQUESTS_PY = 3000
N_CLIENTS_PY = 8


def _tiny_service() -> CaptionService:
    from lrcn_jax.models import vgg as vgg_mod

    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    feats = {100 + i: np.abs(rng.standard_normal(
        cfg.cnn_feature_dim)).astype(np.float32) for i in range(12)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    # an encoder too, so the image paths (C++ base64 decode + the
    # image thread) are inside the fuzz surface
    vgg_params = vgg_mod.init_vgg_params(
        jax.random.PRNGKey(1), width_multiplier=0.05,
        fc_dim=cfg.cnn_feature_dim)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=2,
                         max_words=8, decode_batch=8,
                         vgg_params=vgg_params, encode_batch=2,
                         compute_dtype=jnp.float32,
                         request_timeout_s=10.0)
    svc.warmup()
    return svc


@pytest.fixture(scope="module")
def frontend():
    if httpserve_library() is None:
        pytest.skip("native httpserve unavailable")
    from lrcn_jax.serve.native_http import NativeFrontend

    svc = _tiny_service()
    fe = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=64,
                        wait_ms=2)
    yield fe, svc
    fe.stop()
    svc.close()


@pytest.fixture(scope="module")
def python_server():
    from lrcn_jax.serve.http import make_server

    svc = _tiny_service()
    server = make_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1], svc
    server.shutdown()
    svc.close()


VALID = (b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n"
         b"Content-Length: 11\r\n\r\n" + b'{"id": 100}')

METHODS = [b"GET", b"POST", b"PUT", b"HEAD", b"OPTIONS", b"XYZZY", b"",
           b"P\x00ST", b"post"]
PATHS = [b"/v1/caption", b"/healthz", b"/stats", b"/", b"//", b"/%00",
         b"/v1/caption/../../etc/passwd", b"/" + b"a" * 5000, b"*",
         b"/v1/\xff\xfe"]
VERSIONS = [b"HTTP/1.1", b"HTTP/1.0", b"HTTP/9.9", b"HTTP/", b"FTP/1.1",
            b""]
CL_VALUES = [b"11", b"0", b"-1", b"abc", b"0x10", b"999999999999999999999",
             b"18446744073709551617", b"11 11", b" 11", b"+11", b"1e3",
             b"67108865",          # just over the 64 MiB cap
             b"2147483648", b"\xff", b""]
HEADER_NAMES = [b"Content-Length", b"content-length", b"CONTENT-LENGTH",
                b"Content-Length ", b"Content\x00Length", b"X-" + b"h" * 4096,
                b"Transfer-Encoding", b"Connection", b"Expect", b"Host", b""]
HEADER_VALUES = [b"keep-alive", b"close", b"chunked", b"100-continue",
                 b"x" * 8192, b"\r\n", b"\x00\x01\x02", b""]
BODIES = [b'{"id": 100}', b'{"id": -}', b'{"ids": [100,101]}', b"{",
          b"[]", b'{"id": null}', b'{"id": "100"}', b"\x00" * 64,
          b'{"ids": ' + b"[" * 200 + b"]" * 200 + b"}",
          b'{"id": 100, "id": 101}', b'"' + b"a" * 10000 + b'"',
          # hostile feature bodies (the C++ float parser's input space)
          b'{"features": [[0.1, 0.2]]}',                     # wrong dim
          b'{"features": [[0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.8]]}',  # valid
          b'{"features": [[1e400,-1e400,nan,inf,.5,5.,0e0,8]]}',
          b'{"features": ' + b"[" * 300 + b"]" * 300 + b"}",
          b'{"features": [[0.1][0.2]]}', b'{"features": "abc"}',
          b'{"features": [[]]}', b'{"features": [[-,]]}',
          b'{"features": [[0.1e]]}', b'{"features": [}',
          b'{"features": [[' + b"9" * 5000 + b"]]}",
          b'{"features": [' + b"[1,1,1,1,1,1,1,1]," * 100 +
          b"[1,1,1,1,1,1,1,1]]}",
          # hostile image bodies (C++ base64 decoder + image thread)
          b'{"image_b64": "AAAA"}',                 # valid b64, bad jpeg
          b'{"image_b64": "!!!"}', b'{"image_b64": ""}',
          b'{"image_b64": "A"}',                    # leftover sextet
          b'{"image_b64": "A=== "}', b'{"image_b64": 5}',
          b'{"images_b64": []}', b'{"images_b64": ["AAAA", "????"]}',
          b'{"image_b64": "' + b"A" * 20000 + b'"}',
          b'{"image_b64": "' + b"\\x00" * 64 + b'"}']


def _mutate(rng: np.random.Generator) -> tuple[bytes, bool]:
    """One fuzz case -> (payload, close_immediately)."""
    kind = rng.integers(0, 8)
    if kind == 0:              # raw binary noise
        n = int(rng.integers(0, 2000))
        return rng.integers(0, 256, n).astype(np.uint8).tobytes(), False
    if kind == 1:              # valid request with random byte flips
        b = bytearray(VALID)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        return bytes(b), False
    if kind == 2:              # random request line
        line = (METHODS[rng.integers(0, len(METHODS))] + b" " +
                PATHS[rng.integers(0, len(PATHS))] + b" " +
                VERSIONS[rng.integers(0, len(VERSIONS))])
        return line + b"\r\n\r\n", False
    if kind == 3:              # hostile headers
        hdrs = b""
        for _ in range(int(rng.integers(1, 6))):
            hdrs += (HEADER_NAMES[rng.integers(0, len(HEADER_NAMES))] +
                     b": " +
                     HEADER_VALUES[rng.integers(0, len(HEADER_VALUES))] +
                     b"\r\n")
        return b"POST /v1/caption HTTP/1.1\r\n" + hdrs + b"\r\n", False
    if kind == 4:              # hostile Content-Length
        cl = CL_VALUES[rng.integers(0, len(CL_VALUES))]
        body = BODIES[rng.integers(0, len(BODIES))]
        return (b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: " + cl + b"\r\n\r\n" + body), False
    if kind == 5:              # truncated body, then abrupt close
        body = BODIES[rng.integers(0, len(BODIES))]
        claimed = len(body) + int(rng.integers(1, 4096))
        sent = body[:int(rng.integers(0, len(body) + 1))]
        return (b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: " + str(claimed).encode() +
                b"\r\n\r\n" + sent), True
    if kind == 6:              # pipelined: garbage glued after valid
        tail = BODIES[rng.integers(0, len(BODIES))]
        return VALID + VALID + tail, False
    # kind == 7: random body against a correct frame
    body = BODIES[rng.integers(0, len(BODIES))]
    return (b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: " + str(len(body)).encode() +
            b"\r\n\r\n" + body), False


def _probe_health(port) -> None:
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n"
                  b"Connection: close\r\n\r\n")
        out = b""
        s.settimeout(10)
        while b"}" not in out:
            chunk = s.recv(4096)
            if not chunk:
                break
            out += chunk
    finally:
        s.close()
    assert out.startswith(b"HTTP/1.1 200"), out[:100]
    assert b'"ok": true' in out, out[:200]


def _valid_http(stream: bytes) -> bool:
    """Every response the server starts must be well-formed HTTP/1.1."""
    while stream:
        if not stream.startswith(b"HTTP/1.1 "):
            return False
        code = stream[9:12]
        if not (code.isdigit() and len(code) == 3):
            return False
        head_end = stream.find(b"\r\n\r\n")
        if head_end < 0:
            # truncated tail: we stopped reading mid-response, that's
            # the client's doing, not a desync
            return True
        headers = stream[:head_end].lower()
        cl = 0
        for line in headers.split(b"\r\n"):
            if line.startswith(b"content-length:"):
                try:
                    cl = int(line.split(b":", 1)[1])
                except ValueError:
                    return False
        stream = stream[head_end + 4:]
        if len(stream) < cl:
            return True        # short read of the body — client stopped
        stream = stream[cl:]
    return True


def _fuzz_sweep(port: int, n_requests: int, n_clients: int,
                seed_base: int = 1000) -> None:
    """Run the deterministic hostile sweep + the post-sweep liveness
    checks against whatever HTTP server listens on ``port``."""
    failures: list = []
    done = [0] * n_clients

    def client(ci: int) -> None:
        rng = np.random.default_rng(seed_base + ci)
        per = n_requests // n_clients
        for i in range(per):
            payload, close_now = _mutate(rng)
            try:
                s = socket.create_connection(("127.0.0.1", port),
                                             timeout=10)
            except OSError as e:
                failures.append(("connect", ci, i, repr(e)))
                return
            try:
                try:
                    s.sendall(payload)
                except OSError:
                    continue      # server already slammed the door: fine
                if close_now:
                    continue      # abrupt close is the test
                out = b""
                s.settimeout(0.15)
                try:
                    while len(out) < 65536:
                        chunk = s.recv(8192)
                        if not chunk:
                            break
                        out += chunk
                except TimeoutError:
                    pass
                except OSError:
                    pass          # RST after garbage: acceptable
                if out and not _valid_http(out):
                    failures.append(("desync", ci, i, payload[:120],
                                     out[:200]))
            finally:
                try:
                    s.close()
                except OSError:
                    pass
            done[ci] = i + 1

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "fuzz client hung"
    assert not failures, failures[:5]
    assert sum(done) >= n_requests - n_clients  # nobody bailed early

    # the process survived the hostile sweep and still serves
    _probe_health(port)
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v1/caption", body=json.dumps({"id": 100}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        assert resp.status == 200 and len(out["captions"]) == 1
    finally:
        conn.close()


def test_native_http_fuzz(frontend):
    fe, _svc = frontend
    _fuzz_sweep(fe.port, N_REQUESTS, N_CLIENTS)


def test_python_http_fuzz(python_server):
    port, _svc = python_server
    _fuzz_sweep(port, N_REQUESTS_PY, N_CLIENTS_PY, seed_base=2000)
