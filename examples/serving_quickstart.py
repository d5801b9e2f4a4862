"""Online serving quickstart: library-level API, synthetic model.

Builds a tiny decoder + feature store, starts the caption service with
dynamic batching, serves a few requests over HTTP (Python front-end),
and prints the per-stage batching stats.  Runs anywhere (CPU included):

    python examples/serving_quickstart.py

Production equivalents: `lrcn serve --loadfile ckpt/ --features feats/`
(same endpoints), `--native-frontend` for the C++ front-end, `--mesh N`
for batch-sharded multi-chip serving.
"""
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data.feature_store import FeatureStore
from lrcn_jax.models import lrcn
from lrcn_jax.serve import CaptionService, make_server


def main():
    # a tiny untrained model — captions will be gibberish, the point is
    # the serving machinery (swap in load_checkpoint for a real one)
    cfg = LRCNConfig(hidden=(32, 32), embed=24, vocab_size=50,
                     cnn_feature_dim=16)
    vocab = Vocab([f"word{i}" for i in range(cfg.vocab_size - 3)])
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)

    rng = np.random.default_rng(0)
    feats = {i: np.abs(rng.standard_normal(cfg.cnn_feature_dim))
             .astype(np.float32) for i in range(20)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)

    service = CaptionService(cfg, params, vocab, store=store,
                            beam_width=3, max_words=10, decode_batch=8,
                            max_wait_ms=20.0,
                            compute_dtype=jnp.float32)
    service.warmup()                       # compile before traffic
    server = make_server(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"serving on 127.0.0.1:{port}")

    def request(path, body=None, method=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request(method or ("POST" if body else "GET"), path,
                     body=json.dumps(body) if body else None)
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
        return out

    print("healthz:", request("/healthz"))
    # concurrent single-id requests coalesce into one padded dispatch
    results = {}
    threads = [threading.Thread(
        target=lambda i=i: results.update(
            {i: request("/v1/caption", {"id": i % 20})["captions"][0]}))
        for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print("16 concurrent captions, e.g.:", results[0])
    print("stats:", json.dumps(request("/stats"), indent=2))

    server.shutdown()
    server.server_close()
    service.close()


if __name__ == "__main__":
    main()
