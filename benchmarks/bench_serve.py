"""Online serving throughput/latency at reference model scale.

Hammers ``CaptionService`` with concurrent client threads (each sending
one-image requests, the worst case for batching) and reports served
captions/s plus latency percentiles at several offered concurrencies.
The offline ceiling is the per-batch beam dispatch at B=256 — serving
pays queueing + padding on top; the gap to the scanned offline flagship
is the price of request-level latency.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.models import lrcn
from lrcn_jax.data.feature_store import FeatureStore
from lrcn_jax.serve import CaptionService

cfg = LRCNConfig(hidden=(1000, 1000), embed=1000, vocab_size=8800)
vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
params = jax.device_put(lrcn.init_params(jax.random.PRNGKey(0), cfg))
rng = np.random.default_rng(0)
pool = rng.standard_normal((512, cfg.cnn_feature_dim)).astype(np.float32)
store = FeatureStore.from_dict(
    {i: np.abs(pool[i]) / np.abs(pool[i]).sum() for i in range(512)},
    normalized=True)

import sys
wait_ms = float(sys.argv[1]) if len(sys.argv) > 1 else 10.0
by_id = "--features" not in sys.argv   # default: production id path
svc = CaptionService(cfg, params, vocab, store=store, beam_width=3,
                    max_words=20, decode_batch=256, max_wait_ms=wait_ms)
svc.warmup()
print(f"max_wait_ms={wait_ms} path={'id (HBM-resident table)' if by_id else 'features (uploaded rows)'}")

for n_clients, per_client in [(32, 20), (128, 10), (256, 8), (512, 4)]:
    stage = "decode_ids" if by_id else "decode"
    base = dict(svc.stats()[stage])
    lat: list[float] = []
    lock = threading.Lock()

    def client(i):
        for r in range(per_client):
            t0 = time.perf_counter()
            if by_id:
                svc.caption_ids([(i * 7 + r) % 512])
            else:
                svc.caption_features([pool[(i * 7 + r) % len(pool)]])
            dt = (time.perf_counter() - t0) * 1e3
            with lock:
                lat.append(dt)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    n = n_clients * per_client
    lat.sort()
    s = svc.stats()[stage]
    batches = s["batches"] - base["batches"]
    print(f"{n_clients:4d} clients: {n / wall:8,.0f} captions/s  "
          f"p50={lat[len(lat) // 2]:.0f}ms "
          f"p99={lat[int(0.99 * len(lat))]:.0f}ms  "
          f"mean_batch={n / max(batches, 1):.1f}")

svc.close()
