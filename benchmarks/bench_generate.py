"""End-to-end `lrcn generate` throughput: feature store -> caption lines.

The flagship decode bench (bench.py) times the pure device program over
pre-staged features.  This measures the PRODUCTION bulk path
(`decode/writer.py:generate_captions`): host feed (resident int32 row
indices vs host-gathered float rows), scanned dispatches, pipelined
device->host token copies, vectorized detokenization, and line
building — i.e. what `lrcn generate` actually delivers per wall-second.

Usage:  python benchmarks/bench_generate.py [--n 8192] [--beam 3]

Reference scope: generation is lrcn.jl:127-160 (batch-1 host loop).
"""

import argparse
import json
import time

import jax
import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data.feature_store import FeatureStore
from lrcn_jax.decode.writer import generate_captions
from lrcn_jax.models import lrcn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--beam", type=int, default=3)
    ap.add_argument("--max-words", type=int, default=20)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--scan-depth", type=int, default=16)
    args = ap.parse_args()

    cfg = LRCNConfig(hidden=(1000, 1000), embed=1000, vocab_size=8800)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = jax.device_put(lrcn.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    feats = np.abs(rng.standard_normal(
        (args.n, cfg.cnn_feature_dim))).astype(np.float32)
    feats /= feats.sum(-1, keepdims=True)
    store = FeatureStore.from_dict(
        {i: feats[i] for i in range(args.n)}, normalized=True)
    ids = list(range(args.n))

    results = []
    for resident in (True, False):
        kw = dict(beam_width=args.beam, max_words=args.max_words,
                  batch_size=args.batch, scan_depth=args.scan_depth,
                  resident_store=resident)
        lines = generate_captions(params, vocab, store, ids[:512], **kw)
        assert len(lines) == 512          # compile + warm
        t0 = time.perf_counter()
        lines = generate_captions(params, vocab, store, ids, **kw)
        dt = time.perf_counter() - t0
        assert len(lines) == args.n
        r = {"path": "resident" if resident else "host-gather",
             "captions_per_s": round(args.n / dt, 1),
             "wall_s": round(dt, 3), "n": args.n,
             "geometry": f"{args.batch}x{args.scan_depth}",
             "beam": args.beam}
        print(json.dumps(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
