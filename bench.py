"""North-star benchmarks on one GPU, printed as JSON lines.

Default: prints ONE JSON line — the flagship beam-3 caption decoding
throughput.  ``--all`` additionally runs the other two BASELINE.json
north stars (VGG fc7 images/s, training words/s) and prints one JSON
line per metric.  Every line carries the device it ran on; the script
refuses to run without a GPU.

The reference decodes batch-1 with a host-looped recursive beam search
(lrcn.jl:644-678) — per-step GPU->host probability readbacks and a
full-vocab host sort.  Our decode is one on-device ``lax.scan`` over a
batch of images (lrcn_jax/decode/beam.py).  The reference extracts fc7
per image through an interpreter walk (lrcn.jl:190-221); ours scans
batches of 256 through one jitted dispatch (models/vgg.py).

Timed regions end in ``jax.block_until_ready``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.utils.compile_cache import enable_compile_cache


def bench_decode() -> dict:
    """Flagship: beam-3 caption generation throughput.

    Measures the production path (``decode/writer.py``): groups of 16
    batches of 256 images decode inside one scanned dispatch
    (``beam_search_scan``, writer ``--scan-depth``).
    """
    from lrcn_jax.decode.beam import beam_search_scan
    from lrcn_jax.models import lrcn

    cfg = LRCNConfig(hidden=(1000, 1000), embed=1000, vocab_size=8800)
    params = jax.device_put(lrcn.init_params(jax.random.PRNGKey(0), cfg))

    groups, batch, beam, max_words = 16, 256, 3, 20
    rng = np.random.default_rng(0)
    feats = jnp.asarray(
        rng.standard_normal((groups, batch, cfg.cnn_feature_dim)),
        jnp.float32)
    feats = feats / jnp.sum(jnp.abs(feats), axis=-1, keepdims=True)

    run = lambda f: beam_search_scan(params, f, beam_width=beam,
                                     max_words=max_words)
    jax.block_until_ready(run(feats))  # compile + warm up

    n_iters = 4
    t0 = time.perf_counter()
    outs = [run(feats) for _ in range(n_iters)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0

    captions_per_sec = n_iters * groups * batch / dt
    return {
        "metric": "beam3_captions_per_sec_per_chip",
        "value": round(captions_per_sec, 1),
        "unit": "captions/s",
    }


def bench_vgg() -> dict:
    """VGG-16 fc7 feature extraction throughput (wall clock).

    One scanned dispatch of 16x256 images (models/vgg.py:vgg16_fc7_scan);
    the scan amortizes the per-dispatch host overhead a per-batch loop
    pays.
    """
    from lrcn_jax.models import vgg

    params = jax.device_put(vgg.init_vgg_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    k, b = 16, 256
    stacked = jnp.asarray(
        rng.standard_normal((k, b, 224, 224, 3)), jnp.bfloat16)

    run = jax.jit(lambda p, x: vgg.vgg16_fc7_scan(p, x).sum())
    jax.block_until_ready(run(params, stacked))  # compile + warm up

    n_iters = 3
    t0 = time.perf_counter()
    outs = [run(params, stacked) for _ in range(n_iters)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0

    images_per_sec = n_iters * k * b / dt
    return {
        "metric": "vgg16_fc7_images_per_sec_per_chip",
        "value": round(images_per_sec, 1),
        "unit": "images/s",
    }


def bench_train() -> dict:
    """Decoder training throughput in words/s (reference: slide 7).

    Measures 8 optimizer steps per dispatch
    (``Trainer(steps_per_dispatch=8)``'s scanned program) with the fc7
    feature table resident in device memory and gathered by row index on
    device.
    """
    from lrcn_jax.core.vocab import Vocab
    from lrcn_jax.models import lrcn
    from lrcn_jax.train.metrics import MetricsLogger
    from lrcn_jax.train.trainer import Trainer

    cfg = LRCNConfig(hidden=(1000, 1000), embed=1000, vocab_size=8800,
                     dropout=0.4)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False),
                      steps_per_dispatch=8)
    params = jax.device_put(lrcn.init_params(jax.random.PRNGKey(0), cfg))
    opt_state = trainer.opt.init(params)

    k, b, length = 8, 256, 20
    rng = np.random.default_rng(0)
    table = jnp.asarray(
        rng.standard_normal((10_000, cfg.cnn_feature_dim)), jnp.float32)
    tokens_k = jnp.asarray(
        rng.integers(3, cfg.vocab_size, (k, b, length)), jnp.int32)
    lengths_k = jnp.asarray(rng.integers(10, length + 1, (k, b)), jnp.int32)
    rows_k = jnp.asarray(rng.integers(0, 10_000, (k, b)), jnp.int32)

    key = jax.random.PRNGKey(1)
    params, opt_state, losses = trainer._multi_step(
        params, opt_state, tokens_k, lengths_k, rows_k, table, key,
        np.int32(0))
    jax.block_until_ready(losses)  # compile + warm up

    n_iters = 5
    words = int(jnp.sum(lengths_k)) * n_iters
    t0 = time.perf_counter()
    for i in range(n_iters):
        params, opt_state, losses = trainer._multi_step(
            params, opt_state, tokens_k, lengths_k, rows_k, table, key,
            np.int32(k * (i + 1)))
    jax.block_until_ready((params, losses))
    dt = time.perf_counter() - t0

    words_per_sec = words / dt
    return {
        "metric": "train_words_per_sec_per_chip",
        "value": round(words_per_sec, 1),
        "unit": "words/s",
    }


BENCHES = {"decode": bench_decode, "vgg": bench_vgg, "train": bench_train}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--all", action="store_true",
                        help="run every north-star metric (3 JSON lines)")
    parser.add_argument("--metric", choices=sorted(BENCHES),
                        help="run a single named metric")
    args = parser.parse_args(argv)
    enable_compile_cache()
    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {device.platform!r}")
    stamp = {"platform": device.platform, "device_kind": device.device_kind,
             "device_count": len(jax.devices())}
    if args.metric:
        names = [args.metric]
    elif args.all:
        names = ["decode", "vgg", "train"]
    else:
        names = ["decode"]
    for name in names:
        print(json.dumps({**BENCHES[name](), **stamp}), flush=True)


if __name__ == "__main__":
    main()
