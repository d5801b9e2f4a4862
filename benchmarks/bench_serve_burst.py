"""Burst drain rate A/B: per-batch dispatch vs ONE grouped scanned
dispatch, for every serving path that absorbs backlogs.

The native pump, the Python DynamicBatcher id path and mesh serving all
drain backlogs in grouped dispatches; this bench runs the A/B for each:

1. raw path: G*B table-row decodes issued per-batch (pipelined
   issue/finalize) vs one ``_decode_rows_grouped`` dispatch;
2. batcher path: G*B ids submitted concurrently through the
   DynamicBatcher (which now coalesces them into grouped dispatches);
3. mesh path: same as (1) under a jax.sharding.Mesh (single chip ->
   (1,1) mesh exercises the sharded program; multi-chip shards rows
   along 'data').

Usage: python benchmarks/bench_serve_burst.py [--tiny] [--mesh]
"""

import argparse
import time

import numpy as np


def build(tiny, mesh_shape=None):
    import jax
    import jax.numpy as jnp

    from lrcn_jax.config import LRCNConfig
    from lrcn_jax.core.vocab import Vocab
    from lrcn_jax.data.feature_store import FeatureStore
    from lrcn_jax.models import lrcn
    from lrcn_jax.serve import CaptionService

    if tiny:
        cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                         cnn_feature_dim=8, compute_dtype="float32")
    else:
        cfg = LRCNConfig(hidden=(1000, 1000), embed=1000, vocab_size=8800)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = jax.device_put(lrcn.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    feats = {i: np.abs(rng.standard_normal(cfg.cnn_feature_dim))
             .astype(np.float32) for i in range(1024)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    mesh = None
    if mesh_shape:
        from lrcn_jax.parallel.mesh import make_mesh
        mesh = make_mesh(mesh_shape)
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=3,
                         max_words=20,
                         decode_batch=64 if tiny else 256,
                         compute_dtype=jnp.float32 if tiny else
                         jnp.bfloat16,
                         mesh=mesh, max_wait_ms=10.0)
    print("warmup (compiling serving programs)...", flush=True)
    svc.warmup()
    print("warmup done", flush=True)
    return svc


def drain_per_batch(svc, rows):
    """Pipelined per-batch issue/finalize (the pre-round-4 drain)."""
    b = svc.decode_batch
    raws = [svc._decode_rows_fn(rows[s:s + b])
            for s in range(0, len(rows), b)]
    return [c for raw in raws for c in svc._decode_finalize(raw)]


def drain_grouped(svc, rows):
    return svc._decode_finalize(svc._decode_rows_grouped(rows))


def drain_feats_per_batch(svc, feats):
    """Per-batch raw-feature dispatch (the pre-round-4 feature drain)."""
    b = svc.decode_batch
    raws = [svc._decode_fn(list(feats[s:s + b]))
            for s in range(0, len(feats), b)]
    return [c for raw in raws for c in svc._decode_finalize(raw)]


def drain_feats_grouped(svc, feats):
    return svc._decode_finalize(
        svc._decode_feats_grouped(feats, normalized=True))


def timeit(fn, n=5):
    fn()                     # warm (compiled already by warmup)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    dt = (time.perf_counter() - t0) / n
    return out, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="run the mesh code path (single chip: (1,1))")
    args = ap.parse_args()

    svc = build(args.tiny, mesh_shape=(1, 1) if args.mesh else None)
    g = svc.MAX_DECODE_GROUPS
    b = svc.decode_batch
    rows = [int(r) for r in
            svc.store.rows([i % 1024 for i in range(g * b)])]
    label = "mesh (1,1)" if args.mesh else "single-device"

    out_a, dt_a = timeit(lambda: drain_per_batch(svc, rows))
    out_b, dt_b = timeit(lambda: drain_grouped(svc, rows))
    assert out_a == out_b, "grouped drain must be token-exact"
    n = len(rows)
    print(f"{label}: backlog of {g}x{b} rows")
    print(f"  per-batch drain: {n/dt_a:>9,.0f} captions/s "
          f"({dt_a*1e3:.1f} ms)")
    print(f"  grouped drain:   {n/dt_b:>9,.0f} captions/s "
          f"({dt_b*1e3:.1f} ms)  ({dt_a/dt_b:.2f}x)")

    # end-to-end through the DynamicBatcher (request threads -> coalesce
    # -> grouped dispatch -> fan out)
    ids = [i % 1024 for i in range(n)]
    svc.caption_ids(ids[:b])          # warm the submit path
    t0 = time.perf_counter()
    for _ in range(5):
        svc.caption_ids(ids)
    dt = (time.perf_counter() - t0) / 5
    print(f"  batcher submit path ({n} ids/burst): {n/dt:>9,.0f} "
          f"captions/s ({dt*1e3:.1f} ms)")

    # raw-feature path (uploads fc7 rows instead of table indices —
    # external-encoder deployments; the grouped fn also backs the
    # Python decode batcher since round 4)
    feats_arr = np.stack([svc.store.get(i % 1024) for i in range(n)])
    svc._decode_finalize(         # warm the grouped feats shape
        svc._decode_feats_grouped(feats_arr, normalized=True))
    out_a, dt_a = timeit(lambda: drain_feats_per_batch(svc, feats_arr))
    out_b, dt_b = timeit(lambda: drain_feats_grouped(svc, feats_arr))
    assert out_a == out_b, "grouped feats drain must be token-exact"
    print(f"  feats per-batch drain: {n/dt_a:>9,.0f} captions/s "
          f"({dt_a*1e3:.1f} ms)")
    print(f"  feats grouped drain:   {n/dt_b:>9,.0f} captions/s "
          f"({dt_b*1e3:.1f} ms)  ({dt_a/dt_b:.2f}x)")
    svc.caption_features(list(feats_arr[:b]))    # warm the submit path
    t0 = time.perf_counter()
    for _ in range(5):
        svc.caption_features(list(feats_arr))
    dt = (time.perf_counter() - t0) / 5
    print(f"  feats batcher submit path ({n} rows/burst): "
          f"{n/dt:>9,.0f} captions/s ({dt*1e3:.1f} ms)")
    svc.close()


if __name__ == "__main__":
    main()
