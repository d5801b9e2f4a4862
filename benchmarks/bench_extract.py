"""END-TO-END feature extraction throughput: disk JPEG -> fc7 store.

bench_vgg.py times the pure-device forward (random tensors already in
device memory).  The real pipeline includes host JPEG decode/resize/crop, the
host->device transfer, and periodic atomic store snapshots.  This
bench measures that whole path (reference counterpart: the per-image
interpreter loop, lrcn.jl:190-221) and separates the host-decode
roofline so the gap is attributable.

Method: write N synthetic JPEGs at COCO-typical sizes, then
1. host-decode roofline: native threaded loader over all files;
2. end-to-end: ``extract_features`` (native loader + decode/compute
   overlap + flush cadence), timed on its second run so compilation
   is excluded.

Usage: python benchmarks/bench_extract.py [--n 2048] [--batch 256]
           [--scan-depth 8] [--tiny]
"""

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np


def make_corpus(root: str, n: int) -> dict[int, str]:
    """N synthetic JPEGs at COCO-typical sizes (most val2014 images are
    640x480-ish); content is random noise — decode cost is size-driven,
    not content-driven."""
    from PIL import Image

    rng = np.random.default_rng(0)
    sizes = [(640, 480), (480, 640), (640, 427), (500, 375), (640, 640)]
    paths = {}
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        p = os.path.join(root, f"COCO_val2014_{i:012d}.jpg")
        Image.fromarray(img).save(p, quality=90)
        paths[i] = p
    return paths


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--scan-depth", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="width-scaled VGG (CPU smoke test)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lrcn_jax.data.images import extract_features, load_batch_native
    from lrcn_jax.models import vgg

    root = tempfile.mkdtemp(prefix="lrcn_bench_extract_")
    try:
        t0 = time.perf_counter()
        paths = make_corpus(root, args.n)
        print(f"corpus: {args.n} JPEGs in {time.perf_counter()-t0:.1f}s "
              f"({sum(os.path.getsize(p) for p in paths.values())/2**20:.0f}"
              f" MiB)")

        # 1) host-decode roofline: the threaded native loader alone
        plist = list(paths.values())
        load_batch_native(plist[:args.batch])          # thread-pool warm
        t0 = time.perf_counter()
        for s in range(0, len(plist), args.batch):
            load_batch_native(plist[s:s + args.batch])
        host_dt = time.perf_counter() - t0
        host_rate = args.n / host_dt
        print(f"host decode roofline: {host_rate:,.0f} images/s "
              f"({host_dt:.1f}s, native threaded loader)")

        if args.tiny:
            params = vgg.init_vgg_params(jax.random.PRNGKey(0),
                                         width_multiplier=0.05, fc_dim=24)
        else:
            params = vgg.init_vgg_params(jax.random.PRNGKey(0))
        params = jax.device_put(params)
        avg = np.full((224, 224, 3), 120.0, np.float32)
        ckpt = os.path.join(root, "store")

        # 2) end-to-end, second run (first run pays compilation)
        for run in ("warm", "timed"):
            shutil.rmtree(ckpt, ignore_errors=True)
            t0 = time.perf_counter()
            store = extract_features(
                paths, params, avg, batch_size=args.batch,
                scan_depth=args.scan_depth, checkpoint_dir=ckpt,
                flush_every=8, compute_dtype=jnp.bfloat16)
            dt = time.perf_counter() - t0
            assert len(store) == args.n
            rate = args.n / dt
            print(f"end-to-end ({run}): {rate:,.0f} images/s ({dt:.1f}s, "
                  f"batch {args.batch} x scan {args.scan_depth}, "
                  f"flush every 8 groups)")
        print(json.dumps({
            "metric": "extract_e2e_images_per_s", "value": round(rate, 1),
            "host_decode_images_per_s": round(host_rate, 1),
            "n_images": args.n, "batch": args.batch,
            "scan_depth": args.scan_depth}))
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
