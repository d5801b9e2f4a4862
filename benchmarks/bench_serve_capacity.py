"""TRUE serving capacity: C++ closed-loop load generator vs the server.

Python client processes bottleneck on their own GIL, so HTTP numbers
made with them are lower bounds with unknown slack.  This benchmark uses
``native/loadgen.cpp`` (one C++ thread per connection, keep-alive, no
interpreter anywhere in the client) and sweeps concurrency until the throughput knee, so the
committed number is the SERVER's saturation point.

For each concurrency point it records the loadgen's JSON (throughput,
p50/p90/p99, client CPU seconds) and asserts the client stayed
un-bottlenecked: client CPU utilization = (user+sys)/(wall*ncores)
must be < 0.8 or the point is flagged.

Usage:
  python benchmarks/bench_serve_capacity.py [native|python|both]
      [--duration 10] [--sweep 32,64,128,256,512] [--ids-per-req 1]
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np


def build_service(tiny=False, burst_groups=None, mesh_n=None,
                  with_encoder=False, encode_batch=8):
    import jax

    from lrcn_jax.config import LRCNConfig
    from lrcn_jax.core.vocab import Vocab
    from lrcn_jax.data.feature_store import FeatureStore
    from lrcn_jax.models import lrcn
    from lrcn_jax.serve import CaptionService

    if tiny:      # CPU smoke-test geometry, not a benchmark config
        cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                         cnn_feature_dim=8, compute_dtype="float32")
    else:
        cfg = LRCNConfig(hidden=(1000, 1000), embed=1000, vocab_size=8800)
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = jax.device_put(lrcn.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    feats = {i: np.abs(rng.standard_normal(cfg.cnn_feature_dim))
             .astype(np.float32) for i in range(512)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    import jax.numpy as jnp
    mesh = None
    if mesh_n:
        from lrcn_jax.parallel import make_mesh
        mesh = make_mesh((mesh_n, 1))
    vgg_params = None
    if with_encoder:   # the image endpoint: full VGG-16 geometry unless
        #                tiny (random weights — identical FLOPs/bytes)
        from lrcn_jax.models import vgg as vgg_mod
        vgg_params = vgg_mod.init_vgg_params(
            jax.random.PRNGKey(1),
            **({"width_multiplier": 0.05, "fc_dim": cfg.cnn_feature_dim}
               if tiny else {}))
    svc = CaptionService(cfg, params, vocab, store=store, beam_width=3,
                         max_words=8 if tiny else 20,
                         decode_batch=32 if tiny else 256,
                         encode_batch=encode_batch,
                         vgg_params=vgg_params,
                         compute_dtype=jnp.float32 if tiny else jnp.bfloat16,
                         max_wait_ms=10.0, max_burst_groups=burst_groups,
                         mesh=mesh)
    svc.warmup()
    return svc


def run_loadgen(exe, port, conns, duration, max_id=512, ids_per_req=1,
                rate_rps=0.0, feat_dim=0, img_path=None):
    """Run one loadgen point; also meter THIS process's CPU (the server
    lives in-process: Python pump + C++ connection threads), so each
    point reports how much of the knee is host CPU rather than device.
    """
    import resource

    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.monotonic()
    # timeout must outlive the loadgen's own worst case: open-loop
    # grace watchdog (duration+120s) + a worker blocked in a 60s
    # SO_RCVTIMEO recv when it fires — killing the child earlier loses
    # the JSON for every prior point exactly when the server stalls
    out = subprocess.run(
        [exe, "127.0.0.1", str(port), str(conns), str(duration),
         str(max_id), str(ids_per_req), str(rate_rps), str(feat_dim),
         img_path or ""],
        capture_output=True, text=True, timeout=duration + 240)
    wall = time.monotonic() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    if out.returncode != 0:
        raise RuntimeError(f"loadgen failed: {out.stderr[-500:]}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    server_cpu = ((ru1.ru_utime - ru0.ru_utime) +
                  (ru1.ru_stime - ru0.ru_stime))
    r["server_cpu_util"] = server_cpu / (wall * (os.cpu_count() or 1))
    return r


def start_loadgen(exe, port, conns, duration, max_id=512, ids_per_req=1,
                  rate_rps=0.0, feat_dim=0, img_path=None):
    """Non-blocking loadgen launch — the mixed-traffic soak runs one
    generator per request type simultaneously."""
    return subprocess.Popen(
        [exe, "127.0.0.1", str(port), str(conns), str(duration),
         str(max_id), str(ids_per_req), str(rate_rps), str(feat_dim),
         img_path or ""],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_loadgen(proc, duration):
    out, err = proc.communicate(timeout=duration + 240)
    if proc.returncode != 0:
        raise RuntimeError(f"loadgen failed: {err[-500:]}")
    return json.loads(out.strip().splitlines()[-1])


def rate_sweep(exe, port, name, rate_list, conns, duration, ids_per_req,
               feat_dim=0, img_path=None):
    """OPEN-LOOP latency-vs-load: fixed offered rates, latency measured
    from each request's scheduled time (wrk2-style — queueing delay on
    an overloaded server grows the tail instead of silently shedding
    offered load)."""
    ncores = os.cpu_count() or 1
    print(f"\n=== {name} frontend: OPEN-LOOP, {conns} conns, "
          f"{duration}s per point, ids_per_req={ids_per_req} ===")
    print(f"{'offered/s':>10} {'achieved/s':>11} {'p50 ms':>8} "
          f"{'p90 ms':>8} {'p99 ms':>8} {'errors':>7} {'cli CPU':>8} "
          f"{'srv CPU':>8}")
    results = []
    run_loadgen(exe, port, 8, 2, ids_per_req=ids_per_req,
                feat_dim=feat_dim, img_path=img_path)   # warm
    for rate in rate_list:
        r = run_loadgen(exe, port, conns, duration,
                        ids_per_req=ids_per_req,
                        rate_rps=rate / ids_per_req, feat_dim=feat_dim,
                        img_path=img_path)
        util = (r["cpu_user_s"] + r["cpu_sys_s"]) / (r["wall_s"] * ncores)
        flag = "  <-- client-bound!" if util >= 0.8 else ""
        if util + r["server_cpu_util"] >= 0.9:
            flag += "  <-- host-bound (client+server share the cores)"
        # every scheduled slot fires (late if need be), so overload
        # shows as schedule-relative latency + a drain tail past the
        # schedule window, never as silently shed offered load.
        # achieved counts over the FULL wall (drain included): an
        # over-capacity point reads the server's true sustained rate,
        # not the offered rate it merely queued
        achieved = r["captions"] / r["wall_s"]
        if r.get("completion", 1.0) < 0.99:
            flag += (f"  <-- {1 - r['completion']:.1%} of scheduled "
                     f"requests errored/abandoned")
        if r["wall_s"] > r.get("sched_s", r["wall_s"]) * 1.5:
            flag += "  <-- overloaded (drain ran far past the schedule)"
        print(f"{rate:>10,} {achieved:>11,.0f} {r['p50_ms']:>8.1f} "
              f"{r['p90_ms']:>8.1f} {r['p99_ms']:>8.1f} "
              f"{r['errors']:>7} {util:>7.0%} "
              f"{r['server_cpu_util']:>7.0%}{flag}")
        r.update(conns=conns, client_util=util, offered_captions_s=rate)
        results.append(r)
    return results


def sweep(exe, port, name, conns_list, duration, ids_per_req, stats_fn,
          feat_dim=0, img_path=None):
    ncores = os.cpu_count() or 1
    kind = ("base64 images" if img_path
            else f"features[{feat_dim}]" if feat_dim else "ids")
    print(f"\n=== {name} frontend: closed-loop C++ clients, "
          f"{duration}s per point, {kind}, per_req={ids_per_req} ===")
    print(f"{'conns':>6} {'captions/s':>12} {'p50 ms':>8} {'p90 ms':>8} "
          f"{'p99 ms':>8} {'errors':>7} {'cli CPU':>8} {'srv CPU':>8}")
    best = None
    results = []
    run_loadgen(exe, port, 8, 2, ids_per_req=ids_per_req,
                feat_dim=feat_dim, img_path=img_path)   # warm
    for conns in conns_list:
        before = stats_fn()
        r = run_loadgen(exe, port, conns, duration,
                        ids_per_req=ids_per_req, feat_dim=feat_dim,
                        img_path=img_path)
        after = stats_fn()
        util = (r["cpu_user_s"] + r["cpu_sys_s"]) / (r["wall_s"] * ncores)
        # native /stats exports 'items' ('img_items' for the image
        # path); the Python batcher snapshot calls it 'requests'
        key = "img_items" if img_path else "items"
        served = (after.get(key, after.get("requests", 0))
                  - before.get(key, before.get("requests", 0)))
        server_rate = served / r["wall_s"] if served else None
        pump_d = after.get("pump_cpu_s", 0.0) - before.get("pump_cpu_s",
                                                           0.0)
        if served and pump_d:
            r["pump_us_per_item"] = pump_d / served * 1e6
        flag = "  <-- client-bound!" if util >= 0.8 else ""
        if util + r["server_cpu_util"] >= 0.9:
            flag += "  <-- host-bound (client+server share the cores)"
        print(f"{conns:>6} {r['captions_per_s']:>12,.0f} "
              f"{r['p50_ms']:>8.1f} {r['p90_ms']:>8.1f} "
              f"{r['p99_ms']:>8.1f} {r['errors']:>7} {util:>7.0%} "
              f"{r['server_cpu_util']:>7.0%}{flag}")
        r.update(conns=conns, client_util=util,
                 server_side_rate=server_rate)
        results.append(r)
        if best is None or r["captions_per_s"] > best["captions_per_s"]:
            best = r
    knee = best["conns"]
    print(f"\n{name}: peak {best['captions_per_s']:,.0f} captions/s at "
          f"{knee} connections (p50 {best['p50_ms']:.0f}ms, "
          f"p99 {best['p99_ms']:.0f}ms, client CPU "
          f"{best['client_util']:.0%})")
    if best.get("server_side_rate"):
        print(f"{name}: server-side counter rate "
              f"{best['server_side_rate']:,.0f} items/s")
    if best.get("pump_us_per_item"):
        print(f"{name}: pump-thread CPU {best['pump_us_per_item']:.1f} "
              f"us/item at the peak (pump saturates at "
              f"{1e6 / best['pump_us_per_item']:,.0f} items/s)")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="native",
                    choices=["native", "python", "both"])
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--sweep", default="32,64,128,256,512")
    ap.add_argument("--ids-per-req", type=int, default=1)
    ap.add_argument("--rate-sweep", default=None,
                    help="comma-separated OFFERED captions/s: open-loop "
                         "latency-vs-load instead of the closed-loop "
                         "capacity sweep")
    ap.add_argument("--conns", type=int, default=2048,
                    help="connection pool for --rate-sweep (must exceed "
                         "rate x latency so the pool never binds)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model smoke test (CPU CI), not a benchmark")
    ap.add_argument("--burst-groups", type=int, default=None,
                    help="CaptionService max_burst_groups override")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="serve over an (N, 1) device mesh (batch rows "
                         "shard along 'data')")
    ap.add_argument("--features", action="store_true",
                    help="POST raw fc7 feature bodies instead of ids "
                         "(the external-encoder deployment; rows parsed "
                         "in C++, grouped feature drain)")
    ap.add_argument("--image", action="store_true",
                    help="POST base64-image bodies (JPEG decode + VGG "
                         "encode + beam decode — the full live-image "
                         "path, lrcn.jl:595-597 made a service)")
    ap.add_argument("--encode-batch", type=int, default=8,
                    help="VGG encode batch for --image")
    args = ap.parse_args()
    conns_list = [int(c) for c in args.sweep.split(",")]
    rate_list = ([int(r) for r in args.rate_sweep.split(",")]
                 if args.rate_sweep else None)

    from lrcn_jax.native import loadgen_binary

    exe = loadgen_binary()
    if exe is None:
        sys.exit("loadgen unavailable (g++ missing or LRCN_NATIVE=0)")

    svc = build_service(tiny=args.tiny, burst_groups=args.burst_groups,
                        mesh_n=args.mesh, with_encoder=args.image,
                        encode_batch=args.encode_batch)
    feat_dim = svc.cfg.cnn_feature_dim if args.features else 0
    img_path = None
    if args.image:
        # one representative JPEG (COCO-like geometry, photographic
        # high-frequency content so decode cost is realistic)
        import tempfile

        from PIL import Image

        rng = np.random.default_rng(7)
        base = rng.integers(0, 255, (60, 80, 3)).astype(np.uint8)
        img = Image.fromarray(base).resize((640, 480), Image.BILINEAR)
        fd, img_path = tempfile.mkstemp(suffix=".jpg")
        os.close(fd)
        img.save(img_path, format="JPEG", quality=90)
        print(f"image body: 640x480 JPEG, "
              f"{os.path.getsize(img_path)} bytes")
    all_results = {}

    if args.which in ("python", "both"):
        from lrcn_jax.serve import make_server

        server = make_server(svc, host="127.0.0.1", port=0)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        if rate_list:
            all_results["python"] = rate_sweep(
                exe, port, "python", rate_list, args.conns,
                args.duration, args.ids_per_req, feat_dim=feat_dim,
                img_path=img_path)
        else:
            all_results["python"] = sweep(
                exe, port, "python", conns_list, args.duration,
                args.ids_per_req,
                lambda: svc.stats().get(
                    "encode" if img_path
                    else "decode" if feat_dim else "decode_ids", {}),
                feat_dim=feat_dim, img_path=img_path)
        server.shutdown()
        server.server_close()

    if args.which in ("native", "both"):
        from lrcn_jax.serve.native_http import NativeFrontend

        n_conns = args.conns if rate_list else max(conns_list)
        fe = NativeFrontend(svc, host="127.0.0.1", port=0,
                            n_threads=n_conns + 64, wait_ms=10)

        # the pump thread is the serialization point of the id/feature
        # path; meter ITS CPU specifically (pthread CPU clock) so a
        # cost moved from the pump into the parallel C++ connection
        # threads shows up as pump headroom even when total process
        # CPU is unchanged
        pump_clk = time.pthread_getcpuclockid(fe._pump.ident)

        def native_stats():
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                              timeout=30)
            try:
                conn.request("GET", "/stats")
                st = json.loads(conn.getresponse().read())
            finally:
                conn.close()
            st["pump_cpu_s"] = time.clock_gettime(pump_clk)
            return st

        if rate_list:
            all_results["native"] = rate_sweep(
                exe, fe.port, "native", rate_list, args.conns,
                args.duration, args.ids_per_req, feat_dim=feat_dim,
                img_path=img_path)
        else:
            all_results["native"] = sweep(
                exe, fe.port, "native", conns_list, args.duration,
                args.ids_per_req, native_stats, feat_dim=feat_dim,
                img_path=img_path)
        fe.stop()

    svc.close()
    print("\n" + json.dumps(all_results))


if __name__ == "__main__":
    main()
