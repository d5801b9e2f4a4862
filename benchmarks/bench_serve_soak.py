"""Serving soak: sustained open-loop load, leak + stability accounting.

Runs the native front-end under a fixed offered rate for minutes (not
the 10 s capacity points) and reports what long-running production
cares about: error count, latency drift between the first and last
slice, and host-resource growth (RSS, open fds, threads) across the
run — a leaky connection path or an unbounded queue shows up here long
before it kills a deployment.

``--mixed`` soaks all three request types SIMULTANEOUSLY — open-loop
ids at ``--rate``, open-loop features at ``--feat-rate``, and a
closed-loop image client saturating the image thread — and compares
the id path's p99 against an id-only baseline at the same rate: the
image thread and the pump share the Python GIL, so this is the
measurement that catches one path starving another.

Usage:
  python benchmarks/bench_serve_soak.py [--rate 8000] [--duration 300]
      [--conns 2048] [--slices 3] [--mixed] [--feat-rate 200]
"""

import argparse
import json
import os
import sys
import threading


def rss_mb(trim: bool = True) -> float:
    """Current RSS; by default after malloc_trim(0) so glibc's retained
    free arenas (2048 allocating threads fragment heavily) don't read
    as a leak — residual growth after trim is the real signal."""
    if trim:
        import ctypes

        try:
            ctypes.CDLL("libc.so.6").malloc_trim(0)
        except OSError:
            pass
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6


def fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


def run_mixed(args, exe, build_service, run_loadgen, start_loadgen,
              finish_loadgen, NativeFrontend):
    """Mixed-traffic soak: ids (open-loop) + features (open-loop) +
    images (closed-loop, saturating the image thread) at once; the
    verdict compares the id path's p99 against an id-only baseline at
    the identical offered rate."""
    import tempfile

    import numpy as np
    from PIL import Image

    svc = build_service(tiny=args.tiny, with_encoder=True)
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (60, 80, 3)).astype(np.uint8)
    img = Image.fromarray(base).resize((640, 480), Image.BILINEAR)
    fd, img_path = tempfile.mkstemp(suffix=".jpg")
    os.close(fd)
    img.save(img_path, format="JPEG", quality=90)
    feat_dim = svc.cfg.cnn_feature_dim
    # connection capacity must cover ALL three legs at once (ids +
    # features + images) plus slack — undersizing it bounces whole
    # connections off the C++ connection limit for the entire run
    n_threads = (args.conns + max(8, args.conns // 16)
                 + args.img_conns + 64)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0,
                        n_threads=n_threads, wait_ms=10)
    try:
        # warm every path (compile the burst shapes + the VGG encode)
        run_loadgen(exe, fe.port, 8, 2)
        run_loadgen(exe, fe.port, 8, 2, feat_dim=feat_dim)
        run_loadgen(exe, fe.port, 2, 2, img_path=img_path)

        per = args.duration / 2
        baseline = run_loadgen(exe, fe.port, args.conns, per,
                               rate_rps=args.rate)
        print(json.dumps({"phase": "id-only baseline",
                          **{k: baseline[k] for k in
                             ("captions_per_s", "p50_ms", "p99_ms",
                              "errors", "completion")}}), flush=True)

        procs = {
            "ids": start_loadgen(exe, fe.port, args.conns, per,
                                 rate_rps=args.rate),
            "features": start_loadgen(exe, fe.port,
                                      max(8, args.conns // 16), per,
                                      rate_rps=args.feat_rate,
                                      feat_dim=feat_dim),
            # closed loop: as fast as the image thread will go — the
            # starvation stressor, not a rated load
            "images": start_loadgen(exe, fe.port, args.img_conns, per,
                                    img_path=img_path),
        }
        mixed = {k: finish_loadgen(p, per) for k, p in procs.items()}
        for k, r in mixed.items():
            print(json.dumps({"phase": f"mixed:{k}",
                              **{key: r[key] for key in
                                 ("captions_per_s", "p50_ms", "p99_ms",
                                  "errors")}}), flush=True)

        degrade = mixed["ids"]["p99_ms"] / max(baseline["p99_ms"], 1e-9)
        # distinguish STARVATION (goodput holds, latency explodes: the
        # pump or a shared lock is wedging the id path) from OVER-
        # CAPACITY (goodput falls short of offered: the combined load
        # simply exceeds this host+chip, and open-loop latency above
        # capacity grows without bound by definition)
        goodput_ratio = (mixed["ids"]["captions_per_s"]
                         / max(baseline["captions_per_s"], 1e-9))
        out = {"rate": args.rate, "feat_rate": args.feat_rate,
               "img_conns": args.img_conns, "duration_s": args.duration,
               "id_p99_baseline_ms": baseline["p99_ms"],
               "id_p99_mixed_ms": mixed["ids"]["p99_ms"],
               "id_p99_degradation": round(degrade, 3),
               "id_goodput_ratio": round(goodput_ratio, 3),
               "image_captions_per_s": mixed["images"]["captions_per_s"],
               "feature_captions_per_s":
                   mixed["features"]["captions_per_s"],
               "errors": sum(r["errors"] for r in mixed.values())}
        verdict = []
        if out["errors"]:
            verdict.append(f"{out['errors']} errors")
        if degrade > args.p99_bound:
            kind = (("latency interference — goodput holds at "
                     f"{goodput_ratio:.0%}, so this is shared-host CPU "
                     "contention, not a pump wedge")
                    if goodput_ratio >= 0.95 else
                    f"over capacity at this offered rate (id goodput "
                    f"{goodput_ratio:.0%} of baseline)")
            verdict.append(
                f"id p99 degraded {degrade:.2f}x under mixed traffic "
                f"(bound {args.p99_bound}x) — {kind}")
        out["verdict"] = "; ".join(verdict) if verdict else "clean"
        print(json.dumps(out), flush=True)
        return 1 if verdict else 0
    finally:
        fe.stop()
        svc.close()
        os.unlink(img_path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=int, default=8000)
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--conns", type=int, default=2048)
    ap.add_argument("--slices", type=int, default=3,
                    help="split the run into N loadgen slices so "
                         "latency drift across the soak is visible")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mixed", action="store_true",
                    help="ids + features + images simultaneously; "
                         "verdict bounds the id path's p99 degradation")
    ap.add_argument("--feat-rate", type=int, default=200,
                    help="offered feature rows/s in --mixed")
    ap.add_argument("--img-conns", type=int, default=4,
                    help="closed-loop image connections in --mixed")
    ap.add_argument("--p99-bound", type=float, default=4.0,
                    help="max allowed id-p99 multiplier under --mixed. "
                         "Default 4.0 allows for a host with one CPU core, "
                         "where the closed-loop image leg's decode CPU "
                         "time-slices against the id path; on a "
                         "multi-core host the image thread pool has its "
                         "own cores and ~2.0 is the right bound")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench_serve_capacity import (build_service, finish_loadgen,
                                      run_loadgen, start_loadgen)

    from lrcn_jax.native import loadgen_binary
    from lrcn_jax.serve.native_http import NativeFrontend

    exe = loadgen_binary()
    if exe is None:
        sys.exit("loadgen unavailable")
    if args.mixed:
        sys.exit(run_mixed(args, exe, build_service, run_loadgen,
                           start_loadgen, finish_loadgen, NativeFrontend))
    svc = build_service(tiny=args.tiny)
    fe = NativeFrontend(svc, host="127.0.0.1", port=0,
                        n_threads=args.conns + 64, wait_ms=10)
    try:
        run_loadgen(exe, fe.port, 8, 2)            # warm
        before = {"rss_mb": round(rss_mb(), 1), "fds": fd_count(),
                  "threads": threading.active_count()}
        slices = []
        per = args.duration / args.slices
        for i in range(args.slices):
            r = run_loadgen(exe, fe.port, args.conns, per,
                            rate_rps=args.rate)
            slices.append({k: r[k] for k in
                           ("captions_per_s", "p50_ms", "p99_ms",
                            "errors", "reconnects", "completion")})
            # per-slice RSS: a real leak grows linearly with requests;
            # allocator-arena/cache growth plateaus after slice 0
            slices[-1]["rss_mb"] = round(rss_mb(), 1)
            print(json.dumps({"slice": i, **slices[-1]}), flush=True)
        after = {"rss_mb": round(rss_mb(), 1), "fds": fd_count(),
                 "threads": threading.active_count()}
        total_err = sum(s["errors"] for s in slices)
        drift = slices[-1]["p99_ms"] / max(slices[0]["p99_ms"], 1e-9)
        out = {"rate": args.rate, "duration_s": args.duration,
               "conns": args.conns, "errors": total_err,
               "p99_drift": round(drift, 3),
               "before": before, "after": after,
               "rss_growth_mb": round(after["rss_mb"] - before["rss_mb"],
                                      1),
               "fd_growth": after["fds"] - before["fds"]}
        verdict = []
        if total_err:
            verdict.append(f"{total_err} errors")
        if out["fd_growth"] > 32:
            verdict.append(f"fd leak? +{out['fd_growth']}")
        if out["rss_growth_mb"] > 0.1 * before["rss_mb"]:
            verdict.append(f"rss grew {out['rss_growth_mb']} MB")
        if drift > 1.5:
            verdict.append(f"p99 drifted {drift:.2f}x")
        out["verdict"] = "; ".join(verdict) if verdict else "clean"
        print(json.dumps(out), flush=True)
    finally:
        fe.stop()
        svc.close()


if __name__ == "__main__":
    main()
