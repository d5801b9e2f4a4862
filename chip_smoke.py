"""Bring-up smoke run of the LRCN main path on one NVIDIA GPU.

    python chip_smoke.py             # one card: train, generate, extract,
                                     # joint fine-tune, serve
    python chip_smoke.py --cards 4   # four cards: mesh training, sharded
                                     # decode and mesh serving, each
                                     # against the same work on one card

Everything runs in this one process, at the flagship width the repo
supports (VGG-16 224x224 -> fc7 4096; factored 2x1000 LSTM, embed 1000;
8,800-word vocabulary; beam 3, 20-word cap).  Data and weights are made
from ``--seed``; nothing is downloaded.  The run stops at the first
failed phase with a non-zero exit code.  Its last line is one JSON object
naming the device; every other result is printed on earlier lines.  The
seconds printed per phase are smoke timings, not benchmark metrics.

The script refuses to run (exit code 2, no result line) unless JAX's
first device is a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

import jax
import jax.numpy as jnp

from lrcn_jax import cli
from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data.feature_store import FeatureStore, l1_normalize
from lrcn_jax.decode.beam import beam_search
from lrcn_jax.decode.reference import reference_beam_search
from lrcn_jax.models import lrcn, vgg
from lrcn_jax.train.checkpoint import load_checkpoint, save_checkpoint
from lrcn_jax.utils.compile_cache import enable_compile_cache

# fc7 against the CPU float32 forward, as max|delta| / max|fc7|.  Float32
# on the GPU asks for HIGHEST precision, so only summation order differs
# from the CPU: 13 convs and two dense layers keep that near 1e-6.  The
# bfloat16 path rounds every operand to 8 bits of mantissa (relative
# error 2^-9 each), which 15 layers accumulate to about 1e-2.
VGG_F32_TOL = 1e-4
VGG_BF16_TOL = 3e-2
# beam scores against the host-looped reference (log of a product of
# float32 softmax values vs a sum of float32 log-softmax values)
SCORE_RTOL = 1e-4
# mesh training against one card, float32: reduction order only
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = 1e-4


class PhaseError(RuntimeError):
    """A phase's check failed."""


def check(ok: bool, message: str) -> None:
    if not ok:
        raise PhaseError(message)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Model and data sizes of one smoke run."""

    hidden: int = 1000          # both LSTM layers (lrcn.jl:39)
    embed: int = 1000           # (lrcn.jl:40)
    vocab_words: int = 8797     # + EOS, BOS, UNK = 8,800 ids
    vgg_width: float = 1.0      # full VGG-16 channel widths
    fc_dim: int = 4096          # fc6/fc7 width = decoder feature width
    # a Flickr-format corpus: 1,000 val + 1,000 test images are split off
    # (core/tokenizer.py); the rest must hold > 30,000 captions, or the
    # reference's small-dataset rule forces batch 10 (data/batcher.py)
    n_images: int = 8100
    batch: int = 100
    caption_len: tuple[int, int] = (9, 12)   # one length bucket
    beam: int = 3
    max_words: int = 20
    n_generate: int = 512
    n_reference: int = 8
    n_vgg_check: int = 2
    vgg_scan: tuple[int, int] = (4, 32)      # (batches, batch) for the scan
    joint_batch: int = 16
    joint_steps: int = 3
    decode_batch: int = 256     # serving batch = generate's batch
    encode_batch: int = 16
    n_id_requests: int = 32
    n_feature_requests: int = 8
    n_image_requests: int = 4
    mesh_steps: int = 3
    mesh_decode_batch: int = 256
    mesh_serve_batch: int = 64

    @property
    def vocab_size(self) -> int:
        return self.vocab_words + 3


FULL = Sizes()


def log(*parts) -> None:
    print(*parts, flush=True)


def smoke_timing(phase: str, **seconds: float) -> None:
    fields = " ".join(f"{k}={v:.3f}" for k, v in seconds.items())
    log(f"[{phase}] smoke timing (not a benchmark metric): {fields}")


def print_memory(label: str, compiled) -> None:
    """``compiled.memory_analysis()`` in MiB."""
    mem = compiled.memory_analysis()
    if mem is None:
        log(f"[{label}] memory_analysis: not reported by this backend")
        return
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    log(f"[{label}] memory_analysis MiB: " + " ".join(
        f"{f.replace('_size_in_bytes', '')}="
        f"{getattr(mem, f, 0) / 2**20:.1f}" for f in fields))


def cpu_device():
    return jax.devices("cpu")[0]


# --- synthetic data -------------------------------------------------------

def write_corpus(workdir: str, sizes: Sizes, seed: int) -> dict:
    """Flickr-format ``.token`` file + fc7 feature store, from ``seed``.

    Every word appears at least 5 times (the vocabulary's ``min_count``,
    core/tokenizer.py), the rest of the text follows a Zipf law, so the
    vocabulary has exactly ``sizes.vocab_size`` ids.  Captions do not
    depend on the features: one epoch teaches the decoder the word
    statistics, which is enough for a falling loss.
    """
    rng = np.random.default_rng(seed)
    n_caps = 5 * sizes.n_images
    lo, hi = sizes.caption_len
    lengths = rng.integers(lo, hi + 1, n_caps)
    n_tokens = int(lengths.sum())
    guaranteed = np.repeat(np.arange(sizes.vocab_words), 5)
    if n_tokens < guaranteed.size:
        raise ValueError("corpus too small for its vocabulary")
    zipf = 1.0 / np.arange(1, sizes.vocab_words + 1)
    extra = rng.choice(sizes.vocab_words, n_tokens - guaranteed.size,
                       p=zipf / zipf.sum())
    tokens = rng.permutation(np.concatenate([guaranteed, extra]))
    words = np.array([f"w{i}" for i in range(sizes.vocab_words)])
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    lines = []
    for c in range(n_caps):
        img, j = divmod(c, 5)
        cap = " ".join(words[tokens[bounds[c]:bounds[c + 1]]])
        lines.append(f"{100000 + img}.jpg#{j}\t{cap} .\n")
    token_path = os.path.join(workdir, "captions.token")
    with open(token_path, "w") as f:
        f.writelines(lines)

    feats = l1_normalize(np.abs(rng.standard_normal(
        (sizes.n_images, sizes.fc_dim), np.float32)))
    store = FeatureStore(dim=sizes.fc_dim, normalized=True)
    for i in range(sizes.n_images):
        store.add(100000 + i, feats[i])
    store_dir = os.path.join(workdir, "features")
    store.save(store_dir)
    return {"token": token_path, "features": store_dir}


def random_images(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)


# --- phase 1: decoder training through `lrcn train` -----------------------

def _train_losses(metrics_path: str) -> tuple[float, float]:
    """(loss of the first step, mean train loss after the last epoch)."""
    with open(metrics_path) as f:
        records = [json.loads(line) for line in f]
    first = next(r["loss"] for r in records
                 if r.get("event") == "train" and r.get("batch") == 0)
    last = [r["train_loss"] for r in records if r.get("event") == "epoch"]
    return float(first), float(last[-1])


def _compile_train_steps(sizes: Sizes, data: dict) -> float:
    """AOT-compile the CLI's train steps at the run's shapes; print their
    memory analysis; return the compile seconds."""
    from lrcn_jax.core.tokenizer import tokenize
    from lrcn_jax.train.trainer import Trainer

    vocab, _ = tokenize([data["token"]])
    cfg = LRCNConfig(hidden=(sizes.hidden, sizes.hidden), embed=sizes.embed,
                     vocab_size=len(vocab), cnn_feature_dim=sizes.fc_dim,
                     batch_size=sizes.batch)
    t0 = time.perf_counter()
    for k in (1, 8):
        trainer = Trainer(cfg, vocab, steps_per_dispatch=k)
        params, opt = jax.eval_shape(trainer.init, jax.random.PRNGKey(0))
        key = jax.random.PRNGKey(1)
        length = sizes.caption_len[1]
        i32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)
        if k == 1:
            step = trainer._train_step.lower(
                params, opt, i32(sizes.batch, length), i32(sizes.batch),
                jax.ShapeDtypeStruct((sizes.batch, sizes.fc_dim),
                                     jnp.float32), key)
        else:
            step = trainer._multi_step.lower(
                params, opt, i32(k, sizes.batch, length),
                i32(k, sizes.batch), i32(k, sizes.batch),
                jax.ShapeDtypeStruct((sizes.n_images, sizes.fc_dim),
                                     jnp.float32), key, np.int32(0))
        print_memory(f"train steps_per_dispatch={k}", step.compile())
    return time.perf_counter() - t0


def phase_train(sizes: Sizes, workdir: str, data: dict, seed: int) -> str:
    """`lrcn train` at steps-per-dispatch 1 and 8; returns the first
    run's checkpoint directory."""
    compile_s = _compile_train_steps(sizes, data)
    ckpt = None
    for k in (1, 8):
        out = os.path.join(workdir, f"ckpt_spd{k}")
        metrics = os.path.join(workdir, f"train_spd{k}.jsonl")
        t0 = time.perf_counter()
        rc = cli.main([
            "train", "--datafiles", data["token"],
            "--features", data["features"], "--savefile", out,
            "--epochs", "1", "--batchsize", str(sizes.batch),
            "--hidden", str(sizes.hidden), str(sizes.hidden),
            "--embed", str(sizes.embed), "--seed", str(seed),
            "--steps-per-dispatch", str(k), "--metrics", metrics])
        run_s = time.perf_counter() - t0
        check(rc == 0, f"lrcn train (steps-per-dispatch {k}) returned {rc}")
        first, last = _train_losses(metrics)
        log(f"[train] steps_per_dispatch={k}: first-step loss {first:.4f} "
            f"-> epoch train loss {last:.4f} "
            f"(ln V = {math.log(sizes.vocab_size):.4f})")
        check(math.isfinite(first) and math.isfinite(last),
              f"non-finite training loss ({first}, {last})")
        check(last < first, f"training loss did not fall ({first} -> "
                            f"{last}) at steps-per-dispatch {k}")
        loaded = load_checkpoint(out)
        check(len(loaded["vocab"]) == sizes.vocab_size,
              f"vocabulary has {len(loaded['vocab'])} ids, expected "
              f"{sizes.vocab_size}")
        leaves = jax.tree.leaves(loaded["params"])
        check(all(np.all(np.isfinite(np.asarray(x))) for x in leaves),
              "reloaded checkpoint holds non-finite parameters")
        log(f"[train] checkpoint {os.path.basename(out)} reloads: "
            f"{lrcn.param_count(loaded['params'])} parameters")
        smoke_timing(f"train spd={k}", compile_s=compile_s, run_s=run_s)
        compile_s = 0.0
        ckpt = ckpt or out
    return ckpt


# --- phase 2: generation through `lrcn generate` + reference check ---------

def _read_lines(path: str) -> list[str]:
    with open(path) as f:
        return f.read().splitlines()


def phase_generate(sizes: Sizes, workdir: str, data: dict, ckpt: str,
                   seed: int) -> dict[int, str]:
    """`lrcn generate` in bf16 and f32; the f32 search on the device
    against the host-looped reference on the CPU.  Returns the f32
    captions by image id."""
    captions = {}
    for dtype in ("bfloat16", "float32"):
        out = os.path.join(workdir, f"candidates_{dtype}.txt")
        ids_out = os.path.join(workdir, f"candidate_ids_{dtype}.txt")
        t0 = time.perf_counter()
        rc = cli.main([
            "generate", "--loadfile", ckpt, "--features", data["features"],
            "--datafiles", data["token"],
            "--capnumber", str(sizes.n_generate),
            "--generate", str(sizes.max_words),
            "--beam_width", str(sizes.beam), "--seed", str(seed),
            "--compute-dtype", dtype, "--out", out, "--ids-out", ids_out])
        run_s = time.perf_counter() - t0
        check(rc == 0, f"lrcn generate ({dtype}) returned {rc}")
        lines, ids = _read_lines(out), _read_lines(ids_out)
        check(len(lines) == len(ids) == sizes.n_generate,
              f"generate wrote {len(lines)} captions for {len(ids)} ids")
        check(all(line.endswith(".") for line in lines),
              "a caption line lacks the reference's trailing '.'")
        log(f"[generate] {dtype}: {len(lines)} captions, "
            f"{len(set(lines))} distinct, e.g. {lines[0]!r}")
        smoke_timing(f"generate {dtype}", run_incl_compile_s=run_s,
                     captions_per_s_incl_compile=len(lines) / run_s)
        captions[dtype] = dict(zip((int(i) for i in ids), lines))

    loaded = load_checkpoint(ckpt)
    params, cfg = loaded["params"], loaded["cfg"]
    store = FeatureStore.load(data["features"])
    ref_ids = sorted(captions["float32"])[:sizes.n_reference]
    feats = store.gather(ref_ids).astype(np.float32)
    t0 = time.perf_counter()
    dev_out = {dt: beam_search(params, jnp.asarray(feats),
                               beam_width=sizes.beam,
                               max_words=sizes.max_words, compute_dtype=dt)
               for dt in (jnp.float32, jnp.bfloat16)}
    tokens, scores = (np.asarray(x) for x in dev_out[jnp.float32])
    bf16_tokens = np.asarray(dev_out[jnp.bfloat16][0])
    device_s = time.perf_counter() - t0

    cpu = cpu_device()
    cpu_params = jax.device_put(params, cpu)
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        refs = [reference_beam_search(cpu_params, cfg, feats[b],
                                      sizes.beam, sizes.max_words)
                for b in range(len(ref_ids))]
    host_s = time.perf_counter() - t0
    bf16_agree = 0
    for b, (words, prob, _) in enumerate(refs):
        want = words[1:]
        got = [int(t) for t in tokens[b, 1:1 + len(want)]]
        check(got == want, f"f32 beam tokens differ from the reference on "
                           f"image {ref_ids[b]}: {got} vs {want}")
        ref_score = math.log(prob)
        rel = abs(float(scores[b]) - ref_score) / abs(ref_score)
        check(rel <= SCORE_RTOL, f"f32 beam score {scores[b]} vs reference "
                                 f"{ref_score} (relative {rel:.2e})")
        bf16_agree += [int(t) for t in bf16_tokens[b, 1:1 + len(want)]] \
            == want
    log(f"[generate] f32 device beam == host reference on "
        f"{len(refs)}/{len(refs)} images (tokens identical, scores within "
        f"{SCORE_RTOL:g} relative)")
    log(f"[generate] bf16 device tokens equal the f32 host reference on "
        f"{bf16_agree}/{len(refs)} images (reported, not gated)")
    smoke_timing("generate reference", device_incl_compile_s=device_s,
                 host_reference_s=host_s)
    return captions["float32"]


# --- phase 3: fc7 extraction ----------------------------------------------

def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def phase_vgg(sizes: Sizes, seed: int) -> None:
    """vgg16_fc7 / vgg16_fc7_scan on the device against the CPU f32
    forward."""
    rng = np.random.default_rng(seed + 3)
    params = vgg.init_vgg_params(jax.random.PRNGKey(seed + 3),
                                 width_multiplier=sizes.vgg_width,
                                 fc_dim=sizes.fc_dim)
    mean = np.array([123.68, 116.78, 103.94], np.float32)
    pixels = random_images(rng, sizes.n_vgg_check).astype(np.float32) - mean

    t0 = time.perf_counter()
    compiled = vgg.vgg16_fc7.lower(params, pixels, jnp.float32).compile()
    compile_s = time.perf_counter() - t0
    print_memory("vgg16_fc7 f32", compiled)
    dev_params = jax.device_put(params)
    t0 = time.perf_counter()
    f32 = np.asarray(compiled(dev_params, pixels))
    bf16 = np.asarray(vgg.vgg16_fc7(dev_params, pixels, jnp.bfloat16))
    run_s = time.perf_counter() - t0

    cpu = cpu_device()
    with jax.default_device(cpu):
        want = np.asarray(vgg.vgg16_fc7(jax.device_put(params, cpu),
                                        jax.device_put(pixels, cpu),
                                        jnp.float32))
    check(f32.shape == want.shape == (sizes.n_vgg_check, sizes.fc_dim),
          f"fc7 shape {f32.shape}")
    err32, err16 = _rel_err(f32, want), _rel_err(bf16, want)
    log(f"[vgg] fc7 f32 device vs CPU f32: max|d|/max|fc7| = {err32:.3e} "
        f"(limit {VGG_F32_TOL:g})")
    log(f"[vgg] fc7 bf16 device vs CPU f32: max|d|/max|fc7| = {err16:.3e} "
        f"(limit {VGG_BF16_TOL:g})")
    check(err32 <= VGG_F32_TOL, f"f32 fc7 error {err32:.3e}")
    check(err16 <= VGG_BF16_TOL, f"bf16 fc7 error {err16:.3e}")

    groups, batch = sizes.vgg_scan
    stack = random_images(rng, groups * batch).reshape(
        groups, batch, 224, 224, 3)
    scan_in = jnp.asarray(stack).astype(jnp.float32) - mean
    t0 = time.perf_counter()
    feats = jax.block_until_ready(vgg.vgg16_fc7_scan(dev_params, scan_in))
    scan_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = np.asarray(jax.block_until_ready(
        vgg.vgg16_fc7_scan(dev_params, scan_in)))
    scan_s = time.perf_counter() - t0
    check(feats.shape == (groups, batch, sizes.fc_dim)
          and bool(np.all(np.isfinite(feats))), "vgg16_fc7_scan output")
    one = np.asarray(vgg.vgg16_fc7(dev_params, scan_in[0]))
    err_scan = _rel_err(feats[0], one)
    log(f"[vgg] vgg16_fc7_scan bf16 {groups}x{batch} uint8 images: batch 0 "
        f"vs vgg16_fc7 max|d|/max|fc7| = {err_scan:.3e}")
    check(err_scan <= VGG_BF16_TOL, f"scan vs per-batch {err_scan:.3e}")
    smoke_timing("vgg", compile_f32_s=compile_s, run_f32_bf16_s=run_s,
                 scan_first_call_s=scan_first_s, scan_s=scan_s,
                 scan_images_per_s=groups * batch / scan_s)


# --- phase 4: joint fine-tuning -------------------------------------------

def phase_joint(sizes: Sizes, seed: int) -> None:
    from lrcn_jax.models.joint import JointTrainStep, make_joint_optimizer

    cfg = LRCNConfig(hidden=(sizes.hidden, sizes.hidden), embed=sizes.embed,
                     vocab_size=sizes.vocab_size,
                     cnn_feature_dim=sizes.fc_dim)
    step = JointTrainStep(cfg, make_joint_optimizer(cfg))
    params, opt_state = step.init(
        jax.random.PRNGKey(seed + 4),
        vgg_params=vgg.init_vgg_params(jax.random.PRNGKey(seed + 5),
                                       width_multiplier=sizes.vgg_width,
                                       fc_dim=sizes.fc_dim))
    rng = np.random.default_rng(seed + 4)
    b, length = sizes.joint_batch, sizes.caption_len[1]
    batches = [step.shard_batch(
        random_images(rng, b),
        rng.integers(3, sizes.vocab_size, (b, length)),
        rng.integers(sizes.caption_len[0], length + 1, b))
        for _ in range(sizes.joint_steps)]
    key = jax.random.PRNGKey(seed + 6)
    t0 = time.perf_counter()
    compiled = step._step.lower(params, opt_state, *batches[0], key).compile()
    compile_s = time.perf_counter() - t0
    print_memory(f"joint step batch {b} remat", compiled)
    losses = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        params, opt_state, loss = compiled(
            params, opt_state, *batch, jax.random.fold_in(key, i))
        losses.append(float(loss))
    run_s = time.perf_counter() - t0
    log(f"[joint] losses {[round(x, 4) for x in losses]}")
    check(all(math.isfinite(x) for x in losses), "non-finite joint loss")
    smoke_timing("joint", compile_s=compile_s, run_s=run_s,
                 images_per_s=b * len(batches) / run_s)


# --- phase 5: serving behind the native HTTP front-end --------------------

def _post(port: int, body: dict) -> tuple[int, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/caption", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _post_all(port: int, bodies: list[dict]) -> list[tuple[int, dict]]:
    """POST every body from its own client thread."""
    results: list = [None] * len(bodies)

    def client(i):
        try:
            results[i] = _post(port, bodies[i])
        except OSError as e:
            results[i] = (0, {"error": repr(e)})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "an HTTP client hung")
    return results


def _serve_ids(service, ids: list[int]) -> list[str]:
    """Caption ``ids`` through the native front-end, one request each."""
    from lrcn_jax.serve.native_http import NativeFrontend

    fe = NativeFrontend(service, host="127.0.0.1", port=0)
    try:
        results = _post_all(fe.port, [{"id": int(i)} for i in ids])
    finally:
        fe.stop()
    bad = [r for r in results if r[0] != 200]
    check(not bad, f"{len(bad)} id requests failed, e.g. {bad[:1]}")
    return [r[1]["captions"][0] for r in results]


def phase_serve(sizes: Sizes, data: dict, ckpt: str,
                generated: dict[int, str], seed: int) -> None:
    """CaptionService (float32) behind the C++ front-end: id and raw
    feature requests over HTTP, images through ``caption_images``."""
    from lrcn_jax.serve import CaptionService
    from lrcn_jax.serve.native_http import NativeFrontend

    loaded = load_checkpoint(ckpt)
    store = FeatureStore.load(data["features"])
    service = CaptionService(
        loaded["cfg"], loaded["params"], loaded["vocab"], store=store,
        vgg_params=vgg.init_vgg_params(jax.random.PRNGKey(seed + 7),
                                       width_multiplier=sizes.vgg_width,
                                       fc_dim=sizes.fc_dim),
        beam_width=sizes.beam, max_words=sizes.max_words,
        decode_batch=sizes.decode_batch, encode_batch=sizes.encode_batch,
        compute_dtype=jnp.float32, max_burst_groups=2)
    try:
        t0 = time.perf_counter()
        service.warmup()
        fe = NativeFrontend(service, host="127.0.0.1", port=0)
        compile_s = time.perf_counter() - t0
        try:
            ids = sorted(generated)
            id_ids = ids[:sizes.n_id_requests]
            feat_ids = ids[-sizes.n_feature_requests:]
            bodies = ([{"id": i} for i in id_ids]
                      + [{"features": [store.get(i).tolist()]}
                         for i in feat_ids])
            t0 = time.perf_counter()
            results = _post_all(fe.port, bodies)
            http_s = time.perf_counter() - t0
        finally:
            fe.stop()
        bad = [(b, r) for b, r in zip(bodies, results) if r[0] != 200]
        check(not bad, f"{len(bad)} of {len(bodies)} HTTP requests failed, "
                       f"e.g. status {bad[0][1][0] if bad else ''}: "
                       f"{bad[0][1][1] if bad else ''}")
        served = [r[1]["captions"] for r in results]
        check(all(len(c) == 1 and c[0].endswith(".") for c in served),
              "a response is not one caption line")
        id_served = [c[0] for c in served[:len(id_ids)]]
        mismatch = [i for i, c in zip(id_ids, id_served)
                    if c != generated[i]]
        check(not mismatch, f"served f32 captions differ from `lrcn "
                            f"generate` for ids {mismatch[:5]}")
        feat_same = sum(c[0] == generated[i] for i, c in
                        zip(feat_ids, served[len(id_ids):]))
        log(f"[serve] {len(bodies)} HTTP requests answered 200; "
            f"{len(id_ids)} id captions equal `lrcn generate`'s; "
            f"{feat_same}/{len(feat_ids)} raw-feature captions equal it "
            f"(re-normalized rows; reported, not gated)")

        rng = np.random.default_rng(seed + 8)
        t0 = time.perf_counter()
        images = service.caption_images(
            list(random_images(rng, sizes.n_image_requests)))
        image_s = time.perf_counter() - t0
        check(len(images) == sizes.n_image_requests
              and all(c.endswith(".") for c in images),
              f"caption_images returned {images!r}")
        log(f"[serve] caption_images on {len(images)} uint8 images: "
            f"{images[0]!r}")
        smoke_timing("serve", warmup_compile_s=compile_s, http_s=http_s,
                     images_s=image_s)
    finally:
        service.close()


# --- four cards -----------------------------------------------------------

def _tree_max_diff(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                   - np.asarray(y, np.float64))))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def phase_mesh_train(sizes: Sizes, seed: int, devices) -> None:
    """DPxTP and pipelined training on a 2x2 mesh vs one card, f32."""
    from lrcn_jax.parallel import (PipelinedTrainStep, ShardedTrainStep,
                                   make_mesh)
    from lrcn_jax.train.trainer import Trainer, make_optimizer

    cfg = LRCNConfig(hidden=(sizes.hidden, sizes.hidden), embed=sizes.embed,
                     vocab_size=sizes.vocab_size,
                     cnn_feature_dim=sizes.fc_dim, dropout=0.0,
                     compute_dtype="float32")
    rng = np.random.default_rng(seed + 9)
    b, length = sizes.batch, sizes.caption_len[1]
    batches = [(rng.integers(3, cfg.vocab_size, (b, length)).astype(np.int32),
                rng.integers(sizes.caption_len[0], length + 1, b)
                .astype(np.int32),
                l1_normalize(np.abs(rng.standard_normal(
                    (b, sizes.fc_dim), np.float32))))
               for _ in range(sizes.mesh_steps)]
    keys = [jax.random.PRNGKey(seed + 10 + i) for i in range(len(batches))]

    with jax.default_device(devices[0]):
        trainer = Trainer(cfg, vocab=None)
        params0, opt0 = trainer.init(jax.random.PRNGKey(seed))
        host_params0 = jax.device_get(params0)
        params, opt = params0, opt0
        ref_losses = []
        for batch, key in zip(batches, keys):
            params, opt, loss = trainer._train_step(
                params, opt, *(jnp.asarray(x) for x in batch), key)
            ref_losses.append(float(loss))
        ref_params = jax.device_get(params)

    mesh = make_mesh((2, 2), devices=devices)
    for name, cls in (("mesh 2x2", ShardedTrainStep),
                      ("mesh 2x2 --pipeline", PipelinedTrainStep)):
        t0 = time.perf_counter()
        step = cls(cfg, make_optimizer(cfg), mesh)
        params = step.shard_params(host_params0)
        opt = step.init_opt(params)
        losses = []
        for batch, key in zip(batches, keys):
            params, opt, loss = step(params, opt, *step.shard_batch(*batch),
                                     key)
            losses.append(float(loss))
        run_s = time.perf_counter() - t0
        if cls is PipelinedTrainStep:
            params = step.unshard_params(params)
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses, ref_losses))
        dparam = _tree_max_diff(jax.device_get(params), ref_params)
        log(f"[mesh train] {name}: losses {[round(x, 6) for x in losses]} vs "
            f"one card {[round(x, 6) for x in ref_losses]}; max relative "
            f"loss difference {rel:.2e}, max |param difference| "
            f"{dparam:.2e}")
        check(all(math.isfinite(x) for x in losses), f"{name}: non-finite")
        check(rel <= TRAIN_LOSS_RTOL, f"{name}: losses differ by {rel:.2e}")
        check(dparam <= TRAIN_PARAM_TOL,
              f"{name}: parameters differ by {dparam:.2e}")
        smoke_timing(f"mesh train {name}", run_incl_compile_s=run_s)


def phase_mesh_decode(sizes: Sizes, seed: int, devices) -> None:
    from lrcn_jax.parallel import make_mesh
    from lrcn_jax.parallel.decode import sharded_beam_search

    cfg = LRCNConfig(hidden=(sizes.hidden, sizes.hidden), embed=sizes.embed,
                     vocab_size=sizes.vocab_size,
                     cnn_feature_dim=sizes.fc_dim)
    params = lrcn.init_params(jax.random.PRNGKey(seed + 11), cfg)
    rng = np.random.default_rng(seed + 11)
    feats = l1_normalize(np.abs(rng.standard_normal(
        (sizes.mesh_decode_batch, sizes.fc_dim), np.float32)))
    mesh = make_mesh((len(devices), 1), devices=devices)
    with jax.default_device(devices[0]):
        want, want_scores = beam_search(
            jax.device_put(params, devices[0]), jnp.asarray(feats),
            beam_width=sizes.beam, max_words=sizes.max_words,
            compute_dtype=jnp.float32)
        want = np.asarray(want)
    t0 = time.perf_counter()
    got, got_scores = sharded_beam_search(
        params, feats, mesh, beam_width=sizes.beam,
        max_words=sizes.max_words, compute_dtype=jnp.float32)
    got = np.asarray(got)
    run_s = time.perf_counter() - t0
    differ = int(np.sum(np.any(got != want, axis=1)))
    dscore = float(np.max(np.abs(np.asarray(got_scores)
                                 - np.asarray(want_scores))))
    log(f"[mesh decode] sharded beam search over {len(devices)} cards: "
        f"{len(got) - differ}/{len(got)} captions identical to one card; "
        f"max |score difference| {dscore:.2e}")
    check(differ == 0, f"{differ} sharded captions differ from one card")
    smoke_timing("mesh decode", run_incl_compile_s=run_s)


def phase_mesh_serve(sizes: Sizes, workdir: str, seed: int) -> None:
    """`lrcn serve --mesh 4` id requests vs the same service on one card."""
    cfg = LRCNConfig(hidden=(sizes.hidden, sizes.hidden), embed=sizes.embed,
                     vocab_size=sizes.vocab_size,
                     cnn_feature_dim=sizes.fc_dim)
    vocab = Vocab([f"w{i}" for i in range(sizes.vocab_words)])
    ckpt = os.path.join(workdir, "mesh_ckpt")
    save_checkpoint(ckpt, lrcn.init_params(jax.random.PRNGKey(seed + 12),
                                           cfg), vocab, cfg)
    rng = np.random.default_rng(seed + 12)
    n = 4 * sizes.mesh_serve_batch
    feats = l1_normalize(np.abs(rng.standard_normal((n, sizes.fc_dim),
                                                    np.float32)))
    store = FeatureStore(dim=sizes.fc_dim, normalized=True)
    for i in range(n):
        store.add(500000 + i, feats[i])
    store_dir = os.path.join(workdir, "mesh_features")
    store.save(store_dir)
    ids = list(range(500000, 500000 + sizes.n_id_requests))

    served = {}
    for mesh in (4, None):
        args = cli.build_parser().parse_args(
            ["serve", "--loadfile", ckpt, "--features", store_dir,
             "--generate", str(sizes.max_words),
             "--beam_width", str(sizes.beam),
             "--decode-batch", str(sizes.mesh_serve_batch),
             "--max-burst-groups", "1", "--compute-dtype", "float32"]
            + (["--mesh", str(mesh)] if mesh else []))
        service = cli.make_caption_service(args)
        try:
            t0 = time.perf_counter()
            service.warmup()
            served[mesh] = _serve_ids(service, ids)
            smoke_timing(f"mesh serve --mesh {mesh or 1}",
                         run_incl_compile_s=time.perf_counter() - t0)
        finally:
            service.close()
    differ = sum(a != b for a, b in zip(served[4], served[None]))
    log(f"[mesh serve] --mesh 4: {len(ids)} id requests answered 200; "
        f"{len(ids) - differ}/{len(ids)} captions identical to one card")
    check(differ == 0, f"{differ} mesh-served captions differ from one card")


# --- entry point ----------------------------------------------------------

def device_lines() -> list[str]:
    """nvidia-smi's name and power limit, and JAX's view of the device."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    device = jax.devices()[0]
    return [f"nvidia-smi: {line.strip()}"
            for line in smi.stdout.splitlines() if line.strip()] + [
        f"device_kind: {device.device_kind} x{len(jax.devices())}",
        f"jax: {jax.__version__}"]


def run_one_card(sizes: Sizes, workdir: str, seed: int) -> None:
    t0 = time.perf_counter()
    data = write_corpus(workdir, sizes, seed)
    smoke_timing("data", write_s=time.perf_counter() - t0)
    ckpt = phase_train(sizes, workdir, data, seed)
    generated = phase_generate(sizes, workdir, data, ckpt, seed)
    phase_vgg(sizes, seed)
    phase_joint(sizes, seed)
    phase_serve(sizes, data, ckpt, generated, seed)


def run_four_cards(sizes: Sizes, workdir: str, seed: int, devices) -> None:
    phase_mesh_train(sizes, seed, devices)
    phase_mesh_decode(sizes, seed, devices)
    phase_mesh_serve(sizes, workdir, seed)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1,
                        help="1: the one-card phases; 4: only the mesh "
                             "phases and their one-card comparisons")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the synthetic data and weights")
    args = parser.parse_args(argv)

    cache_dir = enable_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs; "
              f"JAX sees {len(devices)}", file=sys.stderr)
        return 2
    for line in device_lines():
        log(line)
    log(f"compile cache in use: {cache_dir}")

    workdir = tempfile.mkdtemp(prefix="lrcn_smoke_")
    t0 = time.perf_counter()
    try:
        if args.cards == 4:
            run_four_cards(FULL, workdir, args.seed, devices[:4])
        else:
            run_one_card(FULL, workdir, args.seed)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    smoke_timing("total", wall_s=time.perf_counter() - t0)
    device = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
