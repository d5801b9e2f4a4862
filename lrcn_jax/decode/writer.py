"""Caption generation driver + eval-file writers.

Produces the exact output surface of the reference's generation mode:
``candidates.txt`` / ``candidate_ids.txt`` (COCO) and
``candidates_flickr`` / ``candidate_ids_flickr`` (lrcn.jl:132-157), where
each caption line is the generated words joined by spaces with a trailing
`` .`` (lrcn.jl:634-640).

Unlike the reference (one host-looped beam search per image), images are
decoded in fixed-size device batches.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np

from lrcn_jax.core.vocab import EOS_ID, Vocab
from lrcn_jax.data.feature_store import FeatureStore, l1_normalize
from lrcn_jax.decode.beam import beam_search_scan, greedy_search_scan
from lrcn_jax.models.lrcn import Params


def caption_to_line(token_row: np.ndarray, vocab: Vocab) -> str:
    """Token ids (BOS at [0]) -> the reference's caption line format.

    Reference: print each word followed by a space, stop at EOS, then
    print "." (lrcn.jl:634-640) — i.e. ``"w1 w2 ... wn ."``.
    """
    words = []
    for t in token_row[1:]:
        if int(t) == EOS_ID:
            break
        words.append(vocab.word(int(t)))
    return " ".join(words + ["."])


def detokenize_batch(tokens: np.ndarray, vocab: Vocab) -> list[str]:
    """Vectorized ``caption_to_line`` over (N, T) token rows.

    Output-identical to ``[caption_to_line(r, vocab) for r in tokens]``
    (asserted by tests/test_decode.py).  The numpy EOS scan +
    object-array gather leaves only one join per caption in Python.
    """
    toks = np.asarray(tokens)[:, 1:]            # drop BOS
    if toks.size == 0:
        return ["."] * len(toks)
    eos = toks == EOS_ID
    has = eos.any(axis=1)
    ends = np.where(has, eos.argmax(axis=1), toks.shape[1])
    words = vocab.words_array()[toks]           # (N, T-1) object gather
    return [" ".join(list(words[i, :e]) + ["."])
            for i, e in enumerate(ends)]


def generate_captions(params: Params, vocab: Vocab, store: FeatureStore,
                      image_ids: Sequence[int], *, beam_width: int = 3,
                      max_words: int = 30, batch_size: int = 64,
                      normalize: bool | None = None,
                      sample_n: int = 0, temperature: float = 2.0,
                      rng=None, scan_depth: int = 4, max_inflight: int = 4,
                      compute_dtype=jnp.bfloat16,
                      resident_store: bool | None = None) -> list[str]:
    """Decode captions for ``image_ids`` in device batches.

    Strategies: beam search (default), greedy (``beam_width=1``), or the
    paper's best-of-N sampling (``sample_n > 0`` with ``temperature``).

    ``normalize``: L1-normalize features on the fly; defaults to skipping
    normalization when the store says it is already normalized (the
    reference's ``featsn`` files are pre-normalized; the live-CNN path
    normalizes at lrcn.jl:597).

    ``scan_depth``: batches decoded per device dispatch (``lax.scan``
    group); ``max_inflight``: dispatches queued ahead of the host fetch.
    Both trade host/device overlap against memory.

    ``resident_store``: upload the store's full feature table to HBM
    once and dispatch int32 row indices (the serving fast path,
    ``rows_search_scan``) instead of host-gathering float rows per
    batch.  Default (None) decides by upload bytes: the table wins once
    the run decodes at least as many rows as the table holds.
    """
    import jax

    if normalize is None:
        normalize = not store.normalized
    if sample_n > 0 and rng is None:
        rng = jax.random.PRNGKey(0)

    def host_batch(batch_ids: list) -> tuple[np.ndarray, int]:
        """Pad one batch of ids to a static shape and gather features."""
        ids = list(batch_ids)
        n_real = len(ids)
        while len(ids) < batch_size:   # static shape for XLA
            ids.append(ids[-1])
        feats = store.gather(ids).astype(np.float32)
        if normalize:
            feats = l1_normalize(feats)
        if jnp.dtype(compute_dtype) == jnp.dtype(jnp.bfloat16):
            # bit-identical bf16 upload (see the resident path)
            feats = feats.astype(jnp.bfloat16)
        return feats, n_real

    n = len(image_ids)
    id_batches = [image_ids[s:s + batch_size]
                  for s in range(0, n, batch_size)]

    # Decode loop: up to ``max_inflight`` dispatches stay enqueued before
    # the oldest result is fetched — the device streams through batches
    # without idling on host round trips, while host/device memory stays
    # O(batch), not O(dataset).  The beam path additionally scans groups
    # of batches inside ONE dispatch.
    lines: list[str] = []
    pending: list[tuple] = []   # (tokens device array (G, B, T), [n_real])
    max_inflight = max(1, max_inflight)

    def drain_one():
        tokens, n_reals = pending.pop(0)
        tokens = np.asarray(tokens)
        for gi, n_real in enumerate(n_reals):
            if n_real:
                lines.extend(detokenize_batch(tokens[gi, :n_real], vocab))

    if sample_n > 0:
        for batch_ids in id_batches:
            feats, n_real = host_batch(batch_ids)
            from lrcn_jax.decode.sample import best_of_n_search
            rng, k = jax.random.split(rng)
            tokens, _ = best_of_n_search(
                params, jnp.asarray(feats), k, n_samples=sample_n,
                temperature=temperature, max_words=max_words,
                compute_dtype=compute_dtype)
            # start the device->host copy now: it queues behind the
            # dispatch and overlaps the next ones (a blocking asarray
            # at drain time pays the full link RTT per dispatch).
            # Reshape FIRST — the async copy must target the exact
            # array drain_one will fetch, not a pre-reshape alias
            tokens = tokens[None]
            tokens.copy_to_host_async()
            pending.append((tokens, [n_real]))
            if len(pending) > max_inflight:
                drain_one()
    else:
        scan_depth = max(1, scan_depth)
        if resident_store is None:
            resident_store = 0 < len(store) <= n
        if resident_store and len(store):
            # ship the table ONCE, then (G, B) int32 indices per
            # dispatch — the gather runs inside the jitted search
            # (rows_search_scan), bit-identical to host-gathered rows
            from lrcn_jax.decode.beam import rows_search_scan
            table = np.asarray(store.table(), np.float32)  # no-copy: f32
            if normalize:
                table = l1_normalize(table)
            if jnp.dtype(compute_dtype) == jnp.dtype(jnp.bfloat16):
                # the search casts features to bf16 before first use, so
                # a bf16 upload is bit-identical and ships half the
                # bytes
                table = table.astype(jnp.bfloat16)
            dev_table = jnp.asarray(table)
            row_idx = store.rows(image_ids)
            rows_per_group = batch_size * scan_depth
            for g in range(0, len(row_idx), rows_per_group):
                chunk = row_idx[g:g + rows_per_group]
                n_real = len(chunk)
                idx = np.full((scan_depth, batch_size), chunk[-1],
                              np.int32)
                idx.reshape(-1)[:n_real] = chunk
                tokens, _ = rows_search_scan(
                    params, dev_table, jnp.asarray(idx),
                    beam_width=beam_width, max_words=max_words,
                    compute_dtype=compute_dtype)
                tokens.copy_to_host_async()   # overlap the link RTT
                n_reals = [min(batch_size, max(0, n_real - b * batch_size))
                           for b in range(scan_depth)]
                pending.append((tokens, n_reals))
                if len(pending) > max_inflight:
                    drain_one()
            while pending:
                drain_one()
            return lines
        search = (greedy_search_scan if beam_width == 1 else
                  lambda p, f, **kw: beam_search_scan(
                      p, f, beam_width=beam_width, **kw))
        for g in range(0, len(id_batches), scan_depth):
            group = [host_batch(ids)
                     for ids in id_batches[g:g + scan_depth]]
            # pad a short tail group by repeating its last batch (with
            # n_real = 0 so no caption is emitted for the filler) — one
            # program shape for the whole run instead of compiling a
            # second, tail-sized scan
            while len(group) < scan_depth:
                group.append((group[-1][0], 0))
            stacked = jnp.asarray(np.stack([f for f, _ in group]))
            tokens, _ = search(params, stacked, max_words=max_words,
                               compute_dtype=compute_dtype)
            tokens.copy_to_host_async()   # overlap the link RTT
            pending.append((tokens, [nr for _, nr in group]))
            if len(pending) > max_inflight:
                drain_one()

    while pending:
        drain_one()
    return lines


def write_candidate_files(lines: Sequence[str], image_ids: Sequence[int],
                          candidates_path: str, ids_path: str) -> None:
    """Write the caption + id files consumed by the eval harness
    (reference: lrcn.jl:133-139,600)."""
    with open(candidates_path, "w") as f:
        for line in lines:
            f.write(line + "\n")
    with open(ids_path, "w") as f:
        for image_id in image_ids:
            f.write(f"{int(image_id)}\n")


def pick_eval_ids(image_ids: Sequence[int], capnumber: int,
                  rng: np.random.Generator) -> list[int]:
    """Choose ``capnumber`` unique image ids at random (lrcn.jl:142-150)."""
    unique = list(dict.fromkeys(int(i) for i in image_ids))
    rng.shuffle(unique)
    return unique[:capnumber]


def pick_eval_ids_from_captions(captions: Sequence, capnumber: int,
                                rng: np.random.Generator,
                                store: FeatureStore | None = None
                                ) -> list[int]:
    """The reference's eval-id sampling protocol (lrcn.jl:142-150).

    Shuffle the *held-out caption split* (``caption_dicts[2]`` for COCO val,
    ``caption_dicts[3]`` for the Flickr test split, lrcn.jl:132-150) and
    collect unique image ids until ``capnumber`` are chosen.  Sampling from
    the caption split — never from the feature store — guarantees no
    training image is ever captioned for evaluation, even against a
    full-corpus store (e.g. the Karpathy import covers all 30k Flickr
    images).

    Ids whose features are missing from ``store`` are skipped with a
    warning (the reference instead dies mid-run on the first missing
    feature, lrcn.jl:603).
    """
    order = list(captions)
    rng.shuffle(order)
    ids: list[int] = []
    seen: set[int] = set()
    missing = 0
    for cap in order:
        image_id = int(cap.image_id)
        if image_id in seen:
            continue
        seen.add(image_id)
        if store is not None and image_id not in store:
            missing += 1
            continue
        ids.append(image_id)
        if len(ids) == capnumber:
            break
    if missing:
        print(f"generate: skipped {missing} held-out ids with no stored "
              f"features")
    return ids
