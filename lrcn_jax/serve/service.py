"""Online caption service: dynamic batching onto fixed compiled shapes.

Two pipelined stages, each behind its own ``DynamicBatcher``:

- **encode**: raw images -> fc7 features through VGG-16 (optional; only
  when the service was given an encoder).  Live images are L1-normalized
  exactly like the reference's live path (lrcn.jl:597).
- **decode**: fc7 features -> captions through batched on-device beam
  search.

Each stage pads its batch to ONE compiled shape (``decode_batch`` /
``encode_batch`` rows), so serving never triggers a recompile after
warmup and every dispatch runs the same XLA program the offline
benchmarks measure.  Requests by image id resolve features from the
``FeatureStore`` on the host and skip the encode stage entirely.

The reference has no online serving (generation is an offline file
loop, lrcn.jl:127-160); this subsystem is new, production-facing
surface.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data.feature_store import FeatureStore, l1_normalize
from lrcn_jax.decode.beam import beam_search, greedy_search
from lrcn_jax.decode.writer import detokenize_batch
from lrcn_jax.serve.batcher import DynamicBatcher


# Shared with bulk generation (decode/writer.py): serving burst
# absorption and `lrcn generate` both dispatch int32 row indices
# against the HBM-resident table.
from lrcn_jax.decode.beam import (rows_search as _rows_search,
                                  rows_search_scan as _rows_search_scan)


class CaptionService:
    """Caption requests against a loaded model, batched dynamically.

    ``caption_ids`` looks features up in the store; ``caption_images``
    runs the encoder (requires ``vgg_params``).  Both are thread-safe:
    any number of request threads may call them concurrently, and all
    device work funnels through the stage dispatcher threads.
    """

    def __init__(self, cfg: LRCNConfig, params, vocab: Vocab, *,
                 store: FeatureStore | None = None,
                 vgg_params=None, average_image: np.ndarray | None = None,
                 beam_width: int = 3, max_words: int = 30,
                 decode_batch: int = 64, encode_batch: int = 8,
                 max_wait_ms: float = 5.0,
                 compute_dtype=jnp.bfloat16, mesh=None,
                 resident_store: bool = True,
                 max_queue: int | None = None,
                 request_timeout_s: float = 60.0,
                 max_burst_groups: int | None = None):
        self.cfg = cfg
        self.params = params
        self.vocab = vocab
        self.store = store
        self.beam_width = beam_width
        self.max_words = max_words
        self.decode_batch = decode_batch
        self.compute_dtype = compute_dtype
        self.request_timeout_s = request_timeout_s
        self.mesh = mesh
        if max_burst_groups is not None:
            # deeper bursts drain faster at the cost of per-dispatch
            # tail latency
            if max_burst_groups < 1:
                raise ValueError("max_burst_groups must be >= 1")
            self.MAX_DECODE_GROUPS = int(max_burst_groups)
        if mesh is not None:
            n_data = mesh.shape["data"]
            if decode_batch % n_data or (
                    vgg_params is not None and encode_batch % n_data):
                raise ValueError(
                    f"decode_batch={decode_batch} / encode_batch="
                    f"{encode_batch} must be divisible by the mesh's "
                    f"data axis ({n_data}) so every chip gets equal "
                    f"batch rows")
        # feature decodes burst too: a backlog coalesces into up to
        # MAX_DECODE_GROUPS compiled batches drained in ONE scanned
        # dispatch, mirroring the id path below (items are already
        # normalized by every caller, so the grouped fn skips its
        # normalize; <= one batch delegates to _decode_fn unchanged)
        self._decode = DynamicBatcher(
            lambda rows: self._decode_feats_grouped(rows, normalized=True),
            finalize=self._decode_finalize,
            max_batch=decode_batch * self.MAX_DECODE_GROUPS,
            max_wait_ms=max_wait_ms,
            name="decode", max_queue=max_queue)
        # HBM-resident feature table: caption-by-id requests then ship
        # int32 row indices (4 B each) instead of fc7 rows (16 KB each)
        # and the gather runs on device — the same optimization as the
        # trainer's feed.  The table upload happens once, here.
        self._table = self._rows_batcher = None
        if store is not None and resident_store and len(store):
            table = store.table()
            if not store.normalized:
                table = l1_normalize(table)
            # bf16 compute: the search casts features to bf16 before
            # first use, so a bf16-resident table is bit-identical and
            # halves both the one-time upload and the HBM residency
            # (2 GB -> 1 GB at COCO scale)
            table_dtype = (jnp.bfloat16
                           if jnp.dtype(compute_dtype) == jnp.bfloat16
                           else jnp.float32)
            host_table = np.asarray(table, np.float32).astype(
                table_dtype, copy=False)
            if mesh is not None:
                # host -> replicated directly (a default-device commit
                # first would copy the whole table an extra time)
                from jax.sharding import NamedSharding, PartitionSpec as P
                self._table = jax.device_put(
                    host_table, NamedSharding(mesh, P()))
            else:
                self._table = jnp.asarray(host_table)
            # burst absorption: a backlog coalesces into up to
            # MAX_DECODE_GROUPS compiled batches drained in ONE scanned
            # dispatch
            self._rows_batcher = DynamicBatcher(
                self._decode_rows_grouped, finalize=self._decode_finalize,
                max_batch=decode_batch * self.MAX_DECODE_GROUPS,
                max_wait_ms=max_wait_ms,
                name="decode_ids", max_queue=max_queue)
        self._encode = None
        if vgg_params is not None:
            from lrcn_jax.train.joint import identity_average_image
            if mesh is not None:    # replicate the encoder over the mesh
                from jax.sharding import NamedSharding, PartitionSpec as P
                vgg_params = jax.device_put(
                    vgg_params, NamedSharding(mesh, P()))
            self.vgg_params = vgg_params
            self.average_image = (
                np.asarray(average_image, np.float32)
                if average_image is not None else identity_average_image())
            self._encode = DynamicBatcher(
                self._encode_fn, finalize=self._encode_finalize,
                max_batch=encode_batch, max_wait_ms=max_wait_ms,
                name="encode", max_queue=max_queue)

    # --- stage fns (dispatcher threads) ---

    def _decode_fn(self, feats: list[np.ndarray]):
        """ISSUE a padded beam dispatch; returns (n, device tokens).

        Does NOT block on the device — the collector thread's
        ``_decode_finalize`` fetches, so the dispatcher can coalesce and
        issue the next batch while this one runs (serve/batcher.py).
        """
        n = len(feats)
        batch = np.zeros((self.decode_batch, feats[0].shape[-1]),
                         np.float32)
        batch[:n] = np.asarray(feats, np.float32)
        if self.compute_dtype == jnp.bfloat16 and self.mesh is None:
            # the search casts features to bf16 before first use, so a
            # bf16 upload is bit-identical and ships half the bytes
            batch = batch.astype(jnp.bfloat16)
        if self.mesh is not None:
            from lrcn_jax.parallel.decode import sharded_beam_search
            tokens, _ = sharded_beam_search(
                self.params, batch, self.mesh,
                beam_width=self.beam_width, max_words=self.max_words,
                compute_dtype=self.compute_dtype)
        elif self.beam_width == 1:
            tokens, _ = greedy_search(self.params, jnp.asarray(batch),
                                      max_words=self.max_words,
                                      compute_dtype=self.compute_dtype)
        else:
            tokens, _ = beam_search(self.params, jnp.asarray(batch),
                                    beam_width=self.beam_width,
                                    max_words=self.max_words,
                                    compute_dtype=self.compute_dtype)
        tokens.copy_to_host_async()     # overlap the RTT (see grouped)
        return n, tokens

    def _decode_finalize(self, raw) -> list[str]:
        n, tokens = raw
        tokens = np.asarray(tokens)     # blocks for the device here
        if tokens.ndim == 3:            # grouped (G, B, T) burst decode
            tokens = tokens.reshape(-1, tokens.shape[-1])
        return detokenize_batch(tokens[:n], self.vocab)

    MAX_DECODE_GROUPS = 4   # scanned batches per burst dispatch

    def _decode_rows_grouped(self, rows: list[int]):
        """ISSUE up to MAX_DECODE_GROUPS batches of table-row decodes in
        ONE scanned dispatch (burst absorption — see _rows_search_scan).

        Under a mesh, each scanned batch is sharded along ``data``
        exactly like the per-batch path (the scan is over groups; the
        beam loop inside each step partitions per-image, so no
        cross-chip communication appears)."""
        n = len(rows)
        b = self.decode_batch
        g = max(1, -(-n // b))
        assert g <= self.MAX_DECODE_GROUPS
        if g == 1:
            return self._decode_rows_fn(rows)
        idx = np.zeros((g, b), np.int32)
        idx.reshape(-1)[:n] = rows
        if self.mesh is not None:
            # host -> sharded directly (a default-device commit first
            # would be an extra device->device hop)
            from jax.sharding import NamedSharding, PartitionSpec as P
            dev_idx = jax.device_put(
                idx, NamedSharding(self.mesh, P(None, "data")))
        else:
            dev_idx = jnp.asarray(idx)
        tokens, _ = _rows_search_scan(
            self.params, self._table, dev_idx,
            beam_width=self.beam_width, max_words=self.max_words,
            compute_dtype=self.compute_dtype)
        # start the device->host token copy NOW: it queues behind this
        # dispatch and rides the link while the pump issues/works on
        # other batches — the blocking np.asarray in _decode_finalize
        # would otherwise pay the whole device->host round trip
        tokens.copy_to_host_async()
        return n, tokens

    def _decode_feats_grouped(self, rows: np.ndarray,
                              normalized: bool = False):
        """ISSUE up to MAX_DECODE_GROUPS batches of raw-feature decodes
        in ONE scanned dispatch (burst absorption for the native
        front-end's feature path AND the Python decode batcher,
        mirroring ``_decode_rows_grouped`` for ids).

        With ``normalized=False`` rows are L1-normalized here, exactly
        like ``caption_features`` (the reference's live path,
        lrcn.jl:597).  The Python batcher passes ``normalized=True`` —
        its callers (caption_features, the encode stage) normalize
        exactly once already, and re-normalizing would perturb the low
        bits against the per-batch path."""
        from lrcn_jax.decode.beam import beam_search_scan, \
            greedy_search_scan

        rows = np.asarray(rows, np.float32)
        if not normalized:
            rows = l1_normalize(rows)
        n = len(rows)
        b = self.decode_batch
        g = max(1, -(-n // b))
        assert g <= self.MAX_DECODE_GROUPS
        if g == 1:
            return self._decode_fn(list(rows))
        batch = np.zeros((g, b, rows.shape[-1]), np.float32)
        batch.reshape(-1, rows.shape[-1])[:n] = rows
        if self.compute_dtype == jnp.bfloat16 and self.mesh is None:
            # bit-identical (the search casts to bf16 first), half the
            # upload — same rule as _decode_fn
            batch = batch.astype(jnp.bfloat16)
        if self.mesh is not None:
            # host -> sharded directly (no default-device hop); the
            # scan is over groups, each batch shards along 'data'
            from jax.sharding import NamedSharding, PartitionSpec as P
            dev = jax.device_put(
                batch, NamedSharding(self.mesh, P(None, "data")))
        else:
            dev = jnp.asarray(batch)
        search = (greedy_search_scan if self.beam_width == 1
                  else beam_search_scan)
        kwargs = {} if self.beam_width == 1 else {
            "beam_width": self.beam_width}
        tokens, _ = search(self.params, dev, max_words=self.max_words,
                           compute_dtype=self.compute_dtype, **kwargs)
        tokens.copy_to_host_async()     # overlap the RTT (see grouped)
        return n, tokens

    def warmup_feature_burst_shapes(self) -> None:
        """Compile every grouped raw-feature burst shape (g=1..MAX) so
        native-front-end feature traffic never recompiles.  Idempotent;
        called by the native front-end at startup."""
        if getattr(self, "_feat_burst_warm", False):
            return
        dim = self.cfg.cnn_feature_dim
        for g in range(1, self.MAX_DECODE_GROUPS + 1):
            rows = np.ones((self.decode_batch * (g - 1) + 1, dim),
                           np.float32)
            self._decode_finalize(self._decode_feats_grouped(rows))
        self._feat_burst_warm = True

    def _decode_rows_fn(self, rows: list[int]):
        """ISSUE a beam dispatch over HBM-resident table rows.

        The host ships ``decode_batch`` int32 indices; the feature
        gather happens inside the jitted program against the table
        uploaded at construction.
        """
        n = len(rows)
        idx = np.zeros((self.decode_batch,), np.int32)
        idx[:n] = rows
        if self.mesh is not None:
            # host -> sharded directly (no default-device hop)
            from jax.sharding import NamedSharding, PartitionSpec as P
            dev_idx = jax.device_put(
                idx, NamedSharding(self.mesh, P("data")))
        else:
            dev_idx = jnp.asarray(idx)
        tokens, _ = _rows_search(
            self.params, self._table, dev_idx,
            beam_width=self.beam_width, max_words=self.max_words,
            compute_dtype=self.compute_dtype)
        tokens.copy_to_host_async()     # overlap the RTT (see grouped)
        return n, tokens

    def _encode_fn(self, images: list[np.ndarray]):
        """ISSUE a padded VGG dispatch; returns (n, device fc7 rows)."""
        from lrcn_jax.data.images import normalize_batch
        from lrcn_jax.models.vgg import vgg16_fc7
        from lrcn_jax.models.vgg import l1_normalize as l1_dev

        n = len(images)
        pad = self._encode.max_batch
        batch = np.zeros((pad, 224, 224, 3), np.uint8)
        batch[:n] = np.asarray(images, np.uint8)
        if self.mesh is not None:   # batch-shard the encoder over chips
            # host -> sharded directly (no default-device hop)
            from jax.sharding import NamedSharding, PartitionSpec as P
            dev_batch = jax.device_put(
                batch, NamedSharding(self.mesh, P("data")))
        else:
            dev_batch = jnp.asarray(batch)
        pixels = normalize_batch(dev_batch,
                                 jnp.asarray(self.average_image))
        feats = l1_dev(vgg16_fc7(self.vgg_params, pixels,
                                 self.compute_dtype))
        return n, feats

    def _encode_finalize(self, raw) -> list[np.ndarray]:
        n, feats = raw
        return list(np.asarray(feats, np.float32)[:n])

    # --- request side ---

    def caption_features(self, feats: Sequence[np.ndarray]) -> list[str]:
        """Caption raw fc7 rows.

        Rows are L1-normalized here, exactly like the reference's live
        path (``input/sum(input)``, lrcn.jl:597) — the decoder was
        trained on normalized features, and every other entry point
        (ids, images) normalizes too.  Pre-normalized input is a no-op
        (fc7 is post-ReLU, so a normalized row re-normalizes to itself).
        """
        rows = [np.asarray(f, np.float32).reshape(-1) for f in feats]
        for row in rows:
            if row.shape[0] != self.cfg.cnn_feature_dim:
                raise ValueError(
                    f"feature row has {row.shape[0]} dims, model expects "
                    f"{self.cfg.cnn_feature_dim}")
        if not rows:
            return []
        # one vectorized normalize over the request, not a per-row loop
        return self._submit_decode(list(l1_normalize(np.stack(rows))))

    def _submit_decode(self, rows: Sequence[np.ndarray]) -> list[str]:
        """Decode already-normalized fc7 rows through the batcher."""
        return self._await_all([self._decode.submit(r) for r in rows])

    def caption_ids(self, image_ids: Sequence[int]) -> list[str]:
        if self.store is None:
            raise RuntimeError("service has no feature store")
        if self._rows_batcher is not None:
            rows = self.store.rows(image_ids)   # KeyError on unknown ids
            return self._await_all(
                [self._rows_batcher.submit(int(r)) for r in rows])
        feats = [self.store.get(int(i)) for i in image_ids]
        if not self.store.normalized:
            feats = [l1_normalize(r[None])[0] for r in feats]
        return self._submit_decode(feats)

    def caption_images(self, images: Sequence[np.ndarray]) -> list[str]:
        """(224,224,3) uint8 arrays -> captions (encode stage + decode)."""
        if self._encode is None:
            raise RuntimeError("service has no encoder (pass vgg_params)")
        feat_futs = [self._encode.submit(np.asarray(img, np.uint8))
                     for img in images]
        # encoder output is already L1-normalized (see _encode_fn)
        return self._submit_decode(self._await_all(feat_futs))

    def caption_image_bytes(self, blobs: Sequence[bytes]) -> list[str]:
        """Raw encoded image bytes (JPEG/PNG) -> captions.

        Decodes through :func:`lrcn_jax.data.images.load_blobs` (the
        threaded native JPEG loader, PIL rescue) — the same path the
        HTTP image endpoints use, so serving and this contract method
        stay pixel-identical."""
        from lrcn_jax.data.images import load_blobs

        images, ok = load_blobs(blobs)
        bad = np.flatnonzero(~ok)
        if bad.size:
            raise ValueError(
                f"could not decode image bytes "
                f"(blob{'s' if bad.size > 1 else ''} "
                f"{', '.join(str(int(i)) for i in bad)})")
        return self.caption_images(list(images))

    def _await_all(self, futs: list, timeout_s: float | None = None
                   ) -> list:
        """Wait for every future; on timeout CANCEL the not-yet-batched
        remainder so the device never dispatches work whose client is
        gone (under overload that dead work would livelock throughput)."""
        try:
            return [f.result(timeout=timeout_s or self.request_timeout_s)
                    for f in futs]
        except Exception:
            for f in futs:
                f.cancel()
            raise

    # --- ops ---

    def warmup(self, timeout_s: float = 600.0) -> None:
        """Compile every serving program before taking traffic.

        Uses its own generous ``timeout_s``: a cold first compile on a
        slow runtime can exceed ``request_timeout_s`` (which bounds
        STEADY-STATE requests, not compilation — warming up is exactly
        when that would misfire)."""
        self._await_all(
            [self._decode.submit(
                np.zeros(self.cfg.cnn_feature_dim, np.float32))],
            timeout_s=timeout_s)
        self.warmup_feature_burst_shapes()
        if self._rows_batcher is not None:
            self._await_all([self._rows_batcher.submit(0)],
                            timeout_s=timeout_s)
            self.warmup_burst_shapes()
        if self._encode is not None:
            feat = self._await_all(
                [self._encode.submit(np.zeros((224, 224, 3), np.uint8))],
                timeout_s=timeout_s)[0]
            self._await_all([self._decode.submit(feat)],
                            timeout_s=timeout_s)

    def warmup_burst_shapes(self) -> None:
        """Compile every grouped burst shape (g=2..MAX_DECODE_GROUPS) so
        traffic spikes never recompile.  Idempotent (compilation cache);
        called by :meth:`warmup` and by the native front-end."""
        if self._table is None:
            return
        if getattr(self, "_burst_warm", False):
            return
        # g=1 included: the native front-end calls this at startup
        # WITHOUT a prior warmup(), and its first id request must not
        # pay the single-batch rows compile inside the request timeout
        for g in range(1, self.MAX_DECODE_GROUPS + 1):
            self._decode_finalize(self._decode_rows_grouped(
                [0] * (self.decode_batch * (g - 1) + 1)))
        self._burst_warm = True

    def stats(self) -> dict:
        out = {"decode": self._decode.stats.snapshot()}
        if self._rows_batcher is not None:
            out["decode_ids"] = self._rows_batcher.stats.snapshot()
        if self._encode is not None:
            out["encode"] = self._encode.stats.snapshot()
        return out

    def close(self) -> None:
        self._decode.close()
        if self._rows_batcher is not None:
            self._rows_batcher.close()
        if self._encode is not None:
            self._encode.close()
