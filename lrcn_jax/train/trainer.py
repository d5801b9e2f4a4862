"""Training engine: jitted value_and_grad steps, Adam, epoch loop.

Replaces the reference's host-driven training (``train!``/``train1``,
lrcn.jl:223-405) with:

- a single jitted train step (loss + grad + optimizer update) with donated
  params/opt-state buffers — the whole per-token hot loop the reference ran
  as one kernel-launch chain per timestep lives inside one XLA program;
- optax Adam (one shared Adam is equivalent to the reference's per-param
  ``Adam()`` list, lrcn.jl:399-405) with REAL gradient clipping when
  ``gclip > 0`` (the reference parses --gclip but its clipping is commented
  out, lrcn.jl:386-393);
- per-epoch checkpointing and train/val average loss, logged as JSONL
  (reference: lrcn.jl:228-239);
- double-buffered host->HBM feature feed (data/pipeline.py).
"""

from __future__ import annotations

import functools
import time
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data.batcher import Batch, chunk_same_shape, iterate_epoch
from lrcn_jax.data.feature_store import FeatureStore
from lrcn_jax.data.pipeline import prefetch_to_device
from lrcn_jax.models import lrcn
from lrcn_jax.train.checkpoint import (
    make_position,
    resume_start,
    save_checkpoint,
)
from lrcn_jax.train.metrics import MetricsLogger


def make_optimizer(cfg: LRCNConfig) -> optax.GradientTransformation:
    steps = []
    if cfg.gclip and cfg.gclip > 0:
        steps.append(optax.clip_by_global_norm(cfg.gclip))
    steps.append(optax.adam(cfg.lr))
    return optax.chain(*steps)


class Trainer:
    """Single-device by default; pass ``mesh`` to train sharded (DP x TP).

    With a mesh, steps route through ``parallel.ShardedTrainStep``: the
    batch shards over the ``data`` axis and the vocab-sized params over
    ``model`` (the reference has no multi-device story; SURVEY.md §2).
    """

    def __init__(self, cfg: LRCNConfig, vocab: Vocab,
                 metrics: MetricsLogger | None = None, mesh=None,
                 pipeline: bool = False, steps_per_dispatch: int = 1):
        self.cfg = cfg
        self.vocab = vocab
        self.metrics = metrics or MetricsLogger()
        self.opt = make_optimizer(cfg)
        self._compute_dtype = jnp.dtype(cfg.compute_dtype)
        self._sharded = None
        self._pipeline = pipeline and mesh is not None
        self._mesh = mesh
        # K > 1: run K optimizer steps per device dispatch (lax.scan over
        # stacked same-shape batches) with the feature table resident in
        # HBM — host dispatch overhead and the per-step feature upload
        # both amortize away (see train_epoch for the ordering caveat).
        # Not combined with the pipeline step (its own shard_map program).
        if self._pipeline and steps_per_dispatch > 1:
            import warnings
            warnings.warn(
                "steps_per_dispatch > 1 is not supported with pipeline "
                "parallelism; running 1 step per dispatch", stacklevel=2)
        self.steps_per_dispatch = (1 if self._pipeline
                                   else max(1, steps_per_dispatch))
        self._multi_step = None
        self._table_cache = None   # (weakref to store, device table)
        self._multi_eval = None
        if self.steps_per_dispatch > 1:
            kwargs = {}
            ev_kwargs = {}
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                rep = NamedSharding(mesh, P())
                kwargs["out_shardings"] = (None, None, rep)
                ev_kwargs["out_shardings"] = (rep, rep)
            self._multi_step = jax.jit(
                functools.partial(self._multi_step_impl, pdrop=cfg.dropout),
                donate_argnums=(0, 1), **kwargs)
            self._multi_eval = jax.jit(self._multi_eval_impl, **ev_kwargs)
        if self._pipeline:
            # PP over the 2 LSTM layers + vocab TP on 'model', DP on 'data'
            # (parallel/pipeline.py); same host-facing step API.
            from lrcn_jax.parallel.pipeline import PipelinedTrainStep
            self._sharded = PipelinedTrainStep(cfg, self.opt, mesh)
            self._train_step = self._sharded
            self._eval_step = self._sharded.eval_batch
        elif mesh is not None:
            from lrcn_jax.parallel.train import ShardedTrainStep
            self._sharded = ShardedTrainStep(cfg, self.opt, mesh)
            self._train_step = self._sharded
            self._eval_step = self._sharded.eval_batch
        else:
            self._train_step = jax.jit(
                functools.partial(self._step_impl, pdrop=cfg.dropout),
                donate_argnums=(0, 1))
            self._eval_step = jax.jit(self._eval_impl)

    # --- jitted kernels ---

    def _step_impl(self, params, opt_state, tokens, lengths, feats, rng,
                   pdrop):
        loss, grads = jax.value_and_grad(lrcn.loss_fn)(
            params, tokens, lengths, feats, pdrop=pdrop, rng=rng,
            compute_dtype=self._compute_dtype)
        updates, opt_state = self.opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    def _eval_impl(self, params, tokens, lengths, feats):
        return lrcn.loss_total_count(params, tokens, lengths, feats,
                                     pdrop=0.0,
                                     compute_dtype=self._compute_dtype)

    def _multi_step_impl(self, params, opt_state, tokens_k, lengths_k,
                         rows_k, table, base_rng, offset, pdrop):
        """K train steps in ONE dispatch: scan over stacked batches.

        Features are gathered on device from the HBM-resident ``table`` by
        row index — the host feeds a few KB of int32 per dispatch instead
        of megabytes of fc7 rows per step.  Per-step dropout keys derive
        from (base_rng, offset) INSIDE the dispatch: a host-side
        ``jax.random.split`` per chunk would cost two tiny device round
        trips per dispatch.
        """
        k = tokens_k.shape[0]
        rngs_k = jax.vmap(
            lambda i: jax.random.fold_in(base_rng, offset + i)
        )(jnp.arange(k))

        def body(carry, xs):
            params, opt_state = carry
            tokens, lengths, rows, rng = xs
            feats = table[rows]
            loss, grads = jax.value_and_grad(lrcn.loss_fn)(
                params, tokens, lengths, feats, pdrop=pdrop, rng=rng,
                compute_dtype=self._compute_dtype)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), (tokens_k, lengths_k, rows_k, rngs_k))
        return params, opt_state, losses

    def _multi_eval_impl(self, params, tokens_k, lengths_k, rows_k, table):
        """Summed (total, count) over K stacked eval batches, one dispatch."""
        def body(carry, xs):
            total, count = carry
            tokens, lengths, rows = xs
            t, c = lrcn.loss_total_count(
                params, tokens, lengths, table[rows], pdrop=0.0,
                compute_dtype=self._compute_dtype)
            return (total + t, count + c), None
        (total, count), _ = jax.lax.scan(
            body, (jnp.zeros(()), jnp.zeros(())),
            (tokens_k, lengths_k, rows_k))
        return total, count

    # --- host loop ---

    def init(self, rng: jax.Array):
        params = lrcn.init_params(rng, self.cfg)
        if self._sharded is not None:
            params = self._sharded.shard_params(params)
            return params, self._sharded.init_opt(params)
        return params, self.opt.init(params)

    def _device_batches(self, batches, store: FeatureStore,
                        rng: np.random.Generator | None):
        if self._sharded is not None:
            shard = self._sharded.shard_batch
            transform = lambda b: shard(
                b.tokens, b.lengths, store.gather(b.image_ids))
        else:
            def transform(batch: Batch):
                return (jnp.asarray(batch.tokens),
                        jnp.asarray(batch.lengths),
                        jnp.asarray(store.gather(batch.image_ids),
                                    jnp.float32))
        return prefetch_to_device(iterate_epoch(batches, rng), size=2,
                                  transform=transform)

    def _device_table(self, store: FeatureStore) -> jax.Array:
        """The store's feature table, HBM-resident (replicated on a mesh).

        Cached via a weak reference — keying by ``id(store)`` would both
        pin a dead store's table in HBM and risk serving a stale table if
        CPython recycles the address for a new store.
        """
        import weakref

        cached = self._table_cache
        if cached is None or cached[0]() is not store:
            if self._mesh is not None:
                # host -> replicated put (committing to the default
                # device first would be an extra copy, and wrong
                # multi-process)
                from jax.sharding import NamedSharding, PartitionSpec as P
                table = jax.device_put(
                    np.asarray(store.table()),
                    NamedSharding(self._mesh, P()))
            else:
                table = jnp.asarray(store.table())
            self._table_cache = (weakref.ref(store), table)
        return self._table_cache[1]

    def _multi_step_chunks(self, batches: Sequence[Batch],
                           rng: np.random.Generator | None):
        """Same-shape stacks of K batches + tail (data/batcher.py)."""
        return chunk_same_shape(batches, self.steps_per_dispatch, rng)

    def _put_batch_arrays(self, *arrays):
        if self._mesh is None:
            return tuple(jnp.asarray(a) for a in arrays)
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(self._mesh, P(None, "data"))
        # host -> sharded put directly (see parallel.train.put_batch)
        return tuple(jax.device_put(np.asarray(a), sh) for a in arrays)

    def train_epoch(self, params, opt_state, batches: Sequence[Batch],
                    store: FeatureStore, rng_key: jax.Array,
                    shuffle_rng: np.random.Generator,
                    log_every: int = 200, start_dispatch: int = 0,
                    ckpt_every: int | None = None,
                    on_checkpoint=None) -> tuple:
        """One epoch over shuffled batches (reference: train1, lrcn.jl:330-397).

        ``start_dispatch`` resumes mid-epoch: the first N dispatches are
        skipped without host work, and because the batch order derives
        from ``shuffle_rng``'s epoch-start state and every step key is
        index-derived (random access, no split chain), the resumed run
        replays the exact same computation.  ``on_checkpoint(dispatch,
        params, opt_state)`` fires every ``ckpt_every`` dispatches.
        """
        t0 = time.time()
        tokens_seen = 0
        single_step_batches = batches
        single_step_rng = shuffle_rng
        n_chunks = 0

        def maybe_ckpt(dispatch, p, o):
            if ckpt_every and on_checkpoint and dispatch % ckpt_every == 0:
                jax.block_until_ready(p)
                on_checkpoint(dispatch, p, o)

        if self._multi_step is not None:
            chunks, tail = self._multi_step_chunks(batches, shuffle_rng)
            n_chunks = len(chunks)
            table = self._device_table(store)
            offset = 0
            for ci, chunk in enumerate(chunks):
                if ci < start_dispatch:     # resumed: already trained
                    offset += len(chunk)
                    continue
                tokens_k = np.stack([b.tokens for b in chunk])
                lengths_k = np.stack([b.lengths for b in chunk])
                rows_k = np.stack([store.rows(b.image_ids) for b in chunk])
                dev = self._put_batch_arrays(tokens_k, lengths_k, rows_k)
                params, opt_state, losses = self._multi_step(
                    params, opt_state, *dev, table, rng_key,
                    np.int32(offset))
                offset += len(chunk)
                tokens_seen += int(np.sum(np.maximum(lengths_k, 0)))
                if log_every and (ci * len(chunk)) % log_every < len(chunk):
                    self.metrics.log(
                        event="train", batch=ci * len(chunk),
                        loss=round(float(losses[-1]), 4),
                        words_per_sec=round(
                            tokens_seen / (time.time() - t0), 1))
                maybe_ckpt(ci + 1, params, opt_state)
            rng_key = jax.random.fold_in(rng_key, offset + 1)
            single_step_batches = tail   # per-shape remainders
            single_step_rng = None       # already shuffled
        # single-step path: materialize the (possibly shuffled) order so
        # a resume can slice past completed batches; step keys derive
        # from (epoch key, index) so the stream is position-addressable
        order = list(iterate_epoch(single_step_batches, single_step_rng))
        skip_single = max(0, start_dispatch - n_chunks)
        single_base = rng_key
        for i, (tokens, lengths, feats) in enumerate(
                self._device_batches(order[skip_single:], store, None)):
            j = skip_single + i
            step_key = jax.random.fold_in(single_base, j)
            params, opt_state, loss = self._train_step(
                params, opt_state, tokens, lengths, feats, step_key)
            # count from the HOST batch: device lengths may be sharded
            # across processes (not addressable here)
            tokens_seen += int(np.sum(
                np.maximum(order[skip_single + i].lengths, 0)))
            if log_every and j % log_every == 0:
                self.metrics.log(event="train", batch=j,
                                 loss=round(float(loss), 4),
                                 words_per_sec=round(
                                     tokens_seen / (time.time() - t0), 1))
            maybe_ckpt(n_chunks + j + 1, params, opt_state)
        rng_key = jax.random.fold_in(single_base, len(order) + 1)
        jax.block_until_ready(params)
        self.metrics.log(event="epoch_train_done",
                         batches=len(batches),
                         words_per_sec=round(
                             tokens_seen / (time.time() - t0), 1))
        return params, opt_state, rng_key

    def average_loss(self, params, batches: Sequence[Batch],
                     store: FeatureStore) -> float:
        """Dataset-level mean NLL (reference: average_loss, lrcn.jl:407-486).

        With ``steps_per_dispatch > 1``, same-shape batches evaluate in
        scanned multi-batch dispatches (device-resident feature table);
        per-shape remainders go through the single-batch path.
        """
        total, count = 0.0, 0.0
        single = batches
        if self._multi_eval is not None:
            chunks, single = self._multi_step_chunks(batches, None)
            table = self._device_table(store)
            partials = []
            for chunk in chunks:
                dev = self._put_batch_arrays(
                    np.stack([b.tokens for b in chunk]),
                    np.stack([b.lengths for b in chunk]),
                    np.stack([store.rows(b.image_ids) for b in chunk]))
                partials.append(self._multi_eval(params, *dev, table))
            for t, c in partials:   # fetch after every dispatch is queued
                total += float(t)
                count += float(c)
        for tokens, lengths, feats in self._device_batches(
                single, store, None):
            t, c = self._eval_step(params, tokens, lengths, feats)
            total += float(t)
            count += float(c)
        return total / max(count, 1.0)

    def fit(self, params, opt_state, train_batches: Sequence[Batch],
            val_batches: Sequence[Batch] | None,
            train_store: FeatureStore, val_store: FeatureStore | None,
            rng_key: jax.Array, *, epochs: int | None = None,
            savefile: str | None = None, bestfile: str | None = None,
            eval_train_loss: bool = True, ckpt_every: int | None = None,
            resume_position: dict | None = None,
            completed_epochs: int = 0) -> tuple:
        """Full training loop (reference: train!, lrcn.jl:223-246).

        ``bestfile``: additionally checkpoint whenever the epoch's
        validation loss improves.  (The reference's stale variant declared
        ``--bestfile`` and lrcn.jl:63 still references it without declaring
        the flag — a latent KeyError; here it works.)

        ``ckpt_every``: also checkpoint every N dispatches WITHIN an
        epoch (the reference only saves per epoch, lrcn.jl:228-231 — on
        a large corpus a crash loses the whole epoch).  The save carries
        a resume position (epoch, dispatch, shuffle state, epoch key);
        passing it back as ``resume_position`` replays the interrupted
        epoch from that dispatch, bit-exact with the uninterrupted run.
        Epoch-complete saves clear the position.
        """
        import copy

        from lrcn_jax.parallel.distributed import shared_seed

        epochs = epochs if epochs is not None else self.cfg.epochs
        # multi-process: unseeded runs broadcast process 0's entropy so
        # every process shuffles identically (distributed.shared_seed)
        seed = shared_seed(self.cfg.seed if self.cfg.seed > 0 else None)
        shuffle_rng = np.random.default_rng(seed)
        best_val = float("inf")
        geometry = {"steps_per_dispatch": self.steps_per_dispatch,
                    "n_batches": len(train_batches)}
        start_epoch, start_dispatch, rng_key = resume_start(
            resume_position, shuffle_rng, rng_key, geometry)
        # On ANY resume, `epochs` is the TOTAL budget: re-running the
        # identical `lrcn train --epochs N --loadfile ...` after a crash
        # finishes at epoch N, not start+N-1.  Mid-epoch positions carry
        # their own epoch; epoch-complete checkpoints pass the finished
        # count as ``completed_epochs`` (epoch labels continue from it).
        # Fresh runs have start_epoch == 1 so the range is 1..N.
        if not resume_position and completed_epochs:
            start_epoch = completed_epochs + 1
        resumed = bool(resume_position) or completed_epochs > 0
        end_epoch = epochs if resumed else start_epoch + epochs - 1
        if start_epoch > end_epoch:
            print(f"train: checkpoint already covers {completed_epochs} "
                  f"of the {epochs}-epoch budget — nothing to do "
                  f"(raise --epochs to continue training)")
            return params, opt_state
        for epoch in range(start_epoch, end_epoch + 1):
            epoch_state = copy.deepcopy(shuffle_rng.bit_generator.state)
            epoch_key = np.asarray(rng_key)

            def on_ckpt(dispatch, p, o, _epoch=epoch,
                        _state=epoch_state, _key=epoch_key):
                cp = (self._sharded.unshard_params(p)
                      if self._pipeline else p)
                save_checkpoint(
                    savefile, cp, self.vocab, self.cfg, opt_state=o,
                    epoch=_epoch - 1,
                    position=make_position(_epoch, dispatch, _state,
                                           _key, geometry))
                self.metrics.log(event="ckpt", epoch=_epoch,
                                 dispatch=dispatch)

            params, opt_state, rng_key = self.train_epoch(
                params, opt_state, train_batches, train_store, rng_key,
                shuffle_rng,
                start_dispatch=(start_dispatch
                                if epoch == start_epoch else 0),
                ckpt_every=ckpt_every if savefile else None,
                on_checkpoint=on_ckpt if savefile else None)
            # pipeline-layout params convert back to the standard decoder
            # pytree so checkpoints stay layout-independent (the opt state
            # keeps the training layout; resuming with a different layout
            # resets it with a printed note)
            ckpt_params = (self._sharded.unshard_params(params)
                           if self._pipeline else params)
            if savefile:
                save_checkpoint(savefile, ckpt_params, self.vocab, self.cfg,
                                opt_state=opt_state, epoch=epoch)
            record = {"event": "epoch", "epoch": epoch}
            if eval_train_loss:
                record["train_loss"] = round(
                    self.average_loss(params, train_batches, train_store), 4)
            if val_batches is not None and val_store is not None:
                val_loss = self.average_loss(params, val_batches, val_store)
                record["val_loss"] = round(val_loss, 4)
                if bestfile and val_loss < best_val:
                    best_val = val_loss
                    save_checkpoint(bestfile, ckpt_params, self.vocab,
                                    self.cfg, opt_state=opt_state,
                                    epoch=epoch)
                    record["best"] = True
            self.metrics.log(**record)
        return params, opt_state
