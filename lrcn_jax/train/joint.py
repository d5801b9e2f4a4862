"""Joint CNN+LSTM fine-tune loop: the paper's strongest configuration.

The reference never fine-tunes the CNN (features are extracted offline,
lrcn.jl:190-221), but the vendored paper's best result (LRCN-2f, VGGNet,
1411.4389.pdf Table 6) trains the vision encoder jointly.  This module
provides the epoch loop around ``models/joint.py``'s jitted end-to-end
step, exposed to users as ``lrcn train --joint``:

- caption batches come from the same length-bucketed batcher as decoder
  training; each batch's image ids resolve to image files which are
  decoded on the host (native JPEG loader with PIL fallback) and fed as
  uint8 — the mean-subtract preprocessing runs on device inside the
  jitted step (a quarter of the float32 transfer bytes);
- host decode overlaps with device compute via a prefetch pool
  (``prefetch_depth`` loads in flight; the decode is the hot host path:
  13 convs' worth of device work per batch buys a lot of overlap budget);
- ``steps_per_dispatch > 1`` stacks K same-shape batches and runs K
  optimizer steps per device dispatch (``lax.scan``), amortizing the CI
  runtime's per-dispatch round trip exactly like the decoder trainer
  (train/trainer.py);
- per-epoch checkpoints carry BOTH parameter sets (cnn/ + decoder/ key
  prefixes in params.npz) plus vocab and config.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import jax
import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data.batcher import (
    Batch,
    chunk_same_shape,
    iterate_epoch,
)
from lrcn_jax.models.joint import (
    JointParams,
    JointTrainStep,
    make_joint_optimizer,
)
from lrcn_jax.train.checkpoint import (
    make_position,
    resume_start,
    save_checkpoint,
)
from lrcn_jax.train.metrics import MetricsLogger


class JointTrainer:
    """Epoch loop for end-to-end (images -> captions) fine-tuning."""

    def __init__(self, cfg: LRCNConfig, vocab: Vocab,
                 image_paths: dict[int, str], average_image: np.ndarray,
                 metrics: MetricsLogger | None = None, mesh=None,
                 cnn_lr: float | None = None, freeze_cnn: bool = False,
                 steps_per_dispatch: int = 1, prefetch_depth: int = 2,
                 remat_cnn: bool = True):
        self.cfg = cfg
        self.vocab = vocab
        self.image_paths = image_paths
        self.average_image = np.asarray(average_image, np.float32)
        self.metrics = metrics or MetricsLogger()
        self.opt = make_joint_optimizer(cfg, cnn_lr=cnn_lr,
                                        freeze_cnn=freeze_cnn)
        self.step = JointTrainStep(cfg, self.opt, mesh=mesh,
                                   average_image=self.average_image,
                                   remat_cnn=remat_cnn)
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        self.prefetch_depth = max(1, prefetch_depth)

    def init(self, rng: jax.Array, vgg_params=None,
             decoder_params=None) -> tuple:
        params, opt_state = self.step.init(rng, vgg_params=vgg_params)
        if decoder_params is not None:
            params = JointParams(params.cnn, decoder_params)
            opt_state = self.opt.init(params)
        return params, opt_state

    # --- host image feed ---

    def _load_images(self, batch: Batch) -> np.ndarray:
        """Decode the batch's images -> (B, 224, 224, 3) uint8 pixels.

        Mean subtraction happens ON DEVICE inside the jitted step
        (models/joint.py) — the host ships raw uint8.  Padded rows
        (length == -1, data/batcher.py) repeat the last real image id,
        so every id in ``batch.image_ids`` resolves.
        """
        from lrcn_jax.data.images import load_images

        return load_images(
            [self.image_paths[int(i)] for i in batch.image_ids])

    def _load_chunk(self, chunk: list[Batch]) -> tuple:
        """Host arrays for K stacked batches: (K,B,224,224,3) u8 + tokens."""
        return (np.stack([self._load_images(b) for b in chunk]),
                np.stack([b.tokens for b in chunk]),
                np.stack([b.lengths for b in chunk]))

    def _prefetched(self, items: list, load, transform):
        """Decode up to ``prefetch_depth`` items ahead of the device."""
        with ThreadPoolExecutor(max_workers=self.prefetch_depth) as pool:
            futures = deque(pool.submit(load, it)
                            for it in items[:self.prefetch_depth])
            for i in range(len(items)):
                host = futures.popleft().result()   # drop the ref: a kept
                # future pins its decoded (B,224,224,3) array for the epoch
                if i + self.prefetch_depth < len(items):
                    futures.append(
                        pool.submit(load, items[i + self.prefetch_depth]))
                yield transform(host)

    # --- loops ---

    def train_epoch(self, params, opt_state, batches: Sequence[Batch],
                    rng_key: jax.Array,
                    shuffle_rng: np.random.Generator | None,
                    log_every: int = 50, start_dispatch: int = 0,
                    ckpt_every: int | None = None,
                    on_checkpoint=None) -> tuple:
        """One fine-tune epoch; resumable mid-epoch exactly like the
        decoder trainer (train/trainer.py): ``start_dispatch`` skips
        completed dispatches (no image decode for them), step keys are
        position-derived, and ``on_checkpoint`` fires every
        ``ckpt_every`` dispatches."""
        t0 = time.time()
        seen = 0
        n_chunks = 0

        def maybe_ckpt(dispatch, p, o):
            if ckpt_every and on_checkpoint and dispatch % ckpt_every == 0:
                jax.block_until_ready(p)
                on_checkpoint(dispatch, p, o)

        if self.steps_per_dispatch == 1:
            single = list(iterate_epoch(batches, shuffle_rng))
        else:
            chunks, tail = chunk_same_shape(
                batches, self.steps_per_dispatch, shuffle_rng)
            n_chunks = len(chunks)
            skip = min(start_dispatch, n_chunks)
            offset = sum(len(c) for c in chunks[:skip])
            feed = self._prefetched(
                chunks[skip:], self._load_chunk,
                lambda host: self.step.shard_chunk(*host))
            for ci, (images_k, tokens_k, lengths_k) in enumerate(feed):
                params, opt_state, losses = self.step.multi_step(
                    params, opt_state, images_k, tokens_k, lengths_k,
                    rng_key, offset)
                offset += images_k.shape[0]
                seen += images_k.shape[0] * images_k.shape[1]
                gi = skip + ci
                if log_every and (gi * images_k.shape[0]) % log_every \
                        < images_k.shape[0]:
                    self.metrics.log(event="joint_train",
                                     batch=gi * images_k.shape[0],
                                     loss=round(float(losses[-1]), 4),
                                     images_per_sec=round(
                                         seen / (time.time() - t0), 1))
                maybe_ckpt(gi + 1, params, opt_state)
            rng_key = jax.random.fold_in(rng_key, offset + 1)
            single = tail   # per-shape remainders, already shuffled
        skip_single = max(0, start_dispatch - n_chunks)
        single_base = rng_key
        feed = self._prefetched(
            single[skip_single:], self._load_images,
            lambda imgs: imgs)   # shard with the batch below
        for i, (batch, images) in enumerate(zip(single[skip_single:],
                                                feed)):
            j = skip_single + i
            dev = self.step.shard_batch(images, batch.tokens, batch.lengths)
            step_key = jax.random.fold_in(single_base, j)
            params, opt_state, loss = self.step(
                params, opt_state, *dev, step_key)
            seen += dev[0].shape[0]
            if log_every and j % log_every == 0:
                self.metrics.log(event="joint_train", batch=j,
                                 loss=round(float(loss), 4),
                                 images_per_sec=round(
                                     seen / (time.time() - t0), 1))
            maybe_ckpt(n_chunks + j + 1, params, opt_state)
        rng_key = jax.random.fold_in(single_base, len(single) + 1)
        jax.block_until_ready(params)
        return params, opt_state, rng_key

    def average_loss(self, params, batches: Sequence[Batch]) -> float:
        """Mean per-token NLL over a split, images decoded on the fly.

        Uses the step's pre-compiled eval program (a fresh ``@jax.jit``
        closure here would retrace every validation pass).
        """
        total, count = 0.0, 0.0
        order = list(batches)
        feed = self._prefetched(order, self._load_images, lambda x: x)
        # bound in-flight dispatches: each queued batch pins its uint8
        # image buffer (19 MB at B=128) in device memory until executed,
        # so an unbounded queue OOMs a large val split whenever host
        # decode outpaces the device
        partials: deque = deque()
        max_inflight = 2 * self.prefetch_depth
        for batch, images in zip(order, feed):
            dev = self.step.shard_batch(images, batch.tokens, batch.lengths)
            partials.append(self.step.eval_batch(params, *dev))
            while len(partials) > max_inflight:
                t, c = partials.popleft()
                total += float(t)
                count += float(c)
        for t, c in partials:
            total += float(t)
            count += float(c)
        return total / max(count, 1.0)

    def fit(self, params, opt_state, train_batches: Sequence[Batch],
            val_batches: Sequence[Batch] | None, rng_key: jax.Array, *,
            epochs: int | None = None, savefile: str | None = None,
            bestfile: str | None = None, ckpt_every: int | None = None,
            resume_position: dict | None = None,
            completed_epochs: int = 0) -> tuple:
        """Epoch loop; ``ckpt_every``/``resume_position`` give the same
        crash-safe mid-epoch checkpointing as the decoder trainer."""
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
        # on ANY resume, `epochs` is the TOTAL budget (see Trainer.fit);
        # epoch-complete checkpoints continue their epoch labels via
        # ``completed_epochs``
        if not resume_position and completed_epochs:
            start_epoch = completed_epochs + 1
        resumed = bool(resume_position) or completed_epochs > 0
        end_epoch = epochs if resumed else start_epoch + epochs - 1
        if start_epoch > end_epoch:
            print(f"train --joint: checkpoint already covers "
                  f"{completed_epochs} of the {epochs}-epoch budget — "
                  f"nothing to do (raise --epochs to continue)")
            return params, opt_state
        for epoch in range(start_epoch, end_epoch + 1):
            epoch_state = copy.deepcopy(shuffle_rng.bit_generator.state)
            epoch_key = np.asarray(rng_key)

            def on_ckpt(dispatch, p, o, _epoch=epoch,
                        _state=epoch_state, _key=epoch_key):
                save_checkpoint(
                    savefile, p, self.vocab, self.cfg, opt_state=o,
                    epoch=_epoch - 1,
                    position=make_position(_epoch, dispatch, _state,
                                           _key, geometry))
                self.metrics.log(event="ckpt", epoch=_epoch,
                                 dispatch=dispatch)

            params, opt_state, rng_key = self.train_epoch(
                params, opt_state, train_batches, rng_key, shuffle_rng,
                start_dispatch=(start_dispatch
                                if epoch == start_epoch else 0),
                ckpt_every=ckpt_every if savefile else None,
                on_checkpoint=on_ckpt if savefile else None)
            if savefile:
                save_checkpoint(savefile, params, self.vocab, self.cfg,
                                opt_state=opt_state, epoch=epoch)
            record = {"event": "epoch", "epoch": epoch}
            if val_batches is not None:
                val_loss = self.average_loss(params, val_batches)
                record["val_loss"] = round(val_loss, 4)
                if bestfile and val_loss < best_val:
                    best_val = val_loss
                    save_checkpoint(bestfile, params, self.vocab, self.cfg,
                                    opt_state=opt_state, epoch=epoch)
                    record["best"] = True
            self.metrics.log(**record)
        return params, opt_state


def load_joint_params(raw_params: dict) -> JointParams:
    """Rebuild JointParams from a loaded checkpoint's nested param dict."""
    return JointParams(cnn=raw_params["cnn"], decoder=raw_params["decoder"])


def is_joint_checkpoint(raw_params: dict) -> bool:
    return isinstance(raw_params, dict) and set(raw_params) >= {
        "cnn", "decoder"}


def identity_average_image() -> np.ndarray:
    """Zero mean image for training without the MatConvNet .mat file."""
    return np.zeros((224, 224, 3), np.float32)


__all__ = [
    "JointTrainer",
    "load_joint_params",
    "is_joint_checkpoint",
    "identity_average_image",
]
