"""Joint CNN+LSTM fine-tuning: end-to-end gradients through VGG-16.

The reference never fine-tunes the CNN — it extracts fc7 features offline
(lrcn.jl:190-221) and trains only the decoder.  The vendored paper's
strongest configuration (LRCN 2f, 1411.4389.pdf Table 6; SURVEY.md §6) DOES
fine-tune the vision encoder jointly, so this module provides that as a
first-class training path:

- one jitted step: images -> vgg16_fc7 -> L1-normalize -> decoder loss,
  with ``jax.value_and_grad`` over BOTH parameter sets;
- ``jax.checkpoint`` on the VGG forward trades recompute for device memory
  (activations of 13 convs at 224x224 otherwise dominate memory);
- separate learning rates for encoder/decoder via one optax ``multi_transform``
  (the paper uses a reduced CNN lr during fine-tuning), and
  ``freeze_cnn=True`` degenerates to feature-extraction-equivalent training;
- data parallel over a mesh: batch sharded on ``data``, both param sets
  replicated (VGG's 134M params are the bulk; replication is right at this
  scale), gradient all-reduce inserted by GSPMD propagation.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from lrcn_jax.config import LRCNConfig
from lrcn_jax.models import lrcn, vgg


class JointParams(NamedTuple):
    cnn: Any      # VGG-16 params (models/vgg.py)
    decoder: Any  # LRCN decoder params (models/lrcn.py)


def joint_loss(params: JointParams, images: jax.Array, tokens: jax.Array,
               lengths: jax.Array, *, pdrop: float = 0.0,
               rng: jax.Array | None = None,
               compute_dtype=jnp.bfloat16,
               remat_cnn: bool = True) -> jax.Array:
    """Mean NLL of captions given raw preprocessed images."""
    fwd = functools.partial(vgg.vgg16_fc7_fn, compute_dtype=compute_dtype)
    if remat_cnn:
        fwd = jax.checkpoint(fwd)
    feats = fwd(params.cnn, images)
    feats = vgg.l1_normalize(feats)       # live-path normalization, lrcn.jl:597
    return lrcn.loss_fn(params.decoder, tokens, lengths, feats,
                        pdrop=pdrop, rng=rng, compute_dtype=compute_dtype)


def make_joint_optimizer(cfg: LRCNConfig, *, cnn_lr: float | None = None,
                         freeze_cnn: bool = False
                         ) -> optax.GradientTransformation:
    """Adam with a separate (usually smaller) CNN learning rate.

    ``cnn_lr`` defaults to ``cfg.lr / 10`` (fine-tuning convention);
    ``freeze_cnn`` zeroes CNN updates entirely.
    """
    if cnn_lr is None:
        cnn_lr = cfg.lr / 10.0
    cnn_opt = (optax.set_to_zero() if freeze_cnn
               else optax.adam(cnn_lr))
    tx = optax.multi_transform(
        {"cnn": cnn_opt, "decoder": optax.adam(cfg.lr)},
        JointParams(cnn="cnn", decoder="decoder"))
    if cfg.gclip and cfg.gclip > 0:
        return optax.chain(optax.clip_by_global_norm(cfg.gclip), tx)
    return tx


class JointTrainStep:
    """Jitted end-to-end train step (optionally over a mesh).

    Images are fed RAW — uint8 pixels (or 255-scaled float32); the
    mean-image subtraction runs on device inside the jitted step, so the
    host ships a quarter of the bytes a float32 feed would.

    With a mesh, images/tokens/lengths shard over the ``data`` axis and
    params replicate; pass batches through ``shard_batch``.

    ``multi_step`` runs K optimizer steps in ONE dispatch (``lax.scan``
    over stacked same-shape batches) — the same dispatch-amortization
    that lifted the decoder trainer 4.3x (train/trainer.py).
    """

    def __init__(self, cfg: LRCNConfig, opt: optax.GradientTransformation,
                 mesh=None, remat_cnn: bool = True, average_image=None):

        self.cfg = cfg
        self.opt = opt
        self.mesh = mesh
        self._compute_dtype = jnp.dtype(cfg.compute_dtype)
        self._remat = remat_cnn
        avg = (np.zeros((224, 224, 3), np.float32) if average_image is None
               else np.asarray(average_image, np.float32))
        kwargs = {}
        multi_kwargs = {}
        ev_kwargs = {}
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(mesh, P())
            # host -> replicated directly (a default-device commit first
            # would break when the mesh spans processes)
            self._avg = jax.device_put(avg, rep)
            kwargs["out_shardings"] = (None, None, rep)
            multi_kwargs["out_shardings"] = (None, None, rep)
            ev_kwargs["out_shardings"] = (rep, rep)
        else:
            self._avg = jnp.asarray(avg)
        self._step = jax.jit(self._step_impl, donate_argnums=(0, 1),
                             **kwargs)
        self._multi = jax.jit(self._multi_step_impl, donate_argnums=(0, 1),
                              **multi_kwargs)
        self._eval = jax.jit(self._eval_impl, **ev_kwargs)

    def _preprocess(self, images):
        """uint8/float raw pixels -> float32 mean-subtracted (lrcn.jl:771)."""
        return images.astype(jnp.float32) - self._avg

    def _grad_step(self, params, opt_state, images, tokens, lengths, rng):
        loss, grads = jax.value_and_grad(joint_loss)(
            params, self._preprocess(images), tokens, lengths,
            pdrop=self.cfg.dropout, rng=rng,
            compute_dtype=self._compute_dtype, remat_cnn=self._remat)
        updates, opt_state = self.opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    def _step_impl(self, params, opt_state, images, tokens, lengths, rng):
        return self._grad_step(params, opt_state, images, tokens, lengths,
                               rng)

    def _multi_step_impl(self, params, opt_state, images_k, tokens_k,
                         lengths_k, base_rng, offset):
        """K train steps in one dispatch; per-step dropout keys derive
        from (base_rng, offset) inside the program (a host-side split per
        chunk would add device round trips — see the decoder trainer's
        identical note, train/trainer.py)."""
        k = tokens_k.shape[0]
        rngs_k = jax.vmap(
            lambda i: jax.random.fold_in(base_rng, offset + i)
        )(jnp.arange(k))

        def body(carry, xs):
            params, opt_state = carry
            images, tokens, lengths, rng = xs
            params, opt_state, loss = self._grad_step(
                params, opt_state, images, tokens, lengths, rng)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state),
            (images_k, tokens_k, lengths_k, rngs_k))
        return params, opt_state, losses

    def _eval_impl(self, params, images, tokens, lengths):
        feats = vgg.l1_normalize(vgg.vgg16_fc7_fn(
            params.cnn, self._preprocess(images),
            compute_dtype=self._compute_dtype))
        return lrcn.loss_total_count(
            params.decoder, tokens, lengths, feats, pdrop=0.0,
            compute_dtype=self._compute_dtype)

    def init(self, rng: jax.Array, vgg_params=None) -> tuple:
        k1, k2 = jax.random.split(rng)
        if vgg_params is None:
            vgg_params = vgg.init_vgg_params(k1)
        params = JointParams(vgg_params,
                             lrcn.init_params(k2, self.cfg))
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            params = jax.device_put(
                params, NamedSharding(self.mesh, P()))
        return params, self.opt.init(params)

    def _put(self, array, *, batch_axis: int):
        if self.mesh is None:
            # async upload to the default device from the prefetch thread
            return jnp.asarray(array)
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = [None] * batch_axis + ["data"]
        return jax.device_put(array, NamedSharding(self.mesh, P(*spec)))

    def _as_image_array(self, images):
        # host-side until _put: with a mesh the sharded device_put
        # extracts this process's rows (pre-committing to the default
        # device breaks when the mesh spans processes); without one the
        # commit happens in _put
        images = np.asarray(images)
        if images.dtype != np.uint8:   # already-scaled float pixels
            images = images.astype(np.float32)
        return images

    def shard_batch(self, images, tokens, lengths):
        """Raw image pixels (uint8 preferred) + tokens -> device arrays."""
        return (self._put(self._as_image_array(images), batch_axis=0),
                self._put(np.asarray(tokens, np.int32), batch_axis=0),
                self._put(np.asarray(lengths, np.int32), batch_axis=0))

    def shard_chunk(self, images_k, tokens_k, lengths_k):
        """K stacked batches for ``multi_step`` (leading scan axis)."""
        return (self._put(self._as_image_array(images_k), batch_axis=1),
                self._put(np.asarray(tokens_k, np.int32), batch_axis=1),
                self._put(np.asarray(lengths_k, np.int32), batch_axis=1))

    def __call__(self, params, opt_state, images, tokens, lengths, rng):
        return self._step(params, opt_state, images, tokens, lengths, rng)

    def multi_step(self, params, opt_state, images_k, tokens_k, lengths_k,
                   base_rng, offset):
        return self._multi(params, opt_state, images_k, tokens_k,
                           lengths_k, base_rng, np.int32(offset))

    def eval_batch(self, params, images, tokens, lengths):
        """(total NLL, token count) for one batch, images preprocessed
        on device; compiled once (a per-call closure would retrace every
        validation pass)."""
        return self._eval(params, images, tokens, lengths)
