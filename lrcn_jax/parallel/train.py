"""Sharded training step: DP over ``data``, vocab-dim TP over ``model``.

The reference trains on one GPU with a host loop (train1, lrcn.jl:330-397).
Here one jitted XLA program runs the whole step across a device mesh:

- the batch (tokens/lengths/fc7 features) is sharded along the ``data`` axis;
  gradients for replicated parameters automatically all-reduce across it;
- the two vocabulary-sized parameters — the embedding table (V, E) and the
  output projection (H2, V)+bias — shard along ``model``; the (T·B, H2) @
  (H2, V) logits matmul (by far the decoder's largest) then runs as a
  column-parallel matmul, and the log-softmax reduction over the vocabulary
  becomes an XLA all-reduce along ``model``;
- optimizer state follows parameter sharding by propagation (``opt.init`` is
  jitted on already-sharded params, so Adam moments for the TP weights are
  themselves sharded, ZeRO-style).

Sharding is expressed once, as ``NamedSharding`` placements on the params and
the batch ("computation follows data"); GSPMD propagates through the jitted
step and chooses/places the collectives — the scaling-book recipe.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lrcn_jax.config import LRCNConfig
from lrcn_jax.models import lrcn

# PartitionSpec per decoder parameter.  The vocabulary dimension shards over
# "model"; everything else is replicated — at LRCN scale (~30M params) only
# the V-sized tensors are worth sharding.
PARAM_SPECS: dict[str, Any] = {
    "lstm1": {"w": P(), "b": P()},
    "lstm2": {"w": P(), "b": P()},
    "w_factor": P(),
    "w_cnn": P(),
    "embedding": P("model", None),
    "w_out": P(None, "model"),
    "b_out": P("model"),
}


def param_sharding(mesh: Mesh) -> dict[str, Any]:
    """NamedSharding pytree matching the decoder param pytree."""
    return jax.tree.map(lambda spec: NamedSharding(mesh, spec), PARAM_SPECS,
                        is_leaf=lambda x: isinstance(x, P))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-dimension sharding along the ``data`` axis."""
    return NamedSharding(mesh, P("data"))


def shard_params(params: lrcn.Params, mesh: Mesh) -> lrcn.Params:
    """Place a (host or single-device) param pytree onto the mesh."""
    return jax.device_put(params, param_sharding(mesh))


def place_opt_state(opt_state: Any, param_sharding_tree: Any,
                    mesh: Mesh) -> Any:
    """Place a freshly-initialized optimizer state onto the mesh.

    XLA does not propagate sharding through ``opt.init``'s zeros_like
    (fresh constants carry no operand sharding), so place the state
    explicitly: any leaf whose dict-path suffix names a parameter (e.g.
    Adam mu/nu live at ``...mu['lstm1']['w']``) gets that parameter's
    sharding; scalars and the rest replicate.
    """
    flat_p = {
        tuple(k.key for k in path): sh
        for path, sh
        in jax.tree_util.tree_flatten_with_path(param_sharding_tree)[0]
    }
    rep = NamedSharding(mesh, P())

    def place(path, leaf):
        keys = [k.key for k in path
                if isinstance(k, jax.tree_util.DictKey)]
        for start in range(len(keys)):
            sh = flat_p.get(tuple(keys[start:]))
            if sh is not None:
                return jax.device_put(leaf, sh)
        return jax.device_put(leaf, rep)

    return jax.tree_util.tree_map_with_path(place, opt_state)


def put_batch(mesh: Mesh, tokens, lengths, feats) -> tuple:
    """Device-put one (tokens, lengths, feats) batch sharded over 'data'.

    Inputs stay host-side until the sharded put: a ``jnp.asarray`` first
    would commit the full batch to the local default device, an extra
    copy single-host and a wrong intermediate multi-host (each process
    holds the same GLOBAL batch and the put extracts its local rows).
    """
    import numpy as np
    b_sh = batch_sharding(mesh)
    return (jax.device_put(np.asarray(tokens), b_sh),
            jax.device_put(np.asarray(lengths), b_sh),
            jax.device_put(np.asarray(feats, np.float32), b_sh))


class ShardedTrainStep:
    """A jitted multi-chip train step + eval step for the LRCN decoder.

    Usage::

        mesh = make_mesh((dp, tp))
        step = ShardedTrainStep(cfg, opt, mesh)
        params = step.shard_params(lrcn.init_params(key, cfg))
        opt_state = step.init_opt(params)
        params, opt_state, loss = step(params, opt_state,
                                       *step.shard_batch(tok, lens, feats),
                                       rng)

    The global batch size must be divisible by the ``data`` axis size, and
    the vocabulary size by the ``model`` axis size.
    """

    def __init__(self, cfg: LRCNConfig, opt: optax.GradientTransformation,
                 mesh: Mesh):
        tp = mesh.shape.get("model", 1)
        if cfg.vocab_size % tp:
            raise ValueError(
                f"vocab_size={cfg.vocab_size} must be divisible by the "
                f"'model' mesh axis ({tp}): the embedding table and output "
                f"projection shard their vocabulary dimension across it")
        self.cfg = cfg
        self.opt = opt
        self.mesh = mesh
        self._compute_dtype = jnp.dtype(cfg.compute_dtype)
        rep = NamedSharding(mesh, P())
        # Shardings of params/opt/batch are carried by the arguments
        # themselves (placed in shard_params/init_opt/shard_batch); GSPMD
        # propagates them through the step.  Only the scalar outputs are
        # pinned replicated.
        self._step = jax.jit(
            functools.partial(self._step_impl, pdrop=cfg.dropout),
            out_shardings=(None, None, rep),
            donate_argnums=(0, 1))
        self._eval = jax.jit(self._eval_impl, out_shardings=(rep, rep))

    # --- jitted bodies ---

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

    # --- host-facing API ---

    def shard_params(self, params: lrcn.Params) -> lrcn.Params:
        return shard_params(params, self.mesh)

    def init_opt(self, params: lrcn.Params):
        return place_opt_state(self.opt.init(params),
                               param_sharding(self.mesh), self.mesh)

    def shard_batch(self, tokens, lengths, feats):
        return put_batch(self.mesh, tokens, lengths, feats)

    def __call__(self, params, opt_state, tokens, lengths, feats, rng):
        return self._step(params, opt_state, tokens, lengths, feats, rng)

    def eval_batch(self, params, tokens, lengths, feats):
        return self._eval(params, tokens, lengths, feats)
