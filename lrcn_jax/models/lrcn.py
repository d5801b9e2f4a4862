"""The LRCN caption decoder: a factored 2-layer LSTM.

Architecture (reference: ``initweights`` lrcn.jl:489-510, forward ``lrcn``
lrcn.jl:540-551):

- word embedding (V, E)                                  [ref w[end-2]]
- LSTM-1 over word embeddings, width H1                  [ref w[1], w[2]]
- factor projection h1 -> F = ceil(H2/2)                 [ref w[end-4]]
- CNN projection fc7(4096) -> F, computed ONCE per batch [ref w[end-3]]
  and concatenated with the factor output EVERY step — the visual input is
  re-injected at each timestep (lrcn.jl:546, loss hoists it at :558)
- LSTM-2 over the (2F,) concat, width H2                 [ref w[3], w[4]]
- output projection H2 -> V plus bias                    [ref w[end-1], w[end]]

Weight shapes match the reference exactly; LSTM weights are packed
``(X+H, 4H)`` with gate order [forget, ingate, outgate, change] and
forget-gate bias initialized to 1 (lrcn.jl:499-501).

Design decisions (not translations):

- parameters are a pytree; the whole forward is pure and jit/grad-able;
- teacher-forced training unrolls with ``lax.scan``; the layer-1 input
  projection and the output projection are hoisted out of the scan into
  single large matmuls over all timesteps;
- matmuls run in bfloat16 with float32 accumulation; LSTM state is float32;
- variable caption lengths are handled by padding + masking (the reference
  instead deletes captions that don't fill an equal-length batch,
  lrcn.jl:299-327 — a documented divergence that keeps all data).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import BOS_ID, EOS_ID
from lrcn_jax.ops.lstm import (
    lstm_cell_update,
    lstm_recurrent_gates,
    lstm_step,
    matmul,
)

Params = dict[str, Any]


class LSTMState(NamedTuple):
    """Recurrent state of the 2-layer decoder (reference: lrcn.jl:512-526)."""
    h1: jax.Array
    c1: jax.Array
    h2: jax.Array
    c2: jax.Array


def xavier_uniform(key: jax.Array, shape: tuple[int, int],
                   dtype=jnp.float32) -> jax.Array:
    """Xavier/Glorot uniform, matching Knet's ``xavier`` (lrcn.jl:490)."""
    fan_in, fan_out = shape[0], shape[1]
    scale = jnp.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, minval=-scale, maxval=scale)


def init_params(key: jax.Array, cfg: LRCNConfig) -> Params:
    """Initialize the decoder parameter pytree (reference: lrcn.jl:489-510)."""
    if cfg.vocab_size <= 0:
        raise ValueError("cfg.vocab_size must be set before init_params")
    h1, h2 = cfg.hidden
    e, f, v, c = cfg.embed, cfg.factor_dim, cfg.vocab_size, cfg.cnn_feature_dim
    dtype = jnp.dtype(cfg.param_dtype)
    keys = jax.random.split(key, 6)

    def lstm_init(k, x_dim, h_dim):
        w = xavier_uniform(k, (x_dim + h_dim, 4 * h_dim), dtype)
        b = jnp.zeros((4 * h_dim,), dtype)
        b = b.at[:h_dim].set(1.0)  # forget-gate bias = 1 (lrcn.jl:501)
        return {"w": w, "b": b}

    return {
        "lstm1": lstm_init(keys[0], e, h1),
        "lstm2": lstm_init(keys[1], 2 * f, h2),
        "w_factor": xavier_uniform(keys[2], (h1, f), dtype),
        "w_cnn": xavier_uniform(keys[3], (c, f), dtype),
        "embedding": xavier_uniform(keys[4], (v, e), dtype),
        "w_out": xavier_uniform(keys[5], (h2, v), dtype),
        "b_out": jnp.zeros((v,), dtype),
    }


def init_state(cfg: LRCNConfig, batch: int) -> LSTMState:
    """Zero recurrent state (reference: initstate lrcn.jl:512-526)."""
    h1, h2 = cfg.hidden
    z = lambda d: jnp.zeros((batch, d), jnp.float32)
    return LSTMState(z(h1), z(h1), z(h2), z(h2))


def cnn_projection(params: Params, feats: jax.Array,
                   compute_dtype=jnp.bfloat16) -> jax.Array:
    """Project fc7 features once per batch (reference: lrcn.jl:558,611)."""
    return matmul(feats, params["w_cnn"], compute_dtype)


def unroll_h2(params: Params, input_embeds: jax.Array, cnn_proj: jax.Array,
              drop_mask2: jax.Array | None = None,
              compute_dtype=jnp.bfloat16) -> jax.Array:
    """Teacher-forced unroll returning the layer-2 hidden sequence.

    Args:
      input_embeds: (T, B, E) time-major embedded inputs (dropout, if any,
        already applied by the caller — one fused op over the whole tensor).
      cnn_proj: (B, F) CNN factor, injected every step (lrcn.jl:546).
      drop_mask2: optional (T, B, 2F) inverted-dropout mask for the LSTM-2
        input concat (reference applies dropout there per step, lrcn.jl:547).

    Returns: (T, B, H2) float32 hidden states of LSTM-2.
    """
    t_dim, b_dim, e_dim = input_embeds.shape
    h1_dim = params["lstm1"]["b"].shape[-1] // 4
    f_dim = params["w_factor"].shape[-1]

    # Hoist the layer-1 input projection out of the recurrence: one large
    # (T*B, E) @ (E, 4H1) matmul instead of T small ones.
    w1, b1 = params["lstm1"]["w"], params["lstm1"]["b"]
    x1_proj = matmul(input_embeds.reshape(t_dim * b_dim, e_dim),
                     w1[:e_dim], compute_dtype)
    x1_proj = x1_proj.reshape(t_dim, b_dim, 4 * h1_dim)

    w2, b2 = params["lstm2"]["w"], params["lstm2"]["b"]
    state0 = LSTMState(
        jnp.zeros((b_dim, h1_dim), jnp.float32),
        jnp.zeros((b_dim, h1_dim), jnp.float32),
        jnp.zeros((b_dim, params["lstm2"]["b"].shape[-1] // 4), jnp.float32),
        jnp.zeros((b_dim, params["lstm2"]["b"].shape[-1] // 4), jnp.float32),
    )

    def step(state: LSTMState, xs):
        x1p, mask2 = xs
        gates1 = lstm_recurrent_gates(w1, b1, state.h1, x1p, e_dim,
                                      compute_dtype=compute_dtype)
        h1, c1 = lstm_cell_update(gates1, state.c1)
        h1f = matmul(h1, params["w_factor"], compute_dtype)   # lrcn.jl:545
        x2 = jnp.concatenate([h1f, cnn_proj], axis=-1)        # lrcn.jl:546
        if mask2 is not None:
            x2 = x2 * mask2                                   # lrcn.jl:547
        gates2 = (matmul(x2, w2[:2 * f_dim], compute_dtype)
                  + matmul(state.h2, w2[2 * f_dim:], compute_dtype)
                  + b2.astype(jnp.float32))
        h2, c2 = lstm_cell_update(gates2, state.c2)
        return LSTMState(h1, c1, h2, c2), h2

    xs = (x1_proj, drop_mask2)
    _, h2_seq = jax.lax.scan(step, state0, xs)
    return h2_seq


def output_logits(params: Params, h2: jax.Array,
                  compute_dtype=jnp.bfloat16) -> jax.Array:
    """h2 -> vocabulary logits (reference: lrcn.jl:550)."""
    return (matmul(h2, params["w_out"], compute_dtype)
            + params["b_out"].astype(jnp.float32))


def build_teacher_forcing(tokens: jax.Array, lengths: jax.Array
                          ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Build (inputs, targets, mask) for teacher-forced training.

    ``tokens`` is (B, L) padded token ids; ``lengths`` is (B,).  Produces
    T = L+1 steps: inputs = [BOS, tok_0..tok_{L-1}], targets =
    [tok_0..tok_{L-1}, *] with EOS written at position ``lengths[b]`` — the
    reference's extra EOS-prediction step (lrcn.jl:572-579) — and a mask
    selecting positions <= lengths[b].
    """
    b_dim, l_dim = tokens.shape
    bos = jnp.full((b_dim, 1), BOS_ID, tokens.dtype)
    inputs = jnp.concatenate([bos, tokens], axis=1)            # (B, L+1)
    pad = jnp.zeros((b_dim, 1), tokens.dtype)
    targets = jnp.concatenate([tokens, pad], axis=1)           # (B, L+1)
    pos = jnp.arange(l_dim + 1)[None, :]
    targets = jnp.where(pos == lengths[:, None],
                        jnp.asarray(EOS_ID, tokens.dtype), targets)
    mask = pos <= lengths[:, None]
    return inputs, targets, mask


def loss_total_count(params: Params, tokens: jax.Array, lengths: jax.Array,
                     feats: jax.Array, *, pdrop: float = 0.0,
                     rng: jax.Array | None = None,
                     compute_dtype=jnp.bfloat16
                     ) -> tuple[jax.Array, jax.Array]:
    """Summed teacher-forced NLL and prediction count for one batch.

    The building block for both the per-batch mean loss and dataset-level
    average loss (the reference's ``average_loss`` accumulates total/count
    across batches, lrcn.jl:407-486).
    """
    inputs, targets, mask = build_teacher_forcing(tokens, lengths)
    b_dim, t_dim = inputs.shape

    embeds = params["embedding"][inputs]               # (B, T, E) gather
    embeds = jnp.transpose(embeds, (1, 0, 2))          # time-major (T, B, E)

    drop_mask2 = None
    if pdrop > 0.0:
        if rng is None:
            raise ValueError("dropout requires an rng key")
        k1, k2 = jax.random.split(rng)
        keep = 1.0 - pdrop
        # Inverted dropout, matching Knet's dropout scaling (lrcn.jl:542,547).
        embeds = embeds * (
            jax.random.bernoulli(k1, keep, embeds.shape) / keep)
        f2 = 2 * params["w_factor"].shape[-1]
        drop_mask2 = (
            jax.random.bernoulli(k2, keep, (t_dim, b_dim, f2)) / keep
        ).astype(jnp.float32)

    cnn_proj = cnn_projection(params, feats, compute_dtype)
    h2_seq = unroll_h2(params, embeds, cnn_proj, drop_mask2, compute_dtype)

    # One large output matmul over all timesteps (T*B, H2) @ (H2, V).
    h2_flat = h2_seq.reshape(t_dim * b_dim, -1)
    logits = output_logits(params, h2_flat, compute_dtype)
    logp = jax.nn.log_softmax(logits, axis=-1)         # lrcn.jl:562

    tgt_flat = jnp.transpose(targets).reshape(t_dim * b_dim)
    gold = jnp.take_along_axis(logp, tgt_flat[:, None], axis=1)[:, 0]
    mask_flat = jnp.transpose(mask).reshape(t_dim * b_dim)
    total = jnp.sum(gold * mask_flat)
    count = jnp.sum(mask_flat)
    return -total, count


def loss_fn(params: Params, tokens: jax.Array, lengths: jax.Array,
            feats: jax.Array, *, pdrop: float = 0.0,
            rng: jax.Array | None = None,
            compute_dtype=jnp.bfloat16) -> jax.Array:
    """Mean per-token teacher-forced NLL, including the EOS step.

    Semantics of the reference ``loss`` (lrcn.jl:553-581): per-step
    log-softmax over the vocabulary, gather the gold token, average over
    B*(L+1) predictions — here with padding masked out so variable-length
    batches are exact.
    """
    total, count = loss_total_count(params, tokens, lengths, feats,
                                    pdrop=pdrop, rng=rng,
                                    compute_dtype=compute_dtype)
    return total / count


def decode_step(params: Params, state: LSTMState, token_ids: jax.Array,
                cnn_proj: jax.Array, compute_dtype=jnp.bfloat16
                ) -> tuple[LSTMState, jax.Array]:
    """Single generation step: last token ids -> next-token logits.

    The on-device building block for greedy/beam decoding (replaces the
    reference's host-looped per-step forward, lrcn.jl:650-651).
    """
    cell = functools.partial(lstm_step, compute_dtype=compute_dtype)
    x = params["embedding"][token_ids]                       # (B, E)
    l1, l2 = params["lstm1"], params["lstm2"]
    h1, c1 = cell(l1["w"], l1["b"], state.h1, state.c1, x)
    h1f = matmul(h1, params["w_factor"], compute_dtype)
    x2 = jnp.concatenate([h1f, cnn_proj], axis=-1)
    h2, c2 = cell(l2["w"], l2["b"], state.h2, state.c2, x2)
    logits = output_logits(params, h2, compute_dtype)
    return LSTMState(h1, c1, h2, c2), logits


def param_count(params: Params) -> int:
    return sum(int(x.size) for x in jax.tree.leaves(params))
