"""Batched on-device temperature sampling + best-of-N caption generation.

The reference ships sampling helpers (``sample(p)`` / ``sample(p, N)``,
lrcn.jl:680-693) that are unused in its main path; the vendored paper's
strongest generation strategy IS sampling ("sample 100, T=1.5/2.0",
1411.4389.pdf Table 6 — SURVEY.md §6): draw N captions per image from the
tempered softmax and keep the one the model scores highest.

One ``lax.scan`` draws every token of every sample of every image
simultaneously — B*N hypotheses in one batch — instead of
host-looped per-image draws.  Scores accumulate the UNtempered
log-probability (the selection criterion), while tokens are drawn from
``logits / temperature``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lrcn_jax.core.vocab import BOS_ID, EOS_ID
from lrcn_jax.models import lrcn
from lrcn_jax.models.lrcn import LSTMState, Params


@functools.partial(jax.jit, static_argnames=("max_words", "compute_dtype"))
def sample_search(params: Params, feats: jax.Array, rng: jax.Array, *,
                  temperature: float = 1.0, max_words: int = 30,
                  compute_dtype=jnp.bfloat16
                  ) -> tuple[jax.Array, jax.Array]:
    """Sample one caption per feature row.

    Returns (tokens (B, max_words+2) with BOS at column 0, scores (B,))
    where scores are untempered cumulative log-probabilities.
    """
    b_dim = feats.shape[0]
    h1_dim = params["lstm1"]["b"].shape[-1] // 4
    h2_dim = params["lstm2"]["b"].shape[-1] // 4

    cnn_proj = lrcn.cnn_projection(params, feats, compute_dtype)
    tokens0 = jnp.zeros((b_dim, max_words + 2), jnp.int32)
    tokens0 = tokens0.at[:, 0].set(BOS_ID)
    state0 = LSTMState(
        jnp.zeros((b_dim, h1_dim), jnp.float32),
        jnp.zeros((b_dim, h1_dim), jnp.float32),
        jnp.zeros((b_dim, h2_dim), jnp.float32),
        jnp.zeros((b_dim, h2_dim), jnp.float32))

    def body(c, step_rng):
        tokens, scores, state, step, done = c
        last = jax.lax.dynamic_index_in_dim(tokens, step, axis=1,
                                            keepdims=False)
        new_state, logits = lrcn.decode_step(params, state, last, cnn_proj,
                                             compute_dtype)
        logits = logits.astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        word = jax.random.categorical(
            step_rng, logits / temperature, axis=-1).astype(jnp.int32)
        step_score = jnp.take_along_axis(logp, word[:, None], axis=1)[:, 0]

        new_tokens = jax.lax.dynamic_update_index_in_dim(
            tokens, word, step + 1, axis=1)
        tokens = jnp.where(done[:, None], tokens, new_tokens)
        scores = jnp.where(done, scores, scores + step_score)
        state = LSTMState(*(jnp.where(done[:, None], old, new)
                            for old, new in zip(state, new_state)))
        done = jnp.logical_or(done, word == EOS_ID)
        return (tokens, scores, state, step + 1, done), None

    carry0 = (tokens0, jnp.zeros((b_dim,), jnp.float32), state0,
              jnp.zeros((), jnp.int32), jnp.zeros((b_dim,), bool))
    step_rngs = jax.random.split(rng, max_words + 1)
    (tokens, scores, _, _, _), _ = jax.lax.scan(body, carry0, step_rngs)
    return tokens, scores


@functools.partial(jax.jit, static_argnames=("n_samples", "max_words",
                                             "compute_dtype"))
def best_of_n_search(params: Params, feats: jax.Array, rng: jax.Array, *,
                     n_samples: int = 100, temperature: float = 2.0,
                     max_words: int = 30, compute_dtype=jnp.bfloat16
                     ) -> tuple[jax.Array, jax.Array]:
    """The paper's sampling strategy: N draws per image, keep the best.

    All B*N hypotheses decode in ONE scan (the per-image host loop of the
    reference's generation stack, SURVEY.md §3.2, never materializes).
    Returns the model-preferred sample per image: (tokens (B, max_words+2),
    scores (B,)).
    """
    b_dim = feats.shape[0]
    tiled = jnp.repeat(feats, n_samples, axis=0)       # (B*N, F)
    tokens, scores = sample_search(
        params, tiled, rng, temperature=temperature, max_words=max_words,
        compute_dtype=compute_dtype)
    tokens = tokens.reshape(b_dim, n_samples, -1)
    scores = scores.reshape(b_dim, n_samples)
    best = jnp.argmax(scores, axis=1)
    return (jnp.take_along_axis(tokens, best[:, None, None], axis=1)[:, 0],
            jnp.take_along_axis(scores, best[:, None], axis=1)[:, 0])
