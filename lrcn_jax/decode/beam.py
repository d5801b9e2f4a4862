"""Fully on-device batched beam search (and greedy) caption decoding.

The reference decodes one image at a time with a host-side recursive beam
search (lrcn.jl:644-678): every step round-trips probabilities to the host
(:652-653), sorts the FULL vocabulary on the host (:655), multiplies
probabilities in linear space (:657), and deep-copies LSTM states per
hypothesis (:673-676).  That stack is the #1 thing this framework replaces
(SURVEY.md §3.2).

Here the whole search is one ``lax.scan`` compiled by XLA:

- a BATCH of images decodes simultaneously (B×K hypotheses in one
  ``decode_step`` — batched matmuls instead of batch-1);
- scores accumulate in LOG space (monotonically identical ranking to the
  reference's linear-space product, without underflow);
- candidate selection is two ``lax.top_k`` stages (per-hypothesis over the
  vocabulary, then over the K·K shortlist) — exactly the reference's
  per-hypothesis top-K followed by global top-K, since each hypothesis
  contributes at most K survivors; see ``select_candidates`` for the tie
  argument;
- per-hypothesis LSTM states are reordered with a batched gather instead
  of host deep-copies.

Reference semantics preserved exactly:

- the first step expands only hypothesis 0 (lrcn.jl:662-664) — encoded by
  initializing all other beam scores to -inf;
- hypotheses that emit EOS are NOT frozen; they keep being extended
  (the reference has no finished-set), and the search stops when the
  CURRENT BEST hypothesis ends in EOS or the length cap is hit
  (lrcn.jl:670);
- ties rank the lower vocabulary id first (Julia ``sortperm`` stability ==
  ``lax.top_k`` tie behavior over hypothesis-major flattening).

Why ``scan`` and not ``while_loop``: the search state is frozen (masked)
once a batch row's best hypothesis ends in EOS, so running the remaining
steps is idempotent, and a fixed-trip-count scan needs no per-step
predicate read.  Early exit would save at most the tail steps; the batch
waits for its slowest row either way.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lrcn_jax.core.vocab import BOS_ID, EOS_ID
from lrcn_jax.models import lrcn
from lrcn_jax.models.lrcn import LSTMState, Params

NEG_INF = -1e30


class _BeamCarry(NamedTuple):
    last: jax.Array      # (B, K) int32: each hypothesis's latest token
    scores: jax.Array    # (B, K) float32, cumulative log-prob
    state: LSTMState     # each (B, K, H)
    done: jax.Array      # (B,) bool: best hypothesis ended with EOS


def _gather_beams(x: jax.Array, parent: jax.Array) -> jax.Array:
    """Reorder the beam axis: x (B, K, D) indexed by parent (B, K)."""
    return jnp.take_along_axis(x, parent[:, :, None], axis=1)


def select_candidates(scores: jax.Array, logp: jax.Array
                      ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """The K best one-word extensions of K hypotheses.

    ``scores`` (B, K) cumulative log-probs, ``logp`` (B, K, V) next-word
    log-probs.  Returns (B, K) each of the new scores, the parent
    hypothesis and the word, best first.

    Two-stage selection, exactly equivalent to one top-K over the
    flattened (K, V) candidates: each hypothesis contributes at most K
    survivors, so a per-hypothesis top-K over the vocabulary followed by a
    top-K over the K*K shortlist yields the same set — and the same tie
    order (both flattenings are hypothesis-major, and within a hypothesis
    adding its cumulative score preserves order).  The first stage reduces
    each (V,) row independently, so no (B, K*V) candidate tensor is
    materialized.
    """
    b_dim, k = scores.shape
    step_scores, step_words = jax.lax.top_k(logp, k)           # (B, K, K)
    cand = scores[:, :, None] + step_scores
    top_scores, idx = jax.lax.top_k(cand.reshape(b_dim, k * k), k)
    word = jnp.take_along_axis(
        step_words.reshape(b_dim, k * k), idx, axis=1).astype(jnp.int32)
    return top_scores, idx // k, word


def _beam_search_impl(params: Params, feats: jax.Array, *,
                      beam_width: int = 3, max_words: int = 30,
                      compute_dtype=jnp.bfloat16
                      ) -> tuple[jax.Array, jax.Array]:
    """Un-jitted beam search — composable into larger jitted programs
    (``beam_search_scan`` scans it over groups of batches).

    Args:
      params: decoder params.
      feats: (B, 4096) fc7 features (already L1-normalized, lrcn.jl:597).
      beam_width: K (reference ``--beam_width``, default 3).
      max_words: cap on generated tokens (reference ``--generate``).

    Returns:
      tokens: (B, max_words+2) int32 — best hypothesis per image, column 0
        is BOS; the caption is columns 1.. up to (and excluding) EOS.  Up to
        max_words+1 tokens are generated, matching the reference's
        post-append cap check (lrcn.jl:670).
      scores: (B,) float32 cumulative log-probability of the best hypothesis.
    """
    b_dim = feats.shape[0]
    k = beam_width
    h1_dim = params["lstm1"]["b"].shape[-1] // 4
    h2_dim = params["lstm2"]["b"].shape[-1] // 4

    cnn_proj = lrcn.cnn_projection(params, feats, compute_dtype)   # (B, F)
    cnn_flat = jnp.broadcast_to(
        cnn_proj[:, None, :], (b_dim, k, cnn_proj.shape[-1])
    ).reshape(b_dim * k, -1)

    # all hypotheses are identical at step 0: only beam 0 may expand
    scores0 = jnp.where(jnp.arange(k)[None, :] == 0, 0.0, NEG_INF)
    scores0 = jnp.broadcast_to(scores0, (b_dim, k)).astype(jnp.float32)
    zeros = lambda h: jnp.zeros((b_dim, k, h), jnp.float32)
    carry0 = _BeamCarry(jnp.full((b_dim, k), BOS_ID, jnp.int32), scores0,
                        LSTMState(zeros(h1_dim), zeros(h1_dim),
                                  zeros(h2_dim), zeros(h2_dim)),
                        jnp.zeros((b_dim,), bool))
    identity = jnp.broadcast_to(jnp.arange(k)[None, :], (b_dim, k))

    def body(c: _BeamCarry, _) -> tuple[_BeamCarry, tuple]:
        flat_state = LSTMState(*(s.reshape(b_dim * k, -1) for s in c.state))
        new_flat, logits = lrcn.decode_step(
            params, flat_state, c.last.reshape(b_dim * k), cnn_flat,
            compute_dtype)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)

        top_scores, parent, word = select_candidates(
            c.scores, logp.reshape(b_dim, k, -1))

        new_state = LSTMState(*(
            _gather_beams(s.reshape(b_dim, k, -1), parent) for s in new_flat))

        # Finished batch rows: only the OUTPUTS are frozen — identity
        # parent + EOS filler reproduce the old token-buffer semantics
        # exactly (unwritten buffer positions were 0 == EOS_ID), and the
        # final scores freeze via `keep`.  The recurrent state and `last`
        # deliberately keep evolving: everything they influence after
        # `done` (words, parents, candidate scores) is overwritten by the
        # selects below or discarded, so freezing them would buy nothing
        # but five (B, K, H)-sized selects per step.
        keep = c.done
        parent_rec = jnp.where(keep[:, None], identity, parent)
        word_rec = jnp.where(keep[:, None],
                             jnp.asarray(EOS_ID, jnp.int32), word)
        scores = jnp.where(keep[:, None], c.scores, top_scores)
        # stop rule: the CURRENT BEST hypothesis ends with EOS (lrcn.jl:670)
        done = jnp.logical_or(keep, word[:, 0] == EOS_ID)
        return (_BeamCarry(word, scores, new_state, done),
                (parent_rec, word_rec))

    # The token history is NOT carried through the scan (that would be a
    # per-step gather + dynamic-update of a (B, K, T) buffer); instead each
    # step records (parent, word) and the winning path is reconstructed by
    # a backward scan over the tiny (B, K) records.
    final, (parents, words) = jax.lax.scan(
        body, carry0, None, length=max_words + 1)

    batch_idx = jnp.arange(b_dim)

    def backtrace(beam, rec):
        parent_t, word_t = rec
        token = word_t[batch_idx, beam]
        return parent_t[batch_idx, beam], token

    beam0 = jnp.zeros((b_dim,), jnp.int32)   # best hypothesis at the end
    # reverse scan emits outputs at their original step positions, so
    # path_tokens is already in forward order
    _, path_tokens = jax.lax.scan(backtrace, beam0, (parents, words),
                                  reverse=True)
    tokens = jnp.concatenate(
        [jnp.full((b_dim, 1), BOS_ID, jnp.int32),
         jnp.transpose(path_tokens)], axis=1)         # (B, max_words + 2)
    return tokens, final.scores[:, 0]


@functools.partial(jax.jit,
                   static_argnames=("beam_width", "max_words",
                                    "compute_dtype"))
def beam_search(params: Params, feats: jax.Array, *, beam_width: int = 3,
                max_words: int = 30, compute_dtype=jnp.bfloat16
                ) -> tuple[jax.Array, jax.Array]:
    """Jitted batched beam search — see ``_beam_search_impl`` for the
    argument/return contract."""
    return _beam_search_impl(params, feats, beam_width=beam_width,
                             max_words=max_words,
                             compute_dtype=compute_dtype)


@functools.partial(jax.jit,
                   static_argnames=("beam_width", "max_words",
                                    "compute_dtype"))
def beam_search_scan(params: Params, feats: jax.Array, *,
                     beam_width: int = 3, max_words: int = 30,
                     compute_dtype=jnp.bfloat16
                     ) -> tuple[jax.Array, jax.Array]:
    """(G, B, 4096) -> ((G, B, T+2) tokens, (G, B) scores): G batches of
    beam search in ONE dispatch.

    ``lax.scan`` over the group axis amortizes per-dispatch host overhead
    the same way ``vgg16_fc7_scan`` does for the encoder.
    """
    def body(_, f):
        return None, _beam_search_impl(params, f, beam_width=beam_width,
                                       max_words=max_words,
                                       compute_dtype=compute_dtype)
    _, out = jax.lax.scan(body, None, feats)
    return out


def _greedy_search_impl(params: Params, feats: jax.Array, *,
                        max_words: int = 30, compute_dtype=jnp.bfloat16
                        ) -> tuple[jax.Array, jax.Array]:
    """Batched greedy (argmax) decoding — beam search with K=1 semantics,
    implemented directly for speed (no beam axis, no top_k)."""
    b_dim = feats.shape[0]
    h1_dim = params["lstm1"]["b"].shape[-1] // 4
    h2_dim = params["lstm2"]["b"].shape[-1] // 4

    cnn_proj = lrcn.cnn_projection(params, feats, compute_dtype)
    state0 = LSTMState(
        jnp.zeros((b_dim, h1_dim), jnp.float32),
        jnp.zeros((b_dim, h1_dim), jnp.float32),
        jnp.zeros((b_dim, h2_dim), jnp.float32),
        jnp.zeros((b_dim, h2_dim), jnp.float32))

    def body(c, _):
        last, scores, state, done = c
        new_state, logits = lrcn.decode_step(params, state, last, cnn_proj,
                                             compute_dtype)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        word = jnp.argmax(logp, axis=-1).astype(jnp.int32)
        step_score = jnp.take_along_axis(logp, word[:, None], axis=1)[:, 0]

        # finished rows emit EOS filler (== the old zero-initialized
        # token buffer); their score stops accumulating.  As in beam
        # search, the state and `last` keep evolving — post-done words
        # are masked to EOS here, so the extra recurrence is discarded
        # and the per-step state selects are saved.
        word_rec = jnp.where(done, jnp.asarray(EOS_ID, jnp.int32), word)
        scores = jnp.where(done, scores, scores + step_score)
        done = jnp.logical_or(done, word == EOS_ID)
        return (word, scores, new_state, done), word_rec

    carry0 = (jnp.full((b_dim,), BOS_ID, jnp.int32),
              jnp.zeros((b_dim,), jnp.float32), state0,
              jnp.zeros((b_dim,), bool))
    (_, scores, _, _), words = jax.lax.scan(
        body, carry0, None, length=max_words + 1)
    tokens = jnp.concatenate(
        [jnp.full((b_dim, 1), BOS_ID, jnp.int32), jnp.transpose(words)],
        axis=1)                                        # (B, max_words + 2)
    return tokens, scores


@functools.partial(jax.jit, static_argnames=("max_words", "compute_dtype"))
def greedy_search(params: Params, feats: jax.Array, *, max_words: int = 30,
                  compute_dtype=jnp.bfloat16
                  ) -> tuple[jax.Array, jax.Array]:
    """Jitted batched greedy decoding (see ``_greedy_search_impl``)."""
    return _greedy_search_impl(params, feats, max_words=max_words,
                               compute_dtype=compute_dtype)


@functools.partial(jax.jit, static_argnames=("max_words", "compute_dtype"))
def greedy_search_scan(params: Params, feats: jax.Array, *,
                       max_words: int = 30, compute_dtype=jnp.bfloat16
                       ) -> tuple[jax.Array, jax.Array]:
    """(G, B, 4096) -> ((G, B, T+2), (G, B)): G greedy batches, ONE
    dispatch (the greedy analogue of ``beam_search_scan``)."""
    def body(_, f):
        return None, _greedy_search_impl(params, f, max_words=max_words,
                                         compute_dtype=compute_dtype)
    _, out = jax.lax.scan(body, None, feats)
    return out


@functools.partial(jax.jit, static_argnames=("beam_width", "max_words",
                                             "compute_dtype"))
def rows_search(params, table: jax.Array, idx: jax.Array, *,
                beam_width: int, max_words: int, compute_dtype):
    """Gather table rows ON DEVICE, then search — one dispatch, int32 in.

    For an HBM-resident feature table: the host ships (B,) int32 row
    indices instead of (B, 4096) float rows.  Bit-identical to searching
    host-gathered float32 rows (the gather is exact and the search is
    the same jitted program).
    """
    feats = jnp.take(table, idx, axis=0)
    if beam_width == 1:
        return greedy_search(params, feats, max_words=max_words,
                             compute_dtype=compute_dtype)
    return beam_search(params, feats, beam_width=beam_width,
                       max_words=max_words, compute_dtype=compute_dtype)


@functools.partial(jax.jit, static_argnames=("beam_width", "max_words",
                                             "compute_dtype"))
def rows_search_scan(params, table: jax.Array, idx: jax.Array, *,
                     beam_width: int, max_words: int, compute_dtype):
    """(G, B) row indices -> (G, B, T) tokens: G batches in ONE dispatch.

    The scan analogue of ``rows_search`` — serving burst absorption and
    bulk generation both use it so the host never ships feature rows
    (a full (16, 256, 4096) float32 group is 64 MB per dispatch; the
    indices are 16 KB).
    """
    feats = jnp.take(table, idx, axis=0)        # (G, B, D)
    if beam_width == 1:
        return greedy_search_scan(params, feats, max_words=max_words,
                                  compute_dtype=compute_dtype)
    return beam_search_scan(params, feats, beam_width=beam_width,
                            max_words=max_words,
                            compute_dtype=compute_dtype)
