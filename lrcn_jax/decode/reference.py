"""Host-looped recreation of the reference beam search (lrcn.jl:644-678).

The plain reference that ``decode.beam.beam_search`` is checked against:
one image at a time, one ``decode_step`` per hypothesis, probabilities
multiplied in linear space, a full sort of the vocabulary per hypothesis.
It is deliberately slow and shares nothing with the batched search except
the decoder's single step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import BOS_ID, EOS_ID
from lrcn_jax.models import lrcn


def reference_beam_search(params, cfg: LRCNConfig, feat: np.ndarray,
                          beam_width: int, nword: int
                          ) -> tuple[list[int], float, lrcn.LSTMState]:
    """Best hypothesis ``(words, probability, state)`` for one image.

    Reference semantics: linear-space probability products, the first
    step expands only hypothesis 0, finished hypotheses keep expanding,
    and the search stops when the best hypothesis ends in EOS or its
    length exceeds ``nword``.  ``words`` starts with BOS.  Runs in float32
    on whatever device ``params`` live on.
    """
    cnn_proj = lrcn.cnn_projection(params, jnp.asarray(feat[None]),
                                   jnp.float32)
    state0 = lrcn.init_state(cfg, 1)
    hyps = [([BOS_ID], 1.0, state0) for _ in range(beam_width)]

    current = 1
    while True:
        candidates = []
        for words, prob, state in hyps:
            new_state, logits = lrcn.decode_step(
                params, state, jnp.asarray([words[-1]]), cnn_proj,
                jnp.float32)
            p = np.asarray(jax.nn.softmax(logits.astype(jnp.float32)))[0]
            order = np.argsort(-p, kind="stable")[:beam_width]
            for j in order:
                candidates.append((words + [int(j)], prob * float(p[j]),
                                   new_state))
            if current == 1:
                break  # first step: only hypothesis 0 expands
        candidates.sort(key=lambda t: -t[1])
        hyps = candidates[:beam_width]
        if hyps[0][0][-1] == EOS_ID or current > nword:
            return hyps[0]
        current += 1
