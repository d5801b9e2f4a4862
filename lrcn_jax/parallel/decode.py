"""Multi-chip caption decoding: batch-sharded beam search over a mesh.

Decoding is embarrassingly parallel over images, so serving scales by
sharding the feature batch along the ``data`` axis with replicated decoder
params — each chip runs the full beam loop on its slice of the batch and
no collectives appear in the loop body.  The reference decodes batch-1 on
one device (SURVEY.md §3.2); this is the serving-scale counterpart.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lrcn_jax.decode.beam import beam_search, greedy_search
from lrcn_jax.models.lrcn import Params


def shard_for_decode(params: Params, feats, mesh: Mesh
                     ) -> tuple[Params, jax.Array]:
    """Replicate params, shard the feature batch along ``data``.

    The global batch must be divisible by the total device count of the
    ``data`` axis.
    """
    import numpy as np

    params = jax.device_put(params, NamedSharding(mesh, P()))
    if not isinstance(feats, jax.Array):
        # stay host-side until the sharded put: a default-device commit
        # first is an extra hop and breaks when the mesh spans processes
        feats = np.asarray(feats, np.float32)
    elif feats.dtype != jnp.float32:
        feats = feats.astype(jnp.float32)
    feats = jax.device_put(feats, NamedSharding(mesh, P("data")))
    return params, feats


def sharded_beam_search(params: Params, feats, mesh: Mesh, *,
                        beam_width: int = 3, max_words: int = 30,
                        compute_dtype=jnp.bfloat16
                        ) -> tuple[jax.Array, jax.Array]:
    """Beam search with the batch sharded across the mesh's data axis.

    GSPMD partitions every per-image tensor in the scan body (tokens,
    scores, LSTM states, logits) along the batch dimension; top_k runs
    per-image so no cross-chip communication is needed.
    """
    params, feats = shard_for_decode(params, feats, mesh)
    if beam_width == 1:
        return greedy_search(params, feats, max_words=max_words,
                             compute_dtype=compute_dtype)
    return beam_search(params, feats, beam_width=beam_width,
                       max_words=max_words, compute_dtype=compute_dtype)
