"""lrcn_jax — an LRCN image-captioning framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
ekinakyurek/Long-Term-Recurrent-Convolutional-NN (Donahue et al., CVPR 2015):
VGG-16 fc7 image features -> factored 2-layer LSTM caption decoder ->
on-device beam-search generation -> multi-bleu BLEU evaluation on
Flickr30k / MS-COCO 2014.

Layer map (see SURVEY.md for the reference's layer map this mirrors):

- ``lrcn_jax.core``       tokenizer / vocab / deterministic dataset splits
- ``lrcn_jax.data``       batching, feature store, device feed, image preproc
- ``lrcn_jax.models``     VGG-16 encoder and the LRCN decoder
- ``lrcn_jax.ops``        fused compute ops (LSTM cell)
- ``lrcn_jax.parallel``   mesh / sharding / data-parallel training step
- ``lrcn_jax.train``      training loop, optimizer, checkpointing, metrics
- ``lrcn_jax.decode``     on-device greedy / beam / sampling search, writers
- ``lrcn_jax.evaluation`` multi-bleu scorer + reference-file builder
- ``lrcn_jax.native``     C++ host-runtime components (BLEU core, image loader)
- ``lrcn_jax.utils``      profiling / step timing / compile cache
- ``lrcn_jax.cli``        command-line surface mirroring the reference
"""

__version__ = "0.1.0"

from lrcn_jax.config import LRCNConfig  # noqa: F401
