"""Checks that only mean something on the GPU; they skip elsewhere.

Run on the card with ``python -m pytest -m chip tests/test_chip.py``.
Each compares the device against the CPU backend of the same process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lrcn_jax.config import LRCNConfig
from lrcn_jax.decode.beam import beam_search
from lrcn_jax.decode.reference import reference_beam_search
from lrcn_jax.models import lrcn, vgg

pytestmark = pytest.mark.chip


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_f32_beam_search_matches_cpu_reference(gpu):
    """float32 on the card (HIGHEST precision, no TF32) reproduces the
    host-looped reference search run on the CPU, token for token."""
    cfg = LRCNConfig(hidden=(64, 64), embed=32, cnn_feature_dim=128,
                     vocab_size=300)
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    feats = np.abs(np.random.default_rng(0).standard_normal(
        (4, 128))).astype(np.float32)
    tokens, scores = beam_search(jax.device_put(params, gpu),
                                 jnp.asarray(feats), beam_width=3,
                                 max_words=12, compute_dtype=jnp.float32)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        cpu_params = jax.device_put(params, cpu)
        for b in range(len(feats)):
            words, prob, _ = reference_beam_search(cpu_params, cfg, feats[b],
                                                   3, 12)
            assert list(np.asarray(tokens)[b, 1:1 + len(words) - 1]) \
                == words[1:]
            np.testing.assert_allclose(float(scores[b]), np.log(prob),
                                       rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4),
                                       (jnp.bfloat16, 3e-2)])
def test_vgg_fc7_matches_cpu_f32(gpu, dtype, tol):
    """Reduced-width VGG-16 on the card vs the CPU f32 forward (the
    smoke's tolerances: summation order for f32, bf16 operand rounding)."""
    params = vgg.init_vgg_params(jax.random.PRNGKey(1),
                                 width_multiplier=0.25, fc_dim=512)
    x = np.random.default_rng(1).uniform(
        -120, 130, (2, 224, 224, 3)).astype(np.float32)
    got = vgg.vgg16_fc7(jax.device_put(params, gpu), jnp.asarray(x), dtype)
    cpu = jax.devices("cpu")[0]
    want = vgg.vgg16_fc7(jax.device_put(params, cpu),
                         jax.device_put(x, cpu), jnp.float32)
    assert _rel_err(got, want) <= tol
