"""Plain-JAX kernels of the hot path against NumPy references.

The LSTM step, the beam search's two-stage top-K, the VGG conv+bias+ReLU
and the precision the float32 path asks for.  These are the operations a
hand-written GPU kernel would replace; these tests pin what any such
kernel must reproduce.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lrcn_jax.decode.beam import select_candidates
from lrcn_jax.models import vgg
from lrcn_jax.ops.lstm import lstm_step


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def numpy_lstm_cell(w, b, h, c, x):
    """The reference cell (lrcn.jl:528-538) in float64 NumPy."""
    hid = h.shape[-1]
    gates = np.concatenate([x, h], axis=-1) @ w + b
    forget = _sigmoid(gates[:, :hid])
    ingate = _sigmoid(gates[:, hid:2 * hid])
    outgate = _sigmoid(gates[:, 2 * hid:3 * hid])
    change = np.tanh(gates[:, 3 * hid:])
    c = c * forget + ingate * change
    return outgate * np.tanh(c), c


def _lstm_inputs(b_dim, x_dim, h_dim, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((x_dim + h_dim, 4 * h_dim)) * 0.05,
            rng.standard_normal((4 * h_dim,)) * 0.1,
            rng.standard_normal((b_dim, h_dim)),
            rng.standard_normal((b_dim, h_dim)),
            rng.standard_normal((b_dim, x_dim)))


@pytest.mark.parametrize("b_dim,x_dim,h_dim", [
    (4, 24, 32),          # tiny, unaligned
    (128, 256, 128),      # aligned
    (96, 1000, 1000),     # reference-scale dims, unaligned
])
def test_lstm_step_matches_numpy_cell(b_dim, x_dim, h_dim):
    args = _lstm_inputs(b_dim, x_dim, h_dim, seed=0)
    h_ref, c_ref = numpy_lstm_cell(*args)
    h, c = lstm_step(*(jnp.asarray(a, jnp.float32) for a in args),
                     compute_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(h), h_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(c), c_ref, rtol=1e-5, atol=1e-5)


def test_lstm_step_bf16_within_bf16_tolerance():
    """bf16 operands (8-bit mantissa), f32 accumulation and state."""
    args = _lstm_inputs(32, 200, 160, seed=1)
    h_ref, c_ref = numpy_lstm_cell(*args)
    h, c = lstm_step(*(jnp.asarray(a, jnp.float32) for a in args),
                     compute_dtype=jnp.bfloat16)
    assert h.dtype == c.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(h), h_ref, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(c), c_ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("vocab", [500, 8800])
def test_two_stage_topk_equals_flat_topk(vocab):
    """select_candidates == one top-K over the (K*V) flattening, ties
    included: duplicated log-probs within and across hypotheses."""
    rng = np.random.default_rng(vocab)
    b_dim, k = 6, 3
    # few distinct values -> many exact ties
    logp = -rng.integers(1, 6, (b_dim, k, vocab)).astype(np.float32)
    scores = -rng.integers(0, 3, (b_dim, k)).astype(np.float32)
    scores[0] = [0.0, -1e30, -1e30]        # the first step's layout
    top, parent, word = select_candidates(jnp.asarray(scores),
                                          jnp.asarray(logp))
    flat = (scores[:, :, None] + logp).reshape(b_dim, k * vocab)
    want_top, want_idx = jax.lax.top_k(jnp.asarray(flat), k)
    np.testing.assert_array_equal(np.asarray(top), np.asarray(want_top))
    np.testing.assert_array_equal(np.asarray(parent),
                                  np.asarray(want_idx) // vocab)
    np.testing.assert_array_equal(np.asarray(word),
                                  np.asarray(want_idx) % vocab)


def numpy_conv3x3_relu(x, w, b):
    """3x3 pad-1 cross-correlation + bias + ReLU, NHWC/HWIO, float64."""
    _, h, wd, _ = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros(x.shape[:3] + (w.shape[-1],))
    for dy in range(3):
        for dx in range(3):
            out += np.einsum("bhwc,cf->bhwf",
                             xp[:, dy:dy + h, dx:dx + wd], w[dy, dx])
    return np.maximum(out + b, 0.0)


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 16, 32),     # small
    (1, 14, 14, 64, 64),   # conv5-like
    (2, 16, 12, 8, 8),     # rectangular, tiny channels
    (1, 28, 28, 96, 40),   # unaligned channel counts
])
def test_conv_bias_relu_matches_numpy(shape):
    b_dim, h, wd, c, f = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b_dim, h, wd, c))
    w = rng.standard_normal((3, 3, c, f)) * 0.1
    b = rng.standard_normal((f,)) * 0.5
    got = jax.nn.relu(vgg._conv(jnp.asarray(x, jnp.float32),
                                jnp.asarray(w, jnp.float32),
                                jnp.asarray(b, jnp.float32), jnp.float32))
    np.testing.assert_allclose(np.asarray(got), numpy_conv3x3_relu(x, w, b),
                               rtol=1e-4, atol=1e-4)


def test_vgg_f32_lowering_asks_for_highest_precision():
    """Every conv and contraction of the f32 forward carries HIGHEST (a
    GPU would otherwise run them in TF32); the bf16 forward keeps the
    default."""
    params = vgg.init_vgg_params(jax.random.PRNGKey(0),
                                 width_multiplier=0.05, fc_dim=16)
    x = jnp.zeros((1, 224, 224, 3))
    for dtype, highest in ((jnp.float32, True), (jnp.bfloat16, False)):
        text = vgg.vgg16_fc7.lower(params, x, dtype).as_text()
        ops = [line for line in text.splitlines()
               if "stablehlo.convolution" in line
               or "stablehlo.dot_general" in line]
        assert len(ops) == 15       # 13 convs, fc6, fc7
        assert all(("HIGHEST" in line) == highest for line in ops), dtype
