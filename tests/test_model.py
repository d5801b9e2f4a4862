"""LRCN decoder unit tests vs an independent NumPy implementation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import BOS_ID, EOS_ID
from lrcn_jax.models import lrcn


def small_cfg(**kw):
    defaults = dict(hidden=(16, 12), embed=8, cnn_feature_dim=20,
                    vocab_size=30)
    defaults.update(kw)
    return LRCNConfig(**defaults)


@pytest.fixture
def cfg():
    return small_cfg()


@pytest.fixture
def params(cfg):
    return lrcn.init_params(jax.random.PRNGKey(0), cfg)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def np_lstm_step(w, b, h, c, x):
    """Reference cell math (lrcn.jl:528-538), gate order [f,i,o,g]."""
    gates = np.concatenate([x, h], axis=-1) @ w + b
    hd = h.shape[-1]
    f = _sigmoid(gates[:, :hd])
    i = _sigmoid(gates[:, hd:2 * hd])
    o = _sigmoid(gates[:, 2 * hd:3 * hd])
    g = np.tanh(gates[:, 3 * hd:])
    c = c * f + i * g
    h = o * np.tanh(c)
    return h, c


def np_forward(params, token_ids, feats):
    """Full NumPy forward over a (B, T) input-id matrix -> (T, B, V) logits."""
    p = {k: np.asarray(jax.tree.map(np.asarray, v)) if not isinstance(v, dict)
         else {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in params.items()}
    b_dim, t_dim = token_ids.shape
    h1_dim = p["lstm1"]["b"].shape[-1] // 4
    h2_dim = p["lstm2"]["b"].shape[-1] // 4
    h1 = np.zeros((b_dim, h1_dim), np.float32)
    c1 = np.zeros_like(h1)
    h2 = np.zeros((b_dim, h2_dim), np.float32)
    c2 = np.zeros_like(h2)
    cnn_proj = feats @ p["w_cnn"]
    logits = []
    for t in range(t_dim):
        x = p["embedding"][token_ids[:, t]]
        h1, c1 = np_lstm_step(p["lstm1"]["w"], p["lstm1"]["b"], h1, c1, x)
        x2 = np.concatenate([h1 @ p["w_factor"], cnn_proj], axis=-1)
        h2, c2 = np_lstm_step(p["lstm2"]["w"], p["lstm2"]["b"], h2, c2, x2)
        logits.append(h2 @ p["w_out"] + p["b_out"])
    return np.stack(logits)


def test_param_shapes(cfg, params):
    h1, h2 = cfg.hidden
    f = cfg.factor_dim
    assert f == 6
    assert params["lstm1"]["w"].shape == (cfg.embed + h1, 4 * h1)
    assert params["lstm2"]["w"].shape == (2 * f + h2, 4 * h2)
    assert params["w_factor"].shape == (h1, f)
    assert params["w_cnn"].shape == (cfg.cnn_feature_dim, f)
    assert params["embedding"].shape == (cfg.vocab_size, cfg.embed)
    assert params["w_out"].shape == (h2, cfg.vocab_size)
    assert params["b_out"].shape == (cfg.vocab_size,)


def test_forget_gate_bias_is_one(cfg, params):
    h1, h2 = cfg.hidden
    np.testing.assert_array_equal(params["lstm1"]["b"][:h1], 1.0)
    np.testing.assert_array_equal(params["lstm1"]["b"][h1:], 0.0)
    np.testing.assert_array_equal(params["lstm2"]["b"][:h2], 1.0)


def test_default_config_matches_reference_defaults():
    cfg = LRCNConfig(vocab_size=100)
    assert cfg.hidden == (1000, 1000) and cfg.embed == 1000
    assert cfg.factor_dim == 500 and cfg.cnn_feature_dim == 4096
    assert cfg.beam_width == 3 and cfg.batch_size == 25


def test_decode_step_matches_numpy(cfg, params):
    rng = np.random.default_rng(1)
    b = 4
    feats = rng.normal(size=(b, cfg.cnn_feature_dim)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, size=(b, 5)).astype(np.int32)

    expected = np_forward(params, ids, feats)

    cnn_proj = lrcn.cnn_projection(params, jnp.asarray(feats), jnp.float32)
    state = lrcn.init_state(cfg, b)
    got = []
    for t in range(5):
        state, logits = lrcn.decode_step(params, state, jnp.asarray(ids[:, t]),
                                         cnn_proj, jnp.float32)
        got.append(np.asarray(logits))
    np.testing.assert_allclose(np.stack(got), expected, rtol=2e-4, atol=2e-4)


def test_unroll_matches_decode_step(cfg, params):
    """The scan-based training unroll and the single-step decode path must
    produce identical hidden states (they share no code path for layer 2)."""
    rng = np.random.default_rng(2)
    b, t = 3, 6
    feats = rng.normal(size=(b, cfg.cnn_feature_dim)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)

    cnn_proj = lrcn.cnn_projection(params, jnp.asarray(feats), jnp.float32)
    embeds = jnp.transpose(params["embedding"][jnp.asarray(ids)], (1, 0, 2))
    h2_seq = lrcn.unroll_h2(params, embeds, cnn_proj, None, jnp.float32)

    state = lrcn.init_state(cfg, b)
    for step in range(t):
        state, _ = lrcn.decode_step(params, state, jnp.asarray(ids[:, step]),
                                    cnn_proj, jnp.float32)
        np.testing.assert_allclose(np.asarray(h2_seq[step]),
                                   np.asarray(state.h2), rtol=1e-5, atol=1e-5)


def test_teacher_forcing_construction():
    tokens = jnp.array([[5, 6, 7], [8, 9, 0]], jnp.int32)
    lengths = jnp.array([3, 2])
    inputs, targets, mask = lrcn.build_teacher_forcing(tokens, lengths)
    np.testing.assert_array_equal(np.asarray(inputs),
                                  [[BOS_ID, 5, 6, 7], [BOS_ID, 8, 9, 0]])
    # targets: gold tokens then EOS at position `length`
    np.testing.assert_array_equal(np.asarray(targets),
                                  [[5, 6, 7, EOS_ID], [8, 9, EOS_ID, 0]])
    np.testing.assert_array_equal(
        np.asarray(mask),
        [[True, True, True, True], [True, True, True, False]])


def test_loss_matches_numpy(cfg, params):
    rng = np.random.default_rng(3)
    b, l = 4, 5
    feats = rng.normal(size=(b, cfg.cnn_feature_dim)).astype(np.float32)
    tokens = rng.integers(3, cfg.vocab_size, size=(b, l)).astype(np.int32)
    lengths = np.array([5, 3, 4, 5])

    got = lrcn.loss_fn(params, jnp.asarray(tokens), jnp.asarray(lengths),
                       jnp.asarray(feats), compute_dtype=jnp.float32)

    # NumPy reference: per-example teacher-forced NLL over len+1 steps.
    total, count = 0.0, 0
    for i in range(b):
        li = int(lengths[i])
        inp = np.concatenate([[BOS_ID], tokens[i, :li]])
        tgt = np.concatenate([tokens[i, :li], [EOS_ID]])
        logits = np_forward(params, inp[None, :], feats[i:i + 1])[:, 0, :]
        logits = logits - logits.max(axis=-1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
        total += logp[np.arange(li + 1), tgt].sum()
        count += li + 1
    expected = -total / count
    np.testing.assert_allclose(float(got), expected, rtol=1e-4)


def test_loss_bf16_close_to_f32(cfg, params):
    rng = np.random.default_rng(4)
    b, l = 4, 5
    feats = jnp.asarray(rng.normal(size=(b, cfg.cnn_feature_dim)),
                        jnp.float32)
    tokens = jnp.asarray(rng.integers(3, cfg.vocab_size, size=(b, l)),
                         jnp.int32)
    lengths = jnp.full((b,), l)
    l32 = lrcn.loss_fn(params, tokens, lengths, feats,
                       compute_dtype=jnp.float32)
    l16 = lrcn.loss_fn(params, tokens, lengths, feats,
                       compute_dtype=jnp.bfloat16)
    assert abs(float(l32) - float(l16)) / float(l32) < 0.05


def test_grad_is_finite_and_nonzero(cfg, params):
    rng = np.random.default_rng(5)
    b, l = 4, 5
    feats = jnp.asarray(rng.normal(size=(b, cfg.cnn_feature_dim)), jnp.float32)
    tokens = jnp.asarray(rng.integers(3, cfg.vocab_size, size=(b, l)),
                         jnp.int32)
    lengths = jnp.asarray(rng.integers(1, l + 1, size=(b,)))
    grads = jax.grad(lrcn.loss_fn)(params, tokens, lengths, feats,
                                   pdrop=0.4, rng=jax.random.PRNGKey(7))
    for leaf in jax.tree.leaves(grads):
        assert np.all(np.isfinite(np.asarray(leaf)))
    assert any(float(jnp.abs(leaf).max()) > 0
               for leaf in jax.tree.leaves(grads))


def test_loss_ignores_padding_content(cfg, params):
    """Changing token values beyond `lengths` must not change the loss."""
    rng = np.random.default_rng(6)
    b, l = 3, 6
    feats = jnp.asarray(rng.normal(size=(b, cfg.cnn_feature_dim)), jnp.float32)
    tokens = np.asarray(rng.integers(3, cfg.vocab_size, size=(b, l)),
                        np.int32)
    lengths = jnp.array([2, 4, 3])
    l_a = lrcn.loss_fn(params, jnp.asarray(tokens), lengths, feats,
                       compute_dtype=jnp.float32)
    tokens2 = tokens.copy()
    tokens2[0, 3:] = 9
    tokens2[2, 4:] = 11
    l_b = lrcn.loss_fn(params, jnp.asarray(tokens2), lengths, feats,
                       compute_dtype=jnp.float32)
    np.testing.assert_allclose(float(l_a), float(l_b), rtol=1e-6)
