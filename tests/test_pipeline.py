"""Pipeline parallelism (parallel/pipeline.py) tests on the CPU mesh.

The reference has no multi-device story (SURVEY.md §2 parallelism table);
the temporal pipeline is the framework's own design, so correctness is
asserted against the single-device decoder loss: identical forward
semantics and matching gradients through shard_map/ppermute/psum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lrcn_jax.config import LRCNConfig
from lrcn_jax.models import lrcn
from lrcn_jax.parallel import PipelinedTrainStep, make_mesh
from lrcn_jax.parallel.pipeline import (
    from_pipeline_params,
    pipeline_loss_fn,
    pipeline_loss_total_count,
    to_pipeline_params,
    validate_pipeline_config,
)
from lrcn_jax.train.trainer import make_optimizer


def small_cfg(**kw):
    base = dict(hidden=(16, 16), embed=16, cnn_feature_dim=24,
                vocab_size=32, dropout=0.0, compute_dtype="float32",
                lr=1e-2, seed=1)
    base.update(kw)
    return LRCNConfig(**base)


def make_batch(cfg, batch=8, length=7, seed=0):
    rng = np.random.default_rng(seed)
    tokens = jnp.asarray(
        rng.integers(3, cfg.vocab_size, (batch, length)), jnp.int32)
    lengths = jnp.asarray(rng.integers(2, length + 1, (batch,)), jnp.int32)
    feats = jnp.asarray(
        rng.standard_normal((batch, cfg.cnn_feature_dim)), jnp.float32)
    return tokens, lengths, feats


@pytest.mark.parametrize("mesh_shape", [(4, 2), (1, 2)])
def test_pipeline_loss_matches_single_device(mesh_shape):
    cfg = small_cfg()
    mesh = make_mesh(mesh_shape)
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    tokens, lengths, feats = make_batch(cfg)

    ref_total, ref_count = lrcn.loss_total_count(
        params, tokens, lengths, feats, compute_dtype=jnp.float32)
    total, count = jax.jit(
        lambda p, t, l, f: pipeline_loss_total_count(
            p, t, l, f, mesh, compute_dtype=jnp.float32)
    )(to_pipeline_params(params), tokens, lengths, feats)
    assert float(count) == float(ref_count)
    np.testing.assert_allclose(float(total), float(ref_total),
                               rtol=1e-5, atol=1e-4)


def test_pipeline_grads_match_single_device():
    cfg = small_cfg()
    mesh = make_mesh((4, 2))
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    tokens, lengths, feats = make_batch(cfg)

    g_ref = jax.grad(lambda p: lrcn.loss_fn(
        p, tokens, lengths, feats, compute_dtype=jnp.float32))(params)
    g_pp = jax.jit(jax.grad(lambda p: pipeline_loss_fn(
        p, tokens, lengths, feats, mesh, compute_dtype=jnp.float32)))(
        to_pipeline_params(params))
    g_pp = from_pipeline_params(g_pp)
    for path, a in jax.tree_util.tree_flatten_with_path(g_ref)[0]:
        b = a
        node = g_pp
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(np.asarray(node), np.asarray(b),
                                   rtol=1e-4, atol=1e-6, err_msg=str(path))


def test_pipeline_dropout_matches_single_device():
    """The dropout masks are constructed identically (same rng split and
    shapes), so even stochastic losses agree exactly."""
    cfg = small_cfg(dropout=0.4)
    mesh = make_mesh((4, 2))
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    tokens, lengths, feats = make_batch(cfg)
    rng = jax.random.PRNGKey(42)

    ref_total, _ = lrcn.loss_total_count(
        params, tokens, lengths, feats, pdrop=0.4, rng=rng,
        compute_dtype=jnp.float32)
    total, _ = jax.jit(
        lambda p, t, l, f, r: pipeline_loss_total_count(
            p, t, l, f, mesh, pdrop=0.4, rng=r, compute_dtype=jnp.float32)
    )(to_pipeline_params(params), tokens, lengths, feats, rng)
    np.testing.assert_allclose(float(total), float(ref_total),
                               rtol=1e-5, atol=1e-4)


def test_pipeline_train_step_reduces_loss():
    cfg = small_cfg()
    mesh = make_mesh((4, 2))
    step = PipelinedTrainStep(cfg, make_optimizer(cfg), mesh)
    params = step.shard_params(lrcn.init_params(jax.random.PRNGKey(0), cfg))
    opt_state = step.init_opt(params)
    batch = step.shard_batch(*make_batch(cfg))
    losses = []
    key = jax.random.PRNGKey(9)
    for _ in range(60):
        key, sk = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, *batch, sk)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]
    total, count = step.eval_batch(params, *batch)
    assert float(total) / float(count) < losses[0]


def test_pipeline_stage_params_are_sharded():
    """Each stage's LSTM weights live only on its 'model' slice, and the
    Adam moments follow (ZeRO-style over stages)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = small_cfg()
    mesh = make_mesh((4, 2))
    step = PipelinedTrainStep(cfg, make_optimizer(cfg), mesh)
    params = step.shard_params(lrcn.init_params(jax.random.PRNGKey(0), cfg))
    opt_state = step.init_opt(params)
    stage_sh = NamedSharding(mesh, P("model", None, None))
    assert params["lstm_pp"]["w"].sharding.is_equivalent_to(stage_sh, 3)
    moment_leaves = [
        leaf for path, leaf
        in jax.tree_util.tree_flatten_with_path(opt_state)[0]
        if any(getattr(k, "key", None) == "lstm_pp" for k in path)
        and getattr(leaf, "ndim", 0) == 3
    ]
    assert moment_leaves, "no Adam moments found for lstm_pp"
    for leaf in moment_leaves:
        assert leaf.sharding.is_equivalent_to(stage_sh, 3)


def test_pipeline_param_round_trip():
    cfg = small_cfg()
    params = lrcn.init_params(jax.random.PRNGKey(3), cfg)
    back = from_pipeline_params(to_pipeline_params(params))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))


def test_pipeline_config_validation():
    mesh = make_mesh((4, 2))
    with pytest.raises(ValueError, match="uniform cell"):
        validate_pipeline_config(small_cfg(hidden=(16, 32), embed=16), mesh)
    with pytest.raises(ValueError, match="uniform cell"):
        validate_pipeline_config(small_cfg(embed=12), mesh)
    with pytest.raises(ValueError, match="divisible"):
        validate_pipeline_config(small_cfg(vocab_size=31), mesh)
    with pytest.raises(ValueError, match="'model' mesh axis"):
        validate_pipeline_config(small_cfg(), make_mesh((2, 4)))


def test_pipeline_trainer_fit_and_checkpoint(tmp_path):
    """Trainer(pipeline=True) end to end: fit, layout-independent ckpt."""
    from lrcn_jax.core.tokenizer import Caption
    from lrcn_jax.core.vocab import Vocab
    from lrcn_jax.data import FeatureStore, bucket_batches
    from lrcn_jax.train import Trainer, load_checkpoint
    from lrcn_jax.train.metrics import MetricsLogger

    words = [f"w{i}" for i in range(29)]
    vocab = Vocab(words)
    cfg = small_cfg(vocab_size=len(vocab), epochs=1, batch_size=8)
    rng = np.random.default_rng(0)
    caps = [Caption(100 + i % 10, tuple(rng.choice(words, 5)))
            for i in range(40)]
    store = FeatureStore.from_dict(
        {100 + i: rng.standard_normal(cfg.cnn_feature_dim).astype(
            np.float32) for i in range(10)})
    batches = bucket_batches(caps, vocab, 8, apply_small_dataset_rule=False)

    mesh = make_mesh((4, 2))
    trainer = Trainer(cfg, vocab, MetricsLogger(echo=False), mesh=mesh,
                      pipeline=True)
    params, opt_state = trainer.init(jax.random.PRNGKey(0))
    trainer.fit(params, opt_state, batches, None, store, None,
                jax.random.PRNGKey(1), savefile=str(tmp_path / "ck"))
    ck = load_checkpoint(str(tmp_path / "ck"))
    # checkpoint is in the STANDARD decoder layout (usable for decoding)
    assert "lstm1" in ck["params"] and "lstm_pp" not in ck["params"]
    from lrcn_jax.decode.beam import beam_search
    feats = jnp.asarray(rng.standard_normal((4, cfg.cnn_feature_dim)),
                        jnp.float32)
    dev_params = jax.tree.map(jnp.asarray, ck["params"])
    tokens, scores = beam_search(dev_params, feats, beam_width=2,
                                 max_words=5, compute_dtype=jnp.float32)
    assert tokens.shape[0] == 4


def test_pipeline_ignores_steps_per_dispatch():
    """The pipelined step is its own shard_map program; steps_per_dispatch
    silently degrades to 1 rather than composing incorrectly."""
    from lrcn_jax.core.vocab import Vocab
    from lrcn_jax.train import Trainer
    from lrcn_jax.train.metrics import MetricsLogger

    cfg = small_cfg()
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    trainer = Trainer(cfg, vocab, MetricsLogger(echo=False),
                      mesh=make_mesh((4, 2)), pipeline=True,
                      steps_per_dispatch=8)
    assert trainer.steps_per_dispatch == 1
    assert trainer._multi_step is None
