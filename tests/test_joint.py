"""Joint CNN+LSTM fine-tuning tests (scaled-down VGG for CPU speed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lrcn_jax.config import LRCNConfig
from lrcn_jax.models import vgg
from lrcn_jax.models.joint import (
    JointParams,
    JointTrainStep,
    joint_loss,
    make_joint_optimizer,
)
from lrcn_jax.parallel import make_mesh


def tiny_setup(mesh=None, freeze_cnn=False):
    cfg = LRCNConfig(hidden=(16, 16), embed=12, cnn_feature_dim=24,
                     vocab_size=30, dropout=0.0, lr=1e-2,
                     compute_dtype="float32", seed=1)
    opt = make_joint_optimizer(cfg, freeze_cnn=freeze_cnn)
    step = JointTrainStep(cfg, opt, mesh=mesh)
    vgg_params = vgg.init_vgg_params(jax.random.PRNGKey(0),
                                     width_multiplier=0.05, fc_dim=24)
    params, opt_state = step.init(jax.random.PRNGKey(1),
                                  vgg_params=vgg_params)
    rng = np.random.default_rng(0)
    batch = 8
    images = rng.standard_normal((batch, 224, 224, 3)).astype(np.float32)
    tokens = rng.integers(3, cfg.vocab_size, (batch, 6)).astype(np.int32)
    lengths = rng.integers(2, 7, (batch,)).astype(np.int32)
    return cfg, step, params, opt_state, (images, tokens, lengths)


def test_joint_loss_finite_and_grads_flow():
    cfg, step, params, opt_state, (images, tokens, lengths) = tiny_setup()
    loss = joint_loss(params, jnp.asarray(images), jnp.asarray(tokens),
                      jnp.asarray(lengths), compute_dtype=jnp.float32)
    assert np.isfinite(float(loss))
    grads = jax.grad(joint_loss)(params, jnp.asarray(images),
                                 jnp.asarray(tokens), jnp.asarray(lengths),
                                 compute_dtype=jnp.float32)
    # gradients reach the FIRST conv layer (full end-to-end backprop)
    g = grads.cnn["conv1_1"]["w"]
    assert float(jnp.max(jnp.abs(g))) > 0


def test_joint_training_reduces_loss():
    cfg, step, params, opt_state, batch = tiny_setup()
    dev_batch = step.shard_batch(*batch)
    losses = []
    key = jax.random.PRNGKey(2)
    for i in range(12):
        key, sk = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, *dev_batch, sk)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_freeze_cnn_keeps_cnn_params():
    cfg, step, params, opt_state, batch = tiny_setup(freeze_cnn=True)
    before = np.asarray(params.cnn["conv1_1"]["w"]).copy()
    dev_batch = step.shard_batch(*batch)
    params, opt_state, _ = step(params, opt_state, *dev_batch,
                                jax.random.PRNGKey(3))
    np.testing.assert_array_equal(np.asarray(params.cnn["conv1_1"]["w"]),
                                  before)
    # decoder DID update
    assert not np.array_equal(
        np.asarray(params.decoder["w_out"]),
        np.asarray(jax.tree.leaves({"w": params.decoder["w_out"]})[0]) * 0)


def test_multi_step_matches_sequential_steps():
    """K steps in one scanned dispatch == K single-step dispatches.

    Dropout is 0 in tiny_setup, so the rng plumbing cannot mask a
    divergence; the sequential reference still uses the exact fold_in
    keys the scan derives, to keep the test meaningful with dropout.
    """
    cfg, step, params, opt_state, (images, tokens, lengths) = tiny_setup()
    rng = np.random.default_rng(7)
    images2 = rng.standard_normal(images.shape).astype(np.float32)
    tokens2 = rng.integers(3, cfg.vocab_size, tokens.shape).astype(np.int32)
    lengths2 = rng.integers(2, 7, lengths.shape).astype(np.int32)
    base = jax.random.PRNGKey(11)

    p_seq = jax.tree.map(jnp.copy, params)
    o_seq = jax.tree.map(jnp.copy, opt_state)
    seq_losses = []
    for i, (im, tk, ln) in enumerate([(images, tokens, lengths),
                                      (images2, tokens2, lengths2)]):
        dev = step.shard_batch(im, tk, ln)
        p_seq, o_seq, loss = step(p_seq, o_seq, *dev,
                                  jax.random.fold_in(base, i))
        seq_losses.append(float(loss))

    chunk = step.shard_chunk(np.stack([images, images2]),
                             np.stack([tokens, tokens2]),
                             np.stack([lengths, lengths2]))
    p_k, o_k, losses = step.multi_step(params, opt_state, *chunk, base, 0)

    np.testing.assert_allclose(np.asarray(losses), seq_losses, atol=1e-5)
    for a, b in zip(jax.tree.leaves(p_seq), jax.tree.leaves(p_k)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5)


def test_uint8_feed_matches_host_preprocess():
    """uint8 pixels + on-device mean-subtract == host float32 preprocess."""
    cfg, step, params, opt_state, (_, tokens, lengths) = tiny_setup()
    rng = np.random.default_rng(9)
    avg = rng.uniform(90.0, 130.0, (224, 224, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (8, 224, 224, 3)).astype(np.uint8)

    opt = make_joint_optimizer(cfg)
    step_avg = JointTrainStep(cfg, opt, average_image=avg)
    dev = step_avg.shard_batch(u8, tokens, lengths)
    assert dev[0].dtype == jnp.uint8   # the wire format stays uint8
    t_dev, c_dev = step_avg.eval_batch(params, *dev)

    step_zero = JointTrainStep(cfg, opt)   # zero mean image
    host = u8.astype(np.float32) - avg     # the old host-side pipeline
    t_host, c_host = step_zero.eval_batch(
        params, *step_zero.shard_batch(host, tokens, lengths))

    assert float(c_dev) == float(c_host)
    np.testing.assert_allclose(float(t_dev), float(t_host), rtol=1e-5)


def test_joint_step_on_mesh():
    mesh = make_mesh((8, 1))
    cfg, step, params, opt_state, batch = tiny_setup(mesh=mesh)
    dev_batch = step.shard_batch(*batch)
    params, opt_state, loss = step(params, opt_state, *dev_batch,
                                   jax.random.PRNGKey(4))
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_joint_mid_epoch_resume_exact(tmp_path, monkeypatch,
                                      steps_per_dispatch):
    """Crash the joint fine-tune mid-epoch; resume must be bit-identical
    to the uninterrupted run (same protocol as the decoder trainer)."""
    import functools

    from PIL import Image

    from lrcn_jax.core.tokenizer import Caption
    from lrcn_jax.core.vocab import Vocab
    from lrcn_jax.data.batcher import bucket_batches
    from lrcn_jax.train import joint as joint_mod
    from lrcn_jax.train.checkpoint import (
        load_checkpoint,
        restore_opt_state,
        save_checkpoint,
    )
    from lrcn_jax.train.joint import (
        JointTrainer,
        identity_average_image,
        load_joint_params,
    )
    from lrcn_jax.train.metrics import MetricsLogger

    monkeypatch.setattr(
        vgg, "init_vgg_params",
        functools.partial(vgg.init_vgg_params,
                          width_multiplier=0.05, fc_dim=16))

    rng = np.random.default_rng(7)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    paths = {}
    caps = []
    for i in range(8):
        iid = 9000 + i
        p = str(img_dir / f"{iid}.jpg")
        Image.fromarray(rng.integers(0, 255, (230, 240, 3))
                        .astype(np.uint8)).save(p)
        paths[iid] = p
        caps.append(Caption(iid, ("w0", "w1", f"w{2 + i % 3}")))
    vocab = Vocab([f"w{i}" for i in range(6)])
    cfg = LRCNConfig(hidden=(12, 12), embed=8, cnn_feature_dim=16,
                     vocab_size=len(vocab), dropout=0.0, lr=1e-2,
                     compute_dtype="float32", seed=3, batch_size=2)
    batches = bucket_batches(caps, vocab, cfg.batch_size,
                             apply_small_dataset_rule=False)
    ckpt_dir = str(tmp_path / "jckpt")

    def make():
        trainer = JointTrainer(
            cfg, vocab, paths, identity_average_image(),
            metrics=MetricsLogger(echo=False),
            steps_per_dispatch=steps_per_dispatch)
        vgg_params = vgg.init_vgg_params(jax.random.PRNGKey(0))
        params, opt_state = trainer.init(jax.random.PRNGKey(1),
                                         vgg_params=vgg_params)
        return trainer, params, opt_state

    # uninterrupted run
    trainer, params, opt_state = make()
    p_full, _ = trainer.fit(params, opt_state, batches, None,
                            jax.random.PRNGKey(2), epochs=1)

    # interrupted-and-resumed run: crash after the first mid-epoch save
    trainer, params, opt_state = make()

    class Crash(Exception):
        pass

    real_save = save_checkpoint

    def crashing_save(*a, **kw):
        real_save(*a, **kw)
        if kw.get("position") is not None:
            raise Crash()

    monkeypatch.setattr(joint_mod, "save_checkpoint", crashing_save)
    with pytest.raises(Crash):
        trainer.fit(params, opt_state, batches, None,
                    jax.random.PRNGKey(2), epochs=1,
                    savefile=ckpt_dir, ckpt_every=1)
    monkeypatch.setattr(joint_mod, "save_checkpoint", real_save)

    ckpt = load_checkpoint(ckpt_dir)
    assert ckpt["position"] is not None
    trainer2, params2, opt2 = make()
    params2 = load_joint_params(
        jax.tree.map(jnp.asarray, ckpt["params"]))
    opt2 = restore_opt_state(opt2, ckpt["opt_leaves"])
    p_res, _ = trainer2.fit(params2, opt2, batches, None,
                            jax.random.PRNGKey(2), epochs=1,
                            resume_position=ckpt["position"])

    for a, b in zip(jax.tree.leaves(p_full), jax.tree.leaves(p_res)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
