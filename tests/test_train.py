"""Trainer / checkpoint tests: overfit a tiny synthetic dataset."""

import os

import jax
import numpy as np
import pytest

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.tokenizer import Caption
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data import FeatureStore, bucket_batches
from lrcn_jax.models import lrcn
from lrcn_jax.train import Trainer, load_checkpoint, save_checkpoint
from lrcn_jax.train.checkpoint import restore_opt_state
from lrcn_jax.train.metrics import MetricsLogger


def make_dataset(n_images=12, vocab_words=15, dim=24, seed=0):
    """Synthetic captions where the caption is a function of the feature."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab_words)]
    vocab = Vocab(words)
    caps, store = [], FeatureStore(dim=dim)
    for i in range(n_images):
        kind = i % 3
        text = {0: ("w0", "w1", "w2"), 1: ("w3", "w4", "w5", "w6"),
                2: ("w7", "w8")}[kind]
        caps.append(Caption(i, text))
        feat = np.zeros(dim, np.float32)
        feat[kind * 8:(kind + 1) * 8] = 1.0
        feat += rng.normal(scale=0.01, size=dim).astype(np.float32)
        store.add(i, feat)
    return vocab, caps, store


@pytest.fixture(scope="module")
def tiny_setup():
    vocab, caps, store = make_dataset()
    cfg = LRCNConfig(hidden=(32, 32), embed=16, cnn_feature_dim=24,
                     vocab_size=len(vocab), epochs=40, batch_size=4,
                     dropout=0.0, lr=1e-2, seed=11)
    batches = bucket_batches(caps, vocab, cfg.batch_size,
                             apply_small_dataset_rule=False)
    return cfg, vocab, caps, store, batches


def test_overfit_tiny_dataset(tiny_setup):
    cfg, vocab, caps, store, batches = tiny_setup
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False))
    params, opt_state = trainer.init(jax.random.PRNGKey(0))
    loss0 = trainer.average_loss(params, batches, store)
    params, opt_state = trainer.fit(
        params, opt_state, batches, None, store, None,
        jax.random.PRNGKey(1), epochs=40, eval_train_loss=False)
    loss1 = trainer.average_loss(params, batches, store)
    assert loss1 < loss0 * 0.2, (loss0, loss1)
    assert loss1 < 0.5


def test_checkpoint_roundtrip(tmp_path, tiny_setup):
    cfg, vocab, caps, store, batches = tiny_setup
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False))
    params, opt_state = trainer.init(jax.random.PRNGKey(0))
    save_checkpoint(str(tmp_path / "ck"), params, vocab, cfg,
                    opt_state=opt_state, epoch=3)

    ck = load_checkpoint(str(tmp_path / "ck"))
    assert ck["epoch"] == 3
    assert ck["vocab"].words == vocab.words
    assert ck["cfg"].hidden == cfg.hidden
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(ck["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # optimizer state restores into a fresh template
    template = trainer.opt.init(ck["params"])
    restored = restore_opt_state(template, ck["opt_leaves"])
    for a, b in zip(jax.tree.leaves(opt_state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_training(tmp_path, tiny_setup):
    """Losses after save->load->step must equal continuous training."""
    cfg, vocab, caps, store, batches = tiny_setup
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False))
    params, opt_state = trainer.init(jax.random.PRNGKey(0))

    params, opt_state = trainer.fit(
        params, opt_state, batches, None, store, None,
        jax.random.PRNGKey(1), epochs=2, eval_train_loss=False,
        savefile=str(tmp_path / "ck"))
    direct = trainer.average_loss(params, batches, store)

    ck = load_checkpoint(str(tmp_path / "ck"))
    resumed = trainer.average_loss(
        jax.tree.map(lambda x: jax.numpy.asarray(x), ck["params"]),
        batches, store)
    np.testing.assert_allclose(resumed, direct, rtol=1e-6)


def test_gclip_applies():
    """clip_by_global_norm(g) must be EXACTLY "rescale grads to norm g".

    Adam is scale-invariant on its first step, so "params moved a bit"
    cannot detect broken clipping; instead assert the defining property:
    feeding huge grads through the clipped optimizer equals feeding the
    same grads pre-scaled to the threshold through an unclipped one — and
    differs from feeding the raw huge grads through the unclipped one.
    """
    import dataclasses

    import optax

    from lrcn_jax.train.trainer import make_optimizer

    cfg = LRCNConfig(hidden=(32, 32), embed=16, cnn_feature_dim=24,
                     vocab_size=20, gclip=0.5, lr=1e-2, dropout=0.0)
    opt_clip = make_optimizer(cfg)
    opt_plain = make_optimizer(dataclasses.replace(cfg, gclip=0.0))

    key = jax.random.PRNGKey(0)
    params = {"a": jax.random.normal(key, (5, 3)),
              "b": jax.random.normal(jax.random.fold_in(key, 1), (4,))}
    g1 = jax.tree.map(lambda p: p * 0.01, params)      # norm < gclip
    g2 = jax.tree.map(lambda p: p * 1e4, params)       # norm >> gclip
    norm2 = float(optax.global_norm(g2))
    g2_scaled = jax.tree.map(lambda g: g * (cfg.gclip / norm2), g2)

    s_clip, s_plain = opt_clip.init(params), opt_plain.init(params)
    u1c, s_clip = opt_clip.update(g1, s_clip, params)
    u1p, s_plain = opt_plain.update(g1, s_plain, params)
    for a, b in zip(jax.tree.leaves(u1c), jax.tree.leaves(u1p)):
        np.testing.assert_allclose(a, b, rtol=1e-6)    # below: identity

    u2c, _ = opt_clip.update(g2, s_clip, params)
    u2p, _ = opt_plain.update(g2_scaled, s_plain, params)
    u2raw, _ = opt_plain.update(g2, s_plain, params)
    for a, b in zip(jax.tree.leaves(u2c), jax.tree.leaves(u2p)):
        np.testing.assert_allclose(a, b, rtol=1e-5)    # above: exact rescale
    # a regression dropping the clip stage would reproduce u2raw instead
    diff = max(float(np.max(np.abs(a - b)))
               for a, b in zip(jax.tree.leaves(u2c), jax.tree.leaves(u2raw)))
    assert diff > 1e-4, "clipped update is indistinguishable from unclipped"


def test_multi_step_matches_sequential_single_steps(tiny_setup):
    """K scanned steps (device-resident feature table) == K sequential
    single steps with the same batches and rng keys."""
    import jax.numpy as jnp

    cfg, vocab, caps, store, batches = tiny_setup
    import dataclasses
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    same_shape = [b for b in batches if b.padded_len == batches[0].padded_len
                  and b.batch_size == batches[0].batch_size][:2]
    assert len(same_shape) == 2

    t_multi = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False),
                      steps_per_dispatch=2)
    t_single = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False))
    params_m, opt_m = t_multi.init(jax.random.PRNGKey(0))
    params_s, opt_s = t_single.init(jax.random.PRNGKey(0))

    base = jax.random.PRNGKey(7)
    rngs = [jax.random.fold_in(base, i) for i in range(2)]
    tokens_k = np.stack([b.tokens for b in same_shape])
    lengths_k = np.stack([b.lengths for b in same_shape])
    rows_k = np.stack([store.rows(b.image_ids) for b in same_shape])
    params_m, opt_m, losses = t_multi._multi_step(
        params_m, opt_m, jnp.asarray(tokens_k), jnp.asarray(lengths_k),
        jnp.asarray(rows_k), t_multi._device_table(store), base,
        np.int32(0))

    s_losses = []
    for b, rng in zip(same_shape, rngs):
        params_s, opt_s, loss = t_single._train_step(
            params_s, opt_s, jnp.asarray(b.tokens), jnp.asarray(b.lengths),
            jnp.asarray(store.gather(b.image_ids), jnp.float32), rng)
        s_losses.append(float(loss))
    np.testing.assert_allclose(np.asarray(losses), s_losses, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(params_m), jax.tree.leaves(params_s)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_multi_step_fit_overfits(tiny_setup):
    """Full fit with steps_per_dispatch=3 (exercises the per-shape tail)."""
    cfg, vocab, caps, store, batches = tiny_setup
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False),
                      steps_per_dispatch=3)
    params, opt_state = trainer.init(jax.random.PRNGKey(0))
    loss0 = trainer.average_loss(params, batches, store)
    params, opt_state = trainer.fit(
        params, opt_state, batches, None, store, None,
        jax.random.PRNGKey(1), epochs=40, eval_train_loss=False)
    loss1 = trainer.average_loss(params, batches, store)
    assert loss1 < loss0 * 0.2, (loss0, loss1)


def test_multi_step_on_mesh(tiny_setup):
    """Scanned multi-step over a DP x TP mesh (table replicated)."""
    from lrcn_jax.parallel import make_mesh

    cfg, vocab, caps, store, batches = tiny_setup
    mesh = make_mesh((4, 1))
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False),
                      mesh=mesh, steps_per_dispatch=2)
    params, opt_state = trainer.init(jax.random.PRNGKey(0))
    params, opt_state, _ = trainer.train_epoch(
        params, opt_state, batches, store, jax.random.PRNGKey(1),
        np.random.default_rng(0))
    assert np.isfinite(
        trainer.average_loss(params, batches, store))


def test_bestfile_tracks_best_val_loss(tmp_path, tiny_setup):
    """--bestfile checkpoints only on validation improvement (the
    reference's latent :bestfile bug at lrcn.jl:63, implemented working)."""
    cfg, vocab, caps, store, batches = tiny_setup
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False))
    params, opt_state = trainer.init(jax.random.PRNGKey(0))
    trainer.fit(params, opt_state, batches, batches, store, store,
                jax.random.PRNGKey(1), epochs=3, eval_train_loss=False,
                savefile=str(tmp_path / "last"),
                bestfile=str(tmp_path / "best"))
    best = load_checkpoint(str(tmp_path / "best"))
    last = load_checkpoint(str(tmp_path / "last"))
    assert last["epoch"] == 3
    # loss decreases monotonically while overfitting: best == last epoch
    assert best["epoch"] == 3
    for a, b in zip(jax.tree.leaves(best["params"]),
                    jax.tree.leaves(last["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_multi_eval_matches_single_eval(tiny_setup):
    """average_loss via scanned multi-batch eval == single-batch eval."""
    cfg, vocab, caps, store, batches = tiny_setup
    t1 = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False))
    tk = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False),
                 steps_per_dispatch=2)
    params, _ = t1.init(jax.random.PRNGKey(0))
    a = t1.average_loss(params, batches, store)
    b = tk.average_loss(params, batches, store)
    np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_mid_epoch_checkpoint_resume_exact(tmp_path, tiny_setup,
                                           steps_per_dispatch):
    """Kill training mid-epoch; resuming from the step-interval
    checkpoint must replay the EXACT uninterrupted computation (same
    batch order from the saved shuffle state, same index-derived step
    keys) — final params bit-identical to a never-interrupted run.
    The reference only saves per epoch (lrcn.jl:228-231)."""
    cfg, vocab, caps, store, batches = tiny_setup
    ckpt_dir = str(tmp_path / f"ckpt_k{steps_per_dispatch}")
    n_epochs = 2

    def run(interrupt):
        trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False),
                          steps_per_dispatch=steps_per_dispatch)
        params, opt_state = trainer.init(jax.random.PRNGKey(0))

        if interrupt:
            class Crash(Exception):
                pass

            real_save = save_checkpoint
            calls = []

            # crash immediately after the SECOND mid-epoch save lands
            import lrcn_jax.train.trainer as trainer_mod

            def crashing_save(*a, **kw):
                real_save(*a, **kw)
                if kw.get("position") is not None:
                    calls.append(1)
                    if len(calls) == 2:
                        raise Crash()

            trainer_mod.save_checkpoint, orig = (
                crashing_save, trainer_mod.save_checkpoint)
            try:
                with pytest.raises(Crash):
                    trainer.fit(params, opt_state, batches, None, store,
                                None, jax.random.PRNGKey(1),
                                epochs=n_epochs, eval_train_loss=False,
                                savefile=ckpt_dir, ckpt_every=1)
            finally:
                trainer_mod.save_checkpoint = orig

            # resume exactly as cmd_train does: the SAME --epochs N is the
            # total budget, no manual arithmetic
            ckpt = load_checkpoint(ckpt_dir)
            assert ckpt["position"] is not None
            trainer2 = Trainer(cfg, vocab,
                               metrics=MetricsLogger(echo=False),
                               steps_per_dispatch=steps_per_dispatch)
            params2, opt2 = trainer2.init(jax.random.PRNGKey(0))
            params2 = jax.tree.map(jax.numpy.asarray, ckpt["params"])
            opt2 = restore_opt_state(opt2, ckpt["opt_leaves"])
            params2, opt2 = trainer2.fit(
                params2, opt2, batches, None, store, None,
                jax.random.PRNGKey(1), epochs=n_epochs,
                eval_train_loss=False, resume_position=ckpt["position"])
            return params2
        params, opt_state = trainer.fit(
            params, opt_state, batches, None, store, None,
            jax.random.PRNGKey(1), epochs=n_epochs,
            eval_train_loss=False)
        return params

    p_full = run(interrupt=False)
    p_resumed = run(interrupt=True)
    flat_a = jax.tree.leaves(p_full)
    flat_b = jax.tree.leaves(p_resumed)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ckpt_every_cli_flag_and_position_cleared(tmp_path, tiny_setup):
    """`lrcn train --ckpt-every N` writes mid-epoch saves; a run that
    COMPLETES leaves no resume position in the final checkpoint."""
    cfg, vocab, caps, store, batches = tiny_setup
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False))
    params, opt_state = trainer.init(jax.random.PRNGKey(0))
    ckpt_dir = str(tmp_path / "ckpt_clean")
    trainer.fit(params, opt_state, batches, None, store, None,
                jax.random.PRNGKey(1), epochs=1, eval_train_loss=False,
                savefile=ckpt_dir, ckpt_every=1)
    ckpt = load_checkpoint(ckpt_dir)
    assert ckpt["position"] is None       # epoch-complete save wins
    assert ckpt["epoch"] == 1


def test_checkpoint_save_is_atomic(tmp_path, tiny_setup):
    """A crash at any point of a periodic save must leave a loadable
    checkpoint: save_checkpoint writes to .tmp and swaps (the old
    in-place overwrite could tear the ONLY copy mid-write)."""
    import shutil

    from lrcn_jax.train.checkpoint import recover_checkpoint

    cfg, vocab, caps, store, batches = tiny_setup
    params = lrcn.init_params(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "atomic")
    save_checkpoint(path, params, vocab, cfg, epoch=1)

    # crash window 1: a partial .tmp next to an intact checkpoint
    tmp = path + ".tmp"
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "params.npz"), junk=np.zeros(1))
    assert recover_checkpoint(path) == path
    assert load_checkpoint(path)["epoch"] == 1
    assert not os.path.exists(tmp)

    # crash window 2: killed mid-swap — old moved aside, tmp complete
    save_checkpoint(path, params, vocab, cfg, epoch=2)
    shutil.move(path, path + ".old")
    save_dir = path + ".tmp"
    shutil.copytree(path + ".old", save_dir)
    assert recover_checkpoint(path) == path
    assert load_checkpoint(path)["epoch"] == 2


def test_resume_refuses_different_dispatch_geometry(tmp_path, tiny_setup):
    """A mid-epoch position records the dispatch geometry; resuming
    under different --steps-per-dispatch would reinterpret the dispatch
    index as a different batch stream and must fail loudly."""
    cfg, vocab, caps, store, batches = tiny_setup
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False),
                      steps_per_dispatch=2)
    params, opt_state = trainer.init(jax.random.PRNGKey(0))
    ckpt_dir = str(tmp_path / "geo")

    class Crash(Exception):
        pass

    import lrcn_jax.train.trainer as trainer_mod
    real = save_checkpoint

    def crashing(*a, **kw):
        real(*a, **kw)
        if kw.get("position") is not None:
            raise Crash()

    trainer_mod.save_checkpoint = crashing
    try:
        with pytest.raises(Crash):
            trainer.fit(params, opt_state, batches, None, store, None,
                        jax.random.PRNGKey(1), epochs=1,
                        eval_train_loss=False, savefile=ckpt_dir,
                        ckpt_every=1)
    finally:
        trainer_mod.save_checkpoint = real

    ckpt = load_checkpoint(ckpt_dir)
    wrong = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False),
                    steps_per_dispatch=1)   # different geometry
    p2, o2 = wrong.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="geometry"):
        wrong.fit(p2, o2, batches, None, store, None,
                  jax.random.PRNGKey(1), epochs=1, eval_train_loss=False,
                  resume_position=ckpt["position"])
