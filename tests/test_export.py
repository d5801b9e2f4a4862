"""Frozen-model export (jax.export StableHLO artifacts): round-trip
parity with the live decode path, symbolic-batch reuse, the CLI
surface, and the consumer-side loader.

The reference has no deployment story (serving means re-running the
Julia source, SURVEY.md §3.2); the export subsystem is a pure addition.
What IS parity-critical: the frozen program must reproduce the live
``beam_search`` token-for-token, because the artifact is what a
deployment serves."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.decode.beam import beam_search, greedy_search
from lrcn_jax.decode.sample import best_of_n_search
from lrcn_jax.export import (
    DEFAULT_PLATFORMS,
    export_decoder,
    export_image_pipeline,
    load_exported,
    save_exported,
)
from lrcn_jax.models import lrcn


@pytest.fixture(scope="module")
def setup():
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    params = lrcn.init_params(jax.random.PRNGKey(3), cfg)
    vocab = Vocab([f"w{i}" for i in range(22)])
    return cfg, params, vocab


def test_export_round_trip_matches_live_decode(setup, tmp_path):
    """Serialized-and-reloaded programs must equal the live jitted path
    bit for bit, at MULTIPLE batch sizes through one symbolic-batch
    artifact."""
    _cfg, params, vocab = setup
    out = str(tmp_path / "export")
    manifest = save_exported(out, params, vocab,
                             variants=("beam", "greedy", "sample"),
                             beam_width=3, max_words=12, sample_n=4,
                             temperature=1.5)
    assert sorted(manifest["variants"]) == ["beam", "greedy", "sample"]
    model = load_exported(out)
    assert model.manifest["platforms"] == ["cpu", "cuda"]

    rng = np.random.default_rng(0)
    for b in (5, 7):    # two batch sizes, same artifact
        feats = rng.normal(size=(b, 10)).astype(np.float32)
        tokens, scores = model.call("beam", feats)
        want_t, want_s = beam_search(params, jnp.asarray(feats),
                                     beam_width=3, max_words=12)
        np.testing.assert_array_equal(np.asarray(tokens),
                                      np.asarray(want_t))
        np.testing.assert_allclose(np.asarray(scores), np.asarray(want_s),
                                   rtol=1e-6)

        tokens, _ = model.call("greedy", feats)
        want_t, _ = greedy_search(params, jnp.asarray(feats), max_words=12)
        np.testing.assert_array_equal(np.asarray(tokens),
                                      np.asarray(want_t))

        key = jax.random.PRNGKey(7)
        tokens, scores = model.call("sample", feats,
                                    np.asarray(key, np.uint32))
        want_t, want_s = best_of_n_search(params, jnp.asarray(feats), key,
                                          n_samples=4, temperature=1.5,
                                          max_words=12)
        np.testing.assert_array_equal(np.asarray(tokens),
                                      np.asarray(want_t))


def test_exported_captions_detokenize_with_bundled_vocab(setup, tmp_path):
    _cfg, params, vocab = setup
    from lrcn_jax.decode.writer import detokenize_batch

    out = str(tmp_path / "export")
    save_exported(out, params, vocab, variants=("beam",), max_words=8)
    model = load_exported(out)
    feats = np.random.default_rng(1).normal(size=(3, 10)).astype(np.float32)
    lines = model.captions("beam", feats)
    tokens, _ = beam_search(params, jnp.asarray(feats), beam_width=3,
                            max_words=8)
    assert lines == detokenize_batch(np.asarray(tokens), vocab)


def test_export_image_pipeline_pixels_to_tokens(setup):
    """The full-pipeline artifact (uint8 pixels -> tokens) must match
    preprocess -> vgg -> l1 -> beam run as separate live steps."""
    _cfg, params, _vocab = setup
    from lrcn_jax.models.vgg import init_vgg_params, l1_normalize, vgg16_fc7

    vgg = init_vgg_params(jax.random.PRNGKey(5), width_multiplier=0.0,
                          fc_dim=10)
    avg = np.full((224, 224, 3), 117.0, np.float32)
    exp = export_image_pipeline(vgg, avg, params, beam_width=2,
                                max_words=6, batch=2)
    pixels = np.random.default_rng(2).integers(
        0, 256, size=(2, 224, 224, 3), dtype=np.uint8)
    tokens, scores = exp.call(pixels)

    images = jnp.asarray(pixels, jnp.float32) - jnp.asarray(avg)
    feats = l1_normalize(vgg16_fc7(vgg, images))
    want_t, want_s = beam_search(params, feats, beam_width=2, max_words=6)
    np.testing.assert_array_equal(np.asarray(tokens), np.asarray(want_t))
    np.testing.assert_allclose(np.asarray(scores), np.asarray(want_s),
                               rtol=1e-6)


def test_cli_export_and_reload(setup, tmp_path):
    """`lrcn export` on a saved checkpoint -> loadable artifact matching
    the checkpoint's live decode; decoder-only checkpoints refuse the
    image variant with a clear error."""
    cfg, params, vocab = setup
    from lrcn_jax.cli import main
    from lrcn_jax.train.checkpoint import save_checkpoint

    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, params, vocab, cfg)
    out = str(tmp_path / "frozen")
    rc = main(["export", "--loadfile", ckpt, "--out", out,
               "--variants", "beam,greedy", "--beam_width", "2",
               "--generate", "9"])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["beam.hlo", "export.json",
                                       "greedy.hlo", "vocab.json"]
    model = load_exported(out)
    assert model.manifest["beam_width"] == 2
    feats = np.random.default_rng(3).normal(size=(4, 10)).astype(np.float32)
    tokens, _ = model.call("beam", feats)
    want_t, _ = beam_search(params, jnp.asarray(feats), beam_width=2,
                            max_words=9)
    np.testing.assert_array_equal(np.asarray(tokens), np.asarray(want_t))
    # the bundled vocab is the checkpoint's
    assert len(model.vocab) == len(vocab)

    with pytest.raises(SystemExit, match="image variant needs an encoder"):
        main(["export", "--loadfile", ckpt, "--out",
              str(tmp_path / "frozen2"), "--variants", "image"])


def test_export_lowers_for_cuda(setup, tmp_path):
    """A GPU lowering is produced without a GPU present, and the CLI's
    default artifact carries it next to the CPU one."""
    _cfg, params, vocab = setup
    exported = export_decoder(params, beam_width=2, max_words=5,
                              platforms=("cuda",))
    assert exported.platforms == ("cuda",)
    assert "stablehlo" in exported.mlir_module()
    assert DEFAULT_PLATFORMS == ("cpu", "cuda")


def test_export_rejects_unknown_variant(setup, tmp_path):
    _cfg, params, vocab = setup
    with pytest.raises(ValueError, match="unknown export variant"):
        save_exported(str(tmp_path / "x"), params, vocab,
                      variants=("beams",))
