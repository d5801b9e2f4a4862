"""Frozen-model export: serialized StableHLO decode programs.

The reference has no deployment story at all — serving a trained model
means carrying the whole Julia source tree plus Knet and re-tracing the
host-looped beam search (SURVEY.md §3.2).  This module freezes a trained
checkpoint into a **self-contained, versioned StableHLO artifact**
(``jax.export``): the caption program with the parameters embedded as
constants, lowered for BOTH cpu and cuda by default, with a symbolic batch
dimension so one artifact serves any batch size.  The artifact needs only
``jax`` to run — none of this framework's model code — and is guaranteed
stable across jax releases by the StableHLO serialization contract.

Artifacts (one directory):

    export_dir/
      beam.hlo      feats (b, F) f32 -> (tokens (b, T+2) i32, scores (b,))
      greedy.hlo    optional greedy variant (``variants``)
      sample.hlo    optional best-of-N sampling variant (adds an rng arg)
      image.hlo     optional full pipeline: uint8 pixels -> tokens
                    (only when the checkpoint carries a fine-tuned
                    encoder, or an explicit .mat is given)
      vocab.json    the checkpoint's vocab (detokenization contract)
      export.json   manifest: variants, shapes, decode settings

Round-trip loading lives here too (``load_exported``) so the CLI and the
tests exercise the exact consumer path.

Exactness contract: the CPU lowering reproduces the live
``beam_search`` bit for bit (pinned in tests/test_export.py).  An
accelerator lowering embeds the parameters as constants, which lets XLA
fold/layout the weights differently than the live parameter-fed program,
so bf16 near-ties (beams whose scores agree to the last bits) may rank
either way there; scores still agree to rounding.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import export as jax_export

from lrcn_jax.core.vocab import Vocab

# StableHLO artifacts are platform-checked at call time; exporting for
# both means the same file deploys to a GPU server and a CPU canary.
DEFAULT_PLATFORMS = ("cpu", "cuda")

_MANIFEST = "export.json"


def _symbolic_batch(feature_dim: int, dtype) -> jax.ShapeDtypeStruct:
    (b,) = jax_export.symbolic_shape("b")
    return jax.ShapeDtypeStruct((b, feature_dim), dtype)


def _freeze(fn: Callable, example: tuple, platforms) -> jax_export.Exported:
    """Export ``fn`` (params already closed over) for ``platforms``."""
    return jax_export.export(jax.jit(fn), platforms=list(platforms))(*example)


def export_decoder(params: Any, *, variant: str = "beam",
                   beam_width: int = 3, max_words: int = 30,
                   sample_n: int = 100, temperature: float = 2.0,
                   compute_dtype=jnp.bfloat16, batch: int | None = None,
                   platforms=DEFAULT_PLATFORMS) -> jax_export.Exported:
    """Freeze one decode variant over ``params``.

    ``batch=None`` exports a symbolic batch dimension (any size at call
    time); an int pins it (slightly better compile-time specialization).
    The exported callable takes L1-normalized fc7 rows, matching
    ``decode.beam.beam_search`` bit for bit.
    """
    from lrcn_jax.decode import beam, sample

    feature_dim = int(np.asarray(params["w_cnn"]).shape[0])
    if batch is None:
        feats_spec = _symbolic_batch(feature_dim, jnp.float32)
    else:
        feats_spec = jax.ShapeDtypeStruct((batch, feature_dim), jnp.float32)

    if variant == "beam":
        def fn(feats):
            return beam.beam_search(params, feats, beam_width=beam_width,
                                    max_words=max_words,
                                    compute_dtype=compute_dtype)
        example = (feats_spec,)
    elif variant == "greedy":
        def fn(feats):
            return beam.greedy_search(params, feats, max_words=max_words,
                                      compute_dtype=compute_dtype)
        example = (feats_spec,)
    elif variant == "sample":
        def fn(feats, rng):
            return sample.best_of_n_search(
                params, feats, rng, n_samples=sample_n,
                temperature=temperature, max_words=max_words,
                compute_dtype=compute_dtype)
        example = (feats_spec,
                   jax.ShapeDtypeStruct((2,), jnp.uint32))
    else:
        raise ValueError(f"unknown export variant {variant!r}")
    return _freeze(fn, example, platforms)


def export_image_pipeline(vgg_params: Any, average_image: np.ndarray,
                          params: Any, *, beam_width: int = 3,
                          max_words: int = 30, compute_dtype=jnp.bfloat16,
                          batch: int | None = None,
                          platforms=DEFAULT_PLATFORMS
                          ) -> jax_export.Exported:
    """Freeze the FULL pipeline: (b, 224, 224, 3) uint8 RGB -> captions.

    Embeds the encoder (fine-tuned or .mat), the mean image, the
    255-scale preprocessing (lrcn.jl:771), the live-path L1 normalize
    (lrcn.jl:597), and the beam search in one program — the deployment
    shape of the reference's single-image mode (SURVEY.md §3.4), minus
    only the host-side JPEG decode/resize.
    """
    from lrcn_jax.decode import beam
    from lrcn_jax.models.vgg import l1_normalize, vgg16_fc7_fn

    avg = jnp.asarray(np.asarray(average_image), jnp.float32)

    def fn(pixels_u8):
        images = pixels_u8.astype(jnp.float32) - avg
        feats = vgg16_fc7_fn(params_vgg, images, compute_dtype)
        feats = l1_normalize(feats)
        return beam.beam_search(params, feats, beam_width=beam_width,
                                max_words=max_words,
                                compute_dtype=compute_dtype)

    params_vgg = vgg_params
    if batch is None:
        (b,) = jax_export.symbolic_shape("b")
        spec = jax.ShapeDtypeStruct((b, 224, 224, 3), jnp.uint8)
    else:
        spec = jax.ShapeDtypeStruct((batch, 224, 224, 3), jnp.uint8)
    return _freeze(fn, (spec,), platforms)


def save_exported(out_dir: str, params: Any, vocab: Vocab, *,
                  variants=("beam",), beam_width: int = 3,
                  max_words: int = 30, sample_n: int = 100,
                  temperature: float = 2.0, compute_dtype=jnp.bfloat16,
                  batch: int | None = None, platforms=DEFAULT_PLATFORMS,
                  vgg_params: Any = None,
                  average_image: np.ndarray | None = None) -> dict:
    """Export ``variants`` plus vocab + manifest into ``out_dir``.

    Returns the manifest dict.  ``"image"`` in ``variants`` requires
    ``vgg_params``/``average_image``.
    """
    os.makedirs(out_dir, exist_ok=True)
    manifest: dict = {
        "format": "jax.export.stablehlo", "version": 1,
        "platforms": list(platforms),
        "beam_width": beam_width, "max_words": max_words,
        "compute_dtype": np.dtype(compute_dtype).name
        if compute_dtype != jnp.bfloat16 else "bfloat16",
        "batch": batch, "variants": {},
    }
    for variant in variants:
        if variant == "image":
            if vgg_params is None or average_image is None:
                raise ValueError("image export needs an encoder: pass "
                                 "vgg_params + average_image (a joint "
                                 "checkpoint or --cnn)")
            exp = export_image_pipeline(
                vgg_params, average_image, params, beam_width=beam_width,
                max_words=max_words, compute_dtype=compute_dtype,
                batch=batch, platforms=platforms)
            entry = {"input": "uint8 pixels (b, 224, 224, 3), RGB, "
                              "resized+cropped"}
        else:
            exp = export_decoder(
                params, variant=variant, beam_width=beam_width,
                max_words=max_words, sample_n=sample_n,
                temperature=temperature, compute_dtype=compute_dtype,
                batch=batch, platforms=platforms)
            entry = {"input": "L1-normalized fc7 rows (b, F) float32"}
            if variant == "sample":
                entry["input"] += " + uint32[2] PRNG key"
                entry.update(sample_n=sample_n, temperature=temperature)
        name = f"{variant}.hlo"
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(exp.serialize())
        entry["file"] = name
        manifest["variants"][variant] = entry
    vocab.save(os.path.join(out_dir, "vocab.json"))
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


@dataclass
class ExportedModel:
    """A loaded export directory: callable variants + the vocab."""

    manifest: dict
    vocab: Vocab
    _fns: dict

    def call(self, variant: str, *args):
        """Run a variant; returns (tokens, scores) as jax arrays."""
        if variant not in self._fns:
            raise KeyError(f"variant {variant!r} not in this export "
                           f"(has: {sorted(self._fns)})")
        return self._fns[variant].call(*args)

    def captions(self, variant: str, *args) -> list[str]:
        """Run a variant and detokenize to caption lines."""
        from lrcn_jax.decode.writer import detokenize_batch

        tokens, _ = self.call(variant, *args)
        return detokenize_batch(np.asarray(tokens), self.vocab)


def load_exported(out_dir: str) -> ExportedModel:
    """Load an export directory written by ``save_exported``.

    Deserialization needs only jax — the model classes never load; this
    is the consumer path a deployment would run.
    """
    with open(os.path.join(out_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    fns = {}
    for variant, entry in manifest["variants"].items():
        with open(os.path.join(out_dir, entry["file"]), "rb") as f:
            fns[variant] = jax_export.deserialize(bytearray(f.read()))
    vocab = Vocab.load(os.path.join(out_dir, "vocab.json"))
    return ExportedModel(manifest=manifest, vocab=vocab, _fns=fns)
