"""Native C++ BLEU core: build, load, and bit-for-bit parity tests."""

import os
import subprocess

import pytest

from lrcn_jax.evaluation import bleu as bleu_mod
from lrcn_jax.native import bleu_library, native_enabled


def test_native_library_builds_and_loads():
    lib = bleu_library()
    assert lib is not None, "C++ BLEU core failed to build/load"


def test_native_matches_python(monkeypatch):
    hyps = ["a man rides a horse .", "two dogs play in the park .",
            "", "unseen words entirely ."]
    refs = [
        ["a man rides a horse .", "a person rides a horse .",
         "man on horse .", "a man is riding .", "rider on a horse ."],
        ["two dogs play outside .", "dogs playing in a park .",
         "two dogs in the park .", "a pair of dogs play .",
         "dogs play in the grass ."],
        ["something .", "anything .", "x .", "y .", "z ."],
        ["totally different caption .", "another one .", "third .",
         "fourth .", "fifth ."],
    ]
    native = bleu_mod.multi_bleu(hyps, refs)
    monkeypatch.setenv("LRCN_NATIVE", "0")
    python = bleu_mod.multi_bleu(hyps, refs)
    assert native.format() == python.format()
    assert native.hyp_len == python.hyp_len
    assert native.ref_len == python.ref_len
    assert native.bleu == python.bleu


def test_native_matches_python_lowercase(monkeypatch):
    hyps = ["A Man RIDES"]
    refs = [["a man rides", "A MAN rode", "nothing", "x", "y"]]
    native = bleu_mod.multi_bleu(hyps, refs, lowercase=True)
    monkeypatch.setenv("LRCN_NATIVE", "0")
    python = bleu_mod.multi_bleu(hyps, refs, lowercase=True)
    assert native.format() == python.format()


def test_native_golden_artifact_parity(reference_eval_dir):
    """Native path reproduces the Perl scorer on the committed artifacts."""
    stem = os.path.join(reference_eval_dir, "coco_refs", "ref")
    cand = os.path.join(reference_eval_dir, "candidates.txt")
    result = bleu_mod.multi_bleu_files(stem, cand)
    perl = subprocess.run(
        ["perl", os.path.join(reference_eval_dir, "multi-bleu.perl"), stem],
        stdin=open(cand, "rb"), capture_output=True, text=True)
    assert result.format() == perl.stdout.strip()


def test_native_disabled_env(monkeypatch):
    monkeypatch.setenv("LRCN_NATIVE", "0")
    assert not native_enabled()
    assert bleu_mod._counts_native(["a"], [["a"]], False) is None


class TestImageLoader:
    """C++ threaded JPEG loader: build, correctness vs PIL, fallbacks."""

    def _make_jpegs(self, tmp_path, n=6):
        import numpy as np
        from PIL import Image
        rng = np.random.default_rng(0)
        paths = []
        sizes = [(300, 400), (400, 300), (224, 224), (250, 600),
                 (1024, 768), (231, 240)]
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            p = str(tmp_path / f"img{i}.jpg")
            Image.fromarray(
                rng.integers(0, 255, (h, w, 3)).astype("uint8"),
            ).save(p, quality=92)
            paths.append(p)
        return paths

    def test_loader_builds(self):
        from lrcn_jax.native import imageloader_library
        assert imageloader_library() is not None

    def test_loader_close_to_pil(self, tmp_path):
        import numpy as np
        from lrcn_jax.data.images import (
            decode_image, load_batch_native, resize_crop)
        paths = self._make_jpegs(tmp_path)
        out, ok = load_batch_native(paths)
        assert out.shape == (len(paths), 224, 224, 3)
        assert ok.all()
        for i, p in enumerate(paths):
            pil = resize_crop(decode_image(p))
            # different resamplers (DCT-scaled libjpeg + 2-tap bilinear vs
            # PIL antialiased): compare mean abs difference, not pixels
            diff = np.abs(out[i].astype(np.float32)
                          - pil.astype(np.float32)).mean()
            assert diff < 12.0, (p, diff)

    def test_loader_geometry_from_original_dims(self, tmp_path):
        """Resize targets must come from the ORIGINAL dims, not DCT-scaled.

        500x353: reference geometry gives new_w = 500*224//353 = 317;
        computing from the 6/8-DCT-scaled decode (375x265) gives 316,
        shifting the center crop.  A strong horizontal gradient makes a
        one-pixel geometry error visible as a large mean difference.
        """
        import numpy as np
        from PIL import Image

        from lrcn_jax.data.images import (
            decode_image,
            load_batch_native,
            resize_crop,
        )

        grad = np.tile(
            np.linspace(0, 255, 500, dtype=np.uint8)[None, :, None],
            (353, 1, 3))
        path = str(tmp_path / "grad.jpg")
        Image.fromarray(grad).save(path, quality=95)
        out, ok = load_batch_native([path])
        assert ok.all()
        pil = resize_crop(decode_image(path))
        diff = np.abs(out[0].astype(np.float32)
                      - pil.astype(np.float32)).mean()
        assert diff < 2.0, diff   # sub-pixel resampler noise only

    def test_loader_flags_bad_files(self, tmp_path):
        from lrcn_jax.data.images import load_batch_native
        good = self._make_jpegs(tmp_path, 1)[0]
        bad = str(tmp_path / "broken.jpg")
        with open(bad, "wb") as f:
            f.write(b"not a jpeg at all")
        out, ok = load_batch_native([good, bad, good])
        assert ok.tolist() == [True, False, True]
        assert (out[1] == 0).all()

    def test_extract_features_uses_native_path(self, tmp_path):
        import jax
        import numpy as np
        from lrcn_jax.data.images import extract_features
        from lrcn_jax.models import vgg
        paths = {100 + i: p
                 for i, p in enumerate(self._make_jpegs(tmp_path, 3))}
        params = vgg.init_vgg_params(jax.random.PRNGKey(0),
                                     width_multiplier=0.05, fc_dim=16)
        store = extract_features(paths, params,
                                 np.zeros((224, 224, 3), np.float32),
                                 batch_size=2)
        assert len(store) == 3
