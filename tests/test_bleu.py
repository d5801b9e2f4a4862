"""BLEU scorer parity tests.

The headline check: our Python multi-bleu must reproduce the reference's
modified Moses Perl scorer (BP disabled) bit-for-bit on the reference repo's
committed eval artifacts — the reference's only turnkey "test" (SURVEY.md §4).
"""

import os
import shutil
import subprocess

import pytest

from lrcn_jax.evaluation import multi_bleu, multi_bleu_files

PERL = shutil.which("perl")


def _perl_score(eval_dir, ref_stem, hyp_path):
    with open(hyp_path, "rb") as f:
        out = subprocess.run(
            [PERL, os.path.join(eval_dir, "multi-bleu.perl"), ref_stem],
            stdin=f, capture_output=True, check=True, cwd=eval_dir)
    return out.stdout.decode().strip()


@pytest.mark.skipif(PERL is None, reason="perl not available")
@pytest.mark.parametrize("refs,hyps", [
    ("coco_refs/ref", "candidates.txt"),
    ("coco_refs/ref", "caps_coco_bm4"),
    ("coco_refs/ref", "caps_coco_bm5"),
    ("flickr_refs/f_ref", "caps_flickr_bm5"),
    ("flickr_refs/f_ref", "caps_flickr_bm10"),
])
def test_parity_with_perl_on_reference_artifacts(reference_eval_dir, refs,
                                                 hyps):
    ref_stem = os.path.join(reference_eval_dir, refs)
    hyp_path = os.path.join(reference_eval_dir, hyps)
    if not os.path.exists(hyp_path) or not os.path.exists(ref_stem + "0"):
        pytest.skip("artifact missing")
    expected = _perl_score(reference_eval_dir, ref_stem, hyp_path)
    got = multi_bleu_files(ref_stem, hyp_path).format()
    assert got == expected


def test_known_reference_score(reference_eval_dir):
    """BASELINE.md row: candidates.txt vs coco_refs -> 68.2/47.1/33.0/23.5."""
    ref_stem = os.path.join(reference_eval_dir, "coco_refs/ref")
    hyp_path = os.path.join(reference_eval_dir, "candidates.txt")
    result = multi_bleu_files(ref_stem, hyp_path)
    assert result.format().startswith("BLEU = 68.2/47.1/33.0/23.5")


def test_perfect_match_scores_100():
    hyps = ["a cat sat on the mat .", "dogs run in the park ."]
    refs = [[h] for h in hyps]
    r = multi_bleu(hyps, refs)
    assert r.bleu == (1.0, 1.0, 1.0, 1.0)
    assert r.brevity_penalty == 1.0


def test_no_brevity_penalty():
    # A 2-word hypothesis vs a 10-word reference: standard BLEU would apply
    # BP = exp(1 - 10/2); the reference scorer does not (multi-bleu.perl:118).
    hyps = ["a cat"]
    refs = [["a cat sat on the mat near the front door"]]
    r = multi_bleu(hyps, refs)
    assert r.brevity_penalty == 1.0
    assert r.bleu[0] == 1.0  # unigram precision 2/2, no penalty
    assert r.ratio == pytest.approx(0.2)


def test_clipping():
    # "the the the" vs ref with two "the": clipped unigram correct = 2/3.
    r = multi_bleu(["the the the"], [["the cat the"]])
    assert r.bleu[0] == pytest.approx(2 / 3)


def test_zero_ngram_uses_my_log_floor():
    # No 4-gram overlap -> my_log(0) = -9999999999 -> bleu4 == 0.0 exactly
    # after exp() underflow, matching the Perl scorer's printed 0.0.
    r = multi_bleu(["a b c d e"], [["a b c x y"]])
    assert r.bleu[3] == 0.0


def test_empty_reference_edge():
    r = multi_bleu([], [])
    assert r.ref_len == 0 and r.bleu == (0.0, 0.0, 0.0, 0.0)
