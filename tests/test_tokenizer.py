"""Tokenizer / vocab unit tests vs hand-computed expectations.

The normalization rules under test are the reference's
(tokenizer.jl:89-130); see lrcn_jax/core/tokenizer.py docstrings.
"""

import json

import numpy as np
import pytest

from lrcn_jax.core import (
    Caption, Vocab, EOS_ID, BOS_ID, UNK_ID,
    build_vocab, flickr_split, parse_coco_json, parse_flickr_tokens,
    tokenize,
)
from lrcn_jax.core.tokenizer import tokenize_flickr_line, tokenize_coco_caption


def test_flickr_line_basic():
    line = "1000092795.jpg#0\tTwo young guys look at their hands .\n"
    cap = tokenize_flickr_line(line)
    assert cap.image_id == 1000092795
    assert cap.words == ("two", "young", "guys", "look", "at", "their",
                         "hands")


def test_flickr_line_strip_chars():
    # Parentheses/commas/apostrophes are stripped at token edges only.
    line = "42.jpg#3\tA (man), with don't-stop 'style' ?!\n"
    cap = tokenize_flickr_line(line)
    # split on [' ','\t','#','.','\n'] then strip " .,#')(!/?\t`"
    assert cap.image_id == 42
    assert cap.words == ("a", "man", "with", "don't-stop", "style")


def test_flickr_line_final_period_dropped():
    cap = tokenize_flickr_line("7.jpg#0\ta dog .\n")
    assert cap.words == ("a", "dog")


def test_coco_caption_split_on_single_space():
    # Reference splits COCO captions on ' ' only (tokenizer.jl:115).
    words = tokenize_coco_caption("A man, riding  a (horse).")
    assert words == ("a", "man", "riding", "a", "horse")


def test_coco_parse_and_sort():
    payload = json.dumps({"annotations": [
        {"image_id": 10, "caption": "a big red truck parked outside ."},
        {"image_id": 11, "caption": "a dog ."},
    ]})
    caps = parse_coco_json(payload)
    # sorted by length ascending (tokenizer.jl:128)
    assert caps[0].image_id == 11
    assert [len(c) for c in caps] == sorted(len(c) for c in caps)


def test_vocab_reserved_ids_and_min_count():
    caps = [Caption(1, ("cat",) * 5), Caption(2, ("dog",) * 4),
            Caption(3, ("cat", "sat"))]
    vocab = build_vocab([caps], min_count=5)
    assert len(vocab) == 4  # eos, bos, unk, cat
    assert vocab.id("cat") == 3
    assert vocab.id("dog") == UNK_ID      # below min count -> unk
    assert vocab.id("~~") == EOS_ID == 0
    assert vocab.id("``") == BOS_ID == 1
    assert vocab.id("##") == UNK_ID == 2


def test_vocab_roundtrip_json():
    v = Vocab(["alpha", "beta"])
    v2 = Vocab.from_json(v.to_json())
    assert v2.words == v.words
    assert v2.id("beta") == v.id("beta")


def _synthetic_flickr_lines(n_images=2500, seed=0):
    rng = np.random.default_rng(seed)
    words = ["cat", "dog", "runs", "fast", "red", "ball", "park", "tree"]
    lines = []
    for img in range(n_images):
        for c in range(5):
            n = rng.integers(3, 9)
            cap = " ".join(rng.choice(words, size=n))
            lines.append(f"{img + 1000}.jpg#{c}\t{cap} .\n")
    return lines


def test_flickr_split_sizes_and_determinism():
    lines = _synthetic_flickr_lines()
    train, val, test = flickr_split(lines)
    assert len(val) == 5000 and len(test) == 5000
    assert len(train) == len(lines) - 10000
    # splits are disjoint by image id and deterministic
    train_ids = {c.image_id for c in train}
    val_ids = {c.image_id for c in val}
    test_ids = {c.image_id for c in test}
    assert not (train_ids & val_ids) and not (train_ids & test_ids)
    assert not (val_ids & test_ids)
    train2, val2, test2 = flickr_split(lines)
    assert [c.image_id for c in val2] == [c.image_id for c in val]


def test_tokenize_end_to_end_flickr(tmp_path):
    path = tmp_path / "results_20130124.token"
    path.write_text("".join(_synthetic_flickr_lines()))
    vocab, dicts = tokenize([str(path)])
    assert len(dicts) == 3  # train, val, test
    # vocab is built from ALL captions (split-independent)
    assert all(w in vocab for w in
               ["cat", "dog", "runs", "fast", "red", "ball", "park", "tree"])
    # deterministic across calls
    vocab2, _ = tokenize([str(path)])
    assert vocab2.words == vocab.words


def test_tokenize_rejects_unknown_extension(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("x")
    with pytest.raises(ValueError):
        tokenize([str(p)])
