"""Batcher / feature-store / pipeline tests."""

import os

import numpy as np
import pytest

from lrcn_jax.core.tokenizer import Caption
from lrcn_jax.core.vocab import Vocab
from lrcn_jax.data import (
    FeatureStore, bucket_batches, equal_length_batches, prefetch_to_device,
)
from lrcn_jax.data.feature_store import l1_normalize


@pytest.fixture
def vocab():
    return Vocab([f"w{i}" for i in range(20)])


def _caps(lengths, start_id=100):
    return [Caption(start_id + i, tuple(f"w{j % 20}" for j in range(n)))
            for i, n in enumerate(lengths)]


def test_bucket_batches_shapes(vocab):
    caps = _caps([3, 3, 5, 6, 9, 2, 4, 4])
    batches = bucket_batches(caps, vocab, batch_size=4,
                             apply_small_dataset_rule=False)
    for b in batches:
        assert b.tokens.shape == (4, b.padded_len)
        assert b.padded_len % 4 == 0
        assert (b.lengths <= b.padded_len).all()
    # every caption appears exactly once among real rows
    real = [(int(i), int(l)) for b in batches
            for i, l in zip(b.image_ids, b.lengths) if l >= 0]
    assert len(real) == 8


def test_bucket_batches_padding_rows_masked(vocab):
    caps = _caps([3, 3, 3])  # 3 captions, batch 2 -> one padded row
    batches = bucket_batches(caps, vocab, batch_size=2,
                             apply_small_dataset_rule=False)
    assert len(batches) == 2
    pad_lengths = [l for b in batches for l in b.lengths if l < 0]
    assert pad_lengths == [-1]


def test_bucket_batches_skips_too_long(vocab):
    caps = _caps([5, 29, 40])  # 29,40 exceed the 28-token cap
    batches = bucket_batches(caps, vocab, batch_size=1,
                             apply_small_dataset_rule=False)
    total = sum(b.batch_size for b in batches)
    assert total == 1


def test_small_dataset_rule(vocab):
    caps = _caps([4] * 50)
    batches = bucket_batches(caps, vocab, batch_size=25)
    # <30k captions forces batch 10 (lrcn.jl:264-268)
    assert batches[0].batch_size == 10


def test_equal_length_parity_mode(vocab):
    caps = _caps([3, 3, 3, 3, 5, 5, 7])
    batches = equal_length_batches(caps, vocab, batch_size=2,
                                   apply_small_dataset_rule=False)
    # 3s -> 2 batches, 5s -> 1 batch, the lone 7 is deleted
    assert [b.padded_len for b in batches] == [3, 3, 5]
    for b in batches:
        assert (b.lengths == b.padded_len).all()


def test_token_encoding(vocab):
    caps = [Caption(1, ("w0", "w1", "zzz"))]  # zzz is OOV -> UNK(2)
    batches = bucket_batches(caps, vocab, batch_size=1,
                             apply_small_dataset_rule=False)
    np.testing.assert_array_equal(batches[0].tokens[0, :3],
                                  [vocab.id("w0"), vocab.id("w1"), 2])


def test_feature_store_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    store = FeatureStore(dim=16)
    feats = {i: rng.normal(size=16).astype(np.float32) for i in [5, 9, 12]}
    for i, f in feats.items():
        store.add(i, f)
    store.save(str(tmp_path / "store"))

    loaded = FeatureStore.load(str(tmp_path / "store"))
    assert len(loaded) == 3 and 9 in loaded
    np.testing.assert_array_equal(loaded.get(12), feats[12])
    g = loaded.gather([9, 5, 9])
    np.testing.assert_array_equal(g[0], feats[9])
    np.testing.assert_array_equal(g[1], feats[5])
    np.testing.assert_array_equal(g[2], feats[9])


def test_feature_store_resumable(tmp_path):
    store = FeatureStore(dim=4)
    store.add(1, np.ones(4))
    store.save(str(tmp_path / "s"))
    # resume: load, append new ids, mixed gather, save again
    s2 = FeatureStore.load(str(tmp_path / "s"))
    assert s2.missing([1, 2, 3]) == [2, 3]
    s2.add(2, np.full(4, 2.0))
    g = s2.gather([2, 1])
    np.testing.assert_array_equal(g[0], np.full(4, 2.0))
    s2.save(str(tmp_path / "s"))
    s3 = FeatureStore.load(str(tmp_path / "s"))
    assert sorted(s3.ids()) == [1, 2]


def test_save_atomic_and_recover_crash_windows(tmp_path):
    """Every crash window of save_atomic leaves a recoverable store:
    complete .tmp beats path (it is strictly newer), path beats .old,
    incomplete leftovers are cleaned up."""
    import shutil

    def make_store(val):
        s = FeatureStore(dim=4)
        s.add(1, np.full(4, val))
        return s

    path = str(tmp_path / "s")

    # normal atomic save over nothing, then over an existing store
    make_store(1.0).save_atomic(path)
    assert FeatureStore.load(path).get(1)[0] == 1.0
    make_store(2.0).save_atomic(path)
    assert FeatureStore.load(path).get(1)[0] == 2.0
    assert not os.path.exists(path + ".tmp")
    assert not os.path.exists(path + ".old")

    # crash after .tmp completed, before swap: tmp (newer) must win
    make_store(3.0).save(path + ".tmp")
    assert FeatureStore.recover(path) == path
    assert FeatureStore.load(path).get(1)[0] == 3.0
    assert not os.path.exists(path + ".tmp")

    # crash mid-swap: path gone, .old holds the previous snapshot
    os.rename(path, path + ".old")
    assert FeatureStore.recover(path) == path
    assert FeatureStore.load(path).get(1)[0] == 3.0

    # INCOMPLETE .tmp (killed mid-write: no meta.json yet) is discarded
    make_store(9.0).save(path + ".tmp")
    os.remove(os.path.join(path + ".tmp", "meta.json"))
    assert FeatureStore.recover(path) == path
    assert FeatureStore.load(path).get(1)[0] == 3.0
    assert not os.path.exists(path + ".tmp")

    # nothing anywhere -> None
    shutil.rmtree(path)
    assert FeatureStore.recover(path) is None

    # a store mmap-loaded from path can snapshot onto its own path
    make_store(4.0).save_atomic(path)
    live = FeatureStore.load(path)          # mmap open on features.npy
    live.add(2, np.full(4, 5.0))
    live.save_atomic(path)                  # reads via the old inode
    re = FeatureStore.load(path)
    assert sorted(re.ids()) == [1, 2]
    assert re.get(2)[0] == 5.0


def test_feature_store_missing_raises():
    store = FeatureStore(dim=4)
    with pytest.raises(KeyError):
        store.get(99)  # lrcn.jl:603 errors on missing features


def test_l1_normalize():
    x = np.array([[2.0, 6.0], [0.0, 0.0]], np.float32)
    n = l1_normalize(x)
    np.testing.assert_allclose(n[0], [0.25, 0.75])
    np.testing.assert_array_equal(n[1], [0.0, 0.0])  # no div-by-zero


def test_prefetch_preserves_order_and_content():
    data = [np.full((2, 2), i) for i in range(7)]
    out = list(prefetch_to_device(iter(data), size=3))
    assert len(out) == 7
    for i, x in enumerate(out):
        np.testing.assert_array_equal(np.asarray(x), data[i])


def test_download_fetch_extract_file_url(tmp_path, monkeypatch, capsys):
    """The fetch/extract path driven by file:// URLs (no network in CI).

    Covers data/download.py end to end: fetch (with skip-if-present),
    zip and tar.gz extraction, and the download_dataset dispatch.
    """
    import tarfile
    import zipfile

    from lrcn_jax.data import download

    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_text("alpha")
    zip_path = tmp_path / "train2014.zip"
    with zipfile.ZipFile(zip_path, "w") as z:
        z.write(src / "a.txt", "train2014/a.txt")
    tar_path = tmp_path / "flickr30k.tar.gz"
    with tarfile.open(tar_path, "w:gz") as t:
        t.add(src / "a.txt", "flickr30k/captions.token")

    monkeypatch.setattr(download, "COCO_URLS", [zip_path.as_uri()])
    monkeypatch.setattr(download, "FLICKR_URLS", [tar_path.as_uri()])
    root = str(tmp_path / "data")
    download.download_dataset("coco", root)
    assert (tmp_path / "data/MsCoCo/train2014/a.txt").read_text() == "alpha"
    download.download_dataset("flickr", root)
    assert (tmp_path / "data/Flickr30k/flickr30k/"
            "captions.token").read_text() == "alpha"

    # idempotent: a second call skips the fetch (archive already present)
    capsys.readouterr()
    download.download_dataset("coco", root)
    assert "downloading" not in capsys.readouterr().out
