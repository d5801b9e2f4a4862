"""Karpathy feature import + download helpers."""

import json
import os
import zipfile

import numpy as np

from lrcn_jax import cli
from lrcn_jax.data.download import extract, fetch
from lrcn_jax.data.feature_store import FeatureStore
from lrcn_jax.data.karpathy import import_karpathy


def make_karpathy_files(tmp_path, n=5, dim=32):
    from scipy.io import savemat
    rng = np.random.default_rng(0)
    feats = np.abs(rng.standard_normal((dim, n))).astype(np.float32)
    mat_path = str(tmp_path / "vgg_feats.mat")
    savemat(mat_path, {"feats": feats})
    images = [{"imgid": i, "filename": f"{1000 + i}.jpg"} for i in range(n)]
    json_path = str(tmp_path / "dataset.json")
    with open(json_path, "w") as f:
        json.dump({"images": images}, f)
    return mat_path, json_path, feats


def test_import_karpathy(tmp_path):
    mat_path, json_path, feats = make_karpathy_files(tmp_path)
    store = import_karpathy(mat_path, json_path)
    assert len(store) == 5
    assert store.normalized
    # row for imgid=2 -> image id 1002, L1-normalized column 2
    expected = feats[:, 2] / feats[:, 2].sum()
    np.testing.assert_allclose(store.get(1002), expected, rtol=1e-6)

    raw = import_karpathy(mat_path, json_path, normalize=False)
    np.testing.assert_allclose(raw.get(1002), feats[:, 2], rtol=1e-6)


def test_import_karpathy_cli(tmp_path):
    mat_path, json_path, _ = make_karpathy_files(tmp_path)
    out = str(tmp_path / "store")
    rc = cli.main(["import-karpathy", "--vgg-feats", mat_path,
                   "--dataset-json", json_path, "--out", out])
    assert rc == 0
    assert len(FeatureStore.load(out)) == 5


def test_fetch_and_extract_local(tmp_path):
    """fetch() over file:// and zip extraction (no network in CI)."""
    payload = tmp_path / "payload.txt"
    payload.write_text("hello")
    archive = tmp_path / "src" / "data.zip"
    os.makedirs(archive.parent)
    with zipfile.ZipFile(archive, "w") as z:
        z.write(payload, "payload.txt")
    dest = str(tmp_path / "dest")
    got = fetch(archive.as_uri(), dest)
    assert os.path.exists(got)
    got2 = fetch(archive.as_uri(), dest)  # resumable: no re-download
    assert got2 == got
    extract(got, dest)
    assert open(os.path.join(dest, "payload.txt")).read() == "hello"
