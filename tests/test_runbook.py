"""Runbook rehearsal: the RUNBOOK_PARITY.md command sequence end-to-end.

docs/RUNBOOK_PARITY.md documents the real-dataset parity run (download
-> .mat import gate -> extract-features -> train -> generate -> eval);
the datasets themselves are environment-blocked, but every command
AFTER the downloads must already run green.  This test executes that
exact CLI sequence on a synthetic corpus: a MatConvNet-format .mat
(width-scaled for CPU speed), raw JPEG images on disk, COCO-format
caption jsons — proving the runbook's plumbing is turnkey, not
hypothetical.  Individual stages have their own deeper tests; this one
asserts the CHAIN (extraction output feeds training, the checkpoint
feeds generation, the candidates score).
"""

import json
import os

import numpy as np
import pytest

from lrcn_jax import cli
from test_vgg import _save_small_mat

WORDS = ["man", "dog", "park", "red", "ball", "runs", "sits", "big",
         "small", "tree"]


def test_runbook_command_sequence(tmp_path, capsys):
    from PIL import Image

    rng = np.random.default_rng(31)

    # --- corpus on disk: images + captions (runbook step 1's layout) ---
    img_dir = tmp_path / "train2014"
    img_dir.mkdir()
    ids = [61000 + i for i in range(32)]
    for iid in ids:
        Image.fromarray(
            rng.integers(0, 255, (240, 260, 3)).astype(np.uint8)
        ).save(str(img_dir / f"COCO_train2014_{iid:012d}.jpg"))

    def caption_json(path, caps_per_image=5):
        anns = [{"image_id": iid,
                 "caption": " ".join(rng.choice(WORDS, 5)) + " ."}
                for iid in ids for _ in range(caps_per_image)]
        with open(path, "w") as f:
            json.dump({"annotations": anns}, f)
        return str(path)

    train_json = caption_json(tmp_path / "captions_train2014.json")
    val_json = caption_json(tmp_path / "captions_val2014.json")

    mat = str(tmp_path / "imagenet-vgg-verydeep-16.mat")
    _save_small_mat(mat, rng)

    # --- runbook step 2: offline fc7 extraction (resumable, batched) ---
    feats = str(tmp_path / "feats")
    assert cli.main([
        "extract-features", "--cnn", mat, "--images", str(img_dir),
        "--out", feats, "--batch-size", "8", "--scan-depth", "2",
        "--compute-dtype", "float32"]) == 0

    # --- runbook step 3: train the decoder on the extracted store ---
    ckpt = str(tmp_path / "ckpt")
    assert cli.main([
        "train", "--datafiles", train_json, val_json,
        "--features", feats, "--val-features", feats,
        "--savefile", ckpt, "--epochs", "2", "--batchsize", "8",
        "--hidden", "24", "24", "--embed", "16", "--seed", "9",
        "--dropout", "0.0", "--compute-dtype", "float32"]) == 0

    # --- runbook step 4: caption the held-out split ---
    cand = str(tmp_path / "candidates.txt")
    cand_ids = str(tmp_path / "candidate_ids.txt")
    assert cli.main([
        "generate", "--loadfile", ckpt, "--features", feats,
        "--datafiles", train_json, val_json,
        "--capnumber", "16", "--generate", "8", "--beam_width", "2",
        "--batch-size", "16", "--out", cand, "--ids-out", cand_ids,
        "--seed", "7", "--compute-dtype", "float32"]) == 0
    assert len(open(cand).read().splitlines()) == 16

    # --- runbook step 5: reference building + BLEU (eval/eval.jl flow) ---
    refs = str(tmp_path / "refs")
    assert cli.main([
        "eval", "--candidates", cand, "--candidate-ids", cand_ids,
        "--annotations", val_json, "--refs-dir", refs]) == 0
    out = capsys.readouterr().out
    assert "BLEU = " in out, out
    # the scorer line is the runbook's deliverable — it must parse
    bleu_line = [ln for ln in out.splitlines() if ln.startswith("BLEU")][-1]
    b4 = float(bleu_line.split("/")[3].split()[0])
    assert 0.0 <= b4 <= 100.0
