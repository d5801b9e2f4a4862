"""Runnable end-to-end demo on synthetic data (no datasets needed).

Builds a LEARNABLE synthetic corpus — one-hot class features, one fixed
caption per class — then runs the full reference workflow through the
public CLI and ASSERTS the quality gate:

    train -> generate (beam search) -> build references -> BLEU-4 >= 0.9

This is the synthetic analogue of the reference's turnkey run
(``julia lrcn.jl --fast --generate 30`` + ``eval/eval.jl``, README.md:4-8),
but with a hard score floor: because features determine the caption, a
correct train->decode->eval chain must overfit the corpus; exit codes
alone would pass with a silently-broken model.

    python examples/synthetic_end_to_end.py [workdir]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from lrcn_jax import cli
from lrcn_jax.data.feature_store import FeatureStore, l1_normalize
from lrcn_jax.evaluation.bleu import multi_bleu_files
from lrcn_jax.evaluation.references import build_coco_references

WORDS = ("a man rides his bike dog runs on grass two children play in the "
         "park near water under trees").split()
N_CLASSES = 12


def build_dataset(workdir: str):
    """COCO-style train/val jsons + one-hot feature stores per split."""
    rng = np.random.default_rng(17)
    class_caps = [
        " ".join(rng.choice(WORDS, 7)) + " ." for _ in range(N_CLASSES)]

    def make_split(name, id0, n_imgs):
        anns = [{"image_id": id0 + i, "caption": class_caps[i % N_CLASSES]}
                for i in range(n_imgs) for _ in range(5)]
        path = os.path.join(workdir, f"captions_{name}.json")
        with open(path, "w") as f:
            json.dump({"annotations": anns}, f)
        feats = {id0 + i: l1_normalize(
            np.eye(N_CLASSES, dtype=np.float32)[i % N_CLASSES][None])[0]
            for i in range(n_imgs)}
        store = os.path.join(workdir, f"{name}_feats")
        FeatureStore.from_dict(feats, normalized=True).save(store)
        return path, store

    train_json, train_store = make_split("train", 5000, 48)
    val_json, val_store = make_split("val", 9000, 24)
    return train_json, train_store, val_json, val_store


def main(workdir: str | None = None) -> None:
    workdir = workdir or tempfile.mkdtemp(prefix="lrcn_demo_")
    os.makedirs(workdir, exist_ok=True)
    print(f"== workdir: {workdir}")
    train_json, train_store, val_json, val_store = build_dataset(workdir)
    ckpt = os.path.join(workdir, "ckpt")

    print("== training (30 epochs, learnable synthetic corpus)")
    cli.main(["train", "--datafiles", train_json, val_json,
              "--features", train_store, "--savefile", ckpt,
              "--epochs", "30", "--batchsize", "16", "--lr", "3e-3",
              "--hidden", "32", "32", "--embed", "24", "--seed", "13",
              "--dropout", "0.0",
              "--metrics", os.path.join(workdir, "metrics.jsonl")])

    print("== generating captions for the val split with beam search")
    cand = os.path.join(workdir, "candidates.txt")
    ids = os.path.join(workdir, "candidate_ids.txt")
    cli.main(["generate", "--loadfile", ckpt, "--features", val_store,
              "--capnumber", "24", "--generate", "12", "--beam_width", "2",
              "--out", cand, "--ids-out", ids, "--seed", "7"])
    for line in open(cand).read().splitlines()[:3]:
        print("   ", line)

    print("== building references + BLEU (reference eval flow)")
    stem = build_coco_references(ids, val_json,
                                 os.path.join(workdir, "refs"))
    result = multi_bleu_files(stem, cand)
    print("   ", result.format())
    assert result.bleu[3] >= 0.90, (
        f"quality gate failed: BLEU-4 {result.bleu[3]:.3f} < 0.90")
    print("== quality gate PASSED (BLEU-4 >= 0.90)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
