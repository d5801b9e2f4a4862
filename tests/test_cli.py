"""End-to-end CLI workflow tests on synthetic data.

Mirrors the reference's turnkey workflow (README.md:4-8):
train -> generate a caption set -> build references -> BLEU score.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from lrcn_jax import cli
from lrcn_jax.data.feature_store import FeatureStore, l1_normalize

WORDS = ["a", "man", "rides", "his", "bike", "dog", "runs", "on", "grass",
         "two", "children", "play", "in", "the", "park", "near", "water"]


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A tiny Flickr-style dataset: .token file + feature stores."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    n_images = 2100  # enough for the fixed 1000/1000 val/test split
    lines = []
    for img in range(n_images):
        for j in range(5):
            n = rng.integers(4, 9)
            cap = " ".join(rng.choice(WORDS, n))
            lines.append(f"{10000 + img}.jpg#{j}\t{cap} .\n")
    token_path = str(tmp / "flickr.token")
    with open(token_path, "w") as f:
        f.writelines(lines)

    feats = rng.standard_normal((n_images, 64)).astype(np.float32)
    store = FeatureStore.from_dict(
        {10000 + i: l1_normalize(feats[i:i + 1])[0]
         for i in range(n_images)}, normalized=True)
    store_dir = str(tmp / "feats")
    store.save(store_dir)
    return {"tmp": tmp, "token": token_path, "feats": store_dir}


def test_image_id_from_filename():
    assert cli.image_id_from_filename("COCO_val2014_000000391895.jpg") \
        == 391895
    assert cli.image_id_from_filename("/x/1000092795.jpg") == 1000092795
    with pytest.raises(ValueError):
        cli.image_id_from_filename("nodigits.jpg")


def test_cli_help_runs():
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0


def test_train_generate_eval_workflow(synthetic):
    tmp = synthetic["tmp"]
    ckpt = str(tmp / "ckpt")
    rc = cli.main([
        "train", "--datafiles", synthetic["token"],
        "--features", synthetic["feats"],
        "--val-features", synthetic["feats"],
        "--savefile", ckpt, "--epochs", "1", "--batchsize", "16",
        "--hidden", "32", "32", "--embed", "24", "--seed", "3",
        "--dropout", "0.0", "--compute-dtype", "float32",
        "--metrics", str(tmp / "metrics.jsonl")])
    assert rc == 0
    assert os.path.exists(os.path.join(ckpt, "params.npz"))
    metrics = [json.loads(ln) for ln in open(tmp / "metrics.jsonl")]
    assert any(m.get("event") == "epoch" for m in metrics)

    cand = str(tmp / "candidates.txt")
    ids = str(tmp / "candidate_ids.txt")
    rc = cli.main([
        "generate", "--loadfile", ckpt, "--features", synthetic["feats"],
        "--capnumber", "40", "--generate", "10", "--beam_width", "2",
        "--batch-size", "20", "--out", cand, "--ids-out", ids,
        "--seed", "7", "--compute-dtype", "float32"])
    assert rc == 0
    cand_lines = open(cand).read().splitlines()
    id_lines = open(ids).read().splitlines()
    assert len(cand_lines) == len(id_lines) == 40
    assert all(line.endswith(".") for line in cand_lines)

    refs = str(tmp / "refs")
    rc = cli.main([
        "eval", "--candidates", cand, "--candidate-ids", ids,
        "--annotations", synthetic["token"], "--refs-dir", refs])
    assert rc == 0
    assert os.path.exists(os.path.join(refs, "f_ref4"))


def test_train_resume_from_checkpoint(synthetic):
    tmp = synthetic["tmp"]
    ckpt = str(tmp / "ckpt_resume")
    base = ["train", "--datafiles", synthetic["token"],
            "--features", synthetic["feats"],
            "--epochs", "1", "--batchsize", "16",
            "--hidden", "32", "32", "--embed", "24", "--seed", "3",
            "--dropout", "0.0", "--compute-dtype", "float32"]
    assert cli.main(base + ["--savefile", ckpt]) == 0
    # resume training from the checkpoint (reference --loadfile,
    # lrcn.jl:88).  --epochs is the TOTAL budget: the checkpoint already
    # covers 1 epoch, so --epochs 2 trains exactly one more (labeled 2)
    resume2 = str(tmp / "ckpt_resume2")
    base2 = [a if a != "1" else "2" for a in base]
    assert cli.main(base2 + ["--loadfile", ckpt,
                             "--savefile", resume2]) == 0
    from lrcn_jax.train.checkpoint import load_checkpoint
    assert load_checkpoint(resume2)["epoch"] == 2
    # re-running the ORIGINAL command is a no-op, not an overshoot
    assert cli.main(base + ["--loadfile", ckpt,
                            "--savefile", str(tmp / "noop")]) == 0
    assert not os.path.exists(os.path.join(str(tmp / "noop"),
                                           "params.npz"))


def test_train_on_mesh(synthetic):
    tmp = synthetic["tmp"]
    rc = cli.main([
        "train", "--datafiles", synthetic["token"],
        "--features", synthetic["feats"],
        "--savefile", str(tmp / "ckpt_mesh"),
        "--epochs", "1", "--batchsize", "16", "--mesh", "4", "2",
        "--hidden", "32", "32", "--embed", "24", "--seed", "3",
        "--dropout", "0.0", "--compute-dtype", "float32"])
    assert rc == 0


def test_train_on_mesh_pipelined(synthetic):
    """--pipeline: PP over the LSTM layers + vocab TP on the model axis;
    the checkpoint comes out in the standard decoder layout."""
    tmp = synthetic["tmp"]
    ckpt = str(tmp / "ckpt_pp")
    rc = cli.main([
        "train", "--datafiles", synthetic["token"],
        "--features", synthetic["feats"], "--savefile", ckpt,
        "--epochs", "1", "--batchsize", "16", "--mesh", "4", "2",
        "--pipeline", "--hidden", "32", "32", "--embed", "32",
        "--seed", "3", "--dropout", "0.0", "--compute-dtype", "float32"])
    assert rc == 0
    with np.load(os.path.join(ckpt, "params.npz")) as z:
        keys = set(z.files)
    assert any(k.startswith("lstm1/") for k in keys), keys
    assert not any(k.startswith("lstm_pp") for k in keys), keys


def test_console_script_entrypoint():
    # Hermetic: the package may not be pip-installed in the test image, so
    # point PYTHONPATH at the repo root (cwd=/tmp proves -m works from
    # anywhere, not just the source directory).
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "lrcn_jax.cli", "--help"],
                         capture_output=True, text=True, cwd="/tmp", env=env)
    assert out.returncode == 0
    assert "train" in out.stdout and "extract-features" in out.stdout


def synthetic_vgg_mat(path, rng, width=1.0, fc_dim=4096):
    """A MatConvNet-format VGG-16 file with random weights; ``width``
    scales the conv channel counts (tiny widths keep CPU tests fast)."""
    from scipy.io import savemat

    from lrcn_jax.models import vgg as vgg_mod

    def wb(w, b):
        # explicit object array: np.array([w, b], dtype=object) tries to
        # broadcast when the shapes share a leading dim (tiny widths)
        pair = np.empty(2, dtype=object)
        pair[0], pair[1] = w, b
        return pair

    layers, c_in = [], 3
    for entry in vgg_mod.VGG16_LAYOUT:
        if entry == "pool":
            layers.append({"name": "pool", "type": "pool"})
            continue
        name, c_out = entry
        c_out = max(1, round(c_out * width))
        layers.append({"name": name, "type": "conv", "weights": wb(
            rng.standard_normal((3, 3, c_in, c_out)).astype(np.float32)
            * 0.05,
            np.zeros((c_out, 1), np.float32))})
        layers.append({"name": "relu" + name[4:], "type": "relu"})
        c_in = c_out
    for name, shape, d_out in [("fc6", (7, 7, c_in, fc_dim), fc_dim),
                               ("fc7", (1, 1, fc_dim, fc_dim), fc_dim)]:
        layers.append({"name": name, "type": "conv", "weights": wb(
            rng.standard_normal(shape).astype(np.float32) * 0.01,
            np.zeros((d_out, 1), np.float32))})
        layers.append({"name": "relu" + name[2:], "type": "relu"})
    savemat(path, {
        "layers": np.array(layers, dtype=object),
        "meta": {"normalization": {
            "averageImage": np.full((224, 224, 3), 120, np.float32)}},
    })


def test_caption_single_image(tmp_path, synthetic):
    """End-to-end single-image captioning: .mat import -> VGG -> beam."""
    import numpy as np
    from PIL import Image

    # synthetic MatConvNet file (full-size layer list, random weights)
    rng = np.random.default_rng(0)
    mat_path = str(tmp_path / "vgg.mat")
    synthetic_vgg_mat(mat_path, rng)

    img_path = str(tmp_path / "cat.png")
    Image.fromarray(rng.integers(0, 255, (260, 300, 3)).astype(np.uint8)
                    ).save(img_path)

    # a checkpoint whose decoder takes 4096-dim features
    import jax

    from lrcn_jax.config import LRCNConfig
    from lrcn_jax.core.vocab import Vocab
    from lrcn_jax.models import lrcn as lrcn_model
    from lrcn_jax.train.checkpoint import save_checkpoint

    cfg = LRCNConfig(hidden=(16, 16), embed=12, cnn_feature_dim=4096,
                     vocab_size=0, compute_dtype="float32")
    vocab = Vocab(WORDS)
    cfg.vocab_size = len(vocab)
    params = lrcn_model.init_params(jax.random.PRNGKey(0), cfg)
    ckpt = str(tmp_path / "cap_ckpt")
    save_checkpoint(ckpt, params, vocab, cfg)

    rc = cli.main(["caption", img_path, "--loadfile", ckpt,
                   "--cnn", mat_path, "--generate", "5",
                   "--beam_width", "2", "--compute-dtype", "float32"])
    assert rc == 0


def test_generate_with_sampling(synthetic, tmp_path):
    """--sample N routes generation through best-of-N sampling."""
    ckpt = str(synthetic["tmp"] / "ckpt")   # trained by the workflow test
    if not os.path.exists(os.path.join(ckpt, "params.npz")):
        pytest.skip("workflow test has not produced a checkpoint")
    cand = str(tmp_path / "cand_sample.txt")
    ids = str(tmp_path / "ids_sample.txt")
    rc = cli.main([
        "generate", "--loadfile", ckpt, "--features", synthetic["feats"],
        "--capnumber", "10", "--generate", "8", "--sample", "4",
        "--temperature", "1.5", "--batch-size", "10",
        "--out", cand, "--ids-out", ids, "--seed", "11",
        "--compute-dtype", "float32"])
    assert rc == 0
    lines = open(cand).read().splitlines()
    assert len(lines) == 10 and all(l.endswith(".") for l in lines)


def test_train_joint_cli(tmp_path, monkeypatch):
    """`lrcn train --joint`: end-to-end fine-tune, resume, and caption.

    The encoder is monkeypatched to a width-scaled VGG so the CPU test
    stays fast; the CLI derives the decoder's feature dim from the actual
    encoder, so everything stays consistent.
    """
    import functools

    from PIL import Image

    from lrcn_jax.models import vgg as vgg_mod

    monkeypatch.setattr(
        vgg_mod, "init_vgg_params",
        functools.partial(vgg_mod.init_vgg_params,
                          width_multiplier=0.05, fc_dim=24))

    rng = np.random.default_rng(6)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    ids = [41000 + i for i in range(8)]
    for iid in ids:
        Image.fromarray(
            rng.integers(0, 255, (230, 260, 3)).astype(np.uint8)
        ).save(str(img_dir / f"COCO_train2014_{iid:012d}.jpg"))

    anns = [{"image_id": iid, "caption": " ".join(rng.choice(WORDS, 5))}
            for iid in ids for _ in range(5)]
    train_json = str(tmp_path / "captions_train.json")
    with open(train_json, "w") as f:
        json.dump({"annotations": anns}, f)

    ckpt = str(tmp_path / "joint_ckpt")
    base = ["train", "--joint", "--images", str(img_dir),
            "--datafiles", train_json, "--epochs", "1",
            "--batchsize", "4", "--hidden", "16", "16", "--embed", "12",
            "--seed", "3", "--dropout", "0.0",
            "--compute-dtype", "float32"]
    assert cli.main(base + ["--savefile", ckpt]) == 0

    # checkpoint carries BOTH parameter sets
    with np.load(os.path.join(ckpt, "params.npz")) as z:
        keys = set(z.files)
    assert any(k.startswith("cnn/") for k in keys), keys
    assert any(k.startswith("decoder/") for k in keys), keys
    assert os.path.exists(os.path.join(ckpt, "average_image.npy"))

    # resume the joint run (restores encoder+decoder+opt state); scanned
    # K-steps-per-dispatch exercises the stacked uint8 image path.
    # --epochs 2 = total budget (the checkpoint covers epoch 1)
    base_resume = [a if a != "1" else "2" for a in base]
    assert cli.main(base_resume + ["--loadfile", ckpt,
                            "--steps-per-dispatch", "2", "--no-remat-cnn",
                            "--savefile", str(tmp_path / "joint2")]) == 0

    # decoder-only resume of a joint checkpoint is refused with guidance
    with pytest.raises(SystemExit, match="joint"):
        cli.main(["train", "--datafiles", train_json,
                  "--features", "unused", "--loadfile", ckpt])

    # caption a single image with the fine-tuned encoder (no --cnn needed)
    rc = cli.main(["caption", str(img_dir / f"COCO_train2014_{ids[0]:012d}.jpg"),
                   "--loadfile", ckpt, "--generate", "4",
                   "--beam_width", "2", "--compute-dtype", "float32"])
    assert rc == 0


def test_joint_eval_chain(tmp_path, monkeypatch, capsys):
    """The LRCN-2f eval protocol against a fine-tuned joint model:
    ``train --joint -> extract-features --loadfile <joint ckpt> ->
    generate -> eval`` (reference protocol lrcn.jl:127-160; the paper's
    2f numbers, 1411.4389.pdf Table 6, are produced exactly this way).
    The fine-tuned encoder — not a stock .mat — extracts the features."""
    import functools

    from PIL import Image

    from lrcn_jax.models import vgg as vgg_mod

    monkeypatch.setattr(
        vgg_mod, "init_vgg_params",
        functools.partial(vgg_mod.init_vgg_params,
                          width_multiplier=0.05, fc_dim=24))

    rng = np.random.default_rng(9)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    ids = [52000 + i for i in range(8)]
    for iid in ids:
        Image.fromarray(
            rng.integers(0, 255, (230, 260, 3)).astype(np.uint8)
        ).save(str(img_dir / f"COCO_val2014_{iid:012d}.jpg"))

    def anns_for(seed):
        r = np.random.default_rng(seed)
        return [{"image_id": iid, "caption": " ".join(r.choice(WORDS, 5))}
                for iid in ids for _ in range(5)]

    train_json = str(tmp_path / "captions_train.json")
    val_json = str(tmp_path / "captions_val.json")
    with open(train_json, "w") as f:
        json.dump({"annotations": anns_for(1)}, f)
    with open(val_json, "w") as f:
        json.dump({"annotations": anns_for(2)}, f)

    # 1) fine-tune encoder+decoder jointly
    ckpt = str(tmp_path / "joint_ckpt")
    assert cli.main(["train", "--joint", "--images", str(img_dir),
                     "--datafiles", train_json, "--epochs", "1",
                     "--batchsize", "4", "--hidden", "16", "16",
                     "--embed", "12", "--seed", "3", "--dropout", "0.0",
                     "--compute-dtype", "float32",
                     "--savefile", ckpt]) == 0

    # 2) extract features with the FINE-TUNED encoder (no --cnn)
    store_dir = str(tmp_path / "feats_2f")
    assert cli.main(["extract-features", "--loadfile", ckpt,
                     "--images", str(img_dir), "--out", store_dir,
                     "--batch-size", "4", "--scan-depth", "1",
                     "--compute-dtype", "float32"]) == 0
    store = FeatureStore.load(store_dir)
    assert sorted(store.ids()) == ids
    # the store really holds fc7 of the fine-tuned encoder: its feature
    # dim is the scaled encoder's (24), not the stock 4096
    assert store.get(ids[0]).shape == (24,)

    # decoder-only checkpoints are refused with guidance
    import jax

    from lrcn_jax.config import LRCNConfig
    from lrcn_jax.core.vocab import Vocab
    from lrcn_jax.models import lrcn as lrcn_model
    from lrcn_jax.train.checkpoint import save_checkpoint

    dcfg = LRCNConfig(hidden=(16, 16), embed=12, cnn_feature_dim=24,
                      vocab_size=0, compute_dtype="float32")
    dvocab = Vocab(WORDS)
    dcfg.vocab_size = len(dvocab)
    dparams = lrcn_model.init_params(jax.random.PRNGKey(0), dcfg)
    dec_ckpt = str(tmp_path / "dec_only")
    save_checkpoint(dec_ckpt, dparams, dvocab, dcfg)
    with pytest.raises(SystemExit, match="joint"):
        cli.main(["extract-features", "--loadfile", dec_ckpt,
                  "--images", str(img_dir), "--out",
                  str(tmp_path / "x")])

    # 3) generate the caption set from the held-out COCO val split
    cand = str(tmp_path / "cand_2f.txt")
    ids_out = str(tmp_path / "ids_2f.txt")
    assert cli.main(["generate", "--loadfile", ckpt,
                     "--features", store_dir,
                     "--datafiles", train_json, val_json,
                     "--capnumber", "8", "--generate", "8",
                     "--beam_width", "2", "--seed", "7",
                     "--out", cand, "--ids-out", ids_out,
                     "--compute-dtype", "float32"]) == 0
    lines = open(cand).read().splitlines()
    assert len(lines) == 8 and all(l.endswith(".") for l in lines)

    # 4) score against the val annotations (eval/eval.jl protocol)
    refs_dir = str(tmp_path / "refs_2f")
    assert cli.main(["eval", "--candidates", cand,
                     "--candidate-ids", ids_out,
                     "--annotations", val_json,
                     "--refs-dir", refs_dir]) == 0
    out = capsys.readouterr().out
    assert "BLEU = " in out


def test_joint_warm_start_from_decoder_checkpoint(tmp_path):
    """The 2f warm start: ``train --joint --loadfile <decoder-only ckpt>
    --cnn <mat>`` seeds the decoder from a feature-trained (1f) model and
    the encoder from the stock weights (the paper's fine-tune protocol,
    1411.4389.pdf Table 6), instead of refusing the checkpoint."""
    import jax
    from PIL import Image

    from lrcn_jax.config import LRCNConfig
    from lrcn_jax.core.vocab import Vocab
    from lrcn_jax.models import lrcn as lrcn_model
    from lrcn_jax.train.checkpoint import save_checkpoint

    rng = np.random.default_rng(12)
    mat_path = str(tmp_path / "vgg_tiny.mat")
    synthetic_vgg_mat(mat_path, rng, width=0.05, fc_dim=24)

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    ids = [61000 + i for i in range(4)]
    for iid in ids:
        Image.fromarray(
            rng.integers(0, 255, (230, 260, 3)).astype(np.uint8)
        ).save(str(img_dir / f"COCO_train2014_{iid:012d}.jpg"))
    anns = [{"image_id": iid, "caption": " ".join(rng.choice(WORDS, 5))}
            for iid in ids for _ in range(5)]
    train_json = str(tmp_path / "captions_train.json")
    with open(train_json, "w") as f:
        json.dump({"annotations": anns}, f)

    # a "1f" decoder checkpoint matched to the encoder's fc7 dim (24)
    cfg = LRCNConfig(hidden=(16, 16), embed=12, cnn_feature_dim=24,
                     vocab_size=0, compute_dtype="float32", batch_size=4,
                     dropout=0.0)
    vocab = Vocab(WORDS)
    cfg.vocab_size = len(vocab)
    params = lrcn_model.init_params(jax.random.PRNGKey(1), cfg)
    dec_ckpt = str(tmp_path / "dec_1f")
    save_checkpoint(dec_ckpt, params, vocab, cfg)

    out_ckpt = str(tmp_path / "joint_2f")
    assert cli.main(["train", "--joint", "--images", str(img_dir),
                     "--datafiles", train_json, "--loadfile", dec_ckpt,
                     "--cnn", mat_path, "--epochs", "1",
                     "--compute-dtype", "float32",
                     "--savefile", out_ckpt]) == 0
    with np.load(os.path.join(out_ckpt, "params.npz")) as z:
        keys = set(z.files)
    assert any(k.startswith("cnn/") for k in keys)
    assert any(k.startswith("decoder/") for k in keys)
    # the .mat's averageImage rode along for later extraction/caption
    avg = np.load(os.path.join(out_ckpt, "average_image.npy"))
    assert avg.shape == (224, 224, 3) and np.allclose(avg, 120)

    # extract-features with BOTH --loadfile (decoder-only) and --cnn:
    # the explicit --cnn wins, as the help text promises — the
    # checkpoint is not even loaded, so decoder-only is fine here
    both_store = str(tmp_path / "feats_both")
    assert cli.main(["extract-features", "--loadfile", dec_ckpt,
                     "--cnn", mat_path, "--images", str(img_dir),
                     "--out", both_store, "--batch-size", "4",
                     "--scan-depth", "1",
                     "--compute-dtype", "float32"]) == 0

    # dim mismatch between decoder checkpoint and encoder fc7 is refused
    cfg_bad = LRCNConfig(hidden=(16, 16), embed=12, cnn_feature_dim=64,
                         vocab_size=len(vocab), compute_dtype="float32")
    bad = str(tmp_path / "dec_bad")
    save_checkpoint(bad, lrcn_model.init_params(jax.random.PRNGKey(2),
                                                cfg_bad), vocab, cfg_bad)
    with pytest.raises(SystemExit, match="dim"):
        cli.main(["train", "--joint", "--images", str(img_dir),
                  "--datafiles", train_json, "--loadfile", bad,
                  "--cnn", mat_path, "--epochs", "1"])


def test_decode_geometry_auto():
    """Auto geometry ships the flagship dispatch shape to users
    (the reference protocol's 1000 images -> 256x4 in one..few
    dispatches) while small runs stay small; explicit flags win."""
    assert cli.decode_geometry(1000, None, None) == (256, 4)
    assert cli.decode_geometry(4096, None, None) == (256, 16)
    assert cli.decode_geometry(10, None, None) == (16, 1)
    assert cli.decode_geometry(100, None, None) == (128, 1)
    assert cli.decode_geometry(1, None, None) == (16, 1)
    # explicit flags are untouched
    assert cli.decode_geometry(1000, 64, None) == (64, 16)
    assert cli.decode_geometry(1000, None, 2) == (256, 2)
    assert cli.decode_geometry(1000, 20, 3) == (20, 3)


def test_train_resume_honors_explicit_flags(synthetic, tmp_path, capsys):
    """Explicit hyperparameter flags override a resumed checkpoint's config
    (round-1 behavior silently ignored them)."""
    ckpt = str(synthetic["tmp"] / "ckpt")   # trained by the workflow test
    if not os.path.exists(os.path.join(ckpt, "params.npz")):
        pytest.skip("workflow test has not produced a checkpoint")
    rc = cli.main([
        "train", "--datafiles", synthetic["token"],
        "--features", synthetic["feats"], "--loadfile", ckpt,
        "--savefile", str(tmp_path / "ckpt_override"),
        "--epochs", "2", "--lr", "5e-4", "--batchsize", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "overrides checkpoint lr=" in out
    assert "overrides checkpoint batch_size=" in out
    from lrcn_jax.train.checkpoint import load_checkpoint
    cfg = load_checkpoint(str(tmp_path / "ckpt_override"))["cfg"]
    assert cfg.lr == 5e-4 and cfg.batch_size == 8


def test_quality_gate_bleu_overfit(tmp_path):
    """Asserted end-to-end quality gate: train -> generate -> refs -> BLEU.

    The synthetic corpus is LEARNABLE (features determine the caption:
    one-hot class features, one fixed caption per class), so a correct
    train->decode->eval chain must overfit it and score near-perfect
    BLEU-4 with the reference's scorer semantics (BP off).  Exit codes
    alone (the round-1 check) pass with a silently-broken model; a BLEU-4
    floor does not.  Mirrors the reference's only turnkey check
    (eval/eval.jl:38 + multi-bleu.perl) on a trained model instead of
    frozen artifacts.
    """
    from lrcn_jax.evaluation.bleu import multi_bleu_files
    from lrcn_jax.evaluation.references import build_coco_references

    rng = np.random.default_rng(17)
    n_classes = 12
    class_caps = [
        " ".join(rng.choice(WORDS, 7)) + " ." for _ in range(n_classes)]

    def make_split(path, id0, n_imgs):
        anns = [{"image_id": id0 + i, "caption": class_caps[i % n_classes]}
                for i in range(n_imgs) for _ in range(5)]
        with open(path, "w") as f:
            json.dump({"annotations": anns}, f)
        return [id0 + i for i in range(n_imgs)]

    train_json = str(tmp_path / "captions_train.json")
    val_json = str(tmp_path / "captions_val.json")
    train_ids = make_split(train_json, 5000, 48)
    val_ids = make_split(val_json, 9000, 24)

    def one_hot_feats(ids):
        return {iid: l1_normalize(np.eye(n_classes, dtype=np.float32)[
            (iid - ids[0]) % n_classes][None])[0] for iid in ids}

    train_store = str(tmp_path / "train_feats")
    val_store = str(tmp_path / "val_feats")
    FeatureStore.from_dict(one_hot_feats(train_ids),
                           normalized=True).save(train_store)
    FeatureStore.from_dict(one_hot_feats(val_ids),
                           normalized=True).save(val_store)

    ckpt = str(tmp_path / "gate_ckpt")
    assert cli.main([
        "train", "--datafiles", train_json, val_json,
        "--features", train_store, "--savefile", ckpt,
        "--epochs", "30", "--batchsize", "16", "--lr", "3e-3",
        "--hidden", "32", "32", "--embed", "24", "--seed", "13",
        "--dropout", "0.0", "--compute-dtype", "float32"]) == 0

    cand = str(tmp_path / "cands.txt")
    ids_file = str(tmp_path / "ids.txt")
    assert cli.main([
        "generate", "--loadfile", ckpt, "--features", val_store,
        "--capnumber", "24", "--generate", "12", "--beam_width", "2",
        "--batch-size", "24", "--out", cand, "--ids-out", ids_file,
        "--seed", "7", "--compute-dtype", "float32"]) == 0

    stem = build_coco_references(ids_file, val_json, str(tmp_path / "refs"))
    result = multi_bleu_files(stem, cand)
    assert result.bleu[3] >= 0.90, (
        f"quality gate failed: {result.format()}\n"
        f"first candidates: {open(cand).read().splitlines()[:3]}")


def _tiny_checkpoint(path, vocab, feature_dim):
    """An untrained decoder checkpoint (generation needs no training)."""
    import jax

    from lrcn_jax.config import LRCNConfig
    from lrcn_jax.models import lrcn as lrcn_model
    from lrcn_jax.train.checkpoint import save_checkpoint

    cfg = LRCNConfig(hidden=(16, 16), embed=12, cnn_feature_dim=feature_dim,
                     vocab_size=len(vocab), compute_dtype="float32")
    params = lrcn_model.init_params(jax.random.PRNGKey(0), cfg)
    save_checkpoint(path, params, vocab, cfg)


def test_generate_samples_flickr_held_out_split(synthetic, tmp_path,
                                                monkeypatch):
    """Eval ids come from the held-out TEST split, never from train, even
    against a full-corpus feature store (lrcn.jl:132-150); default output
    names are the reference's candidates_flickr/candidate_ids_flickr
    (lrcn.jl:133-134)."""
    from lrcn_jax.core.tokenizer import flickr_split, tokenize

    vocab, _ = tokenize([synthetic["token"]])
    ckpt = str(tmp_path / "ckpt")
    _tiny_checkpoint(ckpt, vocab, 64)

    with open(synthetic["token"]) as f:
        train_caps, _val, test_caps = flickr_split(f.readlines())
    train_ids = {c.image_id for c in train_caps}
    test_ids = {c.image_id for c in test_caps}

    monkeypatch.chdir(tmp_path)
    rc = cli.main([
        "generate", "--loadfile", ckpt, "--features", synthetic["feats"],
        "--datafiles", synthetic["token"],
        "--capnumber", "30", "--generate", "6", "--beam_width", "1",
        "--batch-size", "15", "--seed", "9", "--compute-dtype", "float32"])
    assert rc == 0
    assert os.path.exists("candidates_flickr")
    picked = [int(x) for x in open("candidate_ids_flickr").read().split()]
    assert len(picked) == 30
    assert not (set(picked) & train_ids), \
        "generate sampled TRAINING images for evaluation"
    assert set(picked) <= test_ids


def test_generate_samples_coco_val_split(tmp_path, monkeypatch):
    """COCO: eval ids come from the val json (caption_dicts[2],
    lrcn.jl:140-142), not from the (train+val) feature store; split ids
    missing from the store are skipped."""
    rng = np.random.default_rng(2)

    def make_json(path, id0, n_imgs):
        anns = [{"image_id": id0 + i,
                 "caption": " ".join(rng.choice(WORDS, 5))}
                for i in range(n_imgs) for _ in range(5)]
        with open(path, "w") as f:
            json.dump({"annotations": anns}, f)
        return [id0 + i for i in range(n_imgs)]

    train_json = str(tmp_path / "captions_train.json")
    val_json = str(tmp_path / "captions_val.json")
    train_ids = make_json(train_json, 5000, 40)
    val_ids = make_json(val_json, 9000, 20)

    # full-corpus store: train AND val — but only val may be sampled.
    # one val id is deliberately missing -> must be skipped, not fatal
    store_ids = train_ids + val_ids[:-1]
    feats = {i: l1_normalize(
        rng.standard_normal((1, 32)).astype(np.float32))[0]
        for i in store_ids}
    store_dir = str(tmp_path / "feats")
    FeatureStore.from_dict(feats, normalized=True).save(store_dir)

    from lrcn_jax.core.tokenizer import tokenize
    vocab, _ = tokenize([train_json, val_json])
    ckpt = str(tmp_path / "ckpt")
    _tiny_checkpoint(ckpt, vocab, 32)

    monkeypatch.chdir(tmp_path)
    rc = cli.main([
        "generate", "--loadfile", ckpt, "--features", store_dir,
        "--datafiles", train_json, val_json,
        "--capnumber", "20", "--generate", "6", "--beam_width", "1",
        "--batch-size", "10", "--seed", "3", "--compute-dtype", "float32"])
    assert rc == 0
    picked = [int(x) for x in open("candidate_ids.txt").read().split()]
    assert len(picked) == 19          # 20 val images, 1 without features
    assert set(picked) == set(val_ids[:-1])


def test_datafiles_autofill(tmp_path):
    """--flickr/--coco fill the reference's default caption paths
    (lrcn.jl:24-26,68-69), honoring the annotations/ subdir the current
    COCO zip extracts to."""
    import argparse

    def ns(**kw):
        base = dict(datafiles=[], flickr=False, coco=False,
                    data_root=str(tmp_path))
        base.update(kw)
        return argparse.Namespace(**base)

    args = ns(flickr=True)
    cli._autofill_datafiles(args)
    assert args.datafiles == [
        os.path.join(str(tmp_path), "Flickr30k", "results_20130124.token")]
    assert cli._dataset_kind(args) == "flickr"

    args = ns(coco=True)
    cli._autofill_datafiles(args)
    assert [os.path.basename(f) for f in args.datafiles] == [
        "captions_train2014.json", "captions_val2014.json"]
    assert cli._dataset_kind(args) == "coco"

    # the nested annotations/ layout wins when only it exists
    nested = tmp_path / "MsCoCo" / "annotations"
    nested.mkdir(parents=True)
    (nested / "captions_train2014.json").write_text("{}")
    args = ns(coco=True)
    cli._autofill_datafiles(args)
    assert args.datafiles[0] == str(nested / "captions_train2014.json")

    # explicit datafiles always win; both flags at once is an error
    args = ns(flickr=True, datafiles=["x.token"])
    cli._autofill_datafiles(args)
    assert args.datafiles == ["x.token"]
    with pytest.raises(SystemExit):
        cli._autofill_datafiles(ns(flickr=True, coco=True))


# --- generalization / divergence quality gates -------------------------
#
# A LEARNABLE but non-trivial synthetic corpus: each feature class has
# THREE caption templates of different lengths (masking is exercised at
# train and eval), features are noisy one-hots, and the eval images are
# unseen ids with fresh noise — so a passing BLEU requires generalizing
# class -> caption distribution, not memorizing image ids.  Templates
# within a class start with distinct words so the decoder converges on
# one full template instead of a mixture.


def _class_templates(rng, n_classes):
    templates = []
    for _ in range(n_classes):
        firsts = rng.choice(WORDS, 3, replace=False)
        templates.append([
            " ".join([w] + list(rng.choice(WORDS,
                                           int(rng.integers(3, 8)))))
            for w in firsts])
    return templates


def _learnable_corpus(tmp_path, rng, n_classes=10, n_train=50, n_val=25,
                      feat_noise=0.05):
    """captions_{train,val}.json + a noisy one-hot feature store per split.

    Every image's 5 reference captions cover all 3 of its class's
    templates, so whichever template the model converges on is always in
    the reference set.  Returns (train_json, val_json, train_store_dir,
    val_store_dir, val_ids).
    """
    templates = _class_templates(rng, n_classes)

    def refs_for(class_id):
        t = templates[class_id]
        return [t[0], t[1], t[2], t[0], t[1]]

    def make_split(path, id0, n_imgs):
        anns = [{"image_id": id0 + i, "caption": cap}
                for i in range(n_imgs)
                for cap in refs_for(i % n_classes)]
        with open(path, "w") as f:
            json.dump({"annotations": anns}, f)
        return [id0 + i for i in range(n_imgs)]

    train_json = str(tmp_path / "captions_train.json")
    val_json = str(tmp_path / "captions_val.json")
    train_ids = make_split(train_json, 5000, n_train)
    val_ids = make_split(val_json, 9000, n_val)

    def noisy_feats(ids):
        return {iid: l1_normalize(
            (np.eye(n_classes, dtype=np.float32)[
                (iid - ids[0]) % n_classes]
             + feat_noise * np.abs(rng.standard_normal(n_classes))
             .astype(np.float32))[None])[0]
            for iid in ids}

    train_store = str(tmp_path / "train_feats")
    val_store = str(tmp_path / "val_feats")
    FeatureStore.from_dict(noisy_feats(train_ids),
                           normalized=True).save(train_store)
    FeatureStore.from_dict(noisy_feats(val_ids),
                           normalized=True).save(val_store)
    return train_json, val_json, train_store, val_store, val_ids


def _train_generate_bleu(tmp_path, tag, train_json, val_json, train_store,
                         val_store, n_val, extra_train_flags=(),
                         epochs=30):
    """train -> generate (held-out protocol) -> refs -> BLEU result."""
    from lrcn_jax.evaluation.bleu import multi_bleu_files
    from lrcn_jax.evaluation.references import build_coco_references

    ckpt = str(tmp_path / f"ckpt_{tag}")
    assert cli.main([
        "train", "--datafiles", train_json, val_json,
        "--features", train_store, "--savefile", ckpt,
        "--epochs", str(epochs), "--batchsize", "16", "--lr", "3e-3",
        "--hidden", "32", "32", "--embed", "24", "--seed", "13",
        "--dropout", "0.0", "--compute-dtype", "float32",
        *extra_train_flags]) == 0
    cand = str(tmp_path / f"cands_{tag}.txt")
    ids_file = str(tmp_path / f"ids_{tag}.txt")
    assert cli.main([
        "generate", "--loadfile", ckpt, "--features", val_store,
        "--datafiles", train_json, val_json,
        "--capnumber", str(n_val), "--generate", "14", "--beam_width", "2",
        "--batch-size", str(n_val), "--out", cand, "--ids-out", ids_file,
        "--seed", "7", "--compute-dtype", "float32"]) == 0
    stem = build_coco_references(ids_file, val_json,
                                 str(tmp_path / f"refs_{tag}"))
    return multi_bleu_files(stem, cand), cand


def test_generalization_gate_bleu(tmp_path):
    """The model must GENERALIZE: unseen val ids, fresh feature noise,
    3 variable-length captions per class (VERDICT r2 weak #1 — the old
    gate's one-fixed-caption corpus could pass on memorization)."""
    rng = np.random.default_rng(23)
    corpus = _learnable_corpus(tmp_path, rng)
    result, cand = _train_generate_bleu(tmp_path, "gen", *corpus[:4],
                                        n_val=len(corpus[4]))
    assert result.bleu[3] >= 0.85, (
        f"generalization gate failed: {result.format()}\n"
        f"first candidates: {open(cand).read().splitlines()[:3]}")


def test_batching_divergence_gate(tmp_path):
    """The framework's central intentional divergence — bucketed+masked
    batching instead of the reference's delete-based equal-length
    batching (lrcn.jl:299-327) — must not move BLEU-4 (SURVEY.md §7:
    validate within ±0.5 on the 100 scale, i.e. 0.005)."""
    rng = np.random.default_rng(29)
    # n_train=47: per-length caption counts don't divide the batch size,
    # so the equal-length path really deletes data (40 of 240 captions)
    corpus = _learnable_corpus(tmp_path, rng, n_train=47)
    n_val = len(corpus[4])

    # guard: the two batchings must actually differ on this corpus
    from lrcn_jax.core.tokenizer import tokenize
    from lrcn_jax.data.batcher import bucket_batches, equal_length_batches
    vocab, cls = tokenize([corpus[0], corpus[1]])
    n_bucket = sum(len(b.image_ids)
                   for b in bucket_batches(cls[0], vocab, 16))
    n_equal = sum(len(b.image_ids)
                  for b in equal_length_batches(cls[0], vocab, 16))
    assert n_bucket - n_equal >= 20, (
        "corpus does not exercise the delete-based batching divergence")

    bucketed, _ = _train_generate_bleu(tmp_path, "bucket", *corpus[:4],
                                       n_val=n_val, epochs=50)
    equal, _ = _train_generate_bleu(tmp_path, "equal", *corpus[:4],
                                    n_val=n_val, epochs=50,
                                    extra_train_flags=(
                                        "--equal-length-batches",))
    b, e = bucketed.bleu[3], equal.bleu[3]
    assert b >= 0.85 and e >= 0.85, (b, e)
    assert abs(b - e) <= 0.005, (
        f"batching divergence moved BLEU-4: bucketed={b:.4f} "
        f"equal-length={e:.4f}")


def test_flickr_token_flow_quality_gate(tmp_path, monkeypatch):
    """The same generalization gate through the Flickr .token flow
    end-to-end: token split -> train -> held-out-test generate ->
    build_flickr_references -> BLEU (every prior e2e gate was COCO-json
    only).  Split sizes are scaled down via the tokenizer constants."""
    from lrcn_jax.core import tokenizer as tok
    from lrcn_jax.evaluation.bleu import multi_bleu_files
    from lrcn_jax.evaluation.references import build_flickr_references

    monkeypatch.setattr(tok, "VAL_SIZE", 8)
    monkeypatch.setattr(tok, "TEST_SIZE", 8)

    rng = np.random.default_rng(31)
    n_classes, n_images = 8, 80
    templates = _class_templates(rng, n_classes)
    lines = []
    for i in range(n_images):
        t = templates[i % n_classes]
        for j, cap in enumerate([t[0], t[1], t[2], t[0], t[1]]):
            lines.append(f"{10000 + i}.jpg#{j}\t{cap} .\n")
    token_path = str(tmp_path / "flickr.token")
    with open(token_path, "w") as f:
        f.writelines(lines)

    feats = {10000 + i: l1_normalize(
        (np.eye(n_classes, dtype=np.float32)[i % n_classes]
         + 0.05 * np.abs(rng.standard_normal(n_classes))
         .astype(np.float32))[None])[0] for i in range(n_images)}
    store_dir = str(tmp_path / "feats")
    FeatureStore.from_dict(feats, normalized=True).save(store_dir)

    ckpt = str(tmp_path / "ckpt_flickr")
    assert cli.main([
        "train", "--datafiles", token_path, "--features", store_dir,
        "--savefile", ckpt, "--epochs", "30", "--batchsize", "16",
        "--lr", "3e-3", "--hidden", "32", "32", "--embed", "24",
        "--seed", "13", "--dropout", "0.0",
        "--compute-dtype", "float32"]) == 0

    monkeypatch.chdir(tmp_path)
    assert cli.main([
        "generate", "--loadfile", ckpt, "--features", store_dir,
        "--datafiles", token_path, "--capnumber", "8", "--generate", "14",
        "--beam_width", "2", "--batch-size", "8", "--seed", "7",
        "--compute-dtype", "float32"]) == 0
    # the Flickr default output names (lrcn.jl:133-134)
    assert os.path.exists("candidates_flickr")
    stem = build_flickr_references("candidate_ids_flickr", token_path,
                                   str(tmp_path / "frefs"))
    result = multi_bleu_files(stem, "candidates_flickr")
    assert result.bleu[3] >= 0.85, (
        f"flickr flow gate failed: {result.format()}\n"
        f"candidates: {open('candidates_flickr').read().splitlines()}")


def test_eval_coco_json_path(tmp_path):
    """`lrcn eval` with COCO-style annotations (eval/eval.jl:8-38 flow)."""
    anns = {"annotations": [
        {"image_id": iid, "caption": f"caption {k} for image {iid} ."}
        for iid in (7, 8) for k in range(5)
    ]}
    ann_path = str(tmp_path / "captions_val.json")
    with open(ann_path, "w") as f:
        json.dump(anns, f)
    cand = str(tmp_path / "cands.txt")
    ids = str(tmp_path / "ids.txt")
    with open(cand, "w") as f:
        f.write("caption 0 for image 8 .\ncaption 1 for image 7 .\n")
    with open(ids, "w") as f:
        f.write("8\n7\n")
    refs = str(tmp_path / "refs")
    rc = cli.main(["eval", "--candidates", cand, "--candidate-ids", ids,
                   "--annotations", ann_path, "--refs-dir", refs])
    assert rc == 0
    ref0 = open(os.path.join(refs, "ref0")).read().splitlines()
    assert ref0[0].startswith("caption 0 for image 8")


def test_train_on_coco_json_pair(tmp_path):
    """COCO flow: two captions .json files (train+val) as --datafiles.

    The reference passes both jsons and both feed the vocab
    (lrcn.jl:69, tokenizer.jl:23).
    """
    rng = np.random.default_rng(4)

    def make_json(path, id0, n_imgs):
        anns = []
        for i in range(n_imgs):
            for _ in range(5):
                n = int(rng.integers(4, 9))
                anns.append({"image_id": id0 + i,
                             "caption": " ".join(rng.choice(WORDS, n))})
        with open(path, "w") as f:
            json.dump({"annotations": anns}, f)
        return [id0 + i for i in range(n_imgs)]

    train_json = str(tmp_path / "captions_train.json")
    val_json = str(tmp_path / "captions_val.json")
    train_ids = make_json(train_json, 5000, 30)
    val_ids = make_json(val_json, 9000, 10)

    feats = {i: l1_normalize(
        rng.standard_normal((1, 48)).astype(np.float32))[0]
        for i in train_ids + val_ids}
    store_dir = str(tmp_path / "feats")
    FeatureStore.from_dict(feats, normalized=True).save(store_dir)

    # plant a word that appears ONLY in the val json (5 times, above the
    # min-count filter) — it must reach the vocabulary
    with open(val_json) as f:
        val_data = json.load(f)
    for k in range(5):
        val_data["annotations"][k]["caption"] += " zyzzyva"
    with open(val_json, "w") as f:
        json.dump(val_data, f)

    rc = cli.main([
        "train", "--datafiles", train_json, val_json,
        "--features", store_dir, "--val-features", store_dir,
        "--savefile", str(tmp_path / "ckpt"),
        "--epochs", "1", "--batchsize", "8",
        "--hidden", "16", "16", "--embed", "12", "--seed", "5",
        "--dropout", "0.0", "--compute-dtype", "float32"])
    assert rc == 0
    from lrcn_jax.core.vocab import UNK_ID, Vocab
    vocab = Vocab.load(os.path.join(str(tmp_path / "ckpt"), "vocab.json"))
    assert vocab.id("zyzzyva") != UNK_ID, \
        "val json did not feed the vocabulary (tokenizer.jl:23 parity)"
