"""chip_smoke.py: its device gate, and its phases rehearsed at tiny widths.

The phases run here on the CPU backend exactly as they run on the card,
with every width cut down (``TINY``); the four-card phases run on four
virtual CPU devices.  Only ``main`` insists on a GPU.
"""

import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as smoke  # noqa: E402

# Pipeline parallelism needs hidden == embed, even; vocab-TP needs the
# vocabulary (words + 3 reserved ids) divisible by the model axis (2).
# 2,100 images leave 100 for training once the fixed 1,000/1,000 val/test
# split is taken, so the CLI trains at the small-dataset batch of 10.
TINY = smoke.Sizes(
    hidden=16, embed=16, vocab_words=37, vgg_width=0.05, fc_dim=32,
    n_images=2100, batch=10, n_generate=64, n_reference=3, n_vgg_check=2,
    vgg_scan=(2, 2), joint_batch=2, joint_steps=2, decode_batch=64,
    encode_batch=2, n_id_requests=8, n_feature_requests=2,
    n_image_requests=2, mesh_steps=2, mesh_decode_batch=8,
    mesh_serve_batch=4)


def test_smoke_refuses_without_gpu(tmp_path):
    """No GPU: non-zero exit before any phase, and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_smoke_fails_outside_the_repo(tmp_path):
    """A directory holding only chip_smoke.py cannot run it."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_rehearse_train_generate_serve(tmp_path):
    data = smoke.write_corpus(str(tmp_path), TINY, seed=0)
    ckpt = smoke.phase_train(TINY, str(tmp_path), data, seed=0)
    generated = smoke.phase_generate(TINY, str(tmp_path), data, ckpt, seed=0)
    assert len(generated) == TINY.n_generate
    smoke.phase_serve(TINY, data, ckpt, generated, seed=0)


def test_rehearse_vgg():
    smoke.phase_vgg(TINY, seed=0)


def test_rehearse_joint():
    smoke.phase_joint(TINY, seed=0)


def test_rehearse_four_cards(tmp_path):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    smoke.run_four_cards(TINY, str(tmp_path), 0, devices)


def test_check_raises_phase_error():
    smoke.check(True, "unused")
    with pytest.raises(smoke.PhaseError, match="broken"):
        smoke.check(False, "broken")
