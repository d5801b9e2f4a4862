"""Where compiled programs are cached: JAX_COMPILATION_CACHE_DIR when it is
set, otherwise ``.jax_cache/`` at the checkout root."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILE = (
    "import jax, jax.numpy as jnp\n"
    "from lrcn_jax.utils.compile_cache import enable_compile_cache\n"
    "print(enable_compile_cache())\n"
    "jax.jit(lambda x: jnp.tanh(x) * 3 + 1)(jnp.ones(8)).block_until_ready()\n"
)


def _checkout_copy(tmp_path):
    """A checkout holding just the package, so its root is ``tmp_path``."""
    shutil.copytree(os.path.join(REPO, "lrcn_jax"), tmp_path / "lrcn_jax",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return tmp_path


def _run(checkout, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "PYTHONPATH")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(checkout),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0", **env_extra)
    out = subprocess.run([sys.executable, "-c", _COMPILE], env=env,
                         cwd=checkout, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_cache_lands_in_env_dir_when_set(tmp_path):
    checkout = _checkout_copy(tmp_path / "checkout")
    cache = tmp_path / "elsewhere"
    assert _run(checkout, JAX_COMPILATION_CACHE_DIR=str(cache)) == str(cache)
    assert any(name.endswith("-cache") for name in os.listdir(cache))
    assert not (checkout / ".jax_cache").exists()


def test_cache_lands_in_checkout_when_unset(tmp_path):
    checkout = _checkout_copy(tmp_path / "checkout")
    cache = checkout / ".jax_cache"
    assert _run(checkout) == str(cache)
    assert any(name.endswith("-cache") for name in os.listdir(cache))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
