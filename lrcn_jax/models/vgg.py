"""VGG-16 image encoder to fc7.

Rebuilds the reference's MatConvNet-interpreter CNN (get_params_cnn /
get_convnet, lrcn.jl:696-748) as a pure-JAX forward:

- 13 3x3 convolutions (pad 1, CROSS-correlation — Knet ``mode=1``,
  lrcn.jl:724) each followed by ReLU, with 2x2/stride-2 max pools after
  blocks (conv 2,2,3,3,3 layout), then fc6 (7*7*512 -> 4096) + ReLU and
  fc7 (4096 -> 4096);
- the reference stops the layer walk AT fc7 (``last_layer="fc7"``,
  lrcn.jl:697, break at :717) so **relu7 is NOT applied** — fc7 features can
  be negative; we reproduce that exactly;
- fc6 weights keep their (7, 7, 512, 4096) structure and contract against
  the NHWC activation volume with one einsum — this sidesteps the
  column-major ``mat()`` flattening the reference relies on (lrcn.jl:712,728)
  instead of re-deriving a permutation;
- NHWC layout, ``lax.conv_general_dilated`` in bfloat16 with float32
  accumulation (HIGHEST precision on the f32 path), ``lax.reduce_window``
  max pools, whole-network jit, arbitrary batch (the reference runs batch-1 per image,
  lrcn.jl:190-221 — our extractor is batched, SURVEY.md §3.3).

Weight import from the MatConvNet ``imagenet-vgg-verydeep-16.mat`` release
(URL at lrcn.jl:22) reproduces the reference's load-time fixes: conv biases
flattened (lrcn.jl:710), fc treated as dense (lrcn.jl:712), averageImage
taken from normalization meta (lrcn.jl:113).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from lrcn_jax.ops.lstm import matmul

# (name, out_channels) for the 13 conv layers; 'pool' marks 2x2/2 max pools.
# Mirrors the MatConvNet layer list walked at lrcn.jl:701-718.
VGG16_LAYOUT: tuple = (
    ("conv1_1", 64), ("conv1_2", 64), "pool",
    ("conv2_1", 128), ("conv2_2", 128), "pool",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "pool",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "pool",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "pool",
)

FC6_DIM = 4096
FC7_DIM = 4096

Params = dict[str, Any]


def init_vgg_params(key: jax.Array, dtype=jnp.float32,
                    width_multiplier: float = 1.0,
                    fc_dim: int | None = None) -> Params:
    """Random VGG-16 params (for tests/benchmarks without the .mat file).

    ``width_multiplier``/``fc_dim`` scale channel widths down for fast CPU
    tests; the forward derives every shape from the params themselves, so
    full size is simply the default.
    """
    params: Params = {}
    c_in = 3
    for entry in VGG16_LAYOUT:
        if entry == "pool":
            continue
        name, c_out = entry
        c_out = max(8, int(c_out * width_multiplier))
        key, k = jax.random.split(key)
        scale = np.sqrt(2.0 / (9 * c_in))
        params[name] = {
            "w": jax.random.normal(k, (3, 3, c_in, c_out), dtype) * scale,
            "b": jnp.zeros((c_out,), dtype),
        }
        c_in = c_out
    key, k6, k7 = jax.random.split(key, 3)
    fc6_dim = fc_dim or FC6_DIM
    fc7_dim = fc_dim or FC7_DIM
    params["fc6"] = {
        "w": jax.random.normal(k6, (7, 7, c_in, fc6_dim), dtype) * 0.01,
        "b": jnp.zeros((fc6_dim,), dtype),
    }
    params["fc7"] = {
        "w": jax.random.normal(k7, (fc6_dim, fc7_dim), dtype) * 0.01,
        "b": jnp.zeros((fc7_dim,), dtype),
    }
    return params


def _precision(compute_dtype):
    """HIGHEST for a float32 compute path, else the backend default.

    Without it a GPU runs float32 convolutions and contractions in TF32,
    which keeps about three decimal digits and defeats an explicit f32 path
    (the same rule as ``ops.lstm.matmul``).
    """
    return (jax.lax.Precision.HIGHEST
            if jnp.dtype(compute_dtype) == jnp.float32 else None)


def _conv(x: jax.Array, w: jax.Array, b: jax.Array,
          compute_dtype) -> jax.Array:
    """3x3 pad-1 cross-correlation + bias, NHWC/HWIO.

    The result is emitted directly in the compute dtype (accumulation stays
    f32 inside the conv), which halves the bytes the bias+ReLU epilogue
    reads and writes on the bf16 path.
    """
    y = jax.lax.conv_general_dilated(
        x.astype(compute_dtype), w.astype(compute_dtype),
        window_strides=(1, 1), padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=_precision(compute_dtype),
        preferred_element_type=compute_dtype)
    return y + b.astype(compute_dtype)


def _maxpool(x: jax.Array) -> jax.Array:
    """2x2 stride-2 max pool (Knet ``pool`` defaults, lrcn.jl:726)."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(1, 2, 2, 1), window_strides=(1, 2, 2, 1),
        padding="VALID")


def vgg16_fc7_fn(params: Params, images: jax.Array,
                 compute_dtype=jnp.bfloat16) -> jax.Array:
    """Un-jitted forward — composable into larger jitted programs
    (the joint fine-tune step wraps it in jax.checkpoint)."""
    conv_relu = lambda x, p: jax.nn.relu(
        _conv(x, p["w"], p["b"], compute_dtype))
    x = images
    for entry in VGG16_LAYOUT:
        if entry == "pool":
            x = _maxpool(x)
        else:
            name, _ = entry
            x = conv_relu(x, params[name])
    # fc6: contract the (7,7,512) volume directly — no flatten-order dance.
    w6, b6 = params["fc6"]["w"], params["fc6"]["b"]
    x = jnp.einsum("bhwc,hwcf->bf", x.astype(compute_dtype),
                   w6.astype(compute_dtype),
                   precision=_precision(compute_dtype),
                   preferred_element_type=jnp.float32)
    x = jax.nn.relu(x + b6.astype(jnp.float32))
    # fc7 linear — the reference breaks BEFORE relu7 (lrcn.jl:717).
    x = matmul(x, params["fc7"]["w"], compute_dtype)
    return x + params["fc7"]["b"].astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("compute_dtype",))
def vgg16_fc7(params: Params, images: jax.Array,
              compute_dtype=jnp.bfloat16) -> jax.Array:
    """images (B, 224, 224, 3) preprocessed -> fc7 (B, 4096), NO relu7."""
    return vgg16_fc7_fn(params, images, compute_dtype)


@functools.partial(jax.jit, static_argnames=("compute_dtype",))
def vgg16_fc7_scan(params: Params, images: jax.Array,
                   compute_dtype=jnp.bfloat16) -> jax.Array:
    """(K, B, 224, 224, 3) -> (K, B, 4096): K batches in ONE dispatch.

    ``lax.scan`` over the leading axis runs the batches back-to-back on
    device with a single host dispatch and a single result readback, so
    per-dispatch host overhead is paid once per group, not per batch.
    Replaces the reference's per-image interpreter walk (lrcn.jl:190-221).
    """
    def body(_, x):
        return None, vgg16_fc7_fn(params, x, compute_dtype)
    _, feats = jax.lax.scan(body, None, images)
    return feats


def l1_normalize(feats: jax.Array) -> jax.Array:
    """The reference's live-image normalization: x / sum(x) (lrcn.jl:597).

    Note it divides by the plain sum (not the abs-sum); precomputed feature
    files are expected to be pre-normalized the same way (``featsn.jld``
    naming, lrcn.jl:121-123).
    """
    return feats / jnp.sum(feats, axis=-1, keepdims=True)


def _layer_weights(layer: dict) -> tuple[np.ndarray, np.ndarray] | None:
    """(filters, biases) from a MatConvNet layer struct, or None.

    Handles both release layouts: the beta16+ ``weights`` 1x2 cell (what
    the reference's Knet loader reads, lrcn.jl:706-712) and the original
    2014 release's separate ``filters``/``biases`` fields.  scipy's
    ``simplify_cells`` turns the cell into a list/object-array either way.
    """
    if layer.get("weights") is not None and len(layer["weights"]) >= 2:
        pair = layer["weights"]
        return np.asarray(pair[0]), np.asarray(pair[1])
    if layer.get("filters") is not None:
        return np.asarray(layer["filters"]), np.asarray(layer["biases"])
    return None


def _fc6_weight(w: np.ndarray) -> np.ndarray:
    """fc6 filters -> (7, 7, 512, D).

    The .mat stores fc6 as a (7,7,512,4096) conv (kept as-is; any 4-D
    shape passes through so width-scaled test fixtures work).  If a
    release stores it pre-flattened to 2-D, the flatten was MATLAB
    column-major (the ``mat()`` order the reference relies on,
    lrcn.jl:712,728): row = h + 7*w + 49*c, undone below.
    """
    if w.ndim == 4:
        return w
    if w.ndim == 2 and w.shape[0] == 7 * 7 * 512:
        return w.reshape(512, 7, 7, -1).transpose(2, 1, 0, 3)
    raise ValueError(f"unexpected fc6 weight shape {w.shape}")


def _average_image(mat: dict) -> np.ndarray:
    """normalization.averageImage from either release layout.

    beta16+ nests it under ``meta`` (what the reference reads,
    lrcn.jl:113); the 2014 release keeps ``normalization`` top-level.
    Stored as a (224,224,3) image or a per-channel mean ((3,) / (1,1,3),
    squeezed to (3,) by simplify_cells) — broadcast to the full image.
    """
    norm = None
    meta = mat.get("meta")
    if isinstance(meta, dict):
        norm = meta.get("normalization")
    if norm is None:
        norm = mat.get("normalization")
    if not isinstance(norm, dict) or "averageImage" not in norm:
        raise ValueError(
            "no normalization.averageImage in the .mat (looked under "
            "'meta' and top-level)")
    avg = np.asarray(norm["averageImage"], np.float32)
    avg = avg.reshape(-1) if avg.size == 3 else avg
    if avg.ndim == 1:
        avg = np.broadcast_to(avg, (224, 224, 3)).copy()
    if avg.ndim != 3 or avg.shape[-1] != 3:
        raise ValueError(f"unexpected averageImage shape {avg.shape}")
    return avg


def load_matconvnet(path: str) -> tuple[Params, np.ndarray]:
    """Import ``imagenet-vgg-verydeep-16.mat`` -> (params, average_image).

    Reproduces the reference's load-time fixes (lrcn.jl:697-721): walk the
    layer list in order, collect weights for conv/fc layers, stop at fc7
    inclusive.  fc6 keeps its (7,7,512,4096) conv structure; fc7
    ((1,1,4096,4096), squeezed by scipy to 2-D) becomes a dense
    (4096,4096).  Both MatConvNet release layouts load (see
    ``_layer_weights`` / ``_average_image``).
    """
    from scipy.io import loadmat

    mat = loadmat(path, simplify_cells=True)
    layers = mat["layers"]
    if isinstance(layers, dict):   # single-layer cell squeezed to a struct
        layers = [layers]
    params: Params = {}
    for layer in layers:
        name = str(layer["name"])
        if not (name.startswith("conv") or name.startswith("fc")):
            continue
        pair = _layer_weights(layer)
        if pair is None:
            raise ValueError(f"layer {name!r} has no weights/filters")
        w, b = pair
        b = np.asarray(b, np.float32).reshape(-1)
        w = np.asarray(w, np.float32)
        if name == "fc6":
            w = _fc6_weight(w)
        elif name.startswith("fc"):
            w = w.reshape(-1, w.shape[-1])
        params[name] = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
        if name == "fc7":
            break
    if "fc7" not in params:
        raise ValueError("no fc7 layer found — not a VGG-16 MatConvNet "
                         "file?")
    return params, _average_image(mat)


def vgg_param_count(params: Params) -> int:
    return sum(int(x.size) for x in jax.tree.leaves(params))
