"""Image preprocessing + batched fc7 feature extraction.

Host side reproduces the reference's ``read_image_data`` (lrcn.jl:750-773):
decode (optionally downloading a URL, lrcn.jl:751-754), resize so the
SHORTEST side is 224 using the reference's exact integer arithmetic
``new_size = (dim * 224) ÷ min(dims)`` (lrcn.jl:756), center-crop 224x224
(:757-759), grayscale -> 3 channels (:761-763).

Device side is one jitted program over a batch: uint8 -> float, x255, mean
image subtraction (lrcn.jl:771) fused by XLA into the first VGG conv.  The
reference runs this per image on the host; we batch it (SURVEY.md §3.3 marks
the batch-1 interpreter walk as the hot spot).

Layout note: we keep images (H, W, 3) row-major NHWC end to end.  The
reference's permutedims dance (lrcn.jl:766-771) converts Julia's column-major
channelview to the same logical H/W orientation before the conv, so no
transposition is re-derived here — only the mean image is applied in (W,H,3)
orientation there (g1 permute AFTER subtraction); the mean image is nearly
constant per channel so we subtract it un-transposed and document the
divergence.
"""

from __future__ import annotations

import functools
import os
import tempfile
import urllib.request
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from lrcn_jax.data.feature_store import FeatureStore, l1_normalize

CROP = 224


def decode_image(path_or_url: str) -> np.ndarray:
    """Decode an image file (or URL) to (H, W, 3) uint8 RGB.

    Reference: download at lrcn.jl:752-754, load at :755, grayscale
    promotion at :761-763.
    """
    from PIL import Image

    path = path_or_url
    if "://" in path_or_url:
        suffix = os.path.splitext(path_or_url.split("?")[0])[1] or ".jpg"
        fd, path = tempfile.mkstemp(suffix=suffix)
        os.close(fd)
        urllib.request.urlretrieve(path_or_url, path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def resize_crop(image: np.ndarray) -> np.ndarray:
    """Shortest-side-224 resize + center crop -> (224, 224, 3) uint8.

    Uses the reference's integer resize arithmetic (lrcn.jl:756) and crop
    offsets (lrcn.jl:757-759).
    """
    from PIL import Image

    h, w = image.shape[:2]
    m = min(h, w)
    new_h, new_w = (h * CROP) // m, (w * CROP) // m
    im = Image.fromarray(image).resize((new_w, new_h), Image.BILINEAR)
    arr = np.asarray(im, np.uint8)
    i0 = (new_h - CROP) // 2
    j0 = (new_w - CROP) // 2
    return arr[i0:i0 + CROP, j0:j0 + CROP]


def load_batch_native(paths: Sequence[str], n_threads: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode+resize+crop a batch of JPEGs with the C++ threaded loader.

    Returns (images (N,224,224,3) uint8, ok (N,) bool) or None when the
    native library is unavailable.  Rows whose decode failed are zeroed and
    flagged; callers fall back to PIL for those.
    """
    import ctypes

    from lrcn_jax.native import imageloader_library

    lib = imageloader_library()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    n = len(paths)
    out = np.zeros((n, CROP, CROP, 3), np.uint8)
    status = (ctypes.c_int * n)()
    c_paths = (ctypes.c_char_p * n)(
        *[os.fsencode(p) for p in paths])
    lib.lrcn_load_images(
        c_paths, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), status,
        n_threads)
    ok = np.asarray(status[:], np.int32) == 0
    return out, ok


def decode_blobs_native(blobs: Sequence[bytes],
                        n_threads: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode+resize+crop encoded JPEG blobs with the C++ threaded
    loader (in-memory source — the serving image endpoint's bodies
    never touch disk).  Returns (images (N,224,224,3) uint8, ok (N,)
    bool) or None when the native library is unavailable."""
    import ctypes

    from lrcn_jax.native import imageloader_library

    lib = imageloader_library()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    n = len(blobs)
    out = np.zeros((n, CROP, CROP, 3), np.uint8)
    status = (ctypes.c_int * n)()
    c_blobs = (ctypes.c_char_p * n)(*blobs)
    sizes = (ctypes.c_longlong * n)(*[len(b) for b in blobs])
    lib.lrcn_load_images_mem(
        c_blobs, sizes, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), status,
        n_threads)
    ok = np.asarray(status[:], np.int32) == 0
    return out, ok


def load_blobs(blobs: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Encoded image blobs -> ((N,224,224,3) uint8, ok (N,) bool).

    Threaded native JPEG decode first, PIL rescue per failed row (PNG
    and other formats); ok[i] is False only when both fail.  Both the
    HTTP image endpoints and ``CaptionService.caption_image_bytes`` run
    through here, so the served decode path is byte-identical to the
    contract path regardless of which library decodes."""
    import io

    from PIL import Image

    n = len(blobs)
    native = decode_blobs_native(blobs)
    if native is not None:
        imgs, ok = native
    else:
        imgs = np.zeros((n, CROP, CROP, 3), np.uint8)
        ok = np.zeros(n, bool)
    for idx in np.flatnonzero(~ok):
        try:
            with Image.open(io.BytesIO(blobs[idx])) as im:
                imgs[idx] = resize_crop(
                    np.asarray(im.convert("RGB"), np.uint8))
            ok[idx] = True
        except Exception:   # noqa: BLE001 — bad bytes stay flagged
            pass
    return imgs, ok


def load_preprocessed(path: str) -> np.ndarray:
    """One image -> (224,224,3) uint8: native JPEG fast path, PIL fallback."""
    if path.lower().endswith((".jpg", ".jpeg")):
        native = load_batch_native([path])
        if native is not None and native[1][0]:
            return native[0][0]
    return resize_crop(decode_image(path))


def load_images(paths: Sequence[str]) -> np.ndarray:
    """Decode+resize+crop a batch -> (N, 224, 224, 3) uint8.

    Native threaded JPEG loader when every path is a JPEG, with PIL
    rescue for rows whose native decode fails; plain PIL otherwise.
    """
    if all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
        native = load_batch_native(paths)
        if native is not None:
            imgs, ok = native
            for idx in np.flatnonzero(~ok):   # PIL rescue per failure
                imgs[idx] = resize_crop(decode_image(paths[idx]))
            return imgs
    return np.stack([resize_crop(decode_image(p)) for p in paths])


@functools.partial(jax.jit, donate_argnums=(0,))
def normalize_batch(images_u8: jax.Array, average_image: jax.Array
                    ) -> jax.Array:
    """(B, 224, 224, 3) uint8 -> float32, 255-scale minus mean image.

    The reference loads 0..1 floats and computes ``255 * x - avg``
    (lrcn.jl:771); uint8 pixels are already 255-scaled.
    """
    return images_u8.astype(jnp.float32) - average_image


def preprocess(path_or_url: str, average_image: np.ndarray) -> jax.Array:
    """Single-image pipeline -> (1, 224, 224, 3) float32 on device."""
    img = resize_crop(decode_image(path_or_url))
    return normalize_batch(jnp.asarray(img[None]),
                           jnp.asarray(average_image, jnp.float32))


@functools.partial(jax.jit, static_argnames=("compute_dtype",))
def _normalize_and_fc7_scan(vgg_params, images_u8: jax.Array,
                            average_image: jax.Array,
                            compute_dtype=jnp.bfloat16) -> jax.Array:
    """(K, B, 224, 224, 3) uint8 -> (K, B, 4096) fc7 in ONE dispatch.

    Fuses the 255-scale/mean-subtract preprocessing (lrcn.jl:771) into the
    encoder and scans K batches back-to-back on device: one host dispatch
    and one readback per K*B images, so per-dispatch host overhead is
    paid once per group.
    """
    from lrcn_jax.models.vgg import vgg16_fc7_fn

    def body(_, x):
        x = x.astype(jnp.float32) - average_image
        return None, vgg16_fc7_fn(vgg_params, x, compute_dtype)
    _, feats = jax.lax.scan(body, None, images_u8)
    return feats


def extract_features(
    image_paths: dict[int, str],
    vgg_params,
    average_image: np.ndarray,
    *,
    store: FeatureStore | None = None,
    batch_size: int = 64,
    normalize: bool = True,
    compute_dtype=jnp.bfloat16,
    scan_depth: int = 8,
    checkpoint_dir: str | None = None,
    flush_every: int = 8,
) -> FeatureStore:
    """Batched fc7 extraction into a FeatureStore (lrcn.jl:190-221).

    Resumable: ids already present in ``store`` are skipped (lrcn.jl:203).
    Batches are grouped ``scan_depth`` at a time into a single scanned
    device dispatch (one host->device transfer, one readback) and the host
    decode of group N+1 overlaps with device compute of group N via a
    background thread.  The last partial batch is padded to ``batch_size``;
    a short tail group compiles one extra program shape.

    Crash safety: with ``checkpoint_dir``, an atomic snapshot
    (:meth:`FeatureStore.save_atomic`) lands every ``flush_every``
    groups, so a kill at image 79,999 of 80k loses at most
    ``flush_every * scan_depth`` batches — the reference saves once at
    the very end and loses everything (lrcn.jl:220).  Each flush
    rewrites the whole store; the default cadence keeps that rewrite
    amortized to <10% of extraction time at full VGG scale.
    """
    from concurrent.futures import ThreadPoolExecutor

    todo = (store.missing(image_paths) if store is not None
            else list(dict.fromkeys(int(i) for i in image_paths)))
    avg = jnp.asarray(average_image, jnp.float32)

    def load_host_batch(ids: list) -> np.ndarray:
        imgs = load_images([image_paths[i] for i in ids])
        pad = batch_size - len(ids)
        if pad:
            imgs = np.concatenate(
                [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
        return imgs

    def load_host_group(id_batches: list[list]) -> np.ndarray:
        return np.stack([load_host_batch(ids) for ids in id_batches])

    id_batches = [todo[s:s + batch_size]
                  for s in range(0, len(todo), batch_size)]
    id_groups = [id_batches[s:s + scan_depth]
                 for s in range(0, len(id_batches), scan_depth)]
    with ThreadPoolExecutor(max_workers=1) as pool:
        # depth-1 prefetch: exactly one in-flight decode future
        next_future = (pool.submit(load_host_group, id_groups[0])
                       if id_groups else None)
        for gi, group in enumerate(id_groups):
            imgs = next_future.result()
            next_future = (
                pool.submit(load_host_group, id_groups[gi + 1])
                if gi + 1 < len(id_groups) else None)
            group_feats = np.asarray(
                _normalize_and_fc7_scan(vgg_params, jnp.asarray(imgs), avg,
                                        compute_dtype), np.float32)
            for ids, feats in zip(group, group_feats):
                feats = feats[:len(ids)]
                if normalize:
                    feats = l1_normalize(feats)
                if store is None:   # dim comes from the encoder's output
                    store = FeatureStore(dim=feats.shape[-1],
                                         normalized=normalize)
                for i, f in zip(ids, feats):
                    store.add(i, f)
            if (checkpoint_dir is not None and flush_every > 0
                    and (gi + 1) % flush_every == 0
                    and gi + 1 < len(id_groups)):
                store.save_atomic(checkpoint_dir)
    if store is None:
        store = FeatureStore(normalized=normalize)
    if checkpoint_dir is not None:
        store.save_atomic(checkpoint_dir)
    return store
