"""On-disk feature store: image id -> float32[4096] fc7 vector.

Replaces the reference's JLD feature dicts (``featsn.jld`` etc., loaded
whole into host RAM at lrcn.jl:121-123) with a memory-mappable directory
format:

    store_dir/
      features.npy   (N, dim) float32, mmap-able
      ids.npy        (N,) int64, row i holds the image id of features[i]
      meta.json      {"dim": ..., "normalized": ...}

``gather`` vectorizes the reference's per-batch, row-by-row host->device
feature copy (lrcn.jl:369-376) into one fancy-index + one transfer.
Extraction is resumable like the reference (skips ids already present,
lrcn.jl:203) via the append + save cycle.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Mapping, Sequence

import numpy as np

from lrcn_jax.config import CNN_FEATURE_DIM


def l1_normalize(feats: np.ndarray) -> np.ndarray:
    """Per-row L1 normalization.

    The reference's generation path normalizes live CNN features by their
    sum (``input/sum(input)``, lrcn.jl:597) and its precomputed feature
    files (``featsn.jld``) are stored already normalized.  fc7 is
    post-ReLU so the sum is the L1 norm.
    """
    sums = feats.sum(axis=-1, keepdims=True)
    return feats / np.where(sums == 0, 1.0, sums)


class FeatureStore:
    """Mutable id -> feature mapping with mmap-able persistence."""

    def __init__(self, dim: int = CNN_FEATURE_DIM, normalized: bool = False):
        self.dim = dim
        self.normalized = normalized
        self._index: dict[int, int] = {}
        self._rows: list[np.ndarray] = []      # in-memory appended rows
        self._mmap: np.ndarray | None = None   # rows loaded from disk
        self._mmap_count = 0

    # --- construction ---

    @classmethod
    def from_dict(cls, feats: Mapping[int, np.ndarray],
                  normalized: bool = False) -> "FeatureStore":
        ids = list(feats)
        dim = int(np.asarray(feats[ids[0]]).reshape(-1).shape[0])
        store = cls(dim=dim, normalized=normalized)
        for i in ids:
            store.add(i, feats[i])
        return store

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "FeatureStore":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        store = cls(dim=meta["dim"], normalized=meta.get("normalized", False))
        ids = np.load(os.path.join(path, "ids.npy"))
        feats = np.load(os.path.join(path, "features.npy"),
                        mmap_mode="r" if mmap else None)
        if feats.shape != (len(ids), store.dim):
            raise ValueError(f"corrupt store: features {feats.shape} vs "
                             f"{len(ids)} ids, dim {store.dim}")
        store._mmap = feats
        store._mmap_count = len(ids)
        store._index = {int(i): row for row, i in enumerate(ids)}
        return store

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        n = len(self)
        feats = np.empty((n, self.dim), np.float32)
        ids = np.empty((n,), np.int64)
        for image_id, row in self._index.items():
            ids[row] = image_id
            feats[row] = self._row(row)
        np.save(os.path.join(path, "features.npy"), feats)
        np.save(os.path.join(path, "ids.npy"), ids)
        # meta last: a directory is a valid store iff meta.json exists,
        # which is what save_atomic/recover key on
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"dim": self.dim, "normalized": self.normalized}, f)

    def save_atomic(self, path: str) -> None:
        """Crash-safe save: write a complete snapshot to ``path.tmp``,
        then swap it into place.

        A kill at ANY instant leaves a loadable store: either the old
        ``path``, or a complete ``path.tmp``/``path.old`` that
        :meth:`recover` rotates back in.  Required for periodic flushing
        during extraction — a plain ``save`` onto a directory this store
        is mmap-reading from would truncate the mapped file mid-run.
        """
        import shutil

        tmp, old = path + ".tmp", path + ".old"
        shutil.rmtree(tmp, ignore_errors=True)
        self.save(tmp)
        if os.path.exists(os.path.join(path, "meta.json")):
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        elif os.path.isdir(path):   # partial non-atomic save: discard
            shutil.rmtree(path)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)

    @classmethod
    def recover(cls, path: str) -> str | None:
        """Roll a crashed :meth:`save_atomic` forward; return the loadable
        path (``path`` itself) or None when nothing is there.

        Precedence: a COMPLETE ``path.tmp`` is strictly newer than
        ``path`` (save_atomic clears it before every snapshot), so it
        wins; else an intact ``path``; else ``path.old`` (the crash hit
        mid-swap).  Incomplete leftovers are removed.
        """
        import shutil

        def complete(p):
            return os.path.exists(os.path.join(p, "meta.json"))

        tmp, old = path + ".tmp", path + ".old"
        for candidate in (tmp, path, old):
            if complete(candidate):
                if candidate != path:
                    if os.path.isdir(path):
                        shutil.rmtree(path)
                    os.rename(candidate, path)
                break
        for leftover in (tmp, old):
            shutil.rmtree(leftover, ignore_errors=True)
        return path if complete(path) else None

    # --- access ---

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, image_id: int) -> bool:
        return int(image_id) in self._index

    def ids(self) -> list[int]:
        return list(self._index)

    def _row(self, row: int) -> np.ndarray:
        if row < self._mmap_count:
            return np.asarray(self._mmap[row])
        return self._rows[row - self._mmap_count]

    def add(self, image_id: int, feat: np.ndarray) -> None:
        feat = np.asarray(feat, np.float32).reshape(-1)
        if feat.shape[0] != self.dim:
            raise ValueError(f"feature dim {feat.shape[0]} != {self.dim}")
        image_id = int(image_id)
        if image_id in self._index:
            raise KeyError(f"duplicate feature id {image_id}")
        self._index[image_id] = self._mmap_count + len(self._rows)
        self._rows.append(feat)

    def get(self, image_id: int) -> np.ndarray:
        row = self._index.get(int(image_id))
        if row is None:
            # reference errors out on missing features (lrcn.jl:603)
            raise KeyError(f"missing features for image {image_id}")
        return self._row(row)

    def gather(self, image_ids: Sequence[int] | np.ndarray) -> np.ndarray:
        """Batch feature lookup -> (B, dim) float32.

        One vectorized fancy-index instead of the reference's row-by-row
        device copies (lrcn.jl:369-376).
        """
        rows = np.fromiter((self._index[int(i)] for i in image_ids),
                           np.int64, count=len(image_ids))
        if not self._rows:
            if self._mmap_count == 0:
                return np.empty((0, self.dim), np.float32)
            return np.asarray(self._mmap[rows])
        parts = ([np.asarray(self._mmap)] if self._mmap_count else [])
        parts.append(np.stack(self._rows))
        return np.concatenate(parts, axis=0)[rows]

    def rows(self, image_ids: Sequence[int] | np.ndarray) -> np.ndarray:
        """Row indices of ``image_ids`` into ``table()`` -> (B,) int32.

        For device-resident training: upload ``table()`` to HBM once, then
        feed batches as row indices (a few KB) instead of feature rows
        (MBs) — the gather happens on device inside the jitted step.
        """
        return np.fromiter((self._index[int(i)] for i in image_ids),
                           np.int32, count=len(image_ids))

    def table(self) -> np.ndarray:
        """The full (N, dim) float32 feature table, rows as in ``rows()``."""
        parts = ([np.asarray(self._mmap)] if self._mmap_count else [])
        if self._rows:
            parts.append(np.stack(self._rows))
        if not parts:
            return np.empty((0, self.dim), np.float32)
        return np.concatenate(parts, axis=0)

    def missing(self, image_ids: Iterable[int]) -> list[int]:
        """Ids not yet in the store (resumable extraction, lrcn.jl:203)."""
        return [i for i in dict.fromkeys(int(x) for x in image_ids)
                if i not in self._index]
