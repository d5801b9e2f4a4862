"""Checkpointing: model params + vocab + config, npz-backed.

Replaces the reference's JLD checkpoints, which store the flat param list
and the vocab (lrcn.jl:185,230; GPU arrays round-tripped through the
KnetJLD shim, lrcn.jl:776-781).  The vocab travels with the checkpoint for
self-consistency even though our vocab construction is deterministic
(the reference's is not — see core/vocab.py).

Format:

    ckpt_dir/
      params.npz     flattened param pytree, keys are '/'-joined paths
      opt_state.npz  optional optimizer-state leaves, keys 'leaf_<i>'
      vocab.json
      config.json    LRCNConfig fields + step/epoch metadata
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import jax
import numpy as np

from lrcn_jax.config import LRCNConfig
from lrcn_jax.core.vocab import Vocab


def _flatten_params(params: Any) -> dict[str, np.ndarray]:
    def part(p) -> str:
        # explicit hasattr chain: a truthiness `or` would skip falsy keys
        # (dict key 0, empty string) and corrupt the path
        if hasattr(p, "key"):
            return str(p.key)
        if hasattr(p, "name"):      # GetAttrKey (NamedTuple params)
            return str(p.name)
        return str(getattr(p, "idx", ""))

    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(part(p) for p in path)] = np.asarray(leaf)
    return flat


def _unflatten_params(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _write_checkpoint(path: str, params: Any, vocab: Vocab,
                      cfg: LRCNConfig, opt_state: Any, step: int,
                      epoch: int, position: dict | None,
                      extra_files: dict[str, np.ndarray]) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **_flatten_params(params))
    if opt_state is not None:
        leaves = jax.tree.leaves(opt_state)
        np.savez(os.path.join(path, "opt_state.npz"),
                 **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})
    vocab.save(os.path.join(path, "vocab.json"))
    for name, arr in extra_files.items():
        np.save(os.path.join(path, name), arr)
    meta = dataclasses.asdict(cfg)
    meta.update(step=step, epoch=epoch)
    if position is not None:
        meta["position"] = position
    # config.json is written LAST: its presence marks a complete save
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f, default=str)


def _complete(path: str) -> bool:
    return os.path.exists(os.path.join(path, "config.json"))


def save_checkpoint(path: str, params: Any, vocab: Vocab, cfg: LRCNConfig,
                    opt_state: Any = None, step: int = 0,
                    epoch: int = 0, position: dict | None = None) -> None:
    """Crash-safe checkpoint save: write a complete snapshot to
    ``path.tmp``, then swap it into place — a kill at ANY instant leaves
    a loadable checkpoint (same protocol as FeatureStore.save_atomic;
    step-interval checkpointing overwrites the same directory every N
    dispatches, so tearing the only copy would defeat its purpose).

    ``position``: mid-epoch resume marker written by step-interval
    checkpointing ({epoch, dispatch, shuffle_state, epoch_key,
    geometry}); absent on epoch-complete saves, which is what marks the
    epoch finished.

    Multi-process safe: EVERY process must call this (param/opt leaves
    sharded across processes are fetched with a collective all-gather),
    but only process 0 touches the filesystem — N processes writing the
    same path on a shared filesystem would race the atomic swap.  All
    processes return only after the write completes (barrier), so a
    follow-up ``load_checkpoint`` on any process sees the new snapshot.
    """
    import shutil

    from lrcn_jax.parallel.distributed import barrier, gather_to_host, \
        is_primary

    params = gather_to_host(params)
    if opt_state is not None:
        opt_state = gather_to_host(opt_state)
    if not is_primary():
        barrier("lrcn_ckpt_save")
        return

    # preserve sidecar files earlier code placed next to the checkpoint
    # (e.g. average_image.npy written by the joint CLI before training)
    extra_files = {}
    if os.path.isdir(path):
        for name in os.listdir(path):
            if name.endswith(".npy"):
                extra_files[name] = np.load(os.path.join(path, name))

    tmp, old = path + ".tmp", path + ".old"
    shutil.rmtree(tmp, ignore_errors=True)
    _write_checkpoint(tmp, params, vocab, cfg, opt_state, step, epoch,
                      position, extra_files)
    if _complete(path):
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    elif os.path.isdir(path):   # partial non-atomic leftovers: discard
        shutil.rmtree(path)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    barrier("lrcn_ckpt_save")


def recover_checkpoint(path: str) -> str | None:
    """Roll a crashed ``save_checkpoint`` forward; returns the loadable
    path or None.  Precedence: complete ``path.tmp`` (strictly newer) >
    intact ``path`` > ``path.old`` (crash mid-swap)."""
    import shutil

    tmp, old = path + ".tmp", path + ".old"
    for candidate in (tmp, path, old):
        if _complete(candidate):
            if candidate != path:
                if os.path.isdir(path):
                    shutil.rmtree(path)
                os.rename(candidate, path)
            break
    for leftover in (tmp, old):
        shutil.rmtree(leftover, ignore_errors=True)
    return path if _complete(path) else None


def load_checkpoint(path: str) -> dict[str, Any]:
    """Load a checkpoint directory.

    Returns a dict with 'params' (numpy pytree), 'vocab', 'cfg', 'step',
    'epoch', and 'opt_leaves' (list or None; restore into an optimizer
    state with ``restore_opt_state``).
    """
    recover_checkpoint(path)    # roll a crashed atomic save forward
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten_params({k: z[k] for k in z.files})
    vocab = Vocab.load(os.path.join(path, "vocab.json"))
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    step = meta.pop("step", 0)
    epoch = meta.pop("epoch", 0)
    position = meta.pop("position", None)
    field_names = {f.name for f in dataclasses.fields(LRCNConfig)}
    cfg = LRCNConfig(**{k: v for k, v in meta.items() if k in field_names})
    opt_leaves = None
    opt_path = os.path.join(path, "opt_state.npz")
    if os.path.exists(opt_path):
        with np.load(opt_path) as z:
            opt_leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    return {"params": params, "vocab": vocab, "cfg": cfg, "step": step,
            "epoch": epoch, "opt_leaves": opt_leaves,
            "position": position}


def restore_opt_state(template_opt_state: Any, opt_leaves: list) -> Any:
    """Rebuild an optimizer state from saved leaves + a freshly-initialized
    template (``opt.init(params)``) providing the tree structure."""
    treedef = jax.tree.structure(template_opt_state)
    return jax.tree.unflatten(treedef, opt_leaves)


def restore_opt_state_like(template_opt_state: Any, opt_leaves: list) -> Any:
    """Like ``restore_opt_state``, but places every restored leaf with the
    template leaf's sharding — so resuming on a device mesh re-shards the
    Adam moments exactly as ``opt.init`` laid them out."""
    restored = restore_opt_state(template_opt_state, opt_leaves)
    def place(t, v):
        if isinstance(t, jax.Array):
            return jax.device_put(np.asarray(v), t.sharding)
        return v
    return jax.tree.map(place, template_opt_state, restored)


# --- step-interval resume positions (shared by Trainer / JointTrainer) ---


def make_position(epoch: int, dispatch: int, shuffle_state: dict,
                  epoch_key: np.ndarray, geometry: dict) -> dict:
    """The mid-epoch resume marker a step-interval save carries.

    ``geometry`` records whatever determines the dispatch stream
    (steps_per_dispatch, batch count): a resume under a DIFFERENT
    geometry would silently reinterpret the dispatch index as a
    different batch stream, so ``resume_start`` refuses it."""
    return {"epoch": int(epoch), "dispatch": int(dispatch),
            "shuffle_state": shuffle_state,
            "epoch_key": np.asarray(epoch_key).tolist(),
            "geometry": dict(geometry)}


def resume_start(resume_position: dict | None,
                 shuffle_rng: "np.random.Generator", rng_key,
                 geometry: dict) -> tuple[int, int, Any]:
    """Unpack (and validate) a resume position into
    ``(start_epoch, start_dispatch, rng_key)``; restores the shuffle
    generator state in place.  No position -> ``(1, 0, rng_key)``."""
    if not resume_position:
        return 1, 0, rng_key
    saved = resume_position.get("geometry", {})
    if saved and saved != geometry:
        raise ValueError(
            f"resume: the checkpoint's mid-epoch position was recorded "
            f"under dispatch geometry {saved}, but this run has "
            f"{geometry} — the dispatch index would address a different "
            f"batch stream. Re-run with the original flags (or train "
            f"from the last epoch-complete checkpoint).")
    shuffle_rng.bit_generator.state = resume_position["shuffle_state"]
    rng_key = jax.numpy.asarray(
        np.asarray(resume_position["epoch_key"], np.uint32))
    start_epoch = int(resume_position["epoch"])
    start_dispatch = int(resume_position["dispatch"])
    print(f"resume: continuing epoch {start_epoch} from dispatch "
          f"{start_dispatch}")
    return start_epoch, start_dispatch, rng_key
