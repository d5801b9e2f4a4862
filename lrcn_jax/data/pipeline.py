"""Host -> device input feed.

The reference copies features into the device batch row by row inside the
training loop (lrcn.jl:369-376), serializing host work with device compute.
Here batches are staged to the device ahead of use with a small prefetch
ring: while the device runs step N, the host gathers + transfers step N+1.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator

import jax


def prefetch_to_device(iterator: Iterable[Any], size: int = 2,
                       device: jax.Device | None = None,
                       transform: Callable[[Any], Any] | None = None
                       ) -> Iterator[Any]:
    """Double-buffered (by default) device prefetch.

    ``transform`` runs on host (e.g. feature gather + padding) before the
    async ``jax.device_put``.  ``device_put`` returns immediately; the
    transfer overlaps with the consumer's compute.
    """
    queue: collections.deque = collections.deque()
    it = iter(iterator)

    def put(item):
        # leaves the transform already placed (e.g. sharded global
        # arrays) pass through: a second device_put would be a no-op
        # single-process and reject non-addressable multi-process arrays
        if device is None and all(
                isinstance(leaf, jax.Array)
                for leaf in jax.tree_util.tree_leaves(item)):
            return item
        return jax.device_put(item, device)

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                item = next(it)
            except StopIteration:
                return
            if transform is not None:
                item = transform(item)
            queue.append(put(item))

    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)
