"""A bounded LRU of values built from the content of host arrays.

The filtered scans turn a host filter into what the scan reads (a device
mask, slot bits, per-shard masks, layout bits) once per distinct filter:
the micro-batcher's filtered batches repeat the same few predicates.  The
key is a digest of the array's bytes plus whatever else the value depends
on (a capacity, a count), so an append that changes those never returns a
stale entry.  The micro-batcher's pipeline threads share one cache: a
lookup and an insertion each hold the lock, and the build runs outside it
(two threads may build the same entry; the last one in stays)."""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Hashable, TypeVar

import numpy as np

V = TypeVar("V")


class ContentLRU:
    """The last ``size`` values by key, least recently used out first."""

    def __init__(self, size: int) -> None:
        self.size = int(size)
        self._entries: "OrderedDict[Hashable, object]" = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def key(content: np.ndarray, *extra: Hashable) -> tuple:
        """The 16-byte BLAKE2b digest of ``content``'s bytes, then ``extra``."""
        return (hashlib.blake2b(content.tobytes(), digest_size=16).digest(), *extra)

    def get(self, key: Hashable, build: Callable[[], V]) -> V:
        """The value under ``key``, made by ``build()`` on a miss."""
        with self._lock:
            cached = self._entries.get(key)
            if cached is not None:
                self._entries.move_to_end(key)
                return cached
        value = build()
        with self._lock:
            self._entries[key] = value
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)
        return value

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)
