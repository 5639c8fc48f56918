"""The plain reference: the key-value state a correct store holds.

It is rebuilt from the generated inputs alone (the loaded keys and the
stream's writes, each with its write generation) and
answers what a store must answer: for a point read, the newest
generation of each key or none; for a scan, the next live keys from a
start key in key order with their newest generations.  Values follow from
a key and its generation (``portbench.generator.value_rows``), so the
state is one generation per key.  NumPy and Python only; it imports
nothing of the program.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

NONE = -1              # the generation of a key that holds no value


class KVReference:
    """The state after the load: every loaded key at generation 0.  The
    keys any later write may write (``universe``) are known from the
    generated stream up front and held without a value until written, so
    that the state stays two sorted arrays."""

    def __init__(self, loaded: np.ndarray, universe: np.ndarray = None):
        loaded = np.unique(np.asarray(loaded, dtype=np.uint64))
        if universe is not None:
            universe = np.asarray(universe, dtype=np.uint64)
        self.keys = np.unique(loaded if universe is None
                              else np.concatenate([loaded, universe]))
        self.gens = np.full(self.keys.size, NONE, dtype=np.int64)
        self.gens[np.searchsorted(self.keys, loaded)] = 0

    def write(self, keys: np.ndarray, gens: np.ndarray) -> None:
        """One write op, in order: key ``i`` takes generation ``gens[i]``;
        a key written twice keeps its later generation."""
        keys = np.asarray(keys, dtype=np.uint64)
        gens = np.asarray(gens, dtype=np.int64)
        _, last = np.unique(keys[::-1], return_index=True)
        last = keys.size - 1 - last
        keys, gens = keys[last], gens[last]
        at = np.minimum(np.searchsorted(self.keys, keys), self.keys.size - 1)
        if not (self.keys[at] == keys).all():
            raise KeyError("a write outside the universe the reference holds")
        self.gens[at] = gens

    def get(self, keys: np.ndarray) -> np.ndarray:
        """The generation each key must read, ``NONE`` for none."""
        keys = np.asarray(keys, dtype=np.uint64)
        # the queries sorted first: the search then walks memory in order
        order = np.argsort(keys, kind="stable")
        at = np.empty(keys.size, dtype=np.int64)
        at[order] = np.searchsorted(self.keys, keys[order])
        at = np.minimum(at, self.keys.size - 1)
        return np.where(self.keys[at] == keys, self.gens[at], NONE)

    def scan(self, start: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """The first ``count`` keys >= ``start`` that hold a value, and
        their generations."""
        i = int(np.searchsorted(self.keys, np.uint64(start)))
        take = count
        while True:
            g = self.gens[i:i + take]
            held = np.nonzero(g != NONE)[0]
            if held.size >= count or i + take >= self.keys.size:
                held = held[:count]
                return self.keys[i + held], g[held]
            take *= 4
