"""The benchmark's one traffic generator.

A run's inputs come from the seed, the configuration's ``records`` section
(how many records, their key scheme and value width) and the traffic mix's
parameters (``portbench/traffic/<mix>.json``), and from nothing else.  The
same three give the same load and the same op stream,
op for op.  Values are made from the key and its write generation, so a
value names the key it belongs to and the write that stored it, and a
stale or misplaced answer cannot pass for the right one.

A configuration's ``records`` hold ``count``, the key scheme ``keys`` and
``value_bytes``.  ``fillrandom`` is db_bench's load: ``count`` writes of keys
drawn uniformly, with replacement, from the key space [0, ``count``), a
key being its number (about 63% of the space is written);  ``hashed`` is
YCSB's load phase: the record numbers 0 .. ``count`` - 1, each
scrambled by ``fnv64`` (``insertorder=hashed``).

A mix's JSON holds:

``warmup_ops``
    The stream's first ops, run before the measured window (set-up).  They
    are checked like the window's.
``ops``
    A list of op kinds, each with its ``share`` of the stream:

    * ``read``: ``batch`` keys in one ``multi_get`` (one ``get`` for a
      batch of 1), drawn from the ``keys`` sources below;
    * ``update``: ``batch`` keys rewritten with a new value in one
      ``put_batch`` (one ``put`` for a batch of 1), drawn so too;
    * ``insert``: ``batch`` new keys, each with its first value;
    * ``scan``: one ``scan`` from a ``start`` key drawn as a key source is,
      of a length uniform in ``length`` = [lo, hi].

    A key source is ``{"from": "loaded" | "space", "share": s,
    "distribution": "uniform" | "zipfian", "theta": 0.99}``: the distinct
    loaded keys, or (``fillrandom`` only, uniform) the whole key space,
    written or not, as db_bench's ``readrandom`` and ``overwrite`` draw.
    A batch takes ``round(share * batch)`` keys of each source (the last
    source the rest), in a random order.  ``zipfian`` is YCSB's request
    distribution over the records in load order, scrambled.

Copied from ``chip_smoke.py`` (``zipf_items``, ``salted_values``) so that
the yardstick does not move when the program does; the copies are
reorganised around the mix file.  The load and the key-space draws are
db_bench's own (``benchmarks/db_bench.cc``: ``DoWrite`` and ``ReadRandom``
take ``rand.Uniform(FLAGS_num)``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)
CHUNK = 4096            # single ops drawn at a time
KINDS = ("read", "update", "insert", "scan")


def fnv64(x) -> np.ndarray:
    """YCSB's ``fnvhash64`` of each u64 (FNV-1a over its 8 little-endian
    octets), without YCSB's final ``abs``: the scrambling of YCSB's hashed
    insert order."""
    x = np.asarray(x, dtype=np.uint64)
    h = np.full(x.shape, FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for i in range(8):
            h ^= (x >> np.uint64(8 * i)) & np.uint64(0xFF)
            h *= FNV_PRIME
    return h


class Zipfian:
    """YCSB's zipfian request distribution (constant ``theta``) over
    ``n`` items, scrambled by a seeded permutation so that the hot items
    lie anywhere in the key space (``chip_smoke.py`` ``zipf_items``, with
    the table built once)."""

    def __init__(self, rng: np.random.Generator, n: int, theta: float):
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
        self.cdf = np.cumsum(w)
        self.perm = rng.permutation(n)

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        ranks = np.minimum(
            np.searchsorted(self.cdf, rng.random(size) * self.cdf[-1]),
            self.cdf.size - 1)
        return self.perm[ranks]


@dataclasses.dataclass
class Records:
    """The load: its writes in order, the distinct keys they leave, and
    the key space the draws use."""

    writes: np.ndarray      # uint64, load order; fillrandom repeats keys
    keys: np.ndarray        # uint64, distinct, in order of first write
    space: int              # fillrandom: keys lie in [0, space); else 0
    value_bytes: int
    pattern: np.ndarray     # (value_bytes,) uint8 filler of every value
    scheme: str


def load_records(seed: int, records: dict) -> Records:
    """The load of a run (the schemes above)."""
    n, scheme = int(records["count"]), records["keys"]
    if scheme == "fillrandom":
        writes = np.random.default_rng([seed, 5]).integers(
            0, n, n, dtype=np.uint64)
        keys = writes[np.sort(np.unique(writes, return_index=True)[1])]
        space = n
    elif scheme == "hashed":
        writes = keys = fnv64(np.arange(n, dtype=np.uint64))
        if np.unique(keys).size != n:
            raise ValueError("fnv64 collided on the record numbers")
        space = 0
    else:
        raise ValueError(f"unknown key scheme {scheme!r}")
    width = int(records["value_bytes"])
    pattern = np.random.default_rng([seed, 13]).integers(
        0, 256, width, dtype=np.uint8)
    pattern[-1] |= 1        # a value never ends in a zero byte (as_values)
    return Records(writes, keys, space, width, pattern, scheme)


def value_rows(keys: np.ndarray, gens, records: Records) -> np.ndarray:
    """(n, value_bytes) uint8: each value is the run's filler with its key
    (8 little-endian bytes) in front and its write generation (4
    little-endian bytes) after it."""
    keys = np.asarray(keys, dtype=np.uint64)
    mat = np.empty((keys.size, records.value_bytes), dtype=np.uint8)
    mat[:] = records.pattern
    mat[:, :8] = keys.astype("<u8").view(np.uint8).reshape(-1, 8)
    g = np.broadcast_to(np.asarray(gens, dtype="<u4"), keys.shape)
    mat[:, 8:12] = np.ascontiguousarray(g).view(np.uint8).reshape(-1, 4)
    return mat


def as_values(rows: np.ndarray) -> List[bytes]:
    """The rows of :func:`value_rows` as one ``bytes`` each.  NumPy's
    fixed-width bytes view makes them in one C loop, and drops trailing
    zero bytes, so it takes only rows that end in the filler, whose last
    byte is never zero."""
    w = rows.shape[1]
    if w > 12:
        return np.ascontiguousarray(rows).view(f"S{w}").ravel().tolist()
    flat = rows.tobytes()
    return [flat[i:i + w] for i in range(0, len(flat), w)]


@dataclasses.dataclass
class Op:
    """One request of the stream.  An update or insert writes its ``j``-th
    key at write generation ``gen + j``: generations count the entries the
    stream has written, from 1 (the load is generation 0), so every write
    stores a value no other write stores."""

    kind: str
    keys: np.ndarray
    start: int = 0
    length: int = 0
    gen: int = 0

    @property
    def gens(self) -> np.ndarray:
        return np.arange(self.gen, self.gen + self.keys.size, dtype=np.int64)


class OpStream:
    """The op stream of a mix, endless and the same for the same seed.

    Single ops (batch 1, scans) are drawn ``CHUNK`` at a time, a batched
    op's keys when it is due, so that drawing costs little beside what the
    op itself costs."""

    def __init__(self, seed: int, mix: dict, records: Records):
        self.records = records
        self.rng = np.random.default_rng([seed, 11])
        self.kinds = [dict(o) for o in mix["ops"]]
        for o in self.kinds:
            if o["kind"] not in KINDS:
                raise ValueError(f"unknown op kind {o['kind']!r}")
            o["batch"] = int(o.get("batch", 1))
        shares = np.asarray([float(o["share"]) for o in self.kinds])
        if shares.min() < 0 or not np.isclose(shares.sum(), 1.0):
            raise ValueError("op shares must be non-negative and sum to 1")
        self.cum = np.cumsum(shares)
        self.zipf = {}
        self.n_inserted = 0
        self.n_written = 1
        self._queue: List[tuple] = []

    def _zipf(self, theta: float) -> Zipfian:
        z = self.zipf.get(theta)
        if z is None:
            z = self.zipf[theta] = Zipfian(
                np.random.default_rng([int(self.rng.integers(2**62)), 17]),
                self.records.keys.size, theta)
        return z

    def draw(self, source: dict, n: int) -> np.ndarray:
        """``n`` keys of one key source."""
        frm = source["from"]
        dist = source.get("distribution", "uniform")
        if frm == "space":
            if not self.records.space or dist != "uniform":
                raise ValueError("the key space is drawn uniformly, and "
                                 "only under the fillrandom scheme")
            return self.rng.integers(0, self.records.space, n,
                                     dtype=np.uint64)
        if frm != "loaded":
            raise ValueError(f"unknown key source {frm!r}")
        pop = self.records.keys
        if dist == "uniform":
            return pop[self.rng.integers(0, pop.size, n)]
        if dist == "zipfian":
            return pop[self._zipf(float(source.get("theta", 0.99)))
                       .sample(self.rng, n)]
        raise ValueError(f"unknown distribution {dist!r}")

    def _new_keys(self, n: int) -> np.ndarray:
        """Keys the load never wrote: the next record numbers, hashed
        (``hashed``) or past the key space (``fillrandom``)."""
        r = self.records
        first = max(r.space, r.keys.size) + self.n_inserted
        out = np.arange(first, first + n, dtype=np.uint64)
        self.n_inserted += n
        return fnv64(out) if r.scheme == "hashed" else out

    def _batch_keys(self, kind: dict) -> np.ndarray:
        b = kind["batch"]
        if kind["kind"] == "insert":
            return self._new_keys(b)
        parts, left = [], b
        srcs = kind["keys"]
        for i, s in enumerate(srcs):
            n = left if i == len(srcs) - 1 else int(round(s["share"] * b))
            parts.append(self.draw(s, n))
            left -= n
        return self.rng.permutation(np.concatenate(parts))

    def _refill(self) -> None:
        which = np.searchsorted(self.cum, self.rng.random(CHUNK) * self.cum[-1],
                                side="right")
        which = np.minimum(which, len(self.kinds) - 1)
        zeros = [0] * CHUNK
        starts, lengths = [], []
        for o in self.kinds:
            if o["kind"] == "scan":
                lo, hi = o["length"]
                starts.append(self.draw(o["start"], CHUNK).tolist())
                lengths.append(self.rng.integers(lo, hi + 1, CHUNK).tolist())
            else:
                starts.append(zeros)
                lengths.append(zeros)
        self._queue = [(w, starts[w][j], lengths[w][j])
                       for j, w in enumerate(which.tolist())][::-1]

    def __iter__(self) -> Iterator[Op]:
        return self

    def __next__(self) -> Op:
        if not self._queue:
            self._refill()
        w, start, length = self._queue.pop()
        kind = self.kinds[w]
        if kind["kind"] == "scan":
            return Op("scan", self.records.keys[:0], start=int(start),
                      length=int(length))
        keys = self._batch_keys(kind)
        if kind["kind"] == "read":
            return Op("read", keys)
        op = Op(kind["kind"], keys, gen=self.n_written)
        self.n_written += keys.size
        return op
