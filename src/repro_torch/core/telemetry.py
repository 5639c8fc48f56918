"""Telemetry: latency histograms and the store's event trace.

A copy of ``repro.core.telemetry`` (host bookkeeping, numpy only): the
bucketing (``bucket_of``, ``record``, ``record_many``) and ``percentile``
are the reference's bit for bit, so a histogram filled with the same
samples has the same buckets and percentiles in both packages.

``LatencyHistogram``
    Log-bucketed counts, two buckets per octave (edges at powers of
    sqrt(2), about +-19% relative resolution) over [1 ns, ~73 min], with
    ``record``/``record_many``/``percentile`` and the fieldwise
    ``__add__``/``merge``/``diff`` algebra of ``IOStats``.

``EventTrace``
    A bounded ring buffer of timestamped lifecycle events (flush and
    compaction start/end, slowdown and stall, view rebuilds, cache eviction
    pressure, background retries and failures, corruption, recovery), with
    ``dump()``/``since(cursor)`` and a readable ``timeline()``.  End events
    carry ``t0``/``dur_ns``.

``Telemetry``
    The facade a store carries in ``LSMConfig.telemetry`` (``None`` by
    default: every instrumentation site is then one ``is None`` test).
    Latency samples go to per-thread histogram shards, registered with a
    GIL-atomic ``list.append``, so recording on the lock-free read path
    takes no lock; reads merge the shards.

What a span measures on the device.  Every time here is the host's
``time.perf_counter_ns()``, and telemetry adds no device synchronization.
A span that ends where its path already waits on the device is the
device's time too: ``get``/``multi_get``/``seek``/``scan`` return host
bytes, read back from the device inside the span.  A span whose path does
not wait at its end is host time: ``flush`` and ``compaction`` end after
the new run's one metadata read-back (``SortedRun``'s construction), with
its filter build and block checksums possibly still running on the device,
and ``put``/``put_batch``/``write_batch`` launch no device work unless
they flush.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LatencyHistogram", "EventTrace", "TraceEvent", "Telemetry",
           "TelemetrySnapshot", "TelemetryWindow", "OP_CLASSES"]

# Per-op-class latency histograms the engine records (benchmarks may add
# their own classes; the Telemetry facade accepts any string key).
OP_CLASSES = ("get", "multi_get", "put", "put_batch", "write_batch",
              "scan", "seek", "flush", "compaction", "view_rebuild",
              "wal_fsync", "stall", "rebalance", "scrub")

_SQRT2 = math.sqrt(2.0)
# Octaves 0..42 cover 1 ns .. 2^42 ns (~73 min) at 2 buckets/octave;
# anything larger clamps into the top bucket.
_MAX_OCTAVE = 42
N_BUCKETS = 2 * (_MAX_OCTAVE + 1)
# Lower edge of bucket i: even buckets start at 2^o, odd at floor(2^o*sqrt2).
# (The first odd edge collides with its octave start for o=0 — one empty
# bucket at the bottom, harmless and kept so index math stays branch-free.)
_MID = tuple(int((1 << o) * _SQRT2) for o in range(_MAX_OCTAVE + 2))
BUCKET_EDGES = np.asarray(
    [e for o in range(_MAX_OCTAVE + 1) for e in ((1 << o), _MID[o])],
    dtype=np.int64)
# Upper edge per bucket (top bucket closes one octave up).
_UPPER = np.empty(N_BUCKETS, dtype=np.int64)
_UPPER[:-1] = BUCKET_EDGES[1:]
_UPPER[-1] = 1 << (_MAX_OCTAVE + 1)


def bucket_of(ns: int) -> int:
    """Bucket index of a duration (the single definition ``record``,
    ``record_many`` and the percentile oracle tests all share)."""
    ns = int(ns)
    if ns < 1:
        ns = 1
    o = ns.bit_length() - 1
    if o > _MAX_OCTAVE:
        return N_BUCKETS - 1
    return (o << 1) + (1 if ns >= _MID[o] else 0)


class LatencyHistogram:
    """Log-bucketed latency histogram with the IOStats merge algebra."""

    __slots__ = ("counts", "n", "sum_ns", "max_ns", "min_ns")

    def __init__(self):
        self.counts = np.zeros(N_BUCKETS, dtype=np.int64)
        self.n = 0
        self.sum_ns = 0
        self.max_ns = 0
        self.min_ns = 0       # 0 while empty

    # ------------------------------------------------------------- recording
    def record(self, ns: int) -> None:
        """One sample, O(1), no locks (callers keep per-thread instances)."""
        ns = int(ns)
        if ns < 1:
            ns = 1
        o = ns.bit_length() - 1
        if o > _MAX_OCTAVE:
            i = N_BUCKETS - 1
        else:
            i = (o << 1) + (1 if ns >= _MID[o] else 0)
        self.counts[i] += 1
        self.n += 1
        self.sum_ns += ns
        if ns > self.max_ns:
            self.max_ns = ns
        if self.min_ns == 0 or ns < self.min_ns:
            self.min_ns = ns

    def record_many(self, ns_array) -> None:
        """Vectorized ``record`` (bulk ingestion from benchmark harnesses).

        Bucket-for-bucket identical to a scalar ``record`` loop: the edge
        array is the same one ``bucket_of`` indexes.
        """
        a = np.asarray(ns_array, dtype=np.int64)
        if a.size == 0:
            return
        a = np.maximum(a, 1)
        idx = np.searchsorted(BUCKET_EDGES, a, side="right") - 1
        np.clip(idx, 0, N_BUCKETS - 1, out=idx)
        self.counts += np.bincount(idx, minlength=N_BUCKETS)
        self.n += int(a.size)
        self.sum_ns += int(a.sum())
        mx = int(a.max())
        if mx > self.max_ns:
            self.max_ns = mx
        mn = int(a.min())
        if self.min_ns == 0 or mn < self.min_ns:
            self.min_ns = mn

    # ------------------------------------------------------------- queries
    def percentile(self, p: float) -> float:
        """Nearest-rank percentile, geometrically interpolated *within* the
        bucket holding the rank-th smallest sample by the rank's position
        among that bucket's samples.  The estimate always stays inside the
        bucket (tests assert bucket equality exactly; a lone sample gets
        the geometric midpoint, as before), but unlike a fixed midpoint it
        moves smoothly as the tail mass shifts — the online tuner's
        objective (§17) needs that resolution to see a gradient between
        windows whose p99 lands in the same half-octave bucket."""
        if self.n == 0:
            return float("nan")
        rank = max(1, math.ceil(self.n * float(p) / 100.0))
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank))
        lo = max(int(BUCKET_EDGES[i]), 1)
        hi = max(int(_UPPER[i]), lo)
        if hi <= lo:
            return float(lo)
        before = int(cum[i - 1]) if i else 0
        cnt = int(self.counts[i])
        frac = (rank - before - 0.5) / cnt if cnt else 0.5
        return lo * (hi / lo) ** frac

    def mean(self) -> float:
        return self.sum_ns / self.n if self.n else float("nan")

    def __len__(self) -> int:
        return self.n

    # -------------------------------------------------------------- algebra
    def __add__(self, other: "LatencyHistogram") -> "LatencyHistogram":
        if not isinstance(other, LatencyHistogram):
            return NotImplemented
        out = LatencyHistogram()
        out.counts = self.counts + other.counts
        out.n = self.n + other.n
        out.sum_ns = self.sum_ns + other.sum_ns
        out.max_ns = max(self.max_ns, other.max_ns)
        if self.min_ns and other.min_ns:
            out.min_ns = min(self.min_ns, other.min_ns)
        else:
            out.min_ns = self.min_ns or other.min_ns
        return out

    def __radd__(self, other):
        if other == 0:   # sum() support
            return self + LatencyHistogram()
        return self.__add__(other)

    @staticmethod
    def merge(hists: "Iterable[LatencyHistogram]") -> "LatencyHistogram":
        out = LatencyHistogram()
        for h in hists:
            out = out + h
        return out

    def diff(self, prev: "LatencyHistogram") -> "LatencyHistogram":
        """Windowed delta ``self - prev`` (counts/n/sum_ns are monotonic, so
        the subtraction is the interval's histogram — the sensing primitive
        behind :meth:`Telemetry.delta`, DESIGN.md §17).  ``max_ns``/``min_ns``
        are not subtractable; the window keeps the lifetime extremes, which
        only ever *widen* a percentile caller's view, never narrow it."""
        out = LatencyHistogram()
        out.counts = self.counts - prev.counts
        out.n = self.n - prev.n
        out.sum_ns = self.sum_ns - prev.sum_ns
        out.max_ns = self.max_ns
        out.min_ns = self.min_ns
        return out

    def to_dict(self) -> Dict[str, float]:
        """Summary row (stable key order) for JSON dumps / stats() surfaces."""
        return dict(count=self.n,
                    p50_ns=self.percentile(50),
                    p99_ns=self.percentile(99),
                    p999_ns=self.percentile(99.9),
                    max_ns=self.max_ns,
                    min_ns=self.min_ns,
                    mean_ns=self.mean())


class TraceEvent:
    """One timestamped engine lifecycle event (immutable)."""

    __slots__ = ("seq", "ts_ns", "kind", "fields")

    def __init__(self, seq: int, ts_ns: int, kind: str, fields: dict):
        self.seq = seq
        self.ts_ns = ts_ns
        self.kind = kind
        self.fields = fields

    def interval(self) -> Optional[Tuple[int, int]]:
        """(t0, t1) when the event carries one (end events with t0/dur_ns)."""
        t0 = self.fields.get("t0")
        dur = self.fields.get("dur_ns")
        if t0 is None or dur is None:
            return None
        return int(t0), int(t0) + int(dur)

    def __repr__(self):
        kv = " ".join(f"{k}={v}" for k, v in self.fields.items())
        return f"TraceEvent({self.seq} {self.kind} {kv})"


class EventTrace:
    """Bounded ring buffer of :class:`TraceEvent` (oldest dropped first).

    ``emit`` takes a small leaf mutex (it never acquires another lock, so it
    is deadlock-free inside the cache/scheduler mutexes that call it); it is
    only used on lifecycle paths, never on the lock-free read path.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._mu = threading.Lock()
        self._buf: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0

    def emit(self, kind: str, **fields) -> int:
        """Append one event; returns its seq (a cursor/token)."""
        ts = time.perf_counter_ns()
        with self._mu:
            self._seq += 1
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(TraceEvent(self._seq, ts, kind, fields))
            return self._seq

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def last_seq(self) -> int:
        return self._seq

    def dump(self) -> List[TraceEvent]:
        """All buffered events, oldest first."""
        with self._mu:
            return list(self._buf)

    def since(self, cursor: int) -> Tuple[List[TraceEvent], int]:
        """Events with ``seq > cursor`` plus the new cursor — the
        incremental-consumer API (``evs, cur = trace.since(cur)``)."""
        with self._mu:
            evs = [e for e in self._buf if e.seq > cursor]
            return evs, self._seq

    def timeline(self, limit: Optional[int] = None) -> str:
        """Human-readable timeline (ms relative to the oldest buffered
        event), newest-last.  ``limit`` keeps only the last N lines."""
        evs = self.dump()
        if limit is not None:
            evs = evs[-limit:]
        if not evs:
            return "(no events)"
        t_base = evs[0].ts_ns
        lines = []
        for e in evs:
            kv = " ".join(f"{k}={v}" for k, v in e.fields.items()
                          if k not in ("t0",))
            lines.append(f"{(e.ts_ns - t_base) / 1e6:12.3f} ms "
                         f"#{e.seq:<6d} {e.kind:<18s} {kv}")
        return "\n".join(lines)


class TelemetrySnapshot:
    """Point-in-time capture for windowed-delta sensing (DESIGN.md §17):
    the merged per-op histograms plus the trace cursor.  Pair two of these
    with :meth:`Telemetry.delta` to get an interval's histograms and events
    without re-merging full histories each tick."""

    __slots__ = ("hists", "cursor")

    def __init__(self, hists: Dict[str, LatencyHistogram], cursor: int):
        self.hists = hists
        self.cursor = cursor


class TelemetryWindow:
    """One sensing interval: per-op histogram *diffs* (only classes with
    samples in the window), the trace events emitted during it, and the
    end snapshot (pass as ``prev`` to chain the next window for free)."""

    __slots__ = ("hists", "events", "end")

    def __init__(self, hists: Dict[str, LatencyHistogram],
                 events: List[TraceEvent], end: TelemetrySnapshot):
        self.hists = hists
        self.events = events
        self.end = end

    @property
    def ops(self) -> int:
        """Total samples across the window's op classes."""
        return sum(h.n for h in self.hists.values())


class Telemetry:
    """Facade: per-op-class latency histograms + one event trace.

    Recording is lock-free: each thread gets its own dict of per-op
    histograms, registered in ``_shards`` with a single GIL-atomic
    ``list.append`` (no mutex on the read path, no lost increments — the
    same design as :class:`~repro_torch.core.types.StatsHub`).  Reads merge the
    shards on demand; a merged histogram is a consistent-enough snapshot
    (counters are monotonic), exactly the contract ``IOStats`` reads have.
    """

    def __init__(self, trace_capacity: int = 4096):
        self.trace = EventTrace(trace_capacity)
        self._tl = threading.local()
        self._shards: List[Dict[str, LatencyHistogram]] = []

    # ------------------------------------------------------------- recording
    def _local(self) -> Dict[str, LatencyHistogram]:
        try:
            return self._tl.h
        except AttributeError:
            h: Dict[str, LatencyHistogram] = {}
            self._tl.h = h
            self._shards.append(h)   # GIL-atomic: no lock on first record
            return h

    def record(self, op: str, ns: int) -> None:
        """Record one latency sample for an op class (lock-free)."""
        h = self._local()
        hist = h.get(op)
        if hist is None:
            hist = h[op] = LatencyHistogram()
        hist.record(ns)

    def emit(self, kind: str, **fields) -> int:
        """Append one trace event; returns its seq token."""
        return self.trace.emit(kind, **fields)

    # --------------------------------------------------------------- queries
    def histogram(self, op: str) -> LatencyHistogram:
        """Merged (all threads) histogram for one op class."""
        out = LatencyHistogram()
        for shard in list(self._shards):
            h = shard.get(op)
            if h is not None:
                out = out + h
        return out

    def histograms(self) -> Dict[str, LatencyHistogram]:
        """Merged histograms for every op class any thread recorded."""
        ops: Dict[str, LatencyHistogram] = {}
        for shard in list(self._shards):
            for op, h in list(shard.items()):
                ops[op] = (ops[op] + h) if op in ops else (
                    LatencyHistogram() + h)
        return ops

    def percentile(self, op: str, p: float) -> float:
        return self.histogram(op).percentile(p)

    # ------------------------------------------------- windowed-delta API
    def snapshot(self) -> TelemetrySnapshot:
        """Capture the merged histograms + trace cursor (allocation-light:
        one small int64 array per active op class; no locks taken — the
        merge reads the same GIL-atomic shard list ``histograms`` does)."""
        return TelemetrySnapshot(self.histograms(), self.trace.last_seq)

    def delta(self, prev: TelemetrySnapshot) -> TelemetryWindow:
        """The interval since ``prev``: histogram diffs for every op class
        that recorded samples, plus ``EventTrace.since(prev.cursor)``
        events.  The online tuner and ``serve_latency``'s tail attribution
        both sense through this instead of re-merging full histories."""
        end = self.snapshot()
        hists: Dict[str, LatencyHistogram] = {}
        for op, h in end.hists.items():
            p = prev.hists.get(op)
            d = h.diff(p) if p is not None else h
            if d.n > 0:
                hists[op] = d
        events, _ = self.trace.since(prev.cursor)
        return TelemetryWindow(hists, events, end)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{op: histogram row} over every recorded op class (stable order:
        engine classes first, extras alphabetically)."""
        hs = self.histograms()
        keys = [k for k in OP_CLASSES if k in hs] + \
            sorted(k for k in hs if k not in OP_CLASSES)
        return {k: hs[k].to_dict() for k in keys}

    def report(self, trace_limit: int = 40) -> str:
        """Human-readable report: percentile table + trace timeline tail."""
        rows = ["op                 count      p50_us      p99_us     "
                "p999_us      max_us"]
        for op, d in self.summary().items():
            rows.append(f"{op:<16s}{d['count']:>8d} {d['p50_ns']/1e3:>11.1f} "
                        f"{d['p99_ns']/1e3:>11.1f} {d['p999_ns']/1e3:>11.1f} "
                        f"{d['max_ns']/1e3:>11.1f}")
        return ("\n".join(rows) + "\n\n-- trace (last "
                f"{trace_limit} events) --\n" + self.trace.timeline(
                    limit=trace_limit))
