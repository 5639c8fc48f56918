"""The traced run's reading of the profiler: device busy time, device
time by kernel, and the device's idle gaps named by what the host was
doing.

The window runs under ``torch.profiler`` (CPU and CUDA activity).  The
harness marks the window and each request it sends with a
``record_function`` span (``portbench.window``, ``portbench.<kind>``); the
program's telemetry spans (``flush``, ``compaction``; host clock, from its
event trace) are placed on the profiler's clock by the offset between the
window span's start and the host clock read as it opened.  A gap in which
no device activity ran is named by the innermost span that covers its
middle: a program span, else the harness request, else ``client`` (the
harness between requests).

``short_kernel_name`` is copied from ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW_SPAN = "portbench.window"
OP_SPAN = "portbench."


def short_kernel_name(name: str) -> str:
    """``bloom_bucket_kernel`` from a profiler's demangled kernel name such
    as ``void (anonymous namespace)::bloom_bucket_kernel<unsigned short>(
    long const*, ...)``; copies and fills keep their own names."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1] or name


@dataclasses.dataclass
class TraceReading:
    window_s: float
    busy_s: float
    device_events: int
    kernel_s: Dict[str, float]          # device seconds by short name
    kernel_n: Dict[str, int]            # device events by short name
    idle_by_host: Dict[str, float]      # idle seconds by host activity


def union_length(iv: np.ndarray) -> float:
    """Total length covered by (start, end) intervals."""
    if not len(iv):
        return 0.0
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    # a block of overlapping intervals starts past every earlier end
    first = np.ones(len(iv), dtype=bool)
    first[1:] = iv[1:, 0] > reach[:-1]
    at = np.nonzero(first)[0]
    return float((np.maximum.reduceat(iv[:, 1], at) - iv[at, 0]).sum())


def gaps(iv: np.ndarray, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    if len(iv):
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        for s, e in iv.tolist():
            if s > at:
                out.append((at, min(s, hi)))
            at = max(at, e)
            if at >= hi:
                break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def read_profile(events, host_start_ns: int,
                 program_spans: List[Tuple[str, int, int]]) -> TraceReading:
    """Reduce the profiler's kineto events of one window.

    ``host_start_ns``: the host clock (``perf_counter_ns``) as the window
    span opened; ``program_spans``: (name, start, end) on that clock."""
    from torch.autograd import DeviceType
    win = None
    op_spans = []
    dev = []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if e.name().startswith(OP_SPAN):
                continue            # the harness's spans, mirrored on the card
            dev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name() == WINDOW_SPAN:
            win = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif e.name().startswith(OP_SPAN):
            op_spans.append((e.name()[len(OP_SPAN):], e.start_ns(),
                             e.start_ns() + e.duration_ns()))
    if win is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = win
    offset = lo - host_start_ns
    program = [(n, s + offset, e + offset) for n, s, e in program_spans]
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    iv = []
    for name, s, e in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        iv.append((s, e))
        key = short_kernel_name(name)
        kernel_s[key] = kernel_s.get(key, 0.0) + (e - s) / 1e9
        kernel_n[key] = kernel_n.get(key, 0) + 1
    arr = np.asarray(iv, dtype=np.float64).reshape(-1, 2)
    busy = union_length(arr)
    idle_gaps = np.asarray(gaps(arr, lo, hi), dtype=np.float64).reshape(-1, 2)
    names = np.full(len(idle_gaps), "client", dtype=object)
    mids = idle_gaps.mean(axis=1)
    # the program's spans lie inside the requests: name by them first
    for level in (op_spans, program):
        if not level:
            continue
        level = sorted(level, key=lambda t: t[1])
        starts = np.asarray([s for _, s, _ in level], dtype=np.float64)
        ends = np.asarray([e for _, _, e in level], dtype=np.float64)
        at = np.searchsorted(starts, mids, side="right") - 1
        inside = (at >= 0) & (mids <= ends[np.maximum(at, 0)])
        for i in np.nonzero(inside)[0].tolist():
            names[i] = level[int(at[i])][0]
    idle: Dict[str, float] = {}
    for name, (a, b) in zip(names.tolist(), idle_gaps.tolist()):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    return TraceReading(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                        device_events=len(iv), kernel_s=kernel_s,
                        kernel_n=kernel_n, idle_by_host=idle)


def breakdown(reading: Optional[TraceReading]) -> Optional[dict]:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten host activities under which the device idled
    longest, each with its seconds."""
    if reading is None or not reading.kernel_s:
        return None
    top = sorted(reading.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(reading.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}
