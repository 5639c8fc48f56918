"""One run of one cell: build the store from the seed, load it, warm up,
measure for the window, check every answer against the reference, read
the metrics.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``portbench/configs/<config>.json``) under a traffic mix
(``portbench/traffic/<mix>.json``).  Its metrics are the entries of
``end_to_end`` (untraced runs) or ``per_layer`` (traced runs) that list it
under ``workloads`` or list no cells; each is read by
``portbench/metrics/<name>.py``, or by ``<stem>.py`` for a name
``<stem>.<suffix>``, from the run's :class:`RunRecord`.  Adding a cell, a
configuration, a mix or a metric adds files and entries and edits none.

What is timed.  The window is a closed loop: one client sends the
stream's next request when the last one has returned, until ``seconds``
have passed, then waits for the device.  Rates are taken over the whole
window, drawing the stream's keys and values included; latencies from
each request's call to its return.  The cyclic garbage collector is off
inside the window (as ``timeit`` has it), so that it does not walk the
answers the harness keeps for the check.

What is checked.  Once the window has closed and the peak memory has been
read, every key any write op wrote is read back through the store; then
the store is freed and :class:`~portbench.reference.kv.KVReference` replays
the stream (the warm-up, the window and the read-back) and judges every
answer: each key's value or its absence, each scan's keys and values.
``control=True`` runs the same with every read served from a snapshot
taken before the load's last sixteenth: the program's own stale-read
path, which breaks the configurations' guarantee that a read sees every
write acknowledged before it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import generator as gen
from . import trace as tr
from .reference.kv import KVReference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
LOAD_BATCH = 262_144
CONTROL_STALE = 16      # the control's snapshot misses the load's last 1/16
READBACK_BATCH = 65_536
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WRITES = ("update", "insert")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    metrics: Dict[str, List[dict]]     # "end_to_end" / "per_layer"


def find_cell(workload: str, root: Path = ROOT,
              bench_dir: Path = HERE) -> Cell:
    """The cell named ``workload``, with its configuration, mix and
    metrics, found by name from ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    metrics = {kind: [m for m in bench[kind]
                      if workload in m.get("workloads", [workload])]
               for kind in ("end_to_end", "per_layer")}
    return Cell(workload, config, mix, metrics)


def metric_reader(name: str, bench_dir: Path = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``, else of ``metrics/<stem>.py``."""
    for stem in dict.fromkeys((name, name.split(".")[0])):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"portbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{bench_dir / 'metrics'}")


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read.  Host-clock counts and times of the
    window; with ``--trace 1`` also the program's counters and spans over
    the window and the profiler's reading."""

    setup_s: float
    window_s: float
    requests: Dict[str, int]            # by op kind
    units: Dict[str, int]               # keys read, entries written, scans
    latency_ms: Dict[str, np.ndarray]   # by op kind, call to return
    stats: Dict[str, int]               # the store's IOStats, window delta
    span_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    launch_sizes: Dict[str, list] = dataclasses.field(default_factory=dict)
    trace: Optional[tr.TraceReading] = None


def _payload(op: gen.Op, records: gen.Records):
    """The values a write op sends (made before its clock starts)."""
    if op.kind not in WRITES:
        return None
    rows = gen.value_rows(op.keys, op.gens, records)
    return rows.tobytes() if op.keys.size == 1 else gen.as_values(rows)


def _issue(store, op: gen.Op, payload, snapshot):
    """Send one request; its answer (None for a write)."""
    if op.kind == "read":
        if op.keys.size == 1:
            return [store.get(int(op.keys[0]), snapshot)]
        return store.multi_get(op.keys, snapshot)
    if op.kind == "scan":
        return store.scan(op.start, op.length, snapshot)
    if op.keys.size == 1:
        store.put(int(op.keys[0]), payload)
    else:
        store.put_batch(op.keys, payload)
    return None


def check_get(answer, keys: np.ndarray, want: np.ndarray,
              records: gen.Records):
    """(wrong, missing) of a point-read answer against the generations
    ``want`` (negative: no value): a boolean mask of the keys answered
    wrong, and the number of keys given no answer."""
    n = keys.size
    answer = list(answer) if answer is not None else []
    m = min(len(answer), n)
    got = np.empty(m, dtype=object)
    got[:] = answer[:m]
    got_none = np.equal(got, None)
    wrong = np.zeros(n, dtype=bool)
    wrong[:m] = got_none != (want[:m] < 0)
    both = np.nonzero(~got_none & (want[:m] >= 0))[0]
    if both.size:
        vals = got[both]
        exp = gen.value_rows(keys[both], want[both], records)
        w = records.value_bytes
        try:
            whole = (np.fromiter(map(len, vals), dtype=np.int64,
                                 count=both.size) == w).all()
            flat = b"".join(vals) if whole else None
        except TypeError:       # an answer that is not bytes
            flat = None
        if flat is not None:
            bad = (np.frombuffer(flat, dtype=np.uint8).reshape(-1, w)
                   != exp).any(axis=1)
        else:
            bad = np.asarray([bytes(e) != v for e, v in zip(exp, vals)])
        wrong[both] |= bad
    return wrong, n - m


def check_scan(answer, want_keys: np.ndarray, want_gens: np.ndarray,
               records: gen.Records) -> bool:
    """True if a scan's answer is not the next live keys with their
    newest values."""
    rows = gen.value_rows(want_keys, want_gens, records)
    return answer != list(zip(want_keys.tolist(), gen.as_values(rows)))


def judge(log: List[tuple], records: gen.Records, window: range) -> dict:
    """Replay the stream on the reference and judge every answer.  ``log``
    holds (op, answer) in the order sent; ``window`` the log positions of
    the window's requests.  Returns the compared numbers and the window's
    failed requests (a wrong answer, or a write whose key reads back
    wrong)."""
    written = [op.keys for op, _ in log if op.kind in WRITES]
    ref = KVReference(records.keys,
                      np.concatenate(written) if written else None)
    wrong = missing = checked = 0
    failed = set()
    bad_gens = set()
    for i, (op, answer) in enumerate(log):
        if op.kind in WRITES:
            ref.write(op.keys, op.gens)
            continue
        if op.kind == "scan":
            bad = check_scan(answer, *ref.scan(op.start, op.length), records)
            checked += 1
            wrong += int(bad)
            if bad and i in window:
                failed.add(i)
            continue
        want = ref.get(op.keys)
        mask, miss = check_get(answer, op.keys, want, records)
        checked += op.keys.size
        wrong += int(mask.sum())
        missing += miss
        if (mask.any() or miss) and i in window:
            failed.add(i)
        bad_gens.update(want[mask].tolist())
    bad = np.asarray(sorted(bad_gens), dtype=np.int64)
    for i in window:
        op = log[i][0]
        if op.kind in WRITES and bad.size:
            at = np.searchsorted(bad, op.gen)
            if at < bad.size and bad[at] < op.gen + op.keys.size:
                failed.add(i)
    return dict(wrong_answers=wrong, missing_answers=missing,
                checked_answers=checked, failed=len(failed))


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda:0", chips: int = 1, t_start: float = None,
        root: Path = ROOT, bench_dir: Path = HERE,
        config_override: Optional[dict] = None,
        control: bool = False,
        on_window: Optional[Callable[[], None]] = None) -> dict:
    """One run of ``workload``; the result line as a dict, ``compared``
    last.  ``config_override`` replaces top-level keys and ``records`` /
    ``store`` fields of the configuration (tests run tiny stores);
    ``on_window`` is called as set-up ends (tests break the timed path
    there)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from repro_torch.core import LSMConfig, LSMStore, Telemetry
    from repro_torch.kernels import ops as kops
    dev = torch.device(device)
    cell = find_cell(workload, root, bench_dir)
    cfg = json.loads(json.dumps(cell.config))
    for key, val in (config_override or {}).items():
        if isinstance(val, dict):
            cfg[key].update(val)
        else:
            cfg[key] = val
    mix = cell.mix
    records = gen.load_records(seed, cfg["records"])
    telemetry = Telemetry(trace_capacity=1 << 16) if trace else None
    store = LSMStore(LSMConfig(**cfg["store"], telemetry=telemetry),
                        device=dev)
    split = {"before_load_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    n = records.writes.size
    cut = n - n // CONTROL_STALE if control else n
    snapshot = None
    for lo, hi in ((0, cut), (cut, n)):
        if control and lo:
            store.flush()
            snapshot = store.get_snapshot()
        for i in range(lo, hi, LOAD_BATCH):
            k = records.writes[i:min(i + LOAD_BATCH, hi)]
            store.put_batch(k, gen.as_values(gen.value_rows(k, 0, records)))
    _sync(torch, dev)
    split["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    stream = gen.OpStream(seed, mix, records)
    log: List[tuple] = []
    for _ in range(int(mix.get("warmup_ops", 0))):
        op = next(stream)
        log.append((op, _issue(store, op, _payload(op, records), snapshot)))
    _sync(torch, dev)
    split["warmup_s"] = time.perf_counter() - t
    if on_window is not None:
        on_window()

    # ---------------------------------------------------------- the window
    lat: Dict[str, list] = {}
    stats0 = store.stats
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        tel0 = telemetry.snapshot()
        kops.reset_launch_counts()
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        window_span = record_function(tr.WINDOW_SPAN)
    first = len(log)
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        t_win = time.perf_counter()
        host_start_ns = time.perf_counter_ns()
        if trace:
            window_span.__enter__()
        deadline = t_win + seconds
        while time.perf_counter() < deadline:
            op = next(stream)
            payload = _payload(op, records)
            if trace:
                with record_function(tr.OP_SPAN + op.kind):
                    a = time.perf_counter_ns()
                    answer = _issue(store, op, payload, snapshot)
                    b = time.perf_counter_ns()
            else:
                a = time.perf_counter_ns()
                answer = _issue(store, op, payload, snapshot)
                b = time.perf_counter_ns()
            log.append((op, answer))
            lat.setdefault(op.kind, []).append((b - a) / 1e6)
        _sync(torch, dev)
        if trace:
            window_span.__exit__(None, None, None)
        window_s = time.perf_counter() - t_win
    finally:
        gc.enable()
        gc.unfreeze()
    if trace:
        prof.__exit__(None, None, None)
    window = range(first, len(log))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    stats = dataclasses.asdict(store.stats.delta(stats0))
    requests: Dict[str, int] = {}
    units: Dict[str, int] = {}
    for i in window:
        op = log[i][0]
        requests[op.kind] = requests.get(op.kind, 0) + 1
        units[op.kind] = units.get(op.kind, 0) + (
            1 if op.kind == "scan" else int(op.keys.size))
    record = RunRecord(
        setup_s=t_win - t_start, window_s=window_s, requests=requests,
        units=units, stats=stats,
        latency_ms={k: np.asarray(v) for k, v in lat.items()})
    if trace:
        win = telemetry.delta(tel0)
        record.span_s = {k: h.sum_ns / 1e9 for k, h in win.hists.items()}
        record.launch_sizes = kops.launch_sizes()
        spans = []
        for e in win.events:
            iv = e.interval()
            if iv is not None and e.kind.endswith("_end"):
                spans.append((e.kind[:-4], *iv))
        record.trace = tr.read_profile(prof.profiler.kineto_results.events(),
                                       host_start_ns, spans)
        prof = None

    # ------------------------------------------- the check, after the window
    written = [log[i][0].keys for i in range(len(log))
               if log[i][0].kind in WRITES]
    if written:
        keys = np.unique(np.concatenate(written))
        for i in range(0, keys.size, READBACK_BATCH):
            op = gen.Op("read", keys[i:i + READBACK_BATCH])
            log.append((op, store.multi_get(op.keys, snapshot)))
    levels = [[lvl["level"], lvl["runs"], lvl["entries"]]
              for lvl in store.level_summary()]
    if snapshot is not None:
        store.release_snapshot(snapshot)
    del store, snapshot
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    verdict = judge(log, records, window)
    split["check_s"] = time.perf_counter() - t

    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in cell.metrics[kind]:
        value = metric_reader(m["name"], bench_dir)(record)
        if value is None:
            if kind == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing in {workload}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = record.trace.busy_s
        device_info["window_s"] = record.trace.window_s
    out = {"correct": (verdict["wrong_answers"] == 0
                       and verdict["missing_answers"] == 0
                       and verdict["checked_answers"] > 0),
           "attempted": len(window), "failed": verdict["failed"],
           "metrics": metrics, "device": device_info}
    bd = tr.breakdown(record.trace)
    if bd is not None:
        out["breakdown"] = bd
    out["setup_split"] = split
    out["levels"] = levels
    out["checked_answers"] = verdict["checked_answers"]
    out["compared"] = {
        "wrong_answers": {"value": verdict["wrong_answers"], "limit": 0},
        "missing_answers": {"value": verdict["missing_answers"], "limit": 0}}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
