"""The program's phases as the benchmark reads them: every phase share
of ``BENCHMARK.json`` names phases of the program, each cell's shares on
the tiny CPU store with every phase interval handed to the trace
reduction, and on a card a phase around a kernel placed on the profiler's
clock."""
import json
import time

import pytest
import torch

from conftest import (BENCH, CELLS, check_phase_shares, check_share_entry,
                      phase_shares)
from portbench import trace

SHARES = phase_shares(BENCH)


@pytest.mark.parametrize("name", sorted(SHARES))
def test_share_reads_named_phases_of_the_program(name):
    check_share_entry(name)


@pytest.mark.parametrize("cell", CELLS)
def test_phase_shares_read_on_the_cpu_store(cell, monkeypatch):
    """Each share of the cell reads a value in [0, 100], the distinct
    phases its shares name take at most the window, and every phase
    interval of the window reaches the trace reduction's program spans."""
    check_phase_shares(cell, monkeypatch)


@pytest.mark.cuda
def test_phase_holds_its_kernels_on_the_profiler_clock(cuda_card):
    """A phase around kernels that end in a sync, placed on the profiler's
    clock by ``read_profile`` as the harness places it.  Inside the phase
    the device idles 2 ms before the kernels and 2 ms after them, and a
    small kernel with a sync marks each edge of the phase from outside:
    both idle gaps are named by the phase only if its placement is off by
    less than about 1 ms, so the phase holds the kernels' device interval
    within 1 ms.  Prints the placement's lead and lag at the kernels and
    the delay of the window's first mark against a later one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import Telemetry
    tel = Telemetry()
    x = torch.randn(4096, 4096, device=cuda_card)
    small = torch.ones(1024, device=cuda_card)
    (x @ x).sum().item()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        window = record_function(trace.WINDOW_SPAN)
        host_start_ns = time.perf_counter_ns()
        window.__enter__()
        time.sleep(0.002)
        small.sum().item()                  # the device marks the edge
        snap = tel.snapshot()
        ph, _ = tel.enter("multi_get", "run_probe")
        time.sleep(0.002)
        for _ in range(8):
            y = x @ x
        torch.cuda.synchronize()
        time.sleep(0.002)
        ph.exit()
        small.sum().item()
        time.sleep(0.002)
        mark = record_function(trace.OP_SPAN + "mark")
        mark_ns = time.perf_counter_ns()
        mark.__enter__()
        mark.__exit__(None, None, None)
        window.__exit__(None, None, None)
    del y
    spans = [(e.kind[:-4], *e.interval()) for e in tel.delta(snap).events
             if e.kind[:-4] == "multi_get.run_probe"]
    assert len(spans) == 1
    events = prof.profiler.kineto_results.events()
    r = trace.read_profile(events, host_start_ns, spans)
    # the shift, for the record: the phase's edges on the profiler's clock
    # against its kernels' first start and last end
    cpu = {e.name(): e.start_ns() for e in events
           if e.device_type() != DeviceType.CUDA}
    offset = cpu[trace.WINDOW_SPAN] - host_start_ns
    _, t0, t1 = spans[0]
    mm = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
          if e.device_type() == DeviceType.CUDA
          and not e.name().startswith(trace.OP_SPAN)
          and e.duration_ns() > 100_000]         # the matrix products
    k0, k1 = min(s for s, _ in mm), max(e for _, e in mm)
    print(json.dumps({
        "phase_lead_us": (k0 - (t0 + offset)) / 1e3,
        "phase_lag_us": ((t1 + offset) - k1) / 1e3,
        "first_mark_delay_us":
            (offset - (cpu[trace.OP_SPAN + "mark"] - mark_ns)) / 1e3,
        "idle_by_host_ms": {k: v * 1e3 for k, v in r.idle_by_host.items()}}))
    assert r.idle_by_host.get("multi_get.run_probe", 0.0) > 3.5e-3
    assert r.idle_by_host.get("client", 0.0) > 1.5e-3
