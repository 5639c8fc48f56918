#!/usr/bin/env python3
"""Drive the repro_torch store's and serving path's main paths on one
NVIDIA GPU and check them.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--entries N] [--seed S] [--phases P,...]
                          [--src DIR]

``--phases`` runs a subset of
kernels,attention,equivalence,db_bench,subsystems,durability,sharded,serve,
families,train,mesh,dryrun,examples (all by default; a subset ends in a {"partial": true} line instead of the kernels
and ok lines); ``--src`` imports repro_torch from another checkout's src/ (for
example a parent commit's, to time two versions in one call).

Phases, one JSON line each; any failure raises and the exit code is not 0:
  1. device   — the card's name and power limit;
  2. build    — nvcc builds every kernel of src/repro_torch/csrc; the
                compiler's register and spill lines per kernel, and the
                tensor-core (HMMA/HGMMA) instructions that cuobjdump finds
                in each bf16 flash kernel (none fails the phase);
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the shapes the main paths give it (integer kernels
                exactly equal, attention within 2e-5 in float32 and 2e-2 in
                bfloat16), timed beside its bound (and a library call where
                one computes the same function; attention, its plain
                version and SDPA as CUDA-graph replays, the device's time,
                with the eager per-call time beside it); paged attention
                also over a rotation of page pools larger than L2
                (``ms_cold_l2``); bf16 flash and paged also at a 4,096-token
                context; both attention kernels give the same bits twice,
                and a paged row alone the bits it gets inside a batch;
                the bloom build also at a flush's size and at an upper
                level's, the merge also at an L0 run into a level and at
                two flushes, each with the bytes its own design moves and
                its device time by kernel; the bloom probe at the shapes a
                read wave gives it (PROBE_SHAPES), warm and L2-cold, beside
                builds of it that gather one position or all k at a time;
                both attention kernels also at the model families' shapes
                (``kernel_family`` lines: dh 256 at G 4 and 10, windowed
                with a live band at 1,024 tokens over a window of 512,
                non-causal over 1,600 image tokens and 1,500 audio frames
                in prefill and at one decode query);
  4. equivalence — one seeded op sequence on a CUDA store and a CPU store,
                with a snapshot taken mid-load: bit-identical trees,
                IOStats, multi_get answers, and scans, seeks and iterator
                streams on the current state and under the snapshot; the
                snapshot's release leaves no pin and frees device memory;
                then the same on two stores with async compaction, a block
                cache and a pinned L0 (``equivalence_async``), compared
                after ``wait_for_quiesce``, cache hits and misses included;
                then (``equivalence_subsystems``) two stores with range
                views, paranoid reads, a Telemetry and a same-seed
                FaultInjector failing every 499th block read: equal view
                columns, answers (the same calls refused), IOStats, fired
                counts and event kinds, and the same CorruptionError from a
                block corrupted by a same-seed injector on each;
  5. db_bench — fillrandom then readrandom at LevelDB's documented
                defaults (10M entries, 16-byte keys, 100-byte values, 4 MiB
                write buffer, 10 bits per key), every answer checked; the
                load's last chunk under the profiler (device time by
                kernel), and the size distribution of every bloom-build,
                merge and probe launch; then, on the same store, seekrandom
                (2,000 seeks) and YCSB workload E's scans (2,000 of 1..100
                entries), every answer checked (the ``range`` line);
  5b. subsystems — on phase 5's store (loaded here when phase 5 is not
                asked for): the range view's full and incremental build
                (s, device bytes, merge launches), phase 5's seeks and
                scans through it (every answer equal to phase 5's, no
                fallback); a Telemetry over eight of phase 5's waves (the
                store's multi_get p50/p99 within one bucket of the host
                clock; keys/s on and off in turns); the same waves with
                paranoid reads (keys/s, at most one verify pass per run a
                wave); faults (a block_read failure injected and cleared; a
                corrupted block of the deepest run caught and named by a
                paranoid read and by scrub); then YCSB workload A (2^20
                operations, zipfian, over 1M keys) on an async store with
                the online tuner beside an untuned twin: every read checked
                and equal, knobs in bounds, every actuation at a boundary;
  6. durability — the db_bench load again on LevelDB's background
                compaction thread, 8 MiB LRU block cache and a 16 MiB pinned
                L0 (L0 at its trigger): the tree equals phase 5's, the same
                read waves through the cache, every answer checked; then
                500,000 more writes with rotations queued, a flush, 10,000
                unsynced writes, crash() and recover(): every fsynced write
                reads back, the unsynced tail is lost, recovery's drain,
                WAL replay and scrub timed; the store kernels must launch
                from the worker thread, and no job may be retried, given up
                or leave the store degraded;
  6b. sharded — the sharded facade: (a) phase 5's load on four shards
                under one budget of four workers (the reference's
                micro_dbbench sharded lane), timed until quiesced beside
                phase 6's one-shard load, builds and merges from at least
                two workers, then phase 5's waves, seeks and scans (and
                scans across every splitter), every answer checked and
                held against phase 5's; (b) YCSB's hotspot (90% of 2^20
                operations on the first tenth of 1M dense keys, half reads)
                on four shards armed after a bulk load, beside a one-store
                oracle: every read equal, at least one rebalance (device
                bytes before, at the peak and after each), a snapshot from
                before it unchanged, no pin leaked, then a crash and
                recovery keeping every write and the routing epoch; (c)
                smollm_135m's parameters through the delta-checkpoint
                store on one shard and on two, each the first 2 of 30
                layers (a depth cut for the call's time): the unchanged
                leaves' chunks skipped at step 1, crash, recovery and
                bit-exact restores;
     kernel launches on phases 5, 5b, 6 and 6b, each store kernel's must
     be > 0;
  7. serve    — qwen3_4b at full width (random weights from the seed) over
                AutumnKV: three waves of four 512-token requests (cold,
                warm, mixed), hits, dedup and tokens checked, every kernel
                launched on the path, AutumnKV's store on the reference's
                knobs (two shards, async, cache, pin) drained and not
                degraded, each shard's worker busy ms per wave; then the
                smoke config served on the card and on the CPU at float32,
                tokens equal;
  8. families — gemma3_1b at full size through phase 7's waves and checks,
                then two 1,024-token prompts sharing a page with them (hit
                equal to miss: the windowed rings kept whole in the state
                record); a cold and a warm wave of recurrentgemma_2b,
                mamba2_130m (no attention kernel launched),
                granite_moe_1b_a400m, minicpm_2b over AutumnKV,
                whisper_medium with stubbed frames and no prefix cache,
                mixtral_8x22b at 2 of 56 layers and llama32_vision_90b at
                4 + 1 of 100 (``reduced``; neither fits one card whole),
                warm equal to cold, no plain call; every family's smoke
                config on the card and the CPU at float32, tokens equal;
  9. train    — (a) smollm_135m at full width (fp32 parameters, bf16
                compute, remat, global batch 8 x 2,048 tokens of
                SyntheticTokens, AdamW with WSD): 3 warm-up and 10 timed
                steps (step ms p50/p99, tokens/s), the loss at steps 0 and
                13 (it must fall), two steps under the profiler (idle
                share, top device operations), peak memory; (b) every
                family's smoke config on the card and the CPU at float32:
                every gradient leaf within 1e-4 of max(1, |leaf|), then
                one train step (AdamW at lr 1e-4) with loss, grad norm
                and every parameter within 1e-4; (c) the reference test's
                trainer (smollm SMOKE, a checkpoint every 5 steps through a
                CheckpointStore on the card): train(20) equal by bits to
                train(12) + crash + restore at 10 + train(10..20), the
                store kernels launched (counted by thread), save and
                restore seconds.  Steps run
                under torch.use_deterministic_algorithms with
                CUBLAS_WORKSPACE_CONFIG=:4096:8, set at the start;
  10. mesh    — the same paths on a (1, 1) device mesh of the card
                (launch.sharding's Sharder; ROADMAP A16a): (a) one warm wave
                of phase 7's qwen3_4b (its weights and AutumnKV store, the
                store drained) through ServeEngine(shard=...) and then
                without the mesh, back to back: equal tokens, K3 and K4
                launched and no plain call; then both engines' decode
                steps in turns: p50 on the mesh at most 1.10x; (b) smollm_135m at full width, phase 9's batch,
                Trainer(mesh=(1, 1)) and phase 9's meshless trainer from
                the same start, three steps each in turns: losses and
                every parameter and AdamW leaf equal by bits, step p50 at
                most 1.10x; (c) phase 9 c's crash and bit-exact resume on
                the mesh; then (d) K3's partials entry on each half of
                phase 3's decode pages, merged as two ranks merge them,
                against one K3 call over all of them (the same bits twice);
  11. dryrun  — the dry-run (launch.dryrun; ROADMAP A16b) held against the
                card: a child process that sees no card traces phase 9's
                smollm_135m step and phase 7's qwen3_4b prefill and decode
                steps on a fake (1, 1) mesh, and qwen3_4b's decode_32k on
                the fake 16 x 16 mesh, while this process runs the three
                steps on the card on arguments from the port's init
                functions (each leaf the cell's shape and dtype), three
                times after reset_peak_memory_stats: K3/K4 launches and
                their work a step equal to the dry-run's, its predicted
                peak within 0.98-1.02x of max_memory_allocated, the
                roofline's max term beside the step's ms;
  12. examples — the four twins of examples/*.py (examples/torch/; ROADMAP
                A17) on the card in this process, their prints on stderr,
                each gated by its reference's outcome (answers, hits 0/4/6,
                the resumed step), every kernel launched, no plain call.
The last line is {"ok": true, "device": {...}}.  Without a CUDA card the
script exits non-zero before any phase runs.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import zlib
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, NVIDIA data sheet
# The data sheet gives no integer ALU peak; the fp32 CUDA-core peak (67 TFLOP/s)
# is the highest non-tensor rate, so ops over it stay a lower bound.
ALU_OPS_PER_S = 67e12
# Dense tensor-core peak for bf16 inputs (989 TFLOP/s, H100 SXM, NVIDIA
# data sheet, without sparsity); float32 attention is held to the fp32
# CUDA-core peak above, the rate for float32 arithmetic outside TF32.
BF16_FLOPS_PER_S = 989e12
HASH_OPS = 30                  # hash_pair: two mix32 chains, xors, or
PROBE_OPS = 6                  # one bit test: mul, add, mod, shift, and, test
ROOT = Path(__file__).resolve().parent

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "bloom_probe": ("src/repro_torch/csrc/bloom.cu",
                    "src/repro/kernels/bloom_probe.py:60"),
    "bloom_build": ("src/repro_torch/csrc/bloom.cu",
                    "src/repro/kernels/bloom_probe.py:36"),
    "merge_pair": ("src/repro_torch/csrc/merge.cu",
                   "src/repro/kernels/merge_path.py:77"),
    "paged_attention": ("src/repro_torch/csrc/attention.cu",
                        "src/repro/kernels/paged_attention.py:65"),
    "flash_attention": ("src/repro_torch/csrc/attention.cu",
                        "src/repro/kernels/flash_attention.py:66"),
}
DESIGN = {    # name -> what the kernel's design is, for the kernels line
    "bloom_probe": "one thread per key; its positions gathered two at a "
                   "time, stopping after the first pair with a clear bit; "
                   "fastmod for % m; grid from the SM count",
    "bloom_build": "shared-memory bitsets, no global atomic per key bit: "
                   "bucket positions by 2^12-2^16-bit slice (shared "
                   "histogram and counting sort, 16-bit offsets, one "
                   "segment range reserved per block and slice), then set "
                   "each slice in one block's shared memory and write its "
                   "words once; fastmod for % m",
    "merge_pair": "merge-path tiles of 2,048 outputs: tile ends searched "
                  "once (by the tile's block, 32-way, below 2,048 tiles; "
                  "by a split kernel above), tile staged in shared memory, "
                  "8 items a thread merged serially, 16-byte coalesced "
                  "stores",
    "paged_attention": "split pages over (splits, KH, B) blocks, cp.async "
                       "2-stage tiles, fp32 CUDA cores + ordered combine",
    "flash_attention": "bf16: mma.sync m16n8k16, ldmatrix, cp.async 2-stage "
                       "swizzled tiles; f32: fp32 FMAs on the CUDA cores",
}
STORE_KERNELS = ("bloom_probe", "bloom_build", "merge_pair")
# phase 4's entries, cut from 200,000 for the script's 1,000 s (the CPU
# store's plain versions take most of the phase); its lines say so
EQUIV_ENTRIES, EQUIV_FULL = 100_000, 200_000
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's kernel tests


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``at_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, nops: float, ops_per_s: float = ALU_OPS_PER_S
          ) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its operations over the
    peak rate for their type (by default the ALU rate)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / ops_per_s * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def kernel_label(mangled: str) -> str:
    """``flash_attention_bf16_kernel<128>`` from a mangled kernel name: the
    length-prefixed identifier that ends in ``_kernel``, and its template
    argument."""
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            n = int(mangled[i:run.end()])
            name = mangled[run.end():run.end() + n]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*",
                                                         name):
                arg = re.match(r"I(?:Li(\d+)E|(f)|13__nv_(bfloat16))E",
                               mangled[run.end() + n:])
                if arg is None:
                    return name
                a = next(x for x in arg.groups() if x)
                return f"{name}<{'float' if a == 'f' else a}>"
    return mangled


def ptxas_lines(log: str) -> dict:
    """The compiler's register and spill lines, by kernel."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", ln)
        if m:
            name = kernel_label(m.group(1))
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def tensor_core_instructions(_build) -> dict:
    """HMMA/HGMMA instructions in each function of the attention library,
    read from its SASS (``cuobjdump`` ships beside ``nvcc``)."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build.BUILD / "libattention.so")],
        capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_label(m.group(1))
            counts.setdefault(name, 0)
        elif name and re.search(r"\bHG?MMA\b", ln):
            counts[name] += 1
    return counts


def time_ms(torch, fn, reps: int = 20, graph: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call.  With ``graph`` the ``reps`` calls are captured
    in one CUDA graph and timed as one replay: the device's time alone,
    where eager calls of a kernel shorter than Python's dispatch would time
    the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, got, want) -> int:
    """Largest absolute difference of two integer tensors (0 = equal);
    the kernels are exact, so the tolerance is 0."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if torch.equal(got, want):
        return 0
    return float((got.double() - want.double()).abs().max())


def user_values(keys: np.ndarray, width: int = 100) -> list:
    """The value stored under each u64 key: its 8 little-endian bytes,
    repeated to ``width`` bytes (so an answer names its key)."""
    mat = np.tile(keys.astype("<u8").view(np.uint8).reshape(-1, 8),
                  -(-width // 8))[:, :width]
    flat = mat.tobytes()
    return [flat[i:i + width] for i in range(0, len(flat), width)]


# ------------------------------------------------------------ phase 3
def build_design_bytes(bloom, n: int, m_words: int, k: int, dev) -> int:
    """Bytes the bloom build's own design moves: the keys read twice, every
    position written and read back as an in-slice offset, the words and
    the slice counters written (the first design: the keys and one atomic
    OR of 4 bytes a key bit)."""
    if not hasattr(bloom, "build_plan"):
        return n * 8 + n * k * 4
    plan = bloom.build_plan(n, m_words, k, *bloom.card_limits(dev))
    return (2 * n * 8 + 2 * n * k * plan.offset_bytes + m_words * 4
            + plan.n_slices * 16)


def kernel_split_ms(torch, fn, kernel: str, reps: int = 3) -> dict:
    """Device ms per call of each of ``kernel``'s device functions, from
    the profiler over ``reps`` calls of ``fn``."""
    prof = profile_window(torch, lambda: [fn() for _ in range(reps)],
                          by_kernel=True)
    return {name: ms / reps
            for name, ms in prof.get("device_ms_by_kernel", {}).items()
            if name in STORE_KERNEL_FUNCTIONS[kernel]}


def bloom_build_row(torch, bloom, keys, bpk: float, label: str) -> dict:
    """bloom_build against build_plain on ``keys`` at ``bpk`` bits a key
    (the store's geometry); the kernel timed as a CUDA-graph replay."""
    n_keys = keys.numel()
    m_words = -(-max(64, int(round(bpk * n_keys))) // 32)
    k = max(1, int(round(bpk * math.log(2))))
    got = bloom.build_cuda(keys, m_words, k)
    want = bloom.build_plain(keys, m_words, k)
    torch.cuda.synchronize()
    reps = 10 if n_keys >= 1_000_000 else 50
    return dict(
        shape=f"{label}: {n_keys} keys, {m_words} words, k={k}",
        max_abs_err=max_abs_err(torch, got, want),
        ms=time_ms(torch, lambda: bloom.build_cuda(keys, m_words, k), reps,
                   graph=True),
        eager_ms=time_ms(torch, lambda: bloom.build_cuda(keys, m_words, k),
                         reps),
        plain_ms=time_ms(torch, lambda: bloom.build_plain(keys, m_words, k),
                         3),
        library_ms=None,
        design_bytes=build_design_bytes(bloom, n_keys, m_words, k,
                                        keys.device),
        kernel_split_ms=kernel_split_ms(
            torch, lambda: bloom.build_cuda(keys, m_words, k), "bloom_build"),
        **bound(n_keys * 8 + m_words * 4,
                n_keys * (HASH_OPS + k * PROBE_OPS)))


# The probe's shapes on the read path: (label, keys a launch probes,
# keys of the run's filter, share of the probed keys that the run holds),
# from phase 5's record of one read wave (``probe_record``: keys, words and
# the keys the filter passed, less its false positives): L0 is empty when
# the waves run, so a wave probes L1, L2, L3 and L4 in turn.
PROBE_SHAPES = (
    ("first run of a wave (L1)", 49_077, 144_632, 0.010),
    ("middle level (L3)", 44_753, 1_735_584, 0.125),
    ("deepest level (L4)", 39_150, 6_942_336, 0.58),
)


def probe_work(torch, bloom, q, bits, k):
    """(distinct filter words, bit tests) that the probe needs: each key's
    positions up to its first clear bit."""
    h1, h2 = bloom.hash_pair(q)
    pos = torch.stack([((h1 + i * h2) & 0xFFFFFFFF) % (bits.numel() * 32)
                       for i in range(k)], 1)
    bit = ((bits[pos >> 5].to(torch.int64) & 0xFFFFFFFF) >> (pos & 31)) & 1
    needed = torch.cat([torch.ones_like(bit[:, :1]),
                        torch.cumprod(bit, 1)[:, :-1]], 1).bool()
    return int(torch.unique(pos[needed] >> 5).numel()), int(needed.sum())


def cold_l2_ms(torch, fn, q, bits) -> tuple:
    """Device ms of ``fn(q, bits)`` with L2 cold: copies of the inputs in
    turn, together three times the 50 MB L2, as CUDA-graph replays; and
    the number of copies."""
    copies = math.ceil(150e6 / (q.numel() * 8 + bits.numel() * 4))
    pairs = [(q.clone(), bits.clone()) for _ in range(copies)]
    turn = itertools.cycle(pairs)
    ms = time_ms(torch, lambda: fn(*next(turn)), max(2 * copies, 20),
                 graph=True)
    return ms, copies


# Builds of csrc/bloom.cu that differ from the shipped probe only in the
# positions a key gathers together (the shipped kernel takes two): one at a
# time, stopping at the first clear bit, and all k at once.
PROBE_VARIANTS = {"early_exit": 1, "all_k": 8}


def start_variant_builds(_build) -> dict:
    """nvcc of every :data:`PROBE_VARIANTS` build of csrc/bloom.cu, started
    beside the main build; none for a source without the variants (an
    older checkout)."""
    src = _build.CSRC / "bloom.cu"
    if "BLOOM_PROBE_BATCH" not in src.read_text():
        return {}
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    started = {}
    for name, batch in PROBE_VARIANTS.items():
        out = _build.BUILD / f"libbloom_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               f"-DBLOOM_PROBE_BATCH={batch}", "-o", str(out), str(src)]
        started[name] = out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return started


def load_variants(_build, started: dict):
    """The variant libraries and their compiler lines, once built."""
    libs, logs = {}, {}
    argtypes, restype = _build.SIGNATURES["bloom"]["bloom_probe_launch"]
    for name, (out, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} probe:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.bloom_probe_launch.argtypes = argtypes
        lib.bloom_probe_launch.restype = restype
        libs[name] = lib
        logs[name] = ptxas_lines(log).get("bloom_probe_kernel")
    return libs, logs


def variant_probe(torch, bloom, lib, keys, bits, k):
    """A variant build's probe, launched as ``bloom.probe_cuda`` launches
    the kernel (outside the launch counts)."""
    out = torch.empty(keys.numel(), dtype=torch.bool, device=keys.device)
    rc = lib.bloom_probe_launch(
        keys.data_ptr(), keys.numel(), bits.data_ptr(), bits.numel(), k,
        out.data_ptr(), bloom.card_limits(keys.device)[1],
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"variant bloom_probe: CUDA error {rc}")
    return out


def probe_row(torch, bloom, q, bits, k, shape: str, variants=None) -> dict:
    """bloom_probe against probe_plain on ``q``; warm and L2-cold graph
    replays, eager calls, and each variant build's times on the same
    inputs."""
    got = bloom.probe_cuda(q, bits, k)
    want = bloom.probe_plain(q, bits, k)
    err = max_abs_err(torch, got, want)
    words, tests = probe_work(torch, bloom, q, bits, k)
    n_q = q.numel()
    cold, copies = cold_l2_ms(torch, lambda a, b: bloom.probe_cuda(a, b, k),
                              q, bits)
    row = dict(
        shape=shape, max_abs_err=err, maybe=int(want.sum()),
        ms=time_ms(torch, lambda: bloom.probe_cuda(q, bits, k), 50,
                   graph=True),
        eager_ms=time_ms(torch, lambda: bloom.probe_cuda(q, bits, k), 50),
        ms_cold_l2=cold, cold_copies=copies, filter_mb=bits.numel() * 4 / 1e6,
        plain_ms=time_ms(torch, lambda: bloom.probe_plain(q, bits, k), 5),
        library_ms=None,
        **bound(n_q * 9 + words * 4, n_q * HASH_OPS + tests * PROBE_OPS))
    for name, lib in (variants or {}).items():
        def call(a, b, lib=lib):
            return variant_probe(torch, bloom, lib, a, b, k)
        got = call(q, bits)
        row[f"{name}_max_abs_err"] = max_abs_err(torch, got, want)
        row[f"{name}_ms"] = time_ms(torch, lambda: call(q, bits), 50,
                                    graph=True)
        row[f"{name}_ms_cold_l2"] = cold_l2_ms(torch, call, q, bits)[0]
        err = max(err, row[f"{name}_max_abs_err"])
    if err:
        raise AssertionError(f"bloom_probe differs from its plain version "
                             f"at {shape}")
    return row


def kernel_phase(torch, ops, bloom, merge, rng, dev, variants=None) -> dict:
    """The store's kernels against their plain versions at the main path's
    shapes; returns the headline row per kernel."""
    rows = {}
    # bloom build: the deepest run's filter (10M keys at 10 bits a key), a
    # flush's (a 4 MiB buffer of 116-byte entries: 36,158 keys) and an
    # upper level's (185,959 keys: the first filter of more words than one
    # block's shared memory holds)
    n_keys, bpk = 10_000_000, 10
    keys = ops.keys_to_device(rng.integers(0, 2**64 - 1, n_keys,
                                           dtype=np.uint64), dev)
    for n, label in ((n_keys, "deepest run"), (36_158, "flush"),
                     (185_959, "upper level")):
        row = bloom_build_row(torch, bloom, keys[:n], bpk, label)
        emit({"phase": "kernel", "kernel": "bloom_build", **row})
        rows.setdefault("bloom_build", row)
        if row["max_abs_err"]:
            raise AssertionError(f"bloom_build differs from its plain "
                                 f"version at {row['shape']}")
    # bloom probe: the first design's row (one 65,536-key wave, half
    # members, against the 10M-key filter), then the read path's shapes
    m_words = -(-n_keys * bpk // 32)
    k = round(bpk * np.log(2))
    bits = bloom.build_cuda(keys, m_words, k)
    n_q = 65_536
    q = torch.cat([keys[torch.randperm(n_keys, device=dev)[:n_q // 2]],
                   ops.keys_to_device(rng.integers(0, 2**64 - 1, n_q // 2,
                                                   dtype=np.uint64), dev)])
    rows["bloom_probe"] = probe_row(torch, bloom, q, bits, k,
                                    f"{n_q} keys, {m_words} words, k={k}",
                                    variants)
    emit({"phase": "kernel", "kernel": "bloom_probe", **rows["bloom_probe"]})
    del bits, q
    for label, n_q, n_filter, share in PROBE_SHAPES:
        fkeys = keys[:n_filter]
        m_words = -(-n_filter * bpk // 32)
        bits = bloom.build_cuda(fkeys, m_words, k)
        n_in = round(n_q * share)
        q = torch.cat([fkeys[torch.randperm(n_filter, device=dev)[:n_in]],
                       ops.keys_to_device(rng.integers(
                           0, 2**64 - 1, n_q - n_in, dtype=np.uint64), dev)])
        q = q[torch.randperm(n_q, device=dev)]
        row = probe_row(torch, bloom, q, bits, k,
                        f"{label}: {n_q} keys ({n_in} members), "
                        f"{m_words} words, k={k}", variants)
        emit({"phase": "kernel", "kernel": "bloom_probe", **row})
        del bits, q
    del keys
    # merge: balanced with shared keys, skewed, the u64 maximum, an L0 run
    # into a level, and two flush-sized runs
    def draw(n):
        return rng.integers(0, 2**64 - 1, n, dtype=np.uint64)

    top = np.array([2**64 - 1], dtype=np.uint64)
    cases = []
    shared = draw(1_000_000)
    cases.append(("5M+5M shared",
                  np.unique(np.concatenate([shared, draw(4_000_000), top])),
                  np.unique(np.concatenate([shared, draw(4_000_000), top]))))
    cases.append(("40k+10M skewed", np.unique(draw(40_000)),
                  np.unique(draw(10_000_000))))
    cases.append(("u64 max", np.array([0, 5, 2**63, 2**64 - 1], np.uint64),
                  np.array([2**32 - 1, 5, 2**63 - 1, 2**64 - 1], np.uint64)))
    cases.append(("144k+2M L0 into a level", np.unique(draw(144_000)),
                  np.unique(draw(2_000_000))))
    cases.append(("36k+36k flushes", np.unique(draw(36_000)),
                  np.unique(draw(36_000))))
    for name, a, b in cases:
        ta, tb = ops.keys_to_device(np.sort(a), dev), \
            ops.keys_to_device(np.sort(b), dev)
        gk, gs = merge.merge_pair_cuda(ta, tb)
        wk, ws = merge.merge_pair_plain(ta, tb)
        err = max(max_abs_err(torch, gk, wk), max_abs_err(torch, gs, ws))
        na, nb = ta.numel(), tb.numel()
        n = na + nb
        tiles = -(-n // 2048)
        row = dict(shape=name, na=na, nb=nb, max_abs_err=err,
                   ms=time_ms(torch, lambda: merge.merge_pair_cuda(ta, tb),
                              graph=True),
                   eager_ms=time_ms(torch,
                                    lambda: merge.merge_pair_cuda(ta, tb)),
                   plain_ms=time_ms(torch,
                                    lambda: merge.merge_pair_plain(ta, tb), 5),
                   # each tile end's search: rounds of 32 key pairs (a
                   # binary search of pairs from the split pass)
                   design_bytes=n * 24 + tiles * 2 * 16 * (
                       math.ceil(math.log2(min(na, nb) + 1)) + 1
                       if tiles >= getattr(merge, "SPLIT_TILES", 0) else
                       32 * (math.ceil(math.log(min(na, nb) + 1, 33)) + 1)),
                   **bound(n * 8 + n * 16, n * 4 + 5 * (
                       na * math.ceil(math.log2(nb + 1))
                       + nb * math.ceil(math.log2(na + 1)))),
                   library_ms=time_ms(torch, lambda: torch.sort(
                       torch.cat([ta, tb]), stable=True), graph=True),
                   kernel_split_ms=kernel_split_ms(
                       torch, lambda: merge.merge_pair_cuda(ta, tb),
                       "merge_pair"))
        emit({"phase": "kernel", "kernel": "merge_pair", **row})
        rows.setdefault("merge_pair", row)
        if err:
            raise AssertionError(f"merge_pair differs from its plain version "
                                 f"on {name}: max abs error {err}")
    for name, row in rows.items():
        if row["max_abs_err"]:
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"max abs error {row['max_abs_err']}")
    return rows


def sdpa_ms(torch, q, k, v, **kw) -> float:
    """Device time of one ``scaled_dot_product_attention`` call on (B, H,
    S, dh) inputs (CUDA-graph replay); KV heads are expanded outside the
    timed call."""
    import torch.nn.functional as F
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, **kw), graph=True)


def same_bits(torch, what: str, a, b) -> None:
    """Raise unless two outputs hold the same bits."""
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: outputs differ, max abs "
                             f"{float((a.float() - b.float()).abs().max())}")


def attention_rows(torch, attention, dev, seed: int) -> dict:
    """Flash and paged attention against their plain versions at the serve
    phase's shapes, in bfloat16 (the headline rows) and float32; the
    determinism checks of both kernels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, S, H, KH, dh = 4, 512, 32, 8, 128
    page, P = 64, 16
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        peak = BF16_FLOPS_PER_S if dt == torch.bfloat16 else ALU_OPS_PER_S
        esize = torch.finfo(dt).bits // 8
        tol = ATTN_TOL[name]
        # flash: causal prefill of 4 x 512 tokens
        q = torch.randn(B, S, H, dh, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, KH, dh, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, KH, dh, generator=g, device=dev).to(dt)
        got = attention.flash_cuda(q, k, v, causal=True)
        want = attention.flash_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        same_bits(torch, f"flash_attention {name} run twice", got,
                  attention.flash_cuda(q, k, v, causal=True))
        row = dict(
            shape=f"B{B} S{S} H{H} KH{KH} dh{dh} causal {name}",
            max_abs_err=err, tolerance=tol, deterministic=True,
            ms=time_ms(torch, lambda: attention.flash_cuda(q, k, v),
                       graph=True),
            eager_ms=time_ms(torch, lambda: attention.flash_cuda(q, k, v)),
            plain_ms=time_ms(torch, lambda: attention.flash_plain(q, k, v),
                             5, graph=True),
            library_ms=sdpa_ms(torch, q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), is_causal=True),
            **bound(*attention.flash_work(q.shape, k.shape, dt)[::-1],
                    peak))
        emit({"phase": "kernel", "kernel": "flash_attention", **row})
        if dt == torch.bfloat16:
            rows["flash_attention"] = row
        if not err <= tol:
            raise AssertionError(f"flash_attention {name} differs from its "
                                 f"plain version: {err} > {tol}")
        del q, k, v, got, want
        if dt == torch.bfloat16:
            # a 4,096-token causal prefill of one row
            q, k, v = (torch.randn(1, 4096, n, dh, generator=g,
                                   device=dev).to(dt) for n in (H, KH, KH))
            err = float((attention.flash_cuda(q, k, v).float()
                         - attention.flash_plain(q, k, v).float()).abs().max())
            emit({"phase": "kernel_check", "kernel": "flash_attention",
                  "shape": f"B1 S4096 H{H} KH{KH} dh{dh} causal {name}",
                  "max_abs_err": err, "tolerance": tol,
                  "ms": time_ms(torch, lambda: attention.flash_cuda(q, k, v),
                                10, graph=True),
                  "library_ms": sdpa_ms(torch, q.transpose(1, 2),
                                        k.transpose(1, 2), v.transpose(1, 2),
                                        is_causal=True)})
            if not err <= tol:
                raise AssertionError(f"flash_attention {name} at S 4096 "
                                     f"differs from its plain version: {err}")
            del q, k, v
        # paged: one decode token per row over 16 pages of 64, lengths
        # 513..528, pages scattered through the pool
        q1 = torch.randn(B, H, dh, generator=g, device=dev).to(dt)
        kp = torch.randn(B * P, page, KH, dh, generator=g, device=dev).to(dt)
        vp = torch.randn(B * P, page, KH, dh, generator=g, device=dev).to(dt)
        bt = torch.randperm(B * P, generator=g, device=dev).to(
            torch.int32).view(B, P)
        lens = torch.randint(513, 529, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        got = attention.paged_cuda(q1, kp, vp, bt, lens)
        want = attention.paged_plain(q1, kp, vp, bt, lens)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        same_bits(torch, f"paged_attention {name} run twice", got,
                  attention.paged_cuda(q1, kp, vp, bt, lens))
        # row 0 alone against row 0 among rows of other lengths
        mixed = torch.tensor([int(lens[0]), 1, 0, P * page],
                             dtype=torch.int32, device=dev)
        same_bits(torch, f"paged_attention {name} row 0 alone vs in a batch",
                  attention.paged_cuda(q1[:1], kp, vp, bt[:1], mixed[:1])[0],
                  attention.paged_cuda(q1, kp, vp, bt, mixed)[0])
        paged_ops, live_bytes = attention.paged_work(
            q1.shape, kp.shape, bt.shape, dt, int(lens.sum()))
        # HBM-cold time: distinct page pools in turn, their live pages
        # together 3x the 50 MB L2, as the 36 layers' caches are in decode
        n_pools = math.ceil(150e6 / live_bytes)
        pools = [(torch.randn(kp.shape, generator=g, device=dev).to(dt),
                  torch.randn(vp.shape, generator=g, device=dev).to(dt))
                 for _ in range(n_pools)]
        turn = itertools.cycle(pools)
        ms_cold = time_ms(torch, lambda: attention.paged_cuda(
            q1, *next(turn), bt, lens), 4 * n_pools, graph=True)
        pool_mb = n_pools * 2 * kp.numel() * esize / 1e6
        del pools
        # SDPA on the gathered K/V, lengths as a boolean mask
        kg = kp[bt.long()].reshape(B, P * page, KH, dh).transpose(1, 2)
        vg = vp[bt.long()].reshape(B, P * page, KH, dh).transpose(1, 2)
        mask = (torch.arange(P * page, device=dev)[None]
                < lens[:, None])[:, None, None]
        splits, pps = attention.paged_splits(KH, P, page, n_sm)
        row = dict(
            shape=f"B{B} H{H} KH{KH} dh{dh} page{page} P{P} "
                  f"lengths {lens.tolist()} {name}",
            splits=splits, pages_per_split=pps, blocks=splits * KH * B,
            live_blocks=KH * sum(math.ceil(math.ceil(n / page) / pps)
                                 for n in lens.tolist()),
            max_abs_err=err, tolerance=tol, deterministic=True,
            batch_independent=True,
            ms=time_ms(torch, lambda: attention.paged_cuda(q1, kp, vp, bt,
                                                           lens), 50,
                       graph=True),
            eager_ms=time_ms(torch, lambda: attention.paged_cuda(
                q1, kp, vp, bt, lens), 50),
            ms_cold_l2=ms_cold, cold_pools=n_pools, cold_pool_mb=pool_mb,
            plain_ms=time_ms(torch, lambda: attention.paged_plain(
                q1, kp, vp, bt, lens), 10, graph=True),
            library_ms=sdpa_ms(torch, q1[:, :, None], kg, vg,
                               attn_mask=mask),
            **bound(live_bytes, paged_ops, peak))
        emit({"phase": "kernel", "kernel": "paged_attention", **row})
        if dt == torch.bfloat16:
            rows["paged_attention"] = row
        if not err <= tol:
            raise AssertionError(f"paged_attention {name} differs from its "
                                 f"plain version: {err} > {tol}")
        del kg, vg
        # a 4,096-token context: splits of several tiles each
        P_long = 64
        kp = torch.randn(B * P_long, page, KH, dh, generator=g,
                         device=dev).to(dt)
        vp = torch.randn(kp.shape, generator=g, device=dev).to(dt)
        bt = torch.randperm(B * P_long, generator=g, device=dev).to(
            torch.int32).view(B, P_long)
        lens = torch.tensor([4096, 4000, 2049, 65], dtype=torch.int32,
                            device=dev)
        got = attention.paged_cuda(q1, kp, vp, bt, lens)
        err = float((got.float() - attention.paged_plain(
            q1, kp, vp, bt, lens).float()).abs().max())
        splits, pps = attention.paged_splits(KH, P_long, page, n_sm)
        emit({"phase": "kernel_check", "kernel": "paged_attention",
              "shape": f"B{B} H{H} KH{KH} dh{dh} page{page} P{P_long} "
                       f"lengths {lens.tolist()} {name}",
              "splits": splits, "pages_per_split": pps, "max_abs_err": err,
              "tolerance": tol})
        if not err <= tol:
            raise AssertionError(f"paged_attention {name} at P {P_long} "
                                 f"differs from its plain version: {err}")
        del kp, vp
    return rows


# the model families' attention shapes (phase 8's configurations, batch 4,
# 512-token prompts, s_max 1024, and its long-prompt case): (label, B, Sq,
# Sk, H, KH, dh, causal, window, dtypes)
FAMILY_FLASH = (
    ("gemma3_1b prefill", 4, 512, 512, 4, 1, 256, True, 512,
     ("bfloat16", "float32")),
    ("gemma3_1b long-prompt prefill", 1, 1024, 1024, 4, 1, 256, True, 512,
     ("bfloat16",)),
    ("recurrentgemma_2b prefill", 4, 512, 512, 10, 1, 256, True, 2048,
     ("bfloat16",)),
    ("llama32_vision_90b cross-attention", 4, 512, 1600, 64, 8, 128, False,
     0, ("bfloat16",)),
    ("llama32_vision_90b cross-attention decode", 4, 1, 1600, 64, 8, 128,
     False, 0, ("bfloat16",)),
    ("whisper_medium encoder", 4, 1500, 1500, 16, 16, 64, False, 0,
     ("bfloat16",)),
    ("whisper_medium cross-attention decode", 4, 1, 1500, 16, 16, 64, False,
     0, ("bfloat16",)),
)
# (label, B, H, KH, dh, page, pages a row, lengths, dtypes): gemma3's
# 512-slot local ring (full, one row just past a wrap) and recurrentgemma's
# ring of min(2048, s_max 1024) slots after a 528-token step
FAMILY_PAGED = (
    ("gemma3_1b local decode", 4, 4, 1, 256, 64, 8, [512, 512, 512, 200],
     ("bfloat16", "float32")),
    ("recurrentgemma_2b local decode", 4, 10, 1, 256, 64, 16,
     [528, 528, 528, 528], ("bfloat16",)),
)


def sdpa_mask_args(torch, Sq: int, Sk: int, causal: bool, window: int,
                   dev) -> dict:
    """SDPA's mask arguments for ``flash_plain``'s mask: ``is_causal`` where
    the window lets every causal key through, else an explicit boolean band
    (keys in ``(q - window, q]``, or ``> q - window`` when non-causal)."""
    if window <= 0 or (causal and window >= Sq):
        return dict(is_causal=causal)
    qpos = torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None, :]
    ok = kpos > qpos - window
    if causal:
        ok &= kpos <= qpos
    return dict(attn_mask=ok)


def family_attention_rows(torch, attention, dev, seed: int) -> list:
    """K4 and K3 at the shapes the model families give them (dh 256,
    windowed, non-causal, Sq != Sk), each against its plain version (2e-5
    f32, 2e-2 bf16) with the same bits twice, timed as graph replays
    beside SDPA and its bound."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rows = []
    for label, B, Sq, Sk, H, KH, dh, causal, window, dts in FAMILY_FLASH:
        for name in dts:
            dt = getattr(torch, name)
            q = torch.randn(B, Sq, H, dh, generator=g, device=dev).to(dt)
            k = torch.randn(B, Sk, KH, dh, generator=g, device=dev).to(dt)
            v = torch.randn(B, Sk, KH, dh, generator=g, device=dev).to(dt)
            kw = dict(causal=causal, window=window)
            got = attention.flash_cuda(q, k, v, **kw)
            err = float((got.float() - attention.flash_plain(
                q, k, v, **kw).float()).abs().max())
            same_bits(torch, f"flash_attention {label} {name} run twice",
                      got, attention.flash_cuda(q, k, v, **kw))
            peak = BF16_FLOPS_PER_S if name == "bfloat16" else ALU_OPS_PER_S
            row = dict(
                kernel="flash_attention",
                shape=f"{label}: B{B} Sq{Sq} Sk{Sk} H{H} KH{KH} dh{dh} "
                      f"{'causal' if causal else 'non-causal'}"
                      f"{f' window {window}' if window else ''} {name}",
                max_abs_err=err, tolerance=ATTN_TOL[name],
                deterministic=True,
                ms=time_ms(torch, lambda: attention.flash_cuda(q, k, v, **kw),
                           graph=True),
                plain_ms=time_ms(torch, lambda: attention.flash_plain(
                    q, k, v, **kw), 3, graph=True),
                library_ms=sdpa_ms(torch, q.transpose(1, 2),
                                   k.transpose(1, 2), v.transpose(1, 2),
                                   **sdpa_mask_args(torch, Sq, Sk, causal,
                                                    window, dev)),
                **bound(*attention.flash_work(q.shape, k.shape, dt, causal,
                                              window)[::-1], peak))
            emit({"phase": "kernel_family", **row})
            rows.append(row)
            if not err <= ATTN_TOL[name]:
                raise AssertionError(f"flash_attention {label} {name} "
                                     f"differs from its plain version: {err}")
            del q, k, v, got
    for label, B, H, KH, dh, page, P, lens, dts in FAMILY_PAGED:
        for name in dts:
            dt = getattr(torch, name)
            q = torch.randn(B, H, dh, generator=g, device=dev).to(dt)
            kp = torch.randn(B * P, page, KH, dh, generator=g,
                             device=dev).to(dt)
            vp = torch.randn(kp.shape, generator=g, device=dev).to(dt)
            bt = torch.arange(B * P, dtype=torch.int32,
                              device=dev).view(B, P)    # the model's view
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = attention.paged_cuda(q, kp, vp, bt, ln)
            err = float((got.float() - attention.paged_plain(
                q, kp, vp, bt, ln).float()).abs().max())
            same_bits(torch, f"paged_attention {label} {name} run twice",
                      got, attention.paged_cuda(q, kp, vp, bt, ln))
            kg = kp.reshape(B, P * page, KH, dh).transpose(1, 2)
            vg = vp.reshape(B, P * page, KH, dh).transpose(1, 2)
            mask = (torch.arange(P * page, device=dev)[None]
                    < ln[:, None])[:, None, None]
            peak = BF16_FLOPS_PER_S if name == "bfloat16" else ALU_OPS_PER_S
            row = dict(
                kernel="paged_attention",
                shape=f"{label}: B{B} H{H} KH{KH} dh{dh} page{page} P{P} "
                      f"lengths {lens} {name}",
                max_abs_err=err, tolerance=ATTN_TOL[name],
                deterministic=True,
                ms=time_ms(torch, lambda: attention.paged_cuda(
                    q, kp, vp, bt, ln), 50, graph=True),
                plain_ms=time_ms(torch, lambda: attention.paged_plain(
                    q, kp, vp, bt, ln), 10, graph=True),
                library_ms=sdpa_ms(torch, q[:, :, None], kg, vg,
                                   attn_mask=mask),
                **bound(*attention.paged_work(q.shape, kp.shape, bt.shape,
                                              dt, int(ln.sum()))[::-1],
                        peak))
            emit({"phase": "kernel_family", **row})
            rows.append(row)
            if not err <= ATTN_TOL[name]:
                raise AssertionError(f"paged_attention {label} {name} "
                                     f"differs from its plain version: {err}")
            del q, kp, vp, kg, vg, got
    return rows


# ------------------------------------------------------------ phase 4
def reduced_entries(n: int, full: int):
    """The ``reduced`` field of a phase-4 line: its entries against the
    count the phase ran before the cut, or None when not cut."""
    return None if n >= full else f"{n:,} of {full:,} entries"


def range_answers(store, starts, lengths, snapshot=None) -> list:
    """The store's answers to scans, seeks and a streaming iterator from
    ``starts`` (under ``snapshot`` if given), and one multi_get."""
    scans = [store.scan(int(a), int(n), snapshot=snapshot)
             for a, n in zip(starts, lengths)]
    seeks = [store.seek(int(a), snapshot=snapshot) for a in starts]
    it = store.iterator(snapshot=snapshot)
    it.seek(int(starts[0]))
    streamed = list(itertools.islice(it, 3000))
    del it           # the iterator's cursors hold the runs
    gets = store.multi_get([int(a) for a in starts], snapshot=snapshot)
    return [scans, seeks, streamed, gets]


def equivalence_phase(torch, rt, rng, n_entries: int) -> dict:
    """One seeded op sequence on a CUDA store and a CPU store, with a
    snapshot taken mid-load: bit-identical trees, IOStats, point and range
    answers on the current state and under the snapshot; after the
    snapshot's release no pin is left and its runs leave the device."""
    cfg = rt.LSMConfig(memtable_bytes=64 << 10, base_level_bytes=256 << 10,
                       bits_per_key=10)
    stores = [rt.LSMStore(cfg, device="cuda"), rt.LSMStore(cfg, device="cpu")]
    space = n_entries // 2
    keys = rng.integers(0, space, n_entries, dtype=np.uint64)
    keys[:5] = [0, 2**32 - 1, 2**63 - 1, 2**63, 2**64 - 1]
    lens = rng.integers(0, 120, n_entries)
    vals = [bytes([int(k) & 0xFF]) * int(ln) for k, ln in zip(keys, lens)]
    dels = rng.choice(keys, n_entries // 20)
    starts = np.concatenate([rng.choice(keys, 150), rng.choice(dels, 50),
                             keys[:5], rng.integers(0, 2**64 - 1, 50,
                                                    dtype=np.uint64)])
    lengths = rng.integers(1, 101, starts.size)
    load_s, snaps = [], []
    for s in stores:
        t0 = time.perf_counter()
        s.put_batch(keys[:n_entries // 2].tolist(), vals[:n_entries // 2])
        s.delete_batch(dels.tolist())
        s.flush()
        snaps.append(s.get_snapshot())
        for k in keys[n_entries // 2:n_entries // 2 + 500].tolist():
            s.put(k, b"single")
        s.delete(int(keys[0]))
        s.put_batch(keys[n_entries // 2:].tolist(), vals[n_entries // 2:])
        s.delete_batch(dels[::2].tolist())
        s.flush()
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
    batches = [rng.integers(0, space * 2, m, dtype=np.uint64).tolist()
               for m in (0, 1, 700, 65_536)] + [keys[:4096].tolist()]
    answers = [[s.multi_get(b) for b in batches] for s in stores]
    gets = [[s.get(int(k)) for k in keys[:64]] for s in stores]
    ranges = [range_answers(s, starts, lengths) for s in stores]
    snap_ranges = [range_answers(s, starts, lengths, snap)
                   for s, snap in zip(stores, snaps)]
    cols = [rt.columns_of(s) for s in stores]
    stats = [dataclasses.asdict(s.stats) for s in stores]
    same_tree = len(cols[0]["levels"]) == len(cols[1]["levels"]) and all(
        len(la) == len(lb) and all(
            ra.keys() == rb.keys() and all(
                np.array_equal(ra[f], rb[f]) and np.asarray(ra[f]).shape
                == np.asarray(rb[f]).shape for f in ra)
            for ra, rb in zip(la, lb))
        for la, lb in zip(cols[0]["levels"], cols[1]["levels"]))
    del cols
    # the snapshot's runs: held on the device until the release
    held = [len(s.storage) for s in stores]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for s, snap in zip(stores, snaps):
        s.release_snapshot(snap)
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    out = dict(phase="equivalence", entries=n_entries,
               reduced=reduced_entries(n_entries, EQUIV_FULL),
               runs=sum(len(lvl) for lvl in stores[0]._levels),
               levels=stores[0].num_levels_in_use,
               compactions=stats[0]["compactions"],
               cuda_load_s=load_s[0], cpu_load_s=load_s[1],
               range_reads=stats[0]["range_reads"],
               scanned_entries=sum(len(a) for a in ranges[0][0]),
               snapshot_scanned_entries=sum(len(a) for a in snap_ranges[0][0]),
               same_tree=same_tree, same_stats=stats[0] == stats[1],
               same_answers=answers[0] == answers[1] and gets[0] == gets[1],
               same_range_answers=ranges[0] == ranges[1],
               same_snapshot_answers=snap_ranges[0] == snap_ranges[1],
               snapshot_differs_from_current=snap_ranges[0] != ranges[0],
               same_memtable=rt.columns_of(stores[0])["memtable"]
               == rt.columns_of(stores[1])["memtable"],
               runs_held_by_snapshot=held[0] - len(stores[0].storage),
               pins_after_release=[s.manifest.total_pin_refs()
                                   for s in stores],
               device_bytes_freed_by_release=freed)
    emit(out)
    ok = ("same_tree", "same_stats", "same_answers", "same_range_answers",
          "same_snapshot_answers", "snapshot_differs_from_current",
          "same_memtable")
    if not all(out[name] for name in ok):
        raise AssertionError("CUDA store differs from the CPU store")
    if out["pins_after_release"] != [0, 0] or held[0] != held[1] \
            or out["runs_held_by_snapshot"] <= 0 or freed <= 0:
        raise AssertionError("the released snapshot's runs were not freed")
    return out


def quiesce(store, timeout_s: float = 600.0) -> None:
    """``wait_for_quiesce`` with a bound: a pipeline that never drains
    fails the phase instead of the call's time limit."""
    if not store.wait_for_quiesce(timeout_s):
        raise AssertionError(f"background work still queued after "
                             f"{timeout_s} s")


def async_equivalence(torch, rt, ops, rng, n_entries: int) -> dict:
    """Phase 4's second case: a CUDA store with async compaction, a block
    cache and a pinned L0 against a CPU store of the same configuration,
    after the same seeded operations and ``wait_for_quiesce``: bit-equal
    trees, every answer, every IOStats field (cache hits and misses
    included) and the same cache state.  The write-pressure triggers are
    off in both, so that no counter depends on thread timing."""
    cfg = rt.LSMConfig(memtable_bytes=64 << 10, base_level_bytes=256 << 10,
                       bits_per_key=10, async_compaction=True,
                       cache_bytes=1 << 20, pin_l0_bytes=256 << 10,
                       cache_policy="lru", slowdown_trigger=0,
                       stall_trigger=0)
    stores = [rt.LSMStore(cfg, device="cuda"), rt.LSMStore(cfg, device="cpu")]
    space = n_entries // 2
    keys = rng.integers(0, space, n_entries, dtype=np.uint64)
    keys[:5] = [0, 2**32 - 1, 2**63 - 1, 2**63, 2**64 - 1]
    vals = [bytes([int(k) & 0xFF]) * int(n)
            for k, n in zip(keys, rng.integers(0, 120, n_entries))]
    dels = rng.choice(keys, n_entries // 20)
    starts = np.concatenate([rng.choice(keys, 150), rng.choice(dels, 50),
                             keys[:5], rng.integers(0, 2**64 - 1, 50,
                                                    dtype=np.uint64)])
    lengths = rng.integers(1, 101, starts.size)
    ops.reset_launch_counts()
    load_s = []
    for s in stores:
        t0 = time.perf_counter()
        s.put_batch(keys[:space].tolist(), vals[:space])
        s.delete_batch(dels.tolist())
        s.flush()
        for k in keys[space:space + 500].tolist():
            s.put(k, b"single")
        s.put_batch(keys[space:].tolist(), vals[space:])
        s.delete_batch(dels[::2].tolist())
        s.flush()
        quiesce(s)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
    load_launches = ops.launch_counts()
    batches = [rng.integers(0, space * 2, m, dtype=np.uint64).tolist()
               for m in (0, 1, 700, 65_536)] + [keys[:4096].tolist()]
    answers = [[s.multi_get(b) for b in batches]
               + [[s.get(int(k)) for k in keys[:64]]]
               + range_answers(s, starts, lengths) for s in stores]
    cols = [rt.columns_of(s) for s in stores]
    same_tree = len(cols[0]["levels"]) == len(cols[1]["levels"]) and all(
        len(la) == len(lb) and all(
            ra.keys() == rb.keys() and all(
                np.array_equal(ra[f], rb[f]) for f in ra)
            for ra, rb in zip(la, lb))
        for la, lb in zip(cols[0]["levels"], cols[1]["levels"]))
    del cols
    stats = [dataclasses.asdict(s.stats) for s in stores]
    caches = [s.cache_summary() for s in stores]
    health = [dict(degraded=s.degraded, bg_retries=st["bg_retries"],
                   bg_gave_up=st["bg_gave_up"]) for s, st in
              zip(stores, stats)]
    for s in stores:
        s.close()
    out = dict(phase="equivalence_async", entries=n_entries,
               reduced=reduced_entries(n_entries, EQUIV_FULL),
               config={k: v for k, v in dataclasses.asdict(cfg).items()
                       if k in ("async_compaction", "cache_bytes",
                                "pin_l0_bytes", "cache_policy",
                                "slowdown_trigger", "stall_trigger")},
               cuda_load_s=load_s[0], cpu_load_s=load_s[1],
               bg_flushes=stats[0]["bg_flushes"],
               bg_compactions=stats[0]["bg_compactions"],
               cache=caches[0], health=health,
               load_launches={k: load_launches[k] for k in STORE_KERNELS},
               same_tree=same_tree, same_stats=stats[0] == stats[1],
               same_answers=answers[0] == answers[1],
               same_cache=caches[0] == caches[1])
    emit(out)
    if not (same_tree and out["same_stats"] and out["same_answers"]
            and out["same_cache"]):
        raise AssertionError("the async cached CUDA store differs from the "
                             "CPU store")
    if any(h != dict(degraded=False, bg_retries=0, bg_gave_up=0)
           for h in health) or caches[0]["hits"] == 0:
        raise AssertionError(f"async equivalence: {health}, {caches[0]}")
    if not all(load_launches[k] for k in ("bloom_build", "merge_pair")):
        raise AssertionError(f"no worker launches: {load_launches}")
    return out


def guarded(injected, fn, *args):
    """``("ok", fn(*args))``, or ``("fault", site)`` where an injected
    fault (exception type ``injected``) refused the call."""
    try:
        return ("ok", fn(*args))
    except injected as e:
        return ("fault", e.site)


def equivalence_subsystems(torch, rt, ops, rng, n_entries: int) -> dict:
    """Phase 4's third case: a CUDA store and a CPU store with range views,
    paranoid reads, a Telemetry and a FaultInjector of the same seed armed
    at ``block_read`` (every 499th candidate read fails), after the same
    seeded operations: equal view columns, answers (and the same calls
    refused), IOStats, ``fired`` counts and sequence of event kinds; then
    the same block corrupted by a same-seed injector on each store, and the
    same CorruptionError from a paranoid read of it."""
    def make(device):
        cfg = rt.LSMConfig(
            memtable_bytes=64 << 10, base_level_bytes=256 << 10,
            bits_per_key=10, use_range_views=True, paranoid_checks=True,
            telemetry=rt.core.Telemetry(),
            faults=rt.core.FaultInjector(seed=17).fail_every("block_read",
                                                             499))
        return rt.LSMStore(cfg, device=device)

    stores = [make("cuda"), make("cpu")]
    space = n_entries // 2
    keys = rng.integers(0, space, n_entries, dtype=np.uint64)
    keys[:5] = [0, 2**32 - 1, 2**63 - 1, 2**63, 2**64 - 1]
    vals = [bytes([int(k) & 0xFF]) * int(n)
            for k, n in zip(keys, rng.integers(0, 120, n_entries))]
    dels = rng.choice(keys, n_entries // 20)
    starts = np.concatenate([rng.choice(keys, 150), rng.choice(dels, 50),
                             keys[:5]])
    lengths = rng.integers(1, 101, starts.size)
    batches = [rng.integers(0, space * 2, m, dtype=np.uint64).tolist()
               for m in (1, 700, 20_000)] + [keys[:4096].tolist()]
    for s in stores:
        s.put_batch(keys[:space].tolist(), vals[:space])
        s.delete_batch(dels.tolist())
        s.flush()
        s.put_batch(keys[space:].tolist(), vals[space:])
    fault = rt.core.InjectedFault
    answers = [[guarded(fault, s.multi_get, b) for b in batches]
               + [guarded(fault, s.get, int(k)) for k in keys[:64]]
               + [guarded(fault, s.scan, int(a), int(n))
                  for a, n in zip(starts, lengths)]
               + [guarded(fault, s.seek, int(a)) for a in starts]
               for s in stores]
    views = [s.refresh_range_view() for s in stores]
    same_view = all(torch.equal(getattr(views[0], c).cpu(),
                                getattr(views[1], c))
                    for c in ("keys", "src", "rows", "live", "blocks"))
    fired = [dict(s.config.faults.fired) for s in stores]
    kinds = [[e.kind for e in s.telemetry.trace.dump()] for s in stores]
    stats = [{k: v for k, v in dataclasses.asdict(s.stats).items()
              if not k.endswith("_ns")} for s in stores]
    # a corrupted block: the same one, named by the same error
    deep = max(i for i, lvl in enumerate(stores[1]._levels) if lvl)
    raised = []
    for s in stores:
        s.config.faults.clear()
        run = s._levels[deep][0]
        bid = rt.core.FaultInjector(seed=23).corrupt_run_block(run)
        lo, hi = torch.searchsorted(run.block_of, torch.tensor(
            [bid, bid + 1], device=run.block_of.device)).tolist()
        victims = ops.keys_from_device(run.keys[lo:hi]).tolist()
        try:
            s.multi_get(victims)
            raised.append(None)
        except rt.core.CorruptionError as e:
            raised.append((e.block_id, e.run_id == run.run_id, bid))
    out = dict(phase="equivalence_subsystems", entries=n_entries,
               reduced=reduced_entries(n_entries, EQUIV_FULL // 4),
               view_entries=len(views[0]), view_runs=len(views[0].runs),
               refused_calls=sum(a[0] == "fault" for a in answers[0]),
               fired=fired[0], event_kinds=len(kinds[0]),
               view_scans=stats[0]["view_scans"],
               same_view=same_view, same_answers=answers[0] == answers[1],
               same_stats=stats[0] == stats[1], same_fired=fired[0] == fired[1],
               same_event_kinds=kinds[0] == kinds[1],
               corruption=raised[0], same_corruption=raised[0] == raised[1])
    emit(out)
    ok = ("same_view", "same_answers", "same_stats", "same_fired",
          "same_event_kinds", "same_corruption")
    if not all(out[k] for k in ok):
        raise AssertionError("the CUDA store's subsystems differ from the "
                             "CPU store's")
    if not out["refused_calls"] or raised[0] is None or not raised[0][1] \
            or raised[0][0] != raised[0][2] or not out["view_scans"]:
        raise AssertionError(f"equivalence_subsystems: {out}")
    return out


# ------------------------------------------------------------ phase 5
def fill_workload(seed: int, n_entries: int):
    """db_bench fillrandom's keys (distinct u64, in write order) and the 1%
    deleted after the load, from the seed alone, so that phases 5 and 6
    write the same stream."""
    rng = np.random.default_rng([seed, 5])
    keys = rng.integers(0, 2**64 - 1, n_entries, dtype=np.uint64)
    keys = keys[np.sort(np.unique(keys, return_index=True)[1])]  # distinct
    return keys, rng.choice(keys, keys.size // 100, replace=False)


def read_waves(seed: int, sorted_keys, live, deleted, n_waves: int = 32,
               wave: int = 65_536):
    """readrandom's waves, from the seed alone (phases 5 and 6 read the
    same keys): half live keys, a quarter absent, a quarter deleted; wave
    0 warms up.  Yields (keys, the answers they must get)."""
    rng = np.random.default_rng([seed, 6])
    for _ in range(n_waves + 1):
        parts = [rng.choice(live, wave // 2),
                 rng.integers(0, 2**64 - 1, wave // 4, dtype=np.uint64),
                 rng.choice(deleted, wave // 4)]
        at = np.minimum(np.searchsorted(sorted_keys, parts[1]),
                        sorted_keys.size - 1)
        if (sorted_keys[at] == parts[1]).any():
            raise AssertionError("absent key drawn from the live set")
        yield np.concatenate(parts), user_values(parts[0]) + [None] * (
            wave // 2)


def tree_digest(store) -> list:
    """Per level, per run: its entry count and the CRC-32 of its block
    checksums (one read-back a run)."""
    return [[[len(r), zlib.crc32(r.block_crcs.cpu().numpy().tobytes())]
             for r in lvl] for lvl in store._levels]


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


def profile_window(torch, fn, by_kernel: bool = False) -> dict:
    """Wall time of ``fn`` and the device time of the kernels and copies
    it ran (torch.profiler), hence the device's idle share; with
    ``by_kernel`` also every kernel's device time, by its short name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name, copies = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
            if e.name.startswith("Memcpy"):
                copies[e.name] = copies.get(e.name, 0) + 1
    if not by_name:     # no device-side events: read the op averages
        by_name = {e.key: e.self_device_time_total
                   for e in prof.key_averages()
                   if getattr(e, "self_device_time_total", 0) > 0}
    busy_us = sum(by_name.values())
    if not by_name:
        return dict(wall_ms=wall_us / 1e3, device_busy_ms="not measured")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               device_idle_share=1 - busy_us / wall_us,
               top_device_ms={name[:80]: us / 1e3 for name, us in top},
               copies=copies)
    if by_kernel:
        short = {}
        for name, us in by_name.items():
            key = short_kernel_name(name)
            short[key] = short.get(key, 0.0) + us / 1e3
        out["device_ms_by_kernel"] = dict(
            sorted(short.items(), key=lambda kv: -kv[1]))
    return out


# the device kernels of each store kernel's wrapper, this design's and the
# first design's, by short name
STORE_KERNEL_FUNCTIONS = {
    "bloom_build": ("bloom_bucket_kernel", "bloom_set_kernel",
                    "bloom_build_kernel"),
    "merge_pair": ("merge_split_kernel", "merge_tile_kernel",
                   "merge_pair_kernel"),
    "bloom_probe": ("bloom_probe_kernel",),
}


def size_distribution(sizes) -> dict:
    """Count, sum, quantiles and a decade histogram of launch sizes."""
    if not sizes:
        return dict(count=0)
    arr = np.asarray(sizes, dtype=np.int64)
    decades = {}
    for v in arr.tolist():
        lo = 10 ** max(0, len(str(v)) - 1)
        label = f"[{lo:.0e}, {lo * 10:.0e})"
        decades[label] = decades.get(label, 0) + 1
    return dict(count=int(arr.size), sum=int(arr.sum()), min=int(arr.min()),
                p50=float(np.percentile(arr, 50)),
                p90=float(np.percentile(arr, 90)), max=int(arr.max()),
                decades=dict(sorted(decades.items(),
                                    key=lambda kv: float(kv[0][1:6]))))


def launch_size_report(ops) -> dict:
    """The distribution of the elements of every bloom_build and
    merge_pair launch since the last reset (keys; na + nb and the smaller
    side)."""
    if not hasattr(ops, "launch_sizes"):
        return {}
    sizes = ops.launch_sizes()
    pairs = sizes["merge_pair"]
    return dict(bloom_build_keys=size_distribution(sizes["bloom_build"]),
                merge_pair_elements=size_distribution(
                    [a + b for a, b in pairs]),
                merge_pair_smaller_side=size_distribution(
                    [min(a, b) for a, b in pairs]))


def seek_oracle(run_keys, mem_keys, mem_items, starts) -> list:
    """db_bench Seek with the runs' approximate liveness: the smallest key
    >= start that any run holds (a deleted key's tombstone too), or the
    memtable's first *live* key >= start if smaller."""
    live = np.fromiter((k for k, _, v in mem_items if v is not None),
                       np.uint64)
    out = []
    for a, b in zip(np.searchsorted(run_keys, starts).tolist(),
                    np.searchsorted(live, starts).tolist()):
        cands = [int(run_keys[a])] if a < run_keys.size else []
        if b < live.size:
            cands.append(int(live[b]))
        out.append(min(cands) if cands else None)
    return out


@contextmanager
def counting_refills(iterator_module):
    """Counts MergingIterator refills inside the block."""
    cls = iterator_module.MergingIterator
    refill, count = cls._refill, [0]

    def counted(self):
        count[0] += 1
        return refill(self)

    cls._refill = counted
    try:
        yield count
    finally:
        cls._refill = refill


def range_phase(torch, rt, ops, store, live, deleted, rng,
                n_seeks: int = 2000, n_scans: int = 2000,
                record=None) -> dict:
    """seekrandom (db_bench) and short scans (YCSB workload E: lengths
    uniform in 1..100) on the loaded store; start keys half at live keys,
    a quarter at deleted keys, a quarter uniform over u64.  Every scan is
    held against the next live keys and their values, every seek against
    :func:`seek_oracle` over the runs' keys as they lie on the device and
    the memtable; 50 more scans run under the profiler.  ``record`` (a
    dict) gets the draws and the checked answers, for phase 5b."""
    if not hasattr(store, "scan"):
        return dict(phase="range", skipped="this checkout has no range reads")

    def draw(n):
        return np.concatenate([
            rng.choice(live, n // 2), rng.choice(deleted, n // 4),
            rng.integers(0, 2**64 - 1, n - n // 2 - n // 4, dtype=np.uint64)])

    seek_starts, scan_starts = draw(n_seeks), draw(n_scans)
    lengths = rng.integers(1, 101, n_scans)
    st0 = store.stats
    t = time.perf_counter()
    got_seeks = [store.seek(int(a)) for a in seek_starts.tolist()]
    seek_s = time.perf_counter() - t
    st1 = store.stats
    scan_ms, got_scans = [], []
    with counting_refills(rt.core.iterator) as refills:
        for a, n in zip(scan_starts.tolist(), lengths.tolist()):
            t = time.perf_counter()
            got_scans.append(store.scan(a, n))
            scan_ms.append((time.perf_counter() - t) * 1e3)
    per_scan = store.stats.delta(st1)
    # the oracles
    runs = [r for lvl in store._levels for r in lvl if len(r)]
    run_keys = np.unique(np.concatenate([ops.keys_from_device(r.keys)
                                         for r in runs]))
    mem_keys, mem_items = store.memtable.sorted_entries()
    want_seeks = seek_oracle(run_keys, mem_keys, mem_items, seek_starts)
    bad_seeks = sum(g != w for g, w in zip(got_seeks, want_seeks))
    at = np.searchsorted(live, scan_starts)
    bad_scans = 0
    for a, n, got in zip(at.tolist(), lengths.tolist(), got_scans):
        want_keys = live[a:a + n]
        want = list(zip(want_keys.tolist(), user_values(want_keys)))
        bad_scans += got != want
    scanned = sum(len(g) for g in got_scans)
    # 50 more scans under the profiler: idle share and copies per scan
    prof_starts, prof_lens = draw(50), rng.integers(1, 101, 50)
    prof = profile_window(torch, lambda: [
        store.scan(int(a), int(n)) for a, n in zip(prof_starts, prof_lens)])
    copies = prof.pop("copies", {})
    out = dict(
        phase="range", seeks=n_seeks, seek_s=seek_s,
        seeks_per_s=n_seeks / seek_s,
        seek_ms_mean=seek_s / n_seeks * 1e3,
        seek_stats={k: v for k, v in dataclasses.asdict(
            st1.delta(st0)).items() if v},
        scans=n_scans, scan_s=sum(scan_ms) / 1e3,
        scans_per_s=n_scans / (sum(scan_ms) / 1e3),
        scanned_entries=scanned,
        entries_per_s=scanned / (sum(scan_ms) / 1e3),
        scan_ms_p50=float(np.percentile(scan_ms, 50)),
        scan_ms_p99=float(np.percentile(scan_ms, 99)),
        per_scan=dict(blocks_read=per_scan.blocks_read / n_scans,
                      runs_touched=per_scan.runs_touched_range / n_scans,
                      refills=refills[0] / n_scans),
        levels_in_use=store.num_levels_in_use, runs=len(runs),
        memtable_entries=int(mem_keys.size),
        profile_50_scans=prof,
        d2h_copies_per_scan=sum(c for n, c in copies.items()
                                if "DtoH" in n) / 50,
        h2d_copies_per_scan=sum(c for n, c in copies.items()
                                if "HtoD" in n) / 50,
        copies_50_scans=copies, wrong_seeks=bad_seeks, wrong_scans=bad_scans)
    if bad_seeks or bad_scans:
        emit(out)
        raise AssertionError(f"range reads: {bad_seeks} wrong seeks, "
                             f"{bad_scans} wrong scans")
    if record is not None:
        record.update(seek_starts=seek_starts, scan_starts=scan_starts,
                      lengths=lengths, seeks=got_seeks,
                      want_seeks=want_seeks, scans=got_scans,
                      prof_starts=prof_starts, prof_lens=prof_lens)
    return out


@contextmanager
def recording_probes(torch, bloom):
    """Records every bloom_probe launch inside the block: keys, filter
    words, k and the keys the filter passed (one wait each, outside any
    timed or profiled window)."""
    record, probe = [], bloom.probe_cuda

    def recorded(keys, bits, k):
        out = probe(keys, bits, k)
        record.append(dict(keys=keys.numel(), words=bits.numel(), k=k,
                           maybe=int(out.sum())))
        return out

    bloom.probe_cuda = recorded
    try:
        yield record
    finally:
        bloom.probe_cuda = probe


def probe_size_report(ops) -> dict:
    """Every bloom_probe launch since the last reset, by filter size:
    launches and the keys each probed (a run's filter keeps its size while
    the store is read)."""
    by_words = {}
    for n, words in ops.launch_sizes().get("bloom_probe", []):
        by_words.setdefault(words, []).append(n)
    return {str(w): dict(launches=len(ns), keys_min=min(ns),
                         keys_p50=float(np.percentile(ns, 50)),
                         keys_max=max(ns))
            for w, ns in sorted(by_words.items())}


def run_device_bytes(store) -> int:
    """Device bytes of a store's run columns (every shard's)."""
    return sum(t.numel() * t.element_size()
               for s in getattr(store, "shards", [store])
               for lvl in s._levels for r in lvl
               for t in (r.keys, r.seqs, r.vlens, r.vals, r.block_of,
                         r.fence_keys, r.block_crcs, r.bloom.bits))


DB_BENCH = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=4 << 20,
                base_level_bytes=10 << 20, l0_compaction_trigger=4,
                bits_per_key=10, block_size=4096)   # LevelDB's defaults


def dbbench_phase(torch, rt, ops, bloom, rng, seed: int,
                  n_entries: int, keep=None) -> dict:
    """fillrandom then readrandom at LevelDB's db_bench defaults, then
    seekrandom and short scans on the same store (``range_phase``).
    ``keep`` (a dict) gets the store, its key sets and the range reads'
    draws and answers, for phase 5b."""
    cfg = rt.LSMConfig(**DB_BENCH)
    store = rt.LSMStore(cfg)   # cuda:0
    torch.cuda.reset_peak_memory_stats()
    keys, deleted = fill_workload(seed, n_entries)
    sorted_keys = np.sort(keys)
    # time inside compactions and inside flush's run build, device synced
    spent = {"compaction": 0.0, "flush_build": 0.0}

    def timed(name, fn):
        def wrapper(*args):
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return out
        return wrapper

    store._apply = timed("compaction", store._apply)
    store.memtable.to_run = timed("flush_build", store.memtable.to_run)
    ops.reset_launch_counts()
    # every chunk but the last timed; the last, which flushes and compacts
    # like the others, under the profiler for the load's device split
    chunk = min(500_000, -(-keys.size // 2))
    starts = list(range(0, keys.size, chunk))
    t0 = time.perf_counter()
    for i in starts[:-1]:
        kc = keys[i:i + chunk]
        store.put_batch(kc.tolist(), user_values(kc))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_stats = store.stats
    load_spent = dict(spent)
    kc = keys[starts[-1]:]
    load_profile = profile_window(torch, lambda: store.put_batch(
        kc.tolist(), user_values(kc)), by_kernel=True)
    per_kernel = load_profile.get("device_ms_by_kernel", {})
    load_profile["store_kernels_ms"] = {
        name: sum(per_kernel.get(f, 0.0) for f in fns)
        for name, fns in STORE_KERNEL_FUNCTIONS.items()}
    store.delete_batch(deleted.tolist())
    torch.cuda.synchronize()
    digest = tree_digest(store)
    launch_sizes = launch_size_report(ops)
    live = np.setdiff1d(keys, deleted)
    wave = 65_536
    before = store.stats
    wave_s, checked = [], 0
    for w, (q, want) in enumerate(read_waves(seed, sorted_keys, live,
                                             deleted)):
        with recording_probes(torch, bloom) if w == 0 else nullcontext() \
                as record:       # wave 0 warms up, untimed
            t = time.perf_counter()
            got = store.multi_get(q.tolist())
            dt = time.perf_counter() - t
        if w == 0:
            probe_record = record
        if got != want:
            bad = sum(g != x for g, x in zip(got, want))
            raise AssertionError(f"wave {w}: {bad} wrong answers")
        if w:
            wave_s.append(dt)
            checked += q.size
    read_stats = store.stats.delta(before)
    # three more checked waves under the profiler: the device's idle share
    waves = [(rng.choice(live, wave // 2), rng.choice(deleted, wave // 2))
             for _ in range(3)]
    answers = []
    read_profile = profile_window(torch, lambda: answers.extend(
        store.multi_get(np.concatenate(w).tolist()) for w in waves))
    if answers != [user_values(lv) + [None] * (wave // 2) for lv, _ in waves]:
        raise AssertionError("wrong answers in the profiled waves")
    probe_sizes = probe_size_report(ops)
    record = {}
    ranges = range_phase(torch, rt, ops, store, live, np.sort(deleted), rng,
                         record=record)
    run_bytes = run_device_bytes(store)
    out = dict(
        phase="db_bench", entries=int(keys.size), deleted=int(deleted.size),
        value_bytes=100, key_bytes=cfg.key_bytes,
        config=dataclasses.asdict(cfg), load_timed_entries=starts[-1],
        load_s=load_s, load_entries_per_s=starts[-1] / load_s,
        compaction_s=load_spent["compaction"],
        flush_build_s=load_spent["flush_build"],
        host_write_path_s=load_s - load_spent["compaction"]
        - load_spent["flush_build"],
        compaction_mb_per_s=load_stats.bytes_compacted / 1e6
        / load_spent["compaction"] if load_spent["compaction"] else None,
        load_profile_last_chunk=dict(entries=int(kc.size), **load_profile),
        launch_sizes=launch_sizes, probe_launch_sizes=probe_sizes,
        probe_record=probe_record,
        bytes_compacted=load_stats.bytes_compacted,
        write_amp=load_stats.write_amplification(),
        read_keys=checked, read_s=sum(wave_s),
        multi_get_keys_per_s=checked / sum(wave_s),
        wave_ms_p50=float(np.percentile(wave_s, 50) * 1e3),
        wave_ms_p99=float(np.percentile(wave_s, 99) * 1e3),
        read_profile_3_waves=read_profile,
        levels_in_use=store.num_levels_in_use,
        level_summary=store.level_summary(),
        run_bytes_on_device=run_bytes,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        read_stats={k: v for k, v in dataclasses.asdict(read_stats).items()
                    if v},
        tree_digest=digest, memtable_entries=len(store.memtable))
    emit(out)
    emit(ranges)
    if keep is not None:
        keep.update(store=store, keys=keys, deleted=deleted, live=live,
                    sorted_keys=sorted_keys, range_record=record,
                    range_line=ranges)
    return out


# ------------------------------------------------------------ phase 5b
def storage_bytes(tensors, exclude=()) -> int:
    """Device bytes of the storages of ``tensors``, each counted once,
    leaving out the storages of ``exclude``."""
    skip = {t.untyped_storage().data_ptr() for t in exclude}
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def nearest_rank(samples, p: float) -> float:
    """The histogram's percentile definition (nearest rank) on samples."""
    s = sorted(samples)
    return s[max(1, math.ceil(len(s) * p / 100.0)) - 1]


def timed_waves(torch, store, waves, modes, set_mode) -> dict:
    """Each wave once in each mode, the modes' order alternating from wave
    to wave; every answer checked.  Host seconds by mode."""
    secs = {m: [] for m in modes}
    for w, (q, want) in enumerate(waves):
        keys = q.tolist()       # outside the clock, as outside the span
        for m in (modes if w % 2 == 0 else modes[::-1]):
            set_mode(m)
            t = time.perf_counter()
            got = store.multi_get(keys)
            secs[m].append(time.perf_counter() - t)
            if got != want:
                raise AssertionError(f"wave {w} ({m}): "
                                     f"{sum(g != x for g, x in zip(got, want))}"
                                     f" wrong answers")
    return secs


def zipf_items(rng, n_items: int, n: int, theta: float = 0.99):
    """``n`` draws of YCSB's zipfian request distribution (constant 0.99)
    over ``n_items`` items, scrambled by a seeded permutation, as YCSB's
    scrambled zipfian spreads the hot items over the key space."""
    w = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** theta
    cdf = np.cumsum(w)
    ranks = np.minimum(np.searchsorted(cdf, rng.random(n) * cdf[-1]),
                       n_items - 1)
    return rng.permutation(n_items)[ranks]


def tuner_part(torch, rt, seed: int, n_keys: int = 1_000_000,
               n_ops: int = 1 << 20, batch: int = 4096,
               interval_ops: int = 16_384):
    """YCSB workload A (50% reads, 50% updates, zipfian) over a 1M-key
    load on a tuned async store (phase 6's knobs, a Telemetry and an
    OnlineTuner) and an untuned twin: every read checked against the
    written values and equal between the two; knobs within KNOB_BOUNDS,
    every actuation with the scheduler idle.  Reads and updates go in
    batches of ``batch`` operations (a batch's reads, then its updates),
    values 100 bytes (YCSB ``fieldcount=1``, ``fieldlength=100``).
    Returns the phase line's fields and the gates that failed."""
    cfg = rt.LSMConfig(**DB_BENCH, async_compaction=True,
                       compaction_workers=1, cache_bytes=8 << 20,
                       cache_policy="lru", pin_l0_bytes=16 << 20)
    tel = rt.core.Telemetry()
    # a tick every 16,384 writes (8 batches): 16 samples a window, so the
    # tuner decides on every one
    tun = rt.core.OnlineTuner(interval_ops=interval_ops, min_window_ops=16)
    tuned = rt.LSMStore(dataclasses.replace(cfg, telemetry=tel, tuner=tun))
    twin = rt.LSMStore(cfg)
    actuations, tick_ms = [], []
    actuators, tick = tuned._tuning_actuators, tun.tick

    def recorded_actuators():
        return {k: (get, lambda v, k=k, put=put: (
            actuations.append((k, v, tuned._scheduler.idle())), put(v)))
            for k, (get, put) in actuators().items()}

    def timed_tick(store):
        t = time.perf_counter()
        try:
            return tick(store)
        finally:
            tick_ms.append((time.perf_counter() - t) * 1e3)

    tuned._tuning_actuators, tun.tick = recorded_actuators, timed_tick
    rng = np.random.default_rng([seed, 10])
    keys = np.unique(rng.integers(0, 2**64 - 1, n_keys + n_keys // 100,
                                  dtype=np.uint64))
    keys = rng.permutation(keys)[:n_keys]
    salt = np.zeros(n_keys, dtype=np.int64)
    t = time.perf_counter()
    for s in (tuned, twin):
        for i in range(0, n_keys, 250_000):
            kc = keys[i:i + 250_000]
            s.put_batch(kc.tolist(), salted_values(kc, 0))
        s.flush()
        quiesce(s)
    load_s = time.perf_counter() - t
    items = zipf_items(rng, n_keys, n_ops)
    is_read = rng.random(n_ops) < 0.5
    secs = {"tuned": 0.0, "twin": 0.0}
    wrong = unequal = 0
    for b, i in enumerate(range(0, n_ops, batch)):
        it, rd = items[i:i + batch], is_read[i:i + batch]
        rk, uk = keys[it[rd]], keys[it[~rd]]
        want = salted_values(rk, salt[it[rd]])
        vals = salted_values(uk, 1 + b % 255)
        got = {}
        for name, s in (("tuned", tuned), ("twin", twin)):
            t = time.perf_counter()
            got[name] = s.multi_get(rk.tolist())
            s.put_batch(uk.tolist(), vals)
            secs[name] += time.perf_counter() - t
        salt[it[~rd]] = 1 + b % 255
        wrong += sum(g != w for g, w in zip(got["tuned"], want))
        unequal += sum(a != c for a, c in zip(got["tuned"], got["twin"]))
        if b % 64 == 63:
            quiesce(tuned)       # a drained pipeline is a tuning boundary
    for s in (tuned, twin):
        s.flush()
        quiesce(s)
    final = [checked_reads(s, keys, salted_values(keys, salt))
             for s in (tuned, twin)]
    bounds = rt.core.KNOB_BOUNDS
    out_of_bounds = [(k, v) for step in tun.steps for k, v in step.knobs.items()
                     if not bounds[k][0] - 1e-9 <= v <= bounds[k][1] + 1e-9]
    steps_ev = sum(1 for e in tel.trace.dump() if e.kind == "tuner_step")
    health = [dict(degraded=s.degraded, bg_retries=s.stats.bg_retries,
                   bg_gave_up=s.stats.bg_gave_up) for s in (tuned, twin)]
    for s in (tuned, twin):
        s.close()
    out = dict(
        keys=n_keys, ops=n_ops, batch=batch, load_s_both=load_s,
        ops_per_s={k: n_ops / v for k, v in secs.items()},
        ticks=tun.ticks, decisions=len(tun.steps), tuner_step_events=steps_ev,
        knob_trajectory=tun.knob_trajectory(),
        tick_host_ms=dict(mean=float(np.mean(tick_ms)) if tick_ms else None,
                          max=float(max(tick_ms)) if tick_ms else None,
                          n=len(tick_ms)),
        actuations=len(actuations),
        actuations_not_idle=sum(1 for a in actuations if not a[2]),
        out_of_bounds=out_of_bounds, wrong_reads=int(wrong),
        unequal_reads=int(unequal), final_wrong=final,
        final_policy=dict(T=tuned.policy.T, c=tuned.policy.c),
        health=health)
    bad = []
    if wrong or unequal or any(final):
        bad.append("wrong or unequal reads")
    if not tun.steps or steps_ev != len(tun.steps):
        bad.append("no tuner decisions")
    if out_of_bounds or out["actuations_not_idle"]:
        bad.append("knob out of bounds or actuated off a boundary")
    if any(h != dict(degraded=False, bg_retries=0, bg_gave_up=0)
           for h in health):
        bad.append("background failures")
    return out, bad


def subsystems_phase(torch, rt, ops, seed: int, ctx: dict) -> dict:
    """Phase 5b, on phase 5's store (10M entries, 5 levels): range views
    (full and incremental build; phase 5's seeks and scans through the
    view, every answer equal to phase 5's), telemetry (the store's own
    multi_get percentiles beside the host clock; keys/s with it on and
    off), paranoid reads (answers, keys/s, verify passes per run), faults
    (an injected block_read failure; a corrupted block caught and named),
    and the online tuner on YCSB workload A beside an untuned twin."""
    from repro_torch.core import run as run_mod
    from repro_torch.core.telemetry import bucket_of
    t_phase = time.perf_counter()
    store, rec = ctx["store"], ctx["range_record"]
    for obj, name in ((store, "_apply"), (store.memtable, "to_run")):
        vars(obj).pop(name, None)      # phase 5's timing wrappers
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bad = []
    # ---- views: the full build
    store.config.use_range_views = True
    t = time.perf_counter()
    view = store.refresh_range_view()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    k2_full = ops.launch_counts()["merge_pair"]
    run_cols = [c for lvl in store._levels for r in lvl
                for c in (r.keys, r.block_of)]
    view_bytes = storage_bytes(
        [view.keys, view.src, view.rows, view.live, view.blocks]
        + [c for cols in store._view_cache.values() for c in cols],
        exclude=run_cols)
    # phase 5's seeks and scans, through the view
    st0 = store.stats
    t = time.perf_counter()
    got_seeks = [store.seek(int(a)) for a in rec["seek_starts"].tolist()]
    seek_s = time.perf_counter() - t
    st1 = store.stats
    scan_ms, got_scans = [], []
    for a, n in zip(rec["scan_starts"].tolist(), rec["lengths"].tolist()):
        t = time.perf_counter()
        got_scans.append(store.scan(a, n))
        scan_ms.append((time.perf_counter() - t) * 1e3)
    per_scan = store.stats.delta(st1)
    wrong_seeks = sum(g != w for g, w in zip(got_seeks, rec["seeks"]))
    wrong_scans = sum(g != w for g, w in zip(got_scans, rec["scans"]))
    prof = profile_window(torch, lambda: [
        store.scan(int(a), int(n))
        for a, n in zip(rec["prof_starts"], rec["prof_lens"])])
    copies = prof.pop("copies", {})
    n_scans = len(scan_ms)
    line5 = ctx["range_line"]
    # ---- the incremental build after one more flush, under telemetry
    tel = rt.core.Telemetry()
    store.config.telemetry = tel
    k2 = ops.launch_counts()["merge_pair"]
    t = time.perf_counter()
    store.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t
    t = time.perf_counter()
    view2 = store.refresh_range_view()
    torch.cuda.synchronize()
    inc_s = time.perf_counter() - t
    recheck = [store.scan(int(a), int(n)) for a, n in zip(
        rec["scan_starts"][:200].tolist(), rec["lengths"][:200].tolist())]
    wrong_after_flush = sum(g != w for g, w in zip(recheck, rec["scans"]))
    views = dict(
        phase="subsystems", part="views", entries=len(view),
        runs=len(view.runs), full_build_s=build_s,
        full_build_merge_pair_launches=k2_full,
        view_device_bytes=view_bytes,
        run_device_bytes=storage_bytes(
            [c for lvl in store._levels for r in lvl
             for c in (r.keys, r.seqs, r.vlens, r.vals, r.block_of,
                       r.fence_keys, r.block_crcs, r.bloom.bits)]),
        incremental=dict(flush_s=flush_s, build_s=inc_s,
                         levels_rebuilt=view2.levels_built,
                         levels=sum(1 for lvl in store._levels if lvl),
                         runs=len(view2.runs),
                         merge_pair_launches=ops.launch_counts()
                         ["merge_pair"] - k2,
                         rescanned=len(recheck),
                         wrong=wrong_after_flush),
        seeks=len(got_seeks), seeks_per_s=len(got_seeks) / seek_s,
        seek_ms_mean=seek_s / len(got_seeks) * 1e3,
        scans=n_scans, scans_per_s=n_scans / (sum(scan_ms) / 1e3),
        scan_ms_p50=float(np.percentile(scan_ms, 50)),
        scan_ms_p99=float(np.percentile(scan_ms, 99)),
        per_scan=dict(blocks_read=per_scan.blocks_read / n_scans,
                      runs_touched=per_scan.runs_touched_range / n_scans),
        seek_stats={k: v for k, v in dataclasses.asdict(
            st1.delta(st0)).items() if v},
        view_scans=per_scan.view_scans, view_fallbacks=(
            per_scan.view_fallbacks + st1.delta(st0).view_fallbacks),
        profile_50_scans=prof,
        d2h_copies_per_scan=sum(c for n, c in copies.items()
                                if "DtoH" in n) / 50,
        h2d_copies_per_scan=sum(c for n, c in copies.items()
                                if "HtoD" in n) / 50,
        memtable_entries_at_scans=line5.get("memtable_entries"),
        phase5_range={k: line5.get(k) for k in (
            "seeks_per_s", "scans_per_s", "scan_ms_p50", "scan_ms_p99",
            "per_scan", "d2h_copies_per_scan")},
        wrong_seeks=wrong_seeks, wrong_scans=wrong_scans)
    emit(views)
    if wrong_seeks or wrong_scans or wrong_after_flush \
            or views["view_fallbacks"] or not views["view_scans"]:
        bad.append("view answers differ from phase 5's, or fell back")
    # ---- telemetry: eight of phase 5's waves, on and off in turns
    waves = list(itertools.islice(read_waves(
        seed, ctx["sorted_keys"], ctx["live"], ctx["deleted"]), 1, 9))
    secs = timed_waves(torch, store, waves, ("on", "off"), lambda m: setattr(
        store.config, "telemetry", tel if m == "on" else None))
    store.config.telemetry = None
    hist = tel.histogram("multi_get")
    wave_keys = sum(q.size for q, _ in waves)
    pct = {}
    for p in (50, 99):
        store_ns, host_ns = hist.percentile(p), nearest_rank(secs["on"], p) \
            * 1e9
        pct[f"p{p}"] = dict(store_ms=store_ns / 1e6, host_ms=host_ns / 1e6,
                            bucket_gap=bucket_of(int(host_ns))
                            - bucket_of(int(store_ns)))
    kinds = {}
    for e in tel.trace.dump():
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    telemetry = dict(
        phase="subsystems", part="telemetry", waves=len(waves),
        multi_get=pct, store_multi_get_samples=hist.n,
        keys_per_s_on=wave_keys / sum(secs["on"]),
        keys_per_s_off=wave_keys / sum(secs["off"]),
        event_counts=kinds,
        spans={op: dict(count=d["count"], p50_ms=d["p50_ns"] / 1e6,
                        max_ms=d["max_ns"] / 1e6)
               for op, d in tel.summary().items()})
    emit(telemetry)
    if hist.n != len(waves) or any(abs(v["bucket_gap"]) > 1
                                   for v in pct.values()):
        bad.append("the store's multi_get histogram disagrees with the host")
    # ---- paranoid reads: the same waves, plain and paranoid in turns
    runs = sum(1 for lvl in store._levels for r in lvl if len(r))
    passes = dict(run_mod.VERIFY_PASSES)
    secs = timed_waves(torch, store, waves, ("plain", "paranoid"),
                       lambda m: setattr(store.config, "paranoid_checks",
                                         m == "paranoid"))
    store.config.paranoid_checks = False
    batch_passes = run_mod.VERIFY_PASSES["batch"] - passes["batch"]
    paranoid = dict(
        phase="subsystems", part="paranoid", waves=len(waves), runs=runs,
        keys_per_s_plain=wave_keys / sum(secs["plain"]),
        keys_per_s_paranoid=wave_keys / sum(secs["paranoid"]),
        wave_ms_p50=dict(plain=float(np.percentile(secs["plain"], 50) * 1e3),
                         paranoid=float(np.percentile(secs["paranoid"], 50)
                                        * 1e3)),
        verify_passes_per_wave=batch_passes / len(waves),
        verify_passes_per_run_per_wave=batch_passes / len(waves) / runs,
        single_block_verifies=run_mod.VERIFY_PASSES["block"]
        - passes["block"])
    emit(paranoid)
    if paranoid["verify_passes_per_wave"] > runs \
            or paranoid["single_block_verifies"]:
        bad.append("paranoid verify is not one pass per run per wave")
    # ---- faults, last: they mutate the store
    f = rt.core.FaultInjector(seed)
    store.config.faults = f.fail_every("block_read", 10_000)
    store.config.telemetry = tel
    q, want = waves[0]
    injected = guarded(rt.core.InjectedFault, store.multi_get, q.tolist())[1]
    if not isinstance(injected, str):
        injected = None        # answered: the fault never fired
    fired = dict(f.fired)
    f.clear()
    q, want = waves[1]
    after_clear_ok = store.multi_get(q.tolist()) == want
    deep = max(i for i, lvl in enumerate(store._levels) if lvl)
    run = store._levels[deep][0]
    bid = f.corrupt_run_block(run)
    lo, hi = torch.searchsorted(run.block_of, torch.tensor(
        [bid, bid + 1], device=run.block_of.device)).tolist()
    victims = ops.keys_from_device(run.keys[lo:hi]).tolist()
    store.config.paranoid_checks = True
    try:
        store.multi_get(victims)
        caught = None
    except rt.core.CorruptionError as e:
        caught = (e.run_id, e.block_id)
    store.config.paranoid_checks = False
    t = time.perf_counter()
    report = store.scrub()
    scrub_s = time.perf_counter() - t
    reported = [(r["run_id"], r["bad_blocks"]) for r in report
                if r["bad_blocks"]]
    faults = dict(
        phase="subsystems", part="faults", fail_every_block_read=10_000,
        injected=injected, fired=fired, next_wave_correct=after_clear_ok,
        corrupted=dict(level=deep, run_entries=len(run), block=bid,
                       block_entries=hi - lo),
        corruption_caught=caught, scrub_reported=reported, scrub_s=scrub_s,
        corruption_events=sum(1 for e in tel.trace.dump()
                              if e.kind == "corruption"))
    emit(faults)
    if injected != "block_read" or fired != {"block_read": 1} \
            or not after_clear_ok or caught != (run.run_id, bid) \
            or reported != [(run.run_id, [bid])]:
        bad.append("faults")
    store_launches = ops.launch_counts()
    ctx.clear()
    del store, view, view2, run
    torch.cuda.empty_cache()
    # ---- the online tuner on YCSB workload A
    tuner, tuner_bad = tuner_part(torch, rt, seed)
    emit(dict(phase="subsystems", part="tuner", **tuner))
    bad += tuner_bad
    launches = ops.launch_counts()
    out = dict(phase="subsystems", part="summary",
               s=time.perf_counter() - t_phase,
               launches={k: launches[k] for k in STORE_KERNELS},
               launches_on_phase5_store={k: store_launches[k]
                                         for k in STORE_KERNELS},
               max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(out)
    if not all(launches[k] for k in STORE_KERNELS):
        bad.append(f"store kernels not launched: {launches}")
    if bad:
        raise AssertionError(f"subsystems phase failed: {bad}")
    return out


# ------------------------------------------------------------ phase 6
@contextmanager
def launches_by_thread(bloom, merge):
    """Counts every store-kernel launch inside the block by kernel and by
    the name of the thread that made it."""
    counts, lock = {}, threading.Lock()
    wrapped = {"bloom_probe": (bloom, "probe_cuda"),
               "bloom_build": (bloom, "build_cuda"),
               "merge_pair": (merge, "merge_pair_cuda")}
    saved = {name: getattr(mod, attr)
             for name, (mod, attr) in wrapped.items()}

    def counting(name, fn):
        def call(*args):
            out = fn(*args)
            with lock:
                key = f"{name}@{threading.current_thread().name}"
                counts[key] = counts.get(key, 0) + 1
            return out
        return call

    for name, (mod, attr) in wrapped.items():
        setattr(mod, attr, counting(name, saved[name]))
    try:
        yield counts
    finally:
        for name, (mod, attr) in wrapped.items():
            setattr(mod, attr, saved[name])


def salted_values(keys: np.ndarray, salt, width: int = 100) -> list:
    """A value that names its key (8 little-endian bytes) and a write
    generation ``salt`` (the other bytes; one for every key, or an array of
    one per key), unlike :func:`user_values`."""
    mat = np.empty((keys.size, width), dtype=np.uint8)
    mat[:] = np.asarray(salt, dtype=np.uint8).reshape(-1, 1)
    mat[:, :8] = keys.astype("<u8").view(np.uint8).reshape(-1, 8)
    flat = mat.tobytes()
    return [flat[i:i + width] for i in range(0, len(flat), width)]


def checked_reads(store, keys: np.ndarray, want: list,
                  wave: int = 65_536) -> int:
    """multi_get of ``keys`` in waves; the number of wrong answers."""
    bad = 0
    for i in range(0, keys.size, wave):
        got = store.multi_get(keys[i:i + wave].tolist())
        bad += sum(g != w for g, w in zip(got, want[i:i + wave]))
    return bad


def durability_phase(torch, rt, ops, bloom, merge, seed: int,
                     n_entries: int, phase5=None) -> dict:
    """Phase 5's load on LevelDB's background compaction (one worker), its
    8 MiB LRU block cache and a pinned L0 of 16 MiB (four 4 MiB write
    buffers, L0 at its compaction trigger: the paper's pinned first
    level); the same read waves through the cache; then a crash while the
    pipeline is busy, and recovery."""
    cfg = rt.LSMConfig(**DB_BENCH, async_compaction=True,
                       compaction_workers=1, cache_bytes=8 << 20,
                       cache_policy="lru", pin_l0_bytes=16 << 20)
    store = rt.LSMStore(cfg)   # cuda:0
    torch.cuda.reset_peak_memory_stats()
    keys, deleted = fill_workload(seed, n_entries)
    sorted_keys = np.sort(keys)
    live = np.setdiff1d(keys, deleted)
    # worker time inside flushes and compactions (device synced there),
    # and foreground time inside the cache's accounting
    spent = {"bg_flush": 0.0, "compaction": 0.0, "cache_accounting": 0.0}

    def timed(name, fn, sync=True):
        def wrapper(*args):
            t = time.perf_counter()
            out = fn(*args)
            if sync:
                torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return out
        return wrapper

    store._bg_flush = timed("bg_flush", store._bg_flush)
    store._apply = timed("compaction", store._apply)
    store.block_cache.read_blocks = timed(
        "cache_accounting", store.block_cache.read_blocks, sync=False)
    ops.reset_launch_counts()
    with launches_by_thread(bloom, merge) as by_thread:
        chunk = min(500_000, -(-keys.size // 2))
        starts = list(range(0, keys.size, chunk))
        t0 = time.perf_counter()
        for i in starts[:-1]:
            kc = keys[i:i + chunk]
            store.put_batch(kc.tolist(), user_values(kc))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        quiesce(store)
        torch.cuda.synchronize()
        drained_s = time.perf_counter() - t0
        load_stats = store.stats
        load_spent = dict(spent)
        kc = keys[starts[-1]:]
        load_profile = profile_window(torch, lambda: (store.put_batch(
            kc.tolist(), user_values(kc)), quiesce(store)),
            by_kernel=True)
        store.delete_batch(deleted.tolist())
        quiesce(store)
        torch.cuda.synchronize()
        digest = tree_digest(store)
        memtable_entries = len(store.memtable)
        load_launches = dict(by_thread)
        # the same read waves as phase 5, through the cache
        before = store.stats
        cache_before = spent["cache_accounting"]
        wave_s, checked = [], 0
        for w, (q, want) in enumerate(read_waves(seed, sorted_keys, live,
                                                 deleted)):
            t = time.perf_counter()
            got = store.multi_get(q.tolist())
            dt = time.perf_counter() - t
            if got != want:
                bad = sum(g != x for g, x in zip(got, want))
                raise AssertionError(f"durability wave {w}: {bad} wrong")
            if w:
                wave_s.append(dt)
                checked += q.size
        reads = store.stats.delta(before)
        cache_s = spent["cache_accounting"] - cache_before
        cache = store.cache_summary()
        # a crash while the pipeline is busy: 500,000 writes (half
        # overwrites of live keys, half new keys) rotate into the queue
        # (held there: the worker would keep up), flush() rotates and
        # fsyncs the rest, then 10,000 writes that are never fsynced (they
        # fit the empty write buffer); the worker resumes and the crash
        # comes at once, with a flush in flight and the rest queued
        crng = np.random.default_rng([seed, 8])
        half = min(250_000, keys.size // 20)     # the sizes at 10M entries
        n_unsynced = min(10_000, keys.size // 20)
        over = crng.choice(live, half, replace=False)
        new = crng.integers(0, 2**64 - 1, half + half // 10, dtype=np.uint64)
        new = np.unique(new[~np.isin(new, keys)])[:half]
        batch = np.concatenate([over, new])
        crng.shuffle(batch)
        store._scheduler.pause()
        t = time.perf_counter()
        for i in range(0, batch.size, 50_000):
            kc = batch[i:i + 50_000]
            store.put_batch(kc.tolist(), salted_values(kc, 1))
        store.flush()
        write_s = time.perf_counter() - t
        queued_at_flush = [len(store._imm), store._scheduler.pending()]
        untouched = np.setdiff1d(live, over)
        unsynced = np.concatenate([
            crng.choice(batch, n_unsynced // 2, replace=False),
            crng.choice(untouched, n_unsynced // 2, replace=False)])
        store.put_batch(unsynced.tolist(), salted_values(unsynced, 2))
        unsynced_in_wal = [len(store.memtable), store.wal._synced_upto]
        queued_at_crash = [len(store._imm), store._scheduler.pending()]
        store._scheduler.resume()
        split = {}

        def split_timed(name, fn):
            def wrapper(*args):
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                split[name] = (time.perf_counter() - t, out)
                return out
            return wrapper

        store._consolidate_imm_wal = split_timed("wal_replay",
                                                 store._consolidate_imm_wal)
        store.scrub = split_timed("scrub", store.scrub)
        t = time.perf_counter()
        store.crash()
        drain_s = time.perf_counter() - t
        pins_after_crash = store.manifest.total_pin_refs()
        t = time.perf_counter()
        store.recover()
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t
        del store._consolidate_imm_wal, store.scrub
        report = split["scrub"][1]
        runs = [r for lvl in store._levels for r in lvl]
        # every fsynced write reads back its last value, the unsynced tail
        # its previous one
        prev = {int(k): v for k, v in zip(batch, salted_values(batch, 1))}
        want_unsynced = [prev[int(k)] for k in unsynced[:n_unsynced // 2]] \
            + user_values(unsynced[n_unsynced // 2:])
        rest = np.setdiff1d(untouched, unsynced)
        rest = crng.choice(rest, min(1_500_000, rest.size // 2),
                           replace=False)
        dead = crng.choice(deleted, min(50_000, deleted.size), replace=False)
        t = time.perf_counter()
        wrong = dict(
            fsynced_batch=checked_reads(store, batch,
                                        salted_values(batch, 1)),
            unsynced=checked_reads(store, unsynced, want_unsynced),
            rest=checked_reads(store, rest, user_values(rest)),
            deleted=checked_reads(store, dead, [None] * dead.size))
        verify_s = time.perf_counter() - t
        health = dict(degraded=store.degraded,
                      bg_retries=store.stats.bg_retries,
                      bg_gave_up=store.stats.bg_gave_up,
                      pins=store.manifest.total_pin_refs())
        store.put(2**64 - 1, b"after recovery")
        store.flush()
        quiesce(store)
        after_ok = store.get(2**64 - 1) == b"after recovery"
        store.close()
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    worker = "autumn-compaction-0"
    out = dict(
        phase="durability", entries=int(keys.size), deleted=int(deleted.size),
        config={k: v for k, v in dataclasses.asdict(cfg).items()
                if k in ("async_compaction", "compaction_workers",
                         "cache_bytes", "cache_policy", "pin_l0_bytes",
                         "slowdown_trigger", "stall_trigger",
                         "memtable_bytes", "block_size")},
        load_timed_entries=starts[-1], load_s=load_s,
        load_entries_per_s=starts[-1] / load_s,
        load_drained_s=drained_s,
        load_drained_entries_per_s=starts[-1] / drained_s,
        worker_flush_s=load_spent["bg_flush"],
        worker_compaction_s=load_spent["compaction"],
        stall_ns=load_stats.stall_ns, write_stalls=load_stats.write_stalls,
        write_slowdowns=load_stats.write_slowdowns,
        bg_flushes=load_stats.bg_flushes,
        bg_compactions=load_stats.bg_compactions,
        load_profile_last_chunk=dict(entries=int(kc.size), **load_profile),
        load_launches_by_thread=load_launches,
        tree_digest_equals_phase5=(None if phase5 is None
                                   else digest == phase5["tree_digest"]),
        memtable_entries=memtable_entries,
        levels_in_use=len([lvl for lvl in store._levels if lvl]),
        read_keys=checked, read_s=sum(wave_s),
        multi_get_keys_per_s=checked / sum(wave_s),
        wave_ms_p50=float(np.percentile(wave_s, 50) * 1e3),
        wave_ms_p99=float(np.percentile(wave_s, 99) * 1e3),
        cache_accounting_s=cache_s,
        read_cache_hit_blocks=reads.cache_hit_blocks,
        read_cache_miss_blocks=reads.cache_miss_blocks,
        read_blocks_read=reads.blocks_read, cache=cache,
        phase5_read_blocks_read=(None if phase5 is None else
                                 phase5["read_stats"].get("blocks_read", 0)),
        crash=dict(writes=int(batch.size), write_s=write_s,
                   queued_at_flush=queued_at_flush,
                   unsynced_writes=int(unsynced.size),
                   memtable_and_synced_bytes_at_crash=unsynced_in_wal,
                   queued_at_crash=queued_at_crash,
                   drain_s=drain_s, pins_after_crash=pins_after_crash,
                   recover_s=recover_s,
                   wal_replay_s=split["wal_replay"][0],
                   wal_replay_records=split["wal_replay"][1],
                   scrub_s=split["scrub"][0],
                   scrub_runs=len(report),
                   scrub_gb=sum(r.data_bytes for r in runs) / 1e9,
                   scrub_bad_blocks=sum(len(r["bad_blocks"])
                                        for r in report),
                   verified_keys=int(batch.size + unsynced.size + rest.size
                                     + dead.size),
                   verify_s=verify_s, wrong=wrong, health=health,
                   write_after_recovery=after_ok),
        launches={k: launches[k] for k in STORE_KERNELS},
        launches_by_thread=dict(by_thread),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(out)
    bad = []
    if phase5 is not None and not out["tree_digest_equals_phase5"]:
        bad.append("tree differs from phase 5's")
    if phase5 is not None and memtable_entries != phase5["memtable_entries"]:
        bad.append("the write buffer differs from phase 5's")
    if reads.blocks_read != reads.cache_miss_blocks:
        bad.append("blocks_read != cache misses")
    if phase5 is not None and reads.cache_hit_blocks \
            + reads.cache_miss_blocks != out["phase5_read_blocks_read"]:
        bad.append("hits + misses != phase 5's blocks read")
    if any(wrong.values()) or not after_ok:
        bad.append(f"wrong answers {wrong}")
    if unsynced_in_wal != [int(unsynced.size), 0]:
        bad.append(f"the unsynced tail was synced: {unsynced_in_wal}")
    if health != dict(degraded=False, bg_retries=0, bg_gave_up=0, pins=0) \
            or pins_after_crash:
        bad.append(f"health {health}")
    if out["crash"]["scrub_bad_blocks"]:
        bad.append("bad blocks")
    if not all(launches[k] for k in STORE_KERNELS):
        bad.append(f"store kernels not launched: {launches}")
    off_worker = {k: v for k, v in by_thread.items()
                  if not k.startswith("bloom_probe")
                  and not k.endswith("@" + worker)}
    if off_worker:
        bad.append(f"builds or merges off the worker thread: {off_worker}")
    if bad:
        raise AssertionError(f"durability phase failed: {bad}")
    return out


# ------------------------------------------------------------ phase 6b
def shard_oracle_state(ops, db):
    """Every run key of every shard (sorted, unique) and the shards'
    memtables' sorted entries, concatenated in shard order (the shards'
    ranges are disjoint and ascending, so the result is sorted)."""
    run_keys = np.unique(np.concatenate(
        [ops.keys_from_device(r.keys) for s in db.shards
         for lvl in s._levels for r in lvl if len(r)]))
    mem_keys, mem_items = [], []
    for s in db.shards:
        k, items = s.memtable.sorted_entries()
        mem_keys.append(k)
        mem_items.extend(items)
    return run_keys, np.concatenate(mem_keys), mem_items


def sharded_dbbench_part(torch, rt, ops, bloom, merge, seed: int,
                         n_entries: int, phase5_reads=None,
                         phase6=None) -> dict:
    """(a) Phase 5's fillrandom on four shards under one budget of four
    workers (``benchmarks/micro_dbbench.py``'s sharded lane), LevelDB's
    defaults per shard, default uniform splitters over the u64 space; the
    load timed until every shard quiesces; then phase 5's read waves,
    seeks and scans, every answer checked against oracles over the sharded
    store's own state and held against phase 5's."""
    cfg = rt.LSMConfig(**DB_BENCH, shards=4, async_compaction=True,
                       compaction_workers=4)
    db = rt.core.make_store(cfg)     # cuda:0
    n = len(db.shards)
    keys, deleted = fill_workload(seed, n_entries)
    sorted_keys = np.sort(keys)
    live = np.setdiff1d(keys, deleted)
    spent = {"flush": [0.0] * n, "compaction": [0.0] * n}

    def timed(kind, i, fn):
        def wrapper(*args):
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent[kind][i] += time.perf_counter() - t
            return out
        return wrapper

    for i, s in enumerate(db.shards):
        s._bg_flush = timed("flush", i, s._bg_flush)
        s._apply = timed("compaction", i, s._apply)
    with launches_by_thread(bloom, merge) as by_thread:
        chunk = min(500_000, -(-keys.size // 2))
        starts = list(range(0, keys.size, chunk))
        t0 = time.perf_counter()
        for i in starts[:-1]:
            kc = keys[i:i + chunk]
            db.put_batch(kc.tolist(), user_values(kc))
        load_s = time.perf_counter() - t0
        quiesce(db)
        torch.cuda.synchronize()
        drained_s = time.perf_counter() - t0
        load_spent = {k: list(v) for k, v in spent.items()}
        kc = keys[starts[-1]:]
        db.put_batch(kc.tolist(), user_values(kc))
        db.delete_batch(deleted.tolist())
        quiesce(db)
        load_launches = dict(by_thread)
    workers = sorted({k.split("@", 1)[1] for k in load_launches
                      if not k.startswith("bloom_probe")})
    shards_line = [dict(shard=si, lo=str(db._routing.bounds(si)[0]),
                        entries=sum(len(r) for lvl in s._levels
                                    for r in lvl),
                        levels=[sum(len(r) for r in lvl)
                                for lvl in s._levels],
                        run_device_bytes=run_device_bytes(s),
                        memtable_entries=len(s.memtable),
                        worker_flush_s=load_spent["flush"][si],
                        worker_compaction_s=load_spent["compaction"][si],
                        bg_flushes=s.stats.bg_flushes,
                        bg_compactions=s.stats.bg_compactions,
                        stall_ns=s.stats.stall_ns)
                   for si, s in enumerate(db.shards)]
    # phase 5's read waves
    wave_s, checked = [], 0
    for w, (q, want) in enumerate(read_waves(seed, sorted_keys, live,
                                             deleted)):
        t = time.perf_counter()
        got = db.multi_get(q.tolist())
        dt = time.perf_counter() - t
        if got != want:
            bad = sum(g != x for g, x in zip(got, want))
            raise AssertionError(f"sharded wave {w}: {bad} wrong answers")
        if w:
            wave_s.append(dt)
            checked += q.size
    waves3 = [q for w, (q, _) in zip(range(3), read_waves(
        seed, sorted_keys, live, deleted))]
    prof = profile_window(torch, lambda: [db.multi_get(q.tolist())
                                          for q in waves3])
    copies = prof.pop("copies", {})
    # phase 5's seeks and scans (drawn here when phase 5 did not run),
    # and scans and seeks from just below every splitter
    if phase5_reads is not None:
        seek_starts = phase5_reads["seek_starts"]
        scan_starts = phase5_reads["scan_starts"]
        lengths = phase5_reads["lengths"]
    else:
        rng = np.random.default_rng([seed, 10])
        dr = np.sort(deleted)
        seek_starts, scan_starts = (np.concatenate([
            rng.choice(live, 1000), rng.choice(dr, 500),
            rng.integers(0, 2**64 - 1, 500, dtype=np.uint64)])
            for _ in range(2))
        lengths = rng.integers(1, 101, scan_starts.size)
    edge = np.concatenate([live[max(0, j - 60):j:6] for j in
                           np.searchsorted(live, np.asarray(
                               db.splitters, dtype=np.uint64)).tolist()])
    t = time.perf_counter()
    got_seeks = [db.seek(int(a)) for a in seek_starts.tolist()]
    seek_s = time.perf_counter() - t
    scan_ms, got_scans = [], []
    for a, m in zip(scan_starts.tolist(), lengths.tolist()):
        t = time.perf_counter()
        got_scans.append(db.scan(a, m))
        scan_ms.append((time.perf_counter() - t) * 1e3)
    edge_scans = [db.scan(int(a), 100) for a in edge.tolist()]
    edge_seeks = [db.seek(int(a) + 1) for a in edge.tolist()]
    run_keys, mem_keys, mem_items = shard_oracle_state(ops, db)
    want_seeks = seek_oracle(run_keys, mem_keys, mem_items, seek_starts)
    want_edge_seeks = seek_oracle(run_keys, mem_keys, mem_items, edge + 1)

    def want_scan(a, m):
        at = int(np.searchsorted(live, a))
        k = live[at:at + m]
        return list(zip(k.tolist(), user_values(k)))

    wrong = dict(
        seeks=sum(g != w for g, w in zip(got_seeks, want_seeks)),
        scans=sum(g != want_scan(a, m) for a, m, g in zip(
            scan_starts.tolist(), lengths.tolist(), got_scans)),
        edge_seeks=sum(g != w for g, w in zip(edge_seeks, want_edge_seeks)),
        edge_scans=sum(g != want_scan(a, 100) for a, g in zip(
            edge.tolist(), edge_scans)))
    bounds = [db._routing.bounds(si) for si in range(n)]

    def shard_of(k):
        return next(si for si, (lo, hi) in enumerate(bounds) if lo <= k < hi)

    across = sum(1 for g in got_scans + edge_scans
                 if g and shard_of(g[0][0]) != shard_of(g[-1][0]))
    def member(arr, k) -> bool:
        i = int(np.searchsorted(arr, np.uint64(k)))
        return i < arr.size and int(arr[i]) == k

    dead = np.sort(deleted)
    vs5 = None
    if phase5_reads is not None:
        # Seeks keep the runs' approximate liveness (a run's entry answers
        # even when a memtable tombstone shadows it), so where the flush
        # boundaries differ, so may a seek, either way: phase 5 may answer
        # a deleted key its runs still held while no run of the shards
        # holds it (its put was overwritten by the delete in a shard's
        # memtable, or a compaction dropped both), and the shards may
        # answer a deleted key one of their runs holds while phase 5's
        # runs did not (phase 5's own answer, checked against its state,
        # passed it), their next answer after it being phase 5's.  Any
        # other difference is a fault.
        p5_seeks, p5_scans = phase5_reads["seeks"], phase5_reads["scans"]
        # each differing seek beside its own store's oracle answer
        differ = [(a, g, p, w, w5) for a, g, p, w, w5 in zip(
            seek_starts.tolist(), got_seeks, p5_seeks, want_seeks,
            phase5_reads["want_seeks"]) if g != p]

        def explained(g, p) -> bool:
            if p is None or g is None:
                return False
            if g > p:
                return member(dead, p) and not member(run_keys, p)
            return member(dead, g) and member(run_keys, g) \
                and db.seek(g + 1) == p

        vs5 = dict(scans_equal=got_scans == p5_scans,
                   seeks_equal=len(got_seeks) - len(differ),
                   seeks_differ=len(differ),
                   seeks_differ_unexplained=sum(
                       1 for _, g, p, _, _ in differ
                       if not explained(g, p)),
                   differing_seeks=[dict(
                       start=str(a), shards=str(g), phase5=str(p),
                       shards_oracle=str(w), phase5_oracle=str(w5),
                       both_match_oracle=g == w and p == w5,
                       shards_dead=g is not None and member(dead, g),
                       shards_run_holds=g is not None
                       and member(run_keys, g),
                       phase5_dead=p is not None and member(dead, p),
                       explained=explained(g, p))
                       for a, g, p, w, w5 in differ[:10]])
    out = dict(
        part="a_dbbench", shards=n, entries=int(keys.size),
        config={k: v for k, v in dataclasses.asdict(cfg).items()
                if k in ("shards", "async_compaction", "compaction_workers",
                         "memtable_bytes", "block_size", "bits_per_key",
                         "l0_compaction_trigger")},
        splitters=[str(x) for x in db.splitters],
        load_timed_entries=starts[-1], load_s=load_s,
        load_entries_per_s=starts[-1] / load_s,
        load_drained_s=drained_s,
        load_drained_entries_per_s=starts[-1] / drained_s,
        phase6_one_shard_drained_entries_per_s=(
            None if phase6 is None
            else phase6["load_drained_entries_per_s"]),
        per_shard=shards_line, levels_in_use=db.num_levels_in_use,
        run_device_bytes=run_device_bytes(db),
        load_launches_by_thread=load_launches, launching_workers=workers,
        read_keys=checked, read_s=sum(wave_s),
        multi_get_keys_per_s=checked / sum(wave_s),
        wave_ms_p50=float(np.percentile(wave_s, 50) * 1e3),
        wave_ms_p99=float(np.percentile(wave_s, 99) * 1e3),
        read_profile_3_waves=prof,
        d2h_copies_per_wave=sum(c for k, c in copies.items()
                                if "DtoH" in k) / 3,
        h2d_copies_per_wave=sum(c for k, c in copies.items()
                                if "HtoD" in k) / 3,
        seeks=len(got_seeks), seeks_per_s=len(got_seeks) / seek_s,
        scans=len(got_scans), scans_per_s=len(got_scans)
        / (sum(scan_ms) / 1e3),
        scan_ms_p50=float(np.percentile(scan_ms, 50)),
        scan_ms_p99=float(np.percentile(scan_ms, 99)),
        splitter_scans=len(edge_scans), scans_across_shards=across,
        wrong=wrong, versus_phase5=vs5,
        health=dict(degraded=db.degraded,
                    bg_retries=db.stats.bg_retries,
                    bg_gave_up=db.stats.bg_gave_up))
    db.close()
    bad = []
    if any(wrong.values()):
        bad.append(f"wrong answers {wrong}")
    if len(workers) < 2:
        bad.append(f"builds and merges from fewer than two workers: "
                   f"{workers}")
    if across == 0:
        bad.append("no scan crossed a shard boundary")
    if vs5 is not None and (not vs5["scans_equal"]
                            or vs5["seeks_differ_unexplained"]):
        bad.append(f"answers differ from phase 5's: {vs5}")
    if any(out["health"].values()):
        bad.append(f"health {out['health']}")
    return out, bad


def rebalance_part(torch, rt, seed: int, n_keys: int = 1_000_000,
                   n_ops: int = 1 << 20, batch: int = 4096) -> tuple:
    """(b) YCSB's ``hotspot`` (``benchmarks/ycsb.py``'s skew gauntlet: 90%
    of operations on the first tenth of the key space) on four shards of
    1M dense keys, bulk-loaded unarmed then armed (``arm_rebalancing``),
    half reads and half updates in batches of 4,096 beside a one-store
    oracle on the same card; then a crash and recovery of the facade."""
    base = dict(DB_BENCH, async_compaction=True, compaction_workers=4)
    db = rt.core.make_store(rt.LSMConfig(
        **base, shards=4,
        shard_splitters=rt.core.uniform_splitters(4, n_keys)))
    oracle = rt.LSMStore(rt.LSMConfig(**DB_BENCH))
    val0 = bytes(range(100))
    load = np.arange(n_keys, dtype=np.uint64)
    t = time.perf_counter()
    for i in range(0, n_keys, batch):
        db.put_batch(load[i:i + batch].tolist(), val0)
    db.flush()
    quiesce(db)
    preload_s = time.perf_counter() - t
    for i in range(0, n_keys, batch):
        oracle.put_batch(load[i:i + batch].tolist(), val0)
    oracle.flush()
    db.arm_rebalancing(max(2000, n_ops // 16), ratio=1.4)
    snap = db.get_snapshot()
    rng = np.random.default_rng([seed, 9])
    probe = rng.choice(n_keys, 8192, replace=False).astype(np.uint64)
    snap_before = db.multi_get(probe.tolist(), snapshot=snap)
    hot = rng.random(n_ops) < 0.9
    stream = np.where(hot, rng.integers(0, n_keys // 10, n_ops,
                                        dtype=np.uint64),
                      rng.integers(0, n_keys, n_ops, dtype=np.uint64))
    events = []
    inner = db._rebalance_to

    def measured(*args):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        done = inner(*args)
        torch.cuda.synchronize()
        events.append(dict(landed=done, s=time.perf_counter() - t1,
                           device_bytes_before=m0,
                           device_bytes_peak=torch.cuda.max_memory_allocated(),
                           device_bytes_after=torch.cuda.memory_allocated(),
                           splitters=[str(x) for x in db.splitters]))
        return done

    db._rebalance_to = measured
    loads = [(0, db.shard_load_ops())]
    wrong_reads = reads = 0
    t = time.perf_counter()
    for wi, i in enumerate(range(0, n_ops, batch)):
        wave = stream[i:i + batch].tolist()
        if wi % 2 == 0:
            val = (b"%08d" % wi) * 12 + b"hot!"
            db.put_batch(wave, val)
            oracle.put_batch(wave, val)
        else:
            got = db.multi_get(wave)
            wrong_reads += sum(g != w for g, w in
                               zip(got, oracle.multi_get(wave)))
            reads += len(wave)
        loads.append((db.rebalances, db.shard_load_ops()))
    traffic_s = time.perf_counter() - t
    db.flush()
    quiesce(db)
    oracle.flush()
    del db._rebalance_to

    def imbalance(a, b):
        d = [y - x for x, y in zip(a, b)]
        return max(d) * len(d) / sum(d) if sum(d) else 1.0

    first = next((j for j, (r, _) in enumerate(loads) if r > 0), None)
    last = next((j for j in range(len(loads) - 1, -1, -1)
                 if loads[j][0] < db.rebalances), None)
    share_before = imbalance(loads[0][1], loads[first][1]) \
        if first else None
    share_after = imbalance(loads[last + 1][1], loads[-1][1]) \
        if last is not None and last + 1 < len(loads) - 1 else None

    def all_keys_wrong():
        bad = 0
        for i in range(0, n_keys, 65_536):
            ks = load[i:i + 65_536].tolist()
            bad += sum(g != w for g, w in zip(db.multi_get(ks),
                                              oracle.multi_get(ks)))
        return bad

    wrong_after_traffic = all_keys_wrong()
    snap_after = db.multi_get(probe.tolist(), snapshot=snap)
    db.release_snapshot(snap)
    pins = [s.manifest.total_pin_refs() for s in db.shards]
    epoch, splitters = db._routing.epoch, db.splitters
    t = time.perf_counter()
    db.crash()
    db.recover()
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t
    wrong_after_recovery = all_keys_wrong()
    routing_kept = (db._routing.epoch, db.splitters) == (epoch, splitters)
    out = dict(
        part="b_rebalance", shards=4, keys=n_keys, operations=n_ops,
        batch=batch, reads=reads, preload_s=preload_s,
        traffic_s=traffic_s, ops_per_s=n_ops / traffic_s,
        rebalances=db.rebalances, migrated_entries=db.migrated_entries,
        migration_s=dict(db.migration_s), rebalance_events=events,
        initial_splitters=[str(x) for x in
                           rt.core.uniform_splitters(4, n_keys)],
        final_splitters=[str(x) for x in db.splitters],
        routing_epoch=epoch,
        load_share_max_over_mean_before=share_before,
        load_share_max_over_mean_after=share_after,
        wrong_reads=wrong_reads, wrong_after_traffic=wrong_after_traffic,
        snapshot_unchanged=snap_after == snap_before,
        pins_after_release=pins, recover_s=recover_s,
        wrong_after_recovery=wrong_after_recovery,
        routing_survived_recovery=routing_kept)
    bad = []
    if wrong_reads or wrong_after_traffic or wrong_after_recovery:
        bad.append("reads differ from the oracle")
    if db.rebalances < 1:
        bad.append("no rebalance")
    if snap_after != snap_before or snap_before != [val0] * probe.size:
        bad.append("the snapshot moved")
    if any(pins):
        bad.append(f"pins leaked {pins}")
    if not routing_kept:
        bad.append("routing epoch lost in recovery")
    db.close()
    return out, bad


def leaf_bits(torch, t):
    return t.detach().reshape(-1).view(torch.uint8)


# layers of smollm_135m's 30 that phase 6b c's one- and two-shard runs
# save: a depth cut for the call's time budget (on H100 hosts the script
# took 1,318.6 s with all 30 on one shard and 993.3 s with 10 on each,
# against its 1,000 s)
CHECKPOINT_LAYERS = 2


def checkpoint_part(torch, rt, seed: int, dev) -> tuple:
    """(c) smollm_135m's parameters at full width (random from the seed),
    the first ``CHECKPOINT_LAYERS`` layers of its stage with the embedding,
    through the delta-checkpoint store on the card, with one shard and
    with two: step 0, step 1 with a few leaves changed (the other leaves'
    chunks skipped), then crash, recovery and restores of both steps."""
    from repro_torch.checkpoint import CHUNK_BYTES, CheckpointStore
    from repro_torch.checkpoint import store as ck_store
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_params
    from repro_torch.models.params import tree_map
    cfg = get_config("smollm_135m")
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                       dev)
    runs, bad = [], []
    for shards, layers in ((1, CHECKPOINT_LAYERS), (2, CHECKPOINT_LAYERS)):
        params = full if layers == cfg.n_layers else {
            **full, "stages": tree_map(lambda t: t[:layers], full["stages"])}
        flat = list(ck_store._leaf_paths(params))
        nbytes = sum(t.numel() * t.element_size() for _, t in flat)
        chunks_of = {p: max(1, -(-t.numel() * t.element_size()
                                 // CHUNK_BYTES)) for p, t in flat}
        # a few leaves change between the steps: the final norm, the first
        # stage's attention norm and one projection
        changed = [p for p, _ in flat if "norm" in p][:2] \
            + [p for p, t in flat if t.dim() >= 2][1:3]
        step1 = {p: (t + 1.0 if p in changed else t) for p, t in flat}
        n_chunks = sum(chunks_of.values())
        # two shards split the chunk ids in half (the manifests, at 2^62
        # and up, go to the upper one)
        lsm = dataclasses.replace(
            ck_store.store_config(), shards=shards,
            shard_splitters=(n_chunks // 2,) if shards > 1 else None)
        st = CheckpointStore(lsm, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        st.save(0, params)
        torch.cuda.synchronize()
        save0_s = time.perf_counter() - t
        w0, k0 = st.stats_chunks_written, st.stats_deltas_skipped
        tree1 = ck_store._unflatten(params, iter(
            [step1[p] for p, _ in ck_store._leaf_paths(params)]))
        t = time.perf_counter()
        st.save(1, tree1)
        torch.cuda.synchronize()
        save1_s = time.perf_counter() - t
        written = st.stats_chunks_written - w0
        skipped = st.stats_deltas_skipped - k0
        t = time.perf_counter()
        st.crash()
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t
        latest = st.latest_step()
        got, restore_s = {}, {}
        for step in (1, 0):
            t = time.perf_counter()
            got[step] = st.restore(step)
            torch.cuda.synchronize()
            restore_s[step] = time.perf_counter() - t
        # single-latest retention: step 0's manifest reads the chunks its
        # unchanged leaves share with step 1, and the changed leaves'
        # slots now hold step 1's bytes
        exact = {step: all(
            got[step][p].device == dev and got[step][p].dtype == t.dtype
            and torch.equal(leaf_bits(torch, got[step][p]),
                            leaf_bits(torch, step1[p]))
            for p, t in flat) for step in (0, 1)}
        levels = st.db.num_levels_in_use
        runs.append(dict(
            shards=shards, layers=f"{layers} of {cfg.n_layers}",
            bytes=nbytes, leaves=len(flat), changed_leaves=changed,
            save0_s=save0_s,
            save0_mb_per_s=nbytes / 1e6 / save0_s, save1_s=save1_s,
            chunks=n_chunks, chunks_written_step1=written,
            chunks_skipped_step1=skipped, crash_recover_s=recover_s,
            latest_step=latest,
            restore_s={str(k): v for k, v in restore_s.items()},
            restore_mb_per_s={str(k): nbytes / 1e6 / v
                              for k, v in restore_s.items()},
            bit_exact={str(k): v for k, v in exact.items()},
            levels_in_use=levels, run_device_bytes=run_device_bytes(st.db),
            entries_by_shard=[s.total_entries for s in
                              getattr(st.db, "shards", [st.db])]))
        want_written = sum(chunks_of[p] for p in changed)
        if written != want_written or skipped != n_chunks - want_written:
            bad.append(f"shards={shards}: delta skip wrong "
                       f"({written} written, {skipped} skipped)")
        if latest != 1 or not all(exact.values()):
            bad.append(f"shards={shards}: restore not bit-exact {exact}")
        del st, got
        torch.cuda.empty_cache()
    out = dict(part="c_checkpoint", model=cfg.name,
               params=count_params(cfg), runs=runs,
               reduced=dict(one_shard_layers=f"{CHECKPOINT_LAYERS} of "
                                             f"{cfg.n_layers}",
                            two_shard_layers=f"{CHECKPOINT_LAYERS} of "
                                             f"{cfg.n_layers}"))
    return out, bad


def sharded_phase(torch, rt, ops, bloom, merge, seed: int, n_entries: int,
                  phase5_reads=None, phase6=None) -> dict:
    """Phase 6b: the sharded facade's main paths (db_bench on four shards,
    rebalancing under a hotspot, checkpoints), with the store kernels'
    launches counted from zero."""
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    a, bad_a = sharded_dbbench_part(torch, rt, ops, bloom, merge, seed,
                                    n_entries, phase5_reads, phase6)
    emit({"phase": "sharded", **a})
    torch.cuda.empty_cache()
    b, bad_b = rebalance_part(torch, rt, seed)
    emit({"phase": "sharded", **b})
    torch.cuda.empty_cache()
    c, bad_c = checkpoint_part(torch, rt, seed, torch.device("cuda:0"))
    emit({"phase": "sharded", **c})
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    plain = dict(ops.PLAIN_CALLS)
    out = dict(phase="sharded", part="summary",
               s=time.perf_counter() - t,
               checkpoint_save0_mb_per_s=c["runs"][0]["save0_mb_per_s"],
               launches={k: launches[k] for k in STORE_KERNELS},
               plain_calls={k: v for k, v in plain.items() if v},
               max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(out)
    bad = bad_a + bad_b + bad_c
    if not all(launches[k] for k in STORE_KERNELS):
        bad.append(f"store kernels not launched: {launches}")
    if any(plain.values()):
        bad.append(f"plain versions ran on the card's path: {plain}")
    if bad:
        raise AssertionError(f"sharded phase failed: {bad}")
    return out


# ------------------------------------------------------------ phase 7
ATTN_KERNELS = ("flash_attention", "paged_attention")


def serve_cell(torch, ops, dev, seed: int, cfg, phase: str,
               n_waves: int = 3, extras=None, use_prefix_cache: bool = True,
               reduced=None, profile: bool = False, after=None,
               keep=None) -> dict:
    """One configuration at full width (random weights from the seed) over
    AutumnKV, or with no prefix cache: the waves of
    examples/serve_autumnkv.py at 4 x 512-token prompts (8 pages each) and
    16 decoded tokens (cold, warm, then mixed when ``n_waves`` is 3), every
    check of the reference's semantics, the launches of this run alone.
    ``after(eng, rng, shared)`` runs more requests on the same engine and
    returns (records, checks).  The engine is freed before returning,
    unless ``keep`` (a dict) takes it and the waves' shared prompt."""
    from repro_torch.models import count_params, init_params
    from repro_torch.models.blocks import SELF_ATTN_KINDS
    from repro_torch.serve import Request, ServeEngine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    eng = ServeEngine(cfg, params, batch=4, s_max=1024,
                      use_prefix_cache=use_prefix_cache, device=dev)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, 512, dtype=np.int32)
    other = rng.integers(0, cfg.vocab, 512, dtype=np.int32)
    gen = 16
    waves = [("cold", [shared] * 4), ("warm", [shared] * 4),
             ("mixed", [other] * 2 + [shared] * 2)][:n_waves]
    # host seconds each shard's worker spends in flushes and compactions,
    # which overlap the requests (not device-synced: no perturbation)
    db = eng.kv.db if eng.kv is not None else None
    shards = getattr(db, "shards", [db]) if db is not None else []
    busy = [0.0] * len(shards)

    def worker_timed(fn, i):
        def wrapper(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                busy[i] += time.perf_counter() - t
        return wrapper

    for i, sh in enumerate(shards):
        sh._bg_flush = worker_timed(sh._bg_flush, i)
        sh._bg_compact_one = worker_timed(sh._bg_compact_one, i)
    ops.reset_launch_counts()
    outs, per_wave = [], []
    for name, prompts in waves:
        backlog = sum(sh._scheduler.pending() for sh in shards)
        busy0 = list(busy)
        t = time.perf_counter()
        out = eng.serve_batch([Request(p, gen) for p in prompts], extras)
        wall = time.perf_counter() - t
        tm = eng.last_timings
        st = eng.kv.stats() if eng.kv is not None else {}
        per_wave.append(dict(
            model=cfg.name, wave=name, wall_ms=wall * 1e3,
            lookup_ms=tm["lookup_s"] * 1e3,
            prefill_ms=tm["prefill_s"] * 1e3, insert_ms=tm["insert_s"] * 1e3,
            decode_step_ms_p50=float(np.percentile(tm["decode_step_s"], 50)
                                     * 1e3),
            decoded_tokens_per_s=len(prompts) * gen
            / sum(tm["decode_step_s"]),
            hits=st.get("hits", 0), pages_written=st.get("pages_written", 0),
            pages_deduped=st.get("pages_deduped", 0),
            store_jobs_queued_at_start=backlog,
            store_worker_busy_ms=sum(busy) * 1e3 - sum(busy0) * 1e3,
            store_worker_busy_ms_by_shard=[(b - b0) * 1e3 for b, b0
                                           in zip(busy, busy0)]))
        emit({"phase": f"{phase}_wave", **per_wave[-1]})
        outs.append(np.stack(out))
    launches = ops.launch_counts()
    plain = dict(ops.PLAIN_CALLS)
    hits = [w["hits"] for w in per_wave]
    want_hits = [0, 4, 6][:n_waves] if db is not None else [0] * n_waves
    checks = {
        f"hits_{'_'.join(map(str, want_hits))}": hits == want_hits,
        "warm_equals_cold": np.array_equal(outs[1], outs[0]),
        "tokens_in_vocab": all(((o >= 0) & (o < cfg.vocab)).all()
                               for o in outs),
        "no_plain_calls": not any(plain.values()),
    }
    if n_waves == 3:
        checks["mixed_hits_equal_cold"] = np.array_equal(outs[2][2:],
                                                         outs[0][2:])
        checks["mixed_misses_agree"] = np.array_equal(outs[2][0], outs[2][1])
    st = {}
    if db is not None:
        quiesce(db)
        st = eng.kv.stats()
        written, deduped = (16, 32) if n_waves == 3 else (8, 24)
        checks[f"pages_written_{written}"] = st["pages_written"] == written
        checks[f"pages_deduped_{deduped}"] = st["pages_deduped"] == deduped
        checks["store_async_cached"] = all(
            sh._scheduler is not None for sh in shards) \
            and st["block_cache"]["enabled"]
        checks["store_on_two_shards"] = len(shards) == 2
        checks["store_not_degraded"] = not db.degraded \
            and st["io"]["bg_retries"] == st["io"]["bg_gave_up"] == 0
    if n_waves == 3 and db is not None:
        checks["every_kernel_launched"] = all(launches[k] > 0
                                              for k in KERNELS)
    else:
        if db is not None:
            checks["store_kernels_launched"] = \
                launches["bloom_build"] > 0 and launches["bloom_probe"] > 0
        if any(k in SELF_ATTN_KINDS for k in cfg.layer_pattern):
            checks["attention_kernels_launched"] = all(
                launches[k] > 0 for k in ATTN_KERNELS)
        else:
            checks["no_attention_kernel"] = not any(
                launches[k] for k in ATTN_KERNELS)
    out = dict(phase=phase, model=cfg.name, params=count_params(cfg),
               layers=cfg.n_layers, batch=4, s_max=1024, prompt_tokens=512,
               gen_len=gen, prefix_cache=db is not None,
               extras=sorted(extras or {}), setup_s=setup_s, waves=per_wave)
    if reduced:
        out["reduced"] = reduced
    if after is not None:
        records, more = after(eng, rng, shared)
        out.update(records)
        checks.update(more)
    if profile:
        # the device's idle share over one more warm wave, under the
        # profiler, with the store's background work drained (above)
        prof = profile_window(torch, lambda: eng.serve_batch(
            [Request(shared, gen)] * 4, extras))
        prof["decode_step_ms_p50"] = float(np.percentile(
            eng.last_timings["decode_step_s"], 50) * 1e3)
        out["warm_wave_profile"] = prof
    if st:
        out.update(levels=st["levels"],
                   store_io={k: v for k, v in st["io"].items() if v},
                   block_cache=st["block_cache"])
    out.update(launches=launches, plain_calls=plain,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               checks=checks)
    emit(out)
    if keep is not None:
        keep.update(engine=eng, shared=shared)
    else:
        eng.close()
    del eng
    torch.cuda.empty_cache()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{phase} {cfg.name} failed: {bad}")
    return out


def serve_phase(torch, ops, dev, seed: int, keep=None) -> dict:
    """qwen3_4b at full width over AutumnKV: cold, warm and mixed waves."""
    from repro_torch.configs import get_config
    return serve_cell(torch, ops, dev, seed, get_config("qwen3_4b"), "serve",
                      profile=True, keep=keep)


def serve_equivalence(torch, dev, seed: int, arch: str = "qwen3_4b"
                      ) -> dict:
    """A smoke config served on the card (kernels) and on the CPU (plain
    versions) at float32 from the same weights (and stubbed extras):
    equal tokens."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import stub_frontend_inputs
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    extras = stub_frontend_inputs(cfg, 2, seed) or None
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, cfg.vocab, 128, dtype=np.int32)
            for _ in range(2))
    tokens = []
    for device in (dev, "cpu"):
        eng = ServeEngine(cfg, params, batch=2, s_max=160, device=device)
        tokens.append([np.stack(eng.serve_batch([Request(p, 40)] * 2,
                                                extras))
                       for p in (a, b, a)])
        eng.close()
    same = all(np.array_equal(x, y) for x, y in zip(*tokens))
    out = dict(phase="serve_equivalence", model=cfg.name,
               compute_dtype="float32", same_tokens=same)
    emit(out)
    if not same:
        raise AssertionError(f"CUDA serving of {cfg.name} differs from CPU "
                             f"serving")
    return out


# ------------------------------------------------------------ phase 8
def long_prompt_case(eng, rng, shared):
    """gemma3_1b: two 1,024-token prompts sharing their first page with
    the 512-token prompt of the waves (which fits the 512-slot local
    rings; these wrap them), served miss, miss, hit: the hit decodes the
    miss's tokens (the reference's ring-page fault, repaired)."""
    from repro_torch.serve import Request
    tail = [rng.integers(0, eng.cfg.vocab, 960, dtype=np.int32)
            for _ in range(2)]
    long1, long2 = (np.concatenate([shared[:64], t]) for t in tail)
    hits0 = eng.kv.hits
    t = time.perf_counter()
    got = [eng.serve_batch([Request(p, 16)])[0] for p in (long1, long2,
                                                          long2)]
    wall = time.perf_counter() - t
    quiesce(eng.kv.db)
    records = dict(long_prompt=dict(
        tokens=1024, wall_ms=wall * 1e3, hits=eng.kv.hits - hits0,
        wrapped_ring_extents=eng.kv.codec.wrapped_extents(1024)))
    return records, {"long_prompt_hit_equals_miss":
                     np.array_equal(got[2], got[1]),
                     "long_prompt_one_hit": eng.kv.hits - hits0 == 1}


# every other configuration after the headline gemma3_1b: (arch, layers
# kept or None for all, extras, prefix cache)
FAMILY_CELLS = (
    ("recurrentgemma_2b", None, False, True),
    ("mamba2_130m", None, False, True),
    ("granite_moe_1b_a400m", None, False, True),
    ("minicpm_2b", None, False, True),
    ("whisper_medium", None, True, False),
    ("mixtral_8x22b", 2, False, True),
    ("llama32_vision_90b", 5, True, False),
)


def families_phase(torch, ops, dev, seed: int) -> dict:
    """Phase 8: gemma3_1b at full size through phase 7's three waves and
    the long-prompt case, then one cold and one warm wave of every other
    configuration at full width (mixtral and llama32 at cut depth: neither
    fits one card whole), then every family's smoke config on the card and
    on the CPU."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import stub_frontend_inputs
    cells = [serve_cell(torch, ops, dev, seed, get_config("gemma3_1b"),
                        "families", profile=True, after=long_prompt_case)]
    for arch, keep, with_extras, prefix in FAMILY_CELLS:
        cfg = get_config(arch)
        reduced = None
        if keep is not None:
            reduced = dict(layers=f"{keep} of {cfg.n_layers}",
                           pattern=list(cfg.layer_pattern[:keep]))
            cfg = dataclasses.replace(cfg, n_layers=keep,
                                      layer_pattern=cfg.layer_pattern[:keep])
        extras = stub_frontend_inputs(cfg, 4, seed) if with_extras else None
        cells.append(serve_cell(torch, ops, dev, seed, cfg, "families",
                                n_waves=2, extras=extras,
                                use_prefix_cache=prefix, reduced=reduced))
    for arch in ARCH_IDS:
        serve_equivalence(torch, dev, seed, arch)
    launches = {}
    for c in cells:
        for k, n in c["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out = dict(phase="families", models=[c["model"] for c in cells],
               launches=launches)
    emit(out)
    return out


# ------------------------------------------------------------ phase 9
def leaves_equal_bits(torch, a, b) -> list:
    """Paths of the leaves of two trees that differ in shape, dtype or a
    bit."""
    from repro_torch.models.params import tree_leaves
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["tree structure"]
    return [p for (p, x), (_, y) in zip(la, lb)
            if x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(leaf_bits(torch, x), leaf_bits(torch, y))]


def train_full_part(torch, dev, seed: int, warmup: int = 3,
                    timed: int = 10) -> tuple:
    """(a) smollm_135m at full width: float32 parameters, bf16 compute,
    remat as its config sets it, SyntheticTokens at global batch 8 x 2,048
    (SmolLM's context), AdamW with WSD; ``warmup`` steps, then ``timed``
    steps one by one (host clock, device synchronised), then two more
    under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import Trainer
    from repro_torch.models import count_params
    from repro_torch.train import OptConfig
    cfg = get_config("smollm_135m")
    steps = warmup + timed
    data = DataConfig(vocab=cfg.vocab, seq_len=2048, global_batch=8,
                      seed=seed)
    tr = Trainer(cfg, OptConfig(peak_lr=1e-3, warmup_steps=2,
                                total_steps=steps + 2, schedule="wsd"),
                 data, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tr.init(seed, try_restore=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    losses, step_ms = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = tr.train_step(tr.batch_for(tr.step))
        tr.step += 1
        losses.append(float(m["loss"]))          # synchronises
        if i >= warmup:
            step_ms.append((time.perf_counter() - t) * 1e3)
    prof = profile_window(torch, lambda: [
        tr.train_step(tr.batch_for(s)) for s in (steps, steps + 1)])
    tokens = data.global_batch * data.seq_len
    p50 = nearest_rank(step_ms, 50)
    out = dict(part="a_smollm_full", model=cfg.name,
               params=count_params(cfg), layers=cfg.n_layers,
               d_model=cfg.d_model, vocab=cfg.vocab,
               compute_dtype=cfg.compute_dtype, remat=cfg.remat,
               remat2=cfg.remat2, q_chunk=cfg.q_chunk,
               loss_chunk=cfg.loss_chunk, global_batch=data.global_batch,
               seq_len=data.seq_len, tokens_per_step=tokens,
               schedule="wsd", init_s=init_s, warmup_steps=warmup,
               timed_steps=timed, step_ms=step_ms, step_ms_p50=p50,
               step_ms_p99=nearest_rank(step_ms, 99),
               tokens_per_s=tokens / (p50 / 1e3),
               loss_step0=losses[0], loss_step13=losses[-1],
               losses=losses, profile_two_steps=prof,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    bad = []
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        bad.append(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    del tr
    torch.cuda.empty_cache()
    return out, bad


def train_equivalence_part(torch, dev, seed: int) -> tuple:
    """(b) Every family's smoke config (float32, B 2, S 16, stubbed extras)
    from the same parameters and batch on the card and on the CPU: every
    gradient leaf within 1e-4 of max(1, |leaf|), then one make_train_step
    step (AdamW at lr 1e-4) with loss, grad_norm and every updated
    parameter within 1e-4 (rtol and atol).  AdamW's first step is about
    g / (|g| + eps): where a gradient is near eps (1e-8) a rounding of it
    moves the update by up to lr; ``adam_lr_1e_3`` applies AdamW at lr 1e-3
    to the card's and the CPU's gradients alike on the CPU and reports the
    largest parameter difference and the two gradients under it."""
    from repro_torch.configs import ARCH_IDS, get_smoke
    from repro_torch.data import stub_frontend_inputs
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.models import init_params
    from repro_torch.models import train as T
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import (OptConfig, adamw_update, init_opt_state,
                                   make_train_step)
    rows, bad = [], []
    on = lambda tree: tree_map(lambda x: x.to(dev), tree)
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1),
                 **stub_frontend_inputs(cfg, 2, seed)}
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, want_g = T.value_and_grad(params, batch, cfg)
        with deterministic_algorithms():
            _, got_g = T.value_and_grad(on(params), on(batch), cfg)
        got_g = tree_map(lambda x: x.cpu(), got_g)
        grad_err = max(float((a - b).abs().max())
                       / max(1.0, float(b.abs().max()))
                       for (_, a), (_, b) in zip(tree_leaves(got_g),
                                                 tree_leaves(want_g)))
        step = make_train_step(cfg, OptConfig(peak_lr=1e-4, warmup_steps=1,
                                              total_steps=10))
        want_p, _, want_m = step(params, init_opt_state(params), batch)
        t = time.perf_counter()
        with deterministic_algorithms():
            got_p, _, got_m = step(on(params), init_opt_state(on(params)),
                                   on(batch))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        errs = {k: abs(float(got_m[k]) - float(want_m[k]))
                for k in ("loss", "grad_norm")}
        ok = grad_err <= 1e-4 and all(
            e <= 1e-4 + 1e-4 * abs(float(want_m[k])) for k, e in errs.items())
        worst = 0.0
        for (_, a), (_, b) in zip(tree_leaves(got_p), tree_leaves(want_p)):
            a = a.cpu()
            worst = max(worst, float((a - b).abs().max()))
            ok &= bool(torch.allclose(a, b, rtol=1e-4, atol=1e-4))
        opt3 = OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
        p_cpu = adamw_update(params, want_g, init_opt_state(params), opt3)[0]
        p_card = adamw_update(params, got_g, init_opt_state(params), opt3)[0]
        lr3 = dict(param_max_abs_err=0.0)
        for (path, a), (_, b), (_, ga), (_, gb) in zip(
                tree_leaves(p_card), tree_leaves(p_cpu),
                tree_leaves(got_g), tree_leaves(want_g)):
            d = (a - b).abs().flatten()
            i = int(d.argmax())
            if float(d[i]) > lr3["param_max_abs_err"]:
                lr3 = dict(param_max_abs_err=float(d[i]), leaf=path,
                           grad_card=float(ga.flatten()[i]),
                           grad_cpu=float(gb.flatten()[i]))
        rows.append(dict(model=cfg.name, loss=float(got_m["loss"]),
                         grad_err_of_leaf_max=grad_err,
                         loss_err=errs["loss"],
                         grad_norm_err=errs["grad_norm"],
                         param_max_abs_err=worst, card_step_s=card_s,
                         within_1e_4=ok, adam_lr_1e_3=lr3))
        if not ok:
            bad.append(f"{cfg.name}: card step differs from the CPU's")
    return dict(part="b_families_card_vs_cpu", compute_dtype="float32",
                lr=1e-4, tolerance=1e-4, models=rows), bad


def train_resume_part(torch, ops, bloom, merge, dev, seed: int,
                      mesh=None) -> tuple:
    """(c) The reference test's trainer (smollm_135m SMOKE, seq 32, batch 4,
    WSD, a checkpoint every 5 steps) through a CheckpointStore on the card:
    train(20) against train(12) + simulate_crash + restore at step 10 +
    train(10..20), every parameter and optimizer leaf by bits; the store
    kernels' launches by thread, save and restore seconds.  ``mesh``: the
    trainers' device mesh shape."""
    from repro_torch.launch.sharding import full_tree
    from repro_torch.checkpoint import AsyncCheckpointer, CheckpointStore
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import SimulatedHostFailure, Trainer
    from repro_torch.train import OptConfig
    cfg = get_smoke("smollm_135m")
    saves = []

    def timed_store():
        st = CheckpointStore(device=dev)
        save = st.save

        def timed_save(step, tree):
            t = time.perf_counter()
            out = save(step, tree)
            torch.cuda.synchronize()
            saves.append(time.perf_counter() - t)
            return out
        st.save = timed_save
        return st

    def mk():
        return Trainer(cfg, OptConfig(peak_lr=1e-3, warmup_steps=2,
                                      total_steps=20, schedule="wsd"),
                       DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4),
                       store=timed_store(), checkpoint_every=5, mesh=mesh,
                       device=dev)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with launches_by_thread(bloom, merge) as by_thread:
        tr1 = mk()
        tr1.init(seed, try_restore=False)
        tr1.run(20, log_every=100)
        tr2 = mk()
        tr2.init(seed, try_restore=False)
        failed_at = None
        try:
            tr2.run(20, inject_failure_at=12, log_every=100)
        except SimulatedHostFailure as e:
            failed_at = e.step
        t = time.perf_counter()
        tr2.simulate_crash()
        torch.cuda.synchronize()
        crash_s = time.perf_counter() - t
        t = time.perf_counter()
        resumed = tr2.init(seed, try_restore=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        step_leaf = tr2.opt_state["step"]
        tr2.ckpt = AsyncCheckpointer(tr2.store)
        tr2.run(20, log_every=100)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    differ = leaves_equal_bits(torch, full_tree(tr1.params),
                               full_tree(tr2.params)) \
        + leaves_equal_bits(torch, full_tree(tr1.opt_state),
                            full_tree(tr2.opt_state))
    out = dict(part="c_crash_resume", model=cfg.name, seq_len=32,
               mesh=list(mesh) if mesh else None,
               global_batch=4, checkpoint_every=5, failed_at=failed_at,
               resumed_at=resumed,
               restored_step_leaf=[list(step_leaf.shape),
                                   str(step_leaf.dtype), int(step_leaf)],
               bit_exact=not differ, differing_leaves=differ[:8],
               saves=len(saves), save_s=saves, crash_recover_s=crash_s,
               restore_s=restore_s, part_s=time.perf_counter() - t0,
               launches={k: launches[k] for k in STORE_KERNELS},
               launches_by_thread=dict(sorted(by_thread.items())),
               store_levels=tr2.store.db.num_levels_in_use)
    bad = []
    if failed_at != 12 or resumed != 10 or int(step_leaf) != 10 \
            or step_leaf.shape != () or step_leaf.dtype != torch.int32:
        bad.append(f"crash at {failed_at}, resumed at {resumed}, "
                   f"step leaf {out['restored_step_leaf']}")
    if differ:
        bad.append(f"resume not bit-exact: {differ[:8]}")
    idle = [k for k in STORE_KERNELS if launches[k] == 0]
    if idle:
        bad.append(f"store kernels not launched by the checkpoints: {idle}")
    return out, bad


def train_phase(torch, ops, bloom, merge, dev, seed: int,
                phase6b=None) -> dict:
    """Phase 9: training on the card (smollm_135m at full width, every
    family's step against the CPU, crash and bit-exact resume through the
    device checkpoint store).  The full-width state is not checkpointed
    here: at phase 6b c's rate (its one-shard save of the parameters
    alone, this call's when phase 6b ran) the parameters with AdamW's m
    and v, three times the bytes, would take about three times as long."""
    t = time.perf_counter()
    a, bad_a = train_full_part(torch, dev, seed)
    emit({"phase": "train", **a})
    b, bad_b = train_equivalence_part(torch, dev, seed)
    emit({"phase": "train", **b})
    ops.reset_launch_counts()
    c, bad_c = train_resume_part(torch, ops, bloom, merge, dev, seed)
    emit({"phase": "train", **c})
    launches = c["launches"]
    plain = {k: v for k, v in ops.PLAIN_CALLS.items() if v}
    out = dict(phase="train", part="summary", s=time.perf_counter() - t,
               launches=launches, plain_calls=plain,
               full_width_state_mb=a["params"] * 12 / 1e6,
               full_width_save_estimate_s=None if phase6b is None
               else a["params"] * 12 / 1e6
               / phase6b["checkpoint_save0_mb_per_s"])
    emit(out)
    bad = bad_a + bad_b + bad_c
    if plain:
        bad.append(f"plain versions ran on the card's path: {plain}")
    if bad:
        raise AssertionError(f"train phase failed: {bad}")
    return out


MESH_SLOWDOWN_LIMIT = 1.10     # a (1, 1) mesh against no mesh, p50


def decode_in_turns(torch, engines: dict, prompt, steps: int = 32) -> dict:
    """Each engine's decode step times (ms), the engines stepping in turns
    (which goes first alternates) from their own prefill of a wave of
    ``prompt``: a slow spell of the shared host lands on every engine
    alike, as it cannot on waves served one after the other."""
    state = {}
    for name, e in engines.items():
        tokens = torch.from_numpy(np.stack([np.asarray(prompt, np.int32)]
                                           * e.batch)).to(e.device)
        logits, cache = e.model.prefill(tokens, e.s_max, {})
        state[name] = (torch.argmax(logits, -1)[:, None].to(torch.int32),
                       cache)
    names = list(engines)
    out = {name: [] for name in names}
    for i in range(steps):
        for name in (names if i % 2 == 0 else names[::-1]):
            last, cache = state[name]
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = engines[name].model.decode_step(last, cache)
            last = torch.argmax(logits, -1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t) * 1e3)
            state[name] = (last, cache)
    return out


def mesh_serve_part(torch, ops, dev, seed: int, keep: dict) -> tuple:
    """(a) One warm wave of phase 7's engine (its weights and its AutumnKV
    store, drained) through an engine on a (1, 1) mesh sharing both, then
    through phase 7's engine, back to back: tokens, hits and the mesh
    engine's launches.  The gate's decode p50s come from the two engines
    stepping in turns (``decode_in_turns``).  Frees phase 7's engine."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import Sharder, make_rules
    from repro_torch.serve import Request, ServeEngine
    eng, shared = keep.pop("engine"), keep.pop("shared")
    cfg, gen = eng.cfg, 16
    quiesce(eng.kv.db)
    t = time.perf_counter()
    mesh = make_mesh((1, 1), dev)
    _, rules = make_rules(cfg, mesh, "decode", eng.batch, eng.s_max)
    meng = ServeEngine(cfg, eng.model.params, batch=eng.batch,
                       s_max=eng.s_max, device=dev, shard=Sharder(mesh, rules),
                       prefix_cache=eng.kv)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    reqs = [Request(shared, gen)] * eng.batch
    runs = {}
    ops.reset_launch_counts()
    for name, e in (("mesh", meng), ("none", eng)):
        hits0 = e.metrics["cache_hits"]
        t = time.perf_counter()
        out = np.stack(e.serve_batch(reqs))
        wall = time.perf_counter() - t
        tm = e.last_timings
        runs[name] = dict(tokens=out, wall_ms=wall * 1e3,
                          hits=e.metrics["cache_hits"] - hits0,
                          prefill_ms=tm["prefill_s"] * 1e3,
                          decode_step_ms=[x * 1e3 for x in
                                          tm["decode_step_s"]],
                          decode_step_ms_p50=nearest_rank(
                              [x * 1e3 for x in tm["decode_step_s"]], 50))
        if name == "mesh":
            launches = ops.launch_counts()
            plain = {k: v for k, v in ops.PLAIN_CALLS.items() if v}
    wave_ratio = runs["mesh"]["decode_step_ms_p50"] \
        / runs["none"]["decode_step_ms_p50"]
    turns = decode_in_turns(torch, {"mesh": meng, "none": eng}, shared)
    ratio = nearest_rank(turns["mesh"], 50) / nearest_rank(turns["none"], 50)
    checks = {
        "tokens_equal_meshless": np.array_equal(runs["mesh"]["tokens"],
                                                runs["none"]["tokens"]),
        "warm_hits_4": runs["mesh"]["hits"] == runs["none"]["hits"] == 4,
        f"decode_p50_at_most_{MESH_SLOWDOWN_LIMIT}x": ratio
        <= MESH_SLOWDOWN_LIMIT,
        "k3_k4_launched": all(launches[k] > 0 for k in ATTN_KERNELS),
        "no_plain_calls": not plain}
    out = dict(part="a_serve", model=cfg.name, mesh={"data": 1, "model": 1},
               rules={k: v for k, v in rules.items() if v},
               batch=eng.batch, prompt_tokens=len(shared), gen_len=gen,
               setup_s=setup_s,
               **{f"{k}_{n}": v for n, r in runs.items()
                  for k, v in r.items() if k != "tokens"},
               wave_decode_p50_ratio=wave_ratio,
               decode_step_ms_in_turns=turns,
               decode_p50_ratio=ratio, launches=launches, plain_calls=plain,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               checks=checks)
    eng.close()
    del meng, eng
    torch.cuda.empty_cache()
    return out, [k for k, ok in checks.items() if not ok]


def mesh_train_part(torch, dev, seed: int, steps: int = 3) -> tuple:
    """(b) smollm_135m at full width on phase 9's batch (8 x 2,048) and
    optimizer: a meshless Trainer and Trainer(mesh=(1, 1)) from the same
    start, ``steps`` steps each in turns (host clock, device
    synchronised): losses and every parameter and AdamW leaf by bits."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.sharding import full_tree
    from repro_torch.launch.train import Trainer
    from repro_torch.train import OptConfig
    cfg = get_config("smollm_135m")
    data = DataConfig(vocab=cfg.vocab, seq_len=2048, global_batch=8,
                      seed=seed)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=15,
                    schedule="wsd")
    trs = {"none": Trainer(cfg, opt, data, device=dev),
           "mesh": Trainer(cfg, opt, data, mesh=(1, 1), device=dev)}
    losses = {k: [] for k in trs}
    step_ms = {k: [] for k in trs}
    for tr in trs.values():
        tr.init(seed, try_restore=False)
    for _ in range(steps):
        for name, tr in trs.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = tr.train_step(tr.batch_for(tr.step))
            tr.step += 1
            losses[name].append(float(m["loss"]))     # synchronises
            step_ms[name].append((time.perf_counter() - t) * 1e3)
    differ = leaves_equal_bits(
        torch, {"p": trs["none"].params, "o": trs["none"].opt_state},
        full_tree({"p": trs["mesh"].params, "o": trs["mesh"].opt_state}))
    p50 = {k: nearest_rank(v, 50) for k, v in step_ms.items()}
    ratio = p50["mesh"] / p50["none"]
    out = dict(part="b_train", model=cfg.name, mesh={"data": 1, "model": 1},
               global_batch=8, seq_len=2048, steps=steps,
               step_ms_mesh=step_ms["mesh"], step_ms_meshless=step_ms["none"],
               step_ms_p50_mesh=p50["mesh"], step_ms_p50_meshless=p50["none"],
               step_p50_ratio=ratio, losses_mesh=losses["mesh"],
               losses_meshless=losses["none"], bits_equal=not differ,
               differing=differ[:8],
               embed_placements=str(trs["mesh"].params["embed"].placements))
    bad = []
    if losses["mesh"] != losses["none"] or differ:
        bad.append(f"mesh (1, 1) training differs: {differ[:8]}")
    if not ratio <= MESH_SLOWDOWN_LIMIT:
        bad.append(f"mesh step p50 {ratio:.3f}x the meshless step")
    del trs
    torch.cuda.empty_cache()
    return out, bad


def mesh_merge_part(torch, attention, dev, seed: int) -> tuple:
    """(d) Split decode attention across ranks on the card: phase 3's K3
    shape in bf16 (B 4, H 32, KH 8, dh 128, 16 pages of 64, lengths
    513..528), each row's pages cut in two halves as two ranks of a
    sequence-split cache hold them; K3's partials entry on each half and
    the ranks' merge (``attention.merge_across``), against the same
    entry over every page merged on one rank (float32, within 1.2e-4) and
    against one K3 call (its bf16 output, within one bf16 ulp of it: the
    rounding of two float32 results); the same bits twice.  Times (CUDA
    events, eager and as CUDA-graph replays): one rank's work (the split
    pass on its half and its merge, given the all-reduced statistics; the
    all-reduces themselves not timed) beside one K3 call over every page,
    and the two ranks' work emulated in one process (``merge_across``'s
    three passes)."""
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    B, H, KH, dh, page, P = 4, 32, 8, 128, 64, 16
    dt = torch.bfloat16
    q = torch.randn(B, H, dh, generator=g, device=dev).to(dt)
    kp = torch.randn(B * P, page, KH, dh, generator=g, device=dev).to(dt)
    vp = torch.randn(B * P, page, KH, dh, generator=g, device=dev).to(dt)
    bt = torch.randperm(B * P, generator=g, device=dev).to(
        torch.int32).view(B, P)
    lens = torch.randint(513, 529, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    half = P // 2 * page
    tables = [bt[:, r * P // 2:(r + 1) * P // 2].contiguous()
              for r in (0, 1)]

    def two_ranks():
        return attention.merge_across([attention.paged_partials_cuda(
            q, kp, vp, tables[r], torch.clamp(lens - r * half, 0, half).to(
                torch.int32)) for r in (0, 1)])

    got, again = two_ranks(), two_ranks()
    # the all-reduced max, for one rank's work alone
    M = torch.stack([torch.where(p[2][:, None], p[1][..., 0], -torch.inf)
                     .amax(-1, keepdim=True) for p in (
                         attention.paged_partials_cuda(
                             q, kp, vp, tables[r], torch.clamp(
                                 lens - r * half, 0, half).to(torch.int32))
                         for r in (0, 1))]).amax(0)
    lens0 = torch.clamp(lens, 0, half).to(torch.int32)

    def one_rank_work():
        return attention.merge_partials(
            *attention.paged_partials_cuda(q, kp, vp, tables[0], lens0),
            all_max=lambda t: M, all_sum=lambda t: t)
    one_rank = attention.merge_partials(*attention.paged_partials_cuda(
        q, kp, vp, bt, lens))
    k3 = attention.paged_cuda(q, kp, vp, bt, lens).float()
    ulp = torch.exp2(torch.floor(torch.log2(k3.abs().clamp_min(
        2.0 ** -126))) - 7)
    err_f32 = max(float((x - one_rank).abs().max()) for x in got)
    err_k3 = max(float((x.to(dt).float() - k3).abs().max()) for x in got)
    over_ulp = sum(int(((x.to(dt).float() - k3).abs() > ulp).sum())
                   for x in got)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    out = dict(part="d_split_decode", shape=f"B{B} H{H} KH{KH} dh{dh} "
               f"page{page} P{P} lengths {lens.tolist()} bfloat16",
               ranks=2, pages_per_rank=P // 2,
               max_abs_err_vs_one_rank_f32=err_f32,
               max_abs_err_vs_k3_bf16=err_k3,
               elements_past_one_ulp_of_k3=over_ulp, same_bits_twice=same,
               ms_one_rank=time_ms(torch, one_rank_work, 20, graph=True),
               eager_ms_one_rank=time_ms(torch, one_rank_work, 20),
               ms_k3=time_ms(torch, lambda: attention.paged_cuda(
                   q, kp, vp, bt, lens), 20, graph=True),
               eager_ms_k3=time_ms(torch, lambda: attention.paged_cuda(
                   q, kp, vp, bt, lens), 20),
               eager_ms_two_ranks_emulated=time_ms(torch, two_ranks, 20))
    bad = []
    if not err_f32 <= 1.2e-4 or over_ulp or not same:
        bad.append(f"split decode merge: {err_f32} vs one rank, "
                   f"{over_ulp} elements past one ulp of K3, "
                   f"same bits twice {same}")
    return out, bad


def mesh_phase(torch, ops, bloom, merge, attention, dev, seed: int,
               served=None) -> dict:
    """Phase 10: the serving and training paths on a (1, 1) mesh of the
    card against the same paths without one.  ``served``: part (a), run
    at the end of phase 7 on its engine (alone, phase 7 runs here)."""
    t = time.perf_counter()
    if served is None:
        keep = {}
        serve_phase(torch, ops, dev, seed, keep)
        served = mesh_serve_part(torch, ops, dev, seed, keep)
    a, bad_a = served
    emit({"phase": "mesh", **a})
    ops.reset_launch_counts()
    c, bad_c = train_resume_part(torch, ops, bloom, merge, dev, seed,
                                 mesh=(1, 1))
    emit({"phase": "mesh", **c, "part": "c_crash_resume_mesh"})
    launches = {k: a["launches"][k] + c["launches"].get(k, 0)
                for k in a["launches"]}
    plain = {k: v for k, v in ops.PLAIN_CALLS.items() if v}
    b, bad_b = mesh_train_part(torch, dev, seed)
    emit({"phase": "mesh", **b})
    d, bad_d = mesh_merge_part(torch, attention, dev, seed)
    emit({"phase": "mesh", **d})
    out = dict(phase="mesh", part="summary", s=time.perf_counter() - t,
               launches=launches, plain_calls=plain)
    emit(out)
    bad = bad_a + bad_b + bad_c + bad_d
    if plain:
        bad.append(f"plain versions ran on the mesh's path: {plain}")
    idle = [k for k in KERNELS if launches[k] == 0]
    if idle:
        bad.append(f"kernels not launched on the mesh's path: {idle}")
    if bad:
        raise AssertionError(f"mesh phase failed: {bad}")
    return out

# ------------------------------------------------------------ phase 11
# the dry-run's calibration cells: phase 9's training step, phase 7's
# prefill of 4 x 512-token prompts (K4) and its decode step against a cache
# of s_max 1024 (K3), each on a (1, 1) mesh: (arch, shape, seq_len, global
# batch, mode, accum)
CALIBRATION = (("smollm_135m", "phase9_train", 2048, 8, "train", 1),
               ("qwen3_4b", "phase7_prefill", 512, 4, "prefill", None),
               ("qwen3_4b", "phase7_decode", 1024, 4, "decode", None))
CALIBRATION_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=15,
                       schedule="wsd")                 # phase 9's trainer
PEAK_RATIO = (0.98, 1.02)      # predicted over measured peak bytes, gate
DRYRUN_CHILD = """
import json, sys
import repro_torch.configs as C
from repro_torch.launch.dryrun import roofline_terms, run_cell, trace_cell
from repro_torch.launch.mesh import fake_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.train import OptConfig
cells, opt, out_dir = json.loads(sys.argv[1])
out = {}
for arch, shape, S, B, mode, accum in cells:
    C.SHAPES[shape] = C.ShapeSpec(shape, S, B, mode)
    cell = build_cell(arch, shape, fake_mesh((1, 1), ("data", "model")),
                      opt_cfg=OptConfig(**opt), accum=accum)
    cost, trace_s = trace_cell(cell)
    out[arch + "/" + shape] = dict(
        trace_cost=cost.as_dict(), trace_s=trace_s,
        roofline=roofline_terms(cost, 1, cell.cfg, C.SHAPES[shape]))
out["qwen3_4b/decode_32k"] = run_cell("qwen3_4b", "decode_32k", False,
                                      force=True, out_dir=out_dir)
print(json.dumps(out))
"""


def start_dryrun_child(src: str) -> subprocess.Popen:
    """The dry-run of the calibration cells and of qwen3_4b's decode_32k
    on the 16 x 16 mesh, in a process of its own (a fake process group of
    its own), which sees no card."""
    env = dict(os.environ, PYTHONPATH=str(Path(src).resolve()),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD,
         json.dumps([CALIBRATION, CALIBRATION_OPT,
                     str(ROOT / "dryrun_torch")])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def placed_like(torch, fake, real) -> tuple:
    """``real`` (a tree of tensors on the card) placed as the cell's
    ``fake`` arguments are, on their (1, 1) mesh, where a rank's shard is
    the whole leaf; and the leaves whose shape or dtype differ."""
    from repro_torch.models.params import tree_leaves, tree_map
    from torch.distributed.tensor import DTensor
    bad = [p for (p, f), (_, r) in zip(tree_leaves(fake), tree_leaves(real))
           if tuple(f.shape) != tuple(r.shape) or f.dtype != r.dtype]
    if len(list(tree_leaves(fake))) != len(list(tree_leaves(real))):
        bad.append("leaf count")
    return tree_map(lambda f, r: DTensor.from_local(
        r, f.device_mesh, f.placements, run_check=False)
        if hasattr(f, "placements") else r, fake, real), bad


def calibration_args(torch, cfg, mode: str, S: int, B: int, dev,
                     seed: int) -> tuple:
    """Real arguments of a calibration cell, from the port's own init
    functions: the parameters from the seed, AdamW's zeroed state and
    phase 9's first batch (training), ``B`` prompts of ``S`` tokens drawn
    from the seed (prefill), or a zeroed cache of ``S`` and one token a
    row (decode)."""
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import init_cache, init_params
    from repro_torch.train import init_opt_state
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    if mode == "train":
        batch = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=S,
                                           global_batch=B, seed=seed)
                                ).get_batch(0)
        return (params, init_opt_state(params),
                {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    if mode == "prefill":
        prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
        return params, {"tokens": torch.from_numpy(prompts).to(
            dev, torch.int32)}
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    return params, tokens, init_cache(cfg, B, S, dev)


@contextmanager
def recording_attention_work(attention):
    """Adds up, inside the block, the work (``flash_work`` /
    ``paged_work``: [operations, bytes]) of every K3 and K4 launch, from
    the shapes that reached the kernel's wrapper on the card."""
    work = {k: [0, 0] for k in ATTN_KERNELS}
    saved = {n: getattr(attention, n) for n in (
        "flash_cuda", "paged_cuda", "paged_partials_cuda")}

    def add(name, w):
        work[name][0] += w[0]
        work[name][1] += w[1]

    def flash(q, k, v, *, causal=True, window=0):
        add("flash_attention", attention.flash_work(q.shape, k.shape,
                                                    q.dtype, causal, window))
        return saved["flash_cuda"](q, k, v, causal=causal, window=window)

    def paged(fn):
        def run(q, k_pages, v_pages, block_tables, lengths):
            add("paged_attention", attention.paged_work(
                q.shape, k_pages.shape, block_tables.shape, q.dtype))
            return saved[fn](q, k_pages, v_pages, block_tables, lengths)
        return run

    attention.flash_cuda = flash
    attention.paged_cuda = paged("paged_cuda")
    attention.paged_partials_cuda = paged("paged_partials_cuda")
    try:
        yield work
    finally:
        for n, f in saved.items():
            setattr(attention, n, f)


def measure_cell(torch, ops, dev, mesh, seed: int, entry,
                 runs: int = 3) -> dict:
    """One calibration cell's step on the card: its arguments made by the
    port's init functions and held leaf by leaf against the cell's, then
    ``runs`` steps after ``reset_peak_memory_stats``: K3 and K4 launches
    and work a step, step ms, and the peak above what was allocated before
    the arguments."""
    import repro_torch.configs as C
    from repro_torch.kernels import attention
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import OptConfig
    arch, shape, S, B, mode, accum = entry
    C.SHAPES[shape] = C.ShapeSpec(shape, S, B, mode)
    cell = build_cell(arch, shape, mesh, opt_cfg=OptConfig(**CALIBRATION_OPT),
                      accum=accum, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args, bad_leaves = placed_like(torch, cell.args, calibration_args(
        torch, cell.cfg, mode, S, B, dev, seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms = []
    with recording_attention_work(attention) as work:
        for _ in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = cell.fn(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            del out
    measured = torch.cuda.max_memory_allocated() - base
    counts = ops.launch_counts()
    del args
    torch.cuda.empty_cache()
    return dict(name=cell.name, mode=mode, accum=cell.accum,
                leaves=len(list(tree_leaves(cell.args))),
                leaves_differing=bad_leaves, step_ms=step_ms,
                peak_measured_bytes=measured, counts=counts,
                launches_per_step={k: counts[k] / runs
                                   for k in ATTN_KERNELS},
                work_per_step={k: [w / runs for w in work[k]]
                               for k in ATTN_KERNELS},
                plain_calls={k: v for k, v in ops.PLAIN_CALLS.items() if v})


def calibration_line(meas: dict, pred: dict) -> tuple:
    """A calibration cell's line and failed gates: the card's ``meas``
    beside the dry-run's ``pred`` (K3/K4 launches and their work equal,
    peak ratio within PEAK_RATIO)."""
    name, launches = meas["name"], meas["launches_per_step"]
    cost, roof = pred["trace_cost"], pred["roofline"]
    predicted = {k: cost["launches"].get(k, 0) for k in ATTN_KERNELS}
    work_predicted = {k: [float(w) for w in cost["kernel_work"].get(
        k, [0, 0])] for k in ATTN_KERNELS}
    terms = {k: roof[k] for k in ("compute_s", "memory_s", "collective_s")}
    ratio = cost["peak_bytes"] / meas["peak_measured_bytes"]
    line = dict(part=f"calibration {name}", mesh=[1, 1],
                **{k: v for k, v in meas.items()
                   if k not in ("name", "counts")},
                launches_predicted=predicted,
                work_predicted=work_predicted,
                peak_predicted_bytes=cost["peak_bytes"], peak_ratio=ratio,
                argument_bytes_predicted=cost["argument_bytes"],
                step_ms_min=min(meas["step_ms"]),
                roofline_s=max(terms.values()), roofline_terms=terms,
                roofline_dominant=roof["dominant"],
                flops_by_dtype=cost["flops_by_dtype"],
                hbm_bytes=cost["hbm_bytes"],
                aten_ops_predicted=cost["launches"].get("aten_ops", 0),
                trace_s=pred["trace_s"])
    bad = []
    if meas["leaves_differing"]:
        bad.append(f"{name}: arguments differ from the cell's at "
                   f"{meas['leaves_differing']}")
    if any(launches[k] != predicted[k] for k in ATTN_KERNELS):
        bad.append(f"{name}: launches {launches} on the card, {predicted} "
                   f"counted by the dry-run")
    if meas["work_per_step"] != work_predicted:
        bad.append(f"{name}: K3/K4 work {meas['work_per_step']} on the "
                   f"card, {work_predicted} counted by the dry-run")
    if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
        bad.append(f"{name}: predicted peak {cost['peak_bytes']} is "
                   f"{ratio:.3f}x the measured {meas['peak_measured_bytes']}")
    if meas["plain_calls"]:
        bad.append(f"{name}: plain versions ran: {meas['plain_calls']}")
    return line, bad


def dryrun_phase(torch, ops, dev, seed: int, src: str) -> dict:
    """Phase 11: the dry-run held against the card.  A child process traces
    the three calibration cells on a fake (1, 1) mesh and qwen3_4b's
    decode_32k on the fake 16 x 16 mesh while this one runs the
    calibration cells' steps on the card; their K3/K4 launches and the
    work of those launches must equal, and the predicted peak lie within
    PEAK_RATIO of the measured."""
    from repro_torch.launch.mesh import make_mesh
    t = time.perf_counter()
    child = start_dryrun_child(src)
    try:
        mesh = make_mesh((1, 1), dev)
        measured = [measure_cell(torch, ops, dev, mesh, seed, entry)
                    for entry in CALIBRATION]
        card_s = time.perf_counter() - t
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"dry-run child failed ({child.returncode}): "
                             f"{stderr[-3000:]}")
    pred = json.loads(stdout.strip().splitlines()[-1])
    bad, launches = [], {k: 0 for k in KERNELS}
    for meas in measured:
        line, bad_c = calibration_line(meas, pred[meas["name"]])
        emit({"phase": "dryrun", **line})
        bad += bad_c
        launches = {k: launches[k] + meas["counts"][k] for k in KERNELS}
    prod = pred["qwen3_4b/decode_32k"]
    emit({"phase": "dryrun", "part": "production qwen3_4b/decode_32k",
          **{k: prod.get(k) for k in (
              "status", "chips", "mesh_shape", "trace_s", "memory_analysis",
              "roofline", "error")},
          "trace_cost": {k: prod.get("trace_cost", {}).get(k) for k in (
              "flops_by_dtype", "hbm_bytes", "coll_bytes", "coll_by_kind",
              "coll_by_link", "coll_count", "launches")}})
    if prod.get("status") != "ok":
        bad.append(f"decode_32k on 16 x 16: {prod.get('error')}")
    out = dict(phase="dryrun", part="summary", s=time.perf_counter() - t,
               card_s=card_s, launches=launches)
    emit(out)
    if bad:
        raise AssertionError(f"dryrun phase failed: {bad}")
    return out


# ------------------------------------------------------------ phase 12
EXAMPLES = ("quickstart", "kernels_demo", "serve_autumnkv",
            "train_with_failures")


def load_example(name: str):
    """The module of examples/torch/<name>.py."""
    import importlib.util
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_checks(name: str, r: dict) -> dict:
    """Each example's gates: the reference example's own assertions and
    the outcome its run is known for."""
    if name == "quickstart":
        return {"point read": r["point_read"] == b"value-",
                "range read sorted": r["range_read"] == sorted(
                    r["range_read"]) and len(r["range_read"]) == 5,
                "levels": r["levels"] >= 1}
    if name == "kernels_demo":
        return {"members all hit": r["members_all_hit"],
                "bloom equals plain": r["bloom_mismatches"] == 0,
                "merge equals plain": r["merge_mismatches"] == 0,
                "merged 8000, 5000 from b": (r["merged"], r["from_b"])
                == (8000, 5000) and r["merged_sorted"],
                "paged within 2e-5": r["paged_err"] <= ATTN_TOL["float32"],
                "flash within 2e-2": r["flash_err"] <= ATTN_TOL["bfloat16"]}
    if name == "serve_autumnkv":
        w = r["waves"]
        return {"hits 0/4/6": [x["hits"] for x in w] == [0, 4, 6],
                "warm tokens equal cold": w[1]["tokens"] == w[0]["tokens"],
                "mixed shared rows equal cold":
                    w[2]["tokens"][2:] == w[0]["tokens"][2:]}
    return {"resumed at 30": r["resumed"] == 30, "ended at 60":
            r["step"] == 60, "losses finite": all(
                math.isfinite(x) for _, x in r["losses"])}


def examples_phase(torch, ops, dev) -> dict:
    """Phase 12: the four examples' twins on the card, in this process,
    their prints on stderr; each one's gates, and every kernel launched
    with no plain call."""
    from contextlib import redirect_stdout
    t = time.perf_counter()
    ops.reset_launch_counts()
    bad = []
    for name in EXAMPLES:
        t1 = time.perf_counter()
        with redirect_stdout(sys.stderr):
            r = load_example(name).main(device=str(dev))
        checks = example_checks(name, r)
        keep = {k: v for k, v in r.items()
                if not k.endswith("_out") and k != "point_read"}
        emit({"phase": "examples", "example": name,
              "s": time.perf_counter() - t1, "checks": checks,
              **json.loads(json.dumps(keep, default=str))})
        bad += [f"{name}: {k}" for k, ok in checks.items() if not ok]
        torch.cuda.empty_cache()
    launches = ops.launch_counts()
    plain = {k: v for k, v in ops.PLAIN_CALLS.items() if v}
    out = dict(phase="examples", part="summary", s=time.perf_counter() - t,
               launches={k: launches[k] for k in KERNELS}, plain_calls=plain)
    emit(out)
    idle = [k for k in KERNELS if launches[k] == 0]
    if idle:
        bad.append(f"kernels not launched by the examples: {idle}")
    if plain:
        bad.append(f"plain versions ran in the examples: {plain}")
    if bad:
        raise AssertionError(f"examples phase failed: {bad}")
    return out


PHASES = ("kernels", "attention", "equivalence", "db_bench", "subsystems",
          "durability", "sharded", "serve", "families", "train", "mesh",
          "dryrun", "examples")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entries", type=int, default=10_000_000,
                    help="phase-5 and phase-6 entry count (10M by default)")
    ap.add_argument("--equiv-entries", type=int, default=EQUIV_ENTRIES,
                    help="phase-4 entry count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run after the device and "
                         f"build phases (all by default: {','.join(PHASES)})")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory that holds the repro_torch package "
                         "(this checkout's src/ by default)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    # deterministic cuBLAS for phase 9's bit-exact resume: read when the
    # CUDA context is created, so set before torch touches the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    try:
        import repro_torch as rt
        from repro_torch import _build
        from repro_torch.kernels import attention, bloom, merge, ops
    except ImportError as e:
        print(f"chip_smoke: repro_torch not found in {args.src} ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "src": str(Path(rt.__file__).parent)})
    t = time.perf_counter()
    started = start_variant_builds(_build)
    built = _build.build_all(force=True)
    variants, variant_ptxas = load_variants(_build, started)
    build_s = time.perf_counter() - t
    mma = tensor_core_instructions(_build)
    flash_mma = {n: c for n, c in mma.items()
                 if n.startswith("flash_attention_bf16_kernel")}
    emit({"phase": "build", "built": built, "s": build_s,
          "ptxas": {n: ptxas_lines(log)
                    for n, log in _build.build_logs.items()},
          "ptxas_probe_variants": variant_ptxas,
          "tensor_core_instructions": mma})
    if not flash_mma or not all(flash_mma.values()):
        raise AssertionError(f"bf16 flash attention without tensor-core "
                             f"instructions in its SASS: {mma}")
    rng = np.random.default_rng(args.seed)
    rows = {}
    if "kernels" in phases:
        rows.update(kernel_phase(torch, ops, bloom, merge, rng, dev,
                                 variants))
    if "attention" in phases:
        rows.update(attention_rows(torch, attention, dev, args.seed))
        family_attention_rows(torch, attention, dev, args.seed)
    torch.cuda.empty_cache()
    if "equivalence" in phases:
        equivalence_phase(torch, rt, rng, args.equiv_entries)
        torch.cuda.empty_cache()
        async_equivalence(torch, rt, ops, rng, args.equiv_entries)
        torch.cuda.empty_cache()
        equivalence_subsystems(torch, rt, ops, rng, args.equiv_entries // 4)
        torch.cuda.empty_cache()
    launches, by_path, phase5, ctx = {}, {}, None, {}
    if "db_bench" in phases or "subsystems" in phases:
        # phase 5b runs on phase 5's store: alone, it loads it itself
        phase5 = dbbench_phase(torch, rt, ops, bloom, rng, args.seed,
                               args.entries, keep=ctx)
        launches = ops.launch_counts()
        by_path["db_bench"] = {k: launches[k] for k in STORE_KERNELS}
        idle = [k for k in STORE_KERNELS if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels never launched on phase 5: {idle}")
    phase5_reads = ctx.get("range_record")   # for phase 6b's comparison
    if "subsystems" in phases:
        by_path["subsystems"] = subsystems_phase(torch, rt, ops, args.seed,
                                                 ctx)["launches"]
    ctx.clear()
    torch.cuda.empty_cache()
    phase6 = None
    if "durability" in phases:
        phase6 = durability_phase(torch, rt, ops, bloom, merge, args.seed,
                                  args.entries, phase5)
        by_path["durability"] = phase6["launches"]
        torch.cuda.empty_cache()
    phase6b = None
    if "sharded" in phases:
        if phase5 is not None and phase5_reads is None:
            raise AssertionError("phase 5's range reads were not kept for "
                                 "phase 6b's comparison")
        phase6b = sharded_phase(torch, rt, ops, bloom, merge, args.seed,
                                args.entries, phase5_reads, phase6)
        by_path["sharded"] = phase6b["launches"]
        torch.cuda.empty_cache()
    served = None
    if "serve" in phases:
        keep = {} if "mesh" in phases else None
        serve = serve_phase(torch, ops, dev, args.seed, keep)
        if keep:
            # phase 10 (a) on phase 7's engine, before it is freed
            served = mesh_serve_part(torch, ops, dev, args.seed, keep)
        serve_equivalence(torch, dev, args.seed)
        by_path["serve"] = serve["launches"]
        # launches: the store kernels on phase 5, attention on the serve
        # phase
        launches.update({k: serve["launches"][k] for k in KERNELS
                         if k not in STORE_KERNELS})
    if "families" in phases:
        by_path["families"] = families_phase(torch, ops, dev,
                                             args.seed)["launches"]
    if "train" in phases:
        by_path["train"] = train_phase(torch, ops, bloom, merge, dev,
                                       args.seed, phase6b)["launches"]
    if "mesh" in phases:
        by_path["mesh"] = mesh_phase(torch, ops, bloom, merge, attention, dev,
                                     args.seed, served)["launches"]
    if "dryrun" in phases:
        by_path["dryrun"] = dryrun_phase(torch, ops, dev, args.seed,
                                         args.src)["launches"]
    if "examples" in phases:
        by_path["examples"] = examples_phase(torch, ops, dev)["launches"]
    if list(phases) != list(PHASES):
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        emit({"phase": "done", "s": time.perf_counter() - t_start})
        print(smi, flush=True)
        emit({"partial": True, "phases": phases})
        return 0
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    design=DESIGN[name], launches=launches[name],
                    max_abs_err=rows[name]["max_abs_err"],
                    ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
                    bound_ms=rows[name]["bound_ms"],
                    bound_by=rows[name]["bound_by"],
                    library_ms=rows[name]["library_ms"],
                    launches_by_path={p: c[name] for p, c in by_path.items()
                                      if name in c})
               for name, (src, rep) in KERNELS.items()]
    emit({"kernels": kernels})
    emit({"phase": "done", "s": time.perf_counter() - t_start})
    print(smi, flush=True)
    if torch.distributed.is_initialized():    # phase 10's one-rank group
        torch.distributed.destroy_process_group()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
