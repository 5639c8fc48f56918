#!/usr/bin/env python3
"""Drive the repro_torch store's and serving path's main paths on one
NVIDIA GPU and check them.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--entries N] [--seed S]

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
  4. equivalence — one seeded op sequence on a CUDA store and a CPU store:
                bit-identical trees, IOStats and multi_get answers;
  5. db_bench — fillrandom then readrandom at LevelDB's documented
                defaults (10M entries, 16-byte keys, 100-byte values, 4 MiB
                write buffer, 10 bits per key), every answer checked;
  6. kernel launches on phase 5, each store kernel's must be > 0;
  7. serve    — qwen3_4b at full width (random weights from the seed) over
                AutumnKV: three waves of four 512-token requests (cold,
                warm, mixed), hits, dedup and tokens checked, every kernel
                launched on the path; then the smoke config served on the
                card and on the CPU at float32, tokens equal.
The last line is {"ok": true, "device": {...}}.  Without a CUDA card the
script exits non-zero before any phase runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import time
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
    "bloom_probe": "one thread per key, L2 gathers",
    "bloom_build": "one thread per key, global atomicOr",
    "merge_pair": "rank by binary search, scatter",
    "paged_attention": "split pages over (splits, KH, B) blocks, cp.async "
                       "2-stage tiles, fp32 CUDA cores + ordered combine",
    "flash_attention": "bf16: mma.sync m16n8k16, ldmatrix, cp.async 2-stage "
                       "swizzled tiles; f32: fp32 FMAs on the CUDA cores",
}
STORE_KERNELS = ("bloom_probe", "bloom_build", "merge_pair")
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's kernel tests


def emit(obj) -> None:
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
def kernel_phase(torch, ops, bloom, merge, rng, dev) -> dict:
    """Every kernel against its plain version at the main path's shapes;
    returns the headline row per kernel."""
    rows = {}
    # bloom build: the filter of the deepest run, 10M keys at 10 bits/key
    n_keys, bpk = 10_000_000, 10
    keys = ops.keys_to_device(rng.integers(0, 2**64 - 1, n_keys,
                                           dtype=np.uint64), dev)
    m_words = -(-n_keys * bpk // 32)
    k = round(bpk * np.log(2))
    got = bloom.build_cuda(keys, m_words, k)
    want = bloom.build_plain(keys, m_words, k)
    err = max_abs_err(torch, got, want)
    ms = time_ms(torch, lambda: bloom.build_cuda(keys, m_words, k), 10)
    plain = time_ms(torch, lambda: bloom.build_plain(keys, m_words, k), 3)
    rows["bloom_build"] = dict(
        shape=f"{n_keys} keys, {m_words} words, k={k}", max_abs_err=err,
        ms=ms, plain_ms=plain, library_ms=None,
        **bound(n_keys * 8 + m_words * 4,
                n_keys * (HASH_OPS + k * PROBE_OPS)))
    emit({"phase": "kernel", "kernel": "bloom_build", **rows["bloom_build"]})
    # bloom probe: one 65,536-key wave against that filter, half members
    bits = got
    n_q = 65_536
    q = torch.cat([keys[torch.randperm(n_keys, device=dev)[:n_q // 2]],
                   ops.keys_to_device(rng.integers(0, 2**64 - 1, n_q // 2,
                                                   dtype=np.uint64), dev)])
    got = bloom.probe_cuda(q, bits, k)
    want = bloom.probe_plain(q, bits, k)
    err = max_abs_err(torch, got, want)
    # bytes the probe needs: keys in, flags out, and the distinct filter
    # words read up to each key's first clear bit
    h1, h2 = bloom.hash_pair(q)
    pos = torch.stack([((h1 + i * h2) & 0xFFFFFFFF) % (m_words * 32)
                       for i in range(k)], 1)
    bit = ((bits[pos >> 5].to(torch.int64) & 0xFFFFFFFF) >> (pos & 31)) & 1
    needed = torch.cat([torch.ones_like(bit[:, :1]),
                        torch.cumprod(bit, 1)[:, :-1]], 1).bool()
    words = int(torch.unique(pos[needed] >> 5).numel())
    ms = time_ms(torch, lambda: bloom.probe_cuda(q, bits, k), 50)
    plain = time_ms(torch, lambda: bloom.probe_plain(q, bits, k), 10)
    rows["bloom_probe"] = dict(
        shape=f"{n_q} keys, {m_words} words, k={k}", max_abs_err=err, ms=ms,
        plain_ms=plain, library_ms=None,
        **bound(n_q * 9 + words * 4,
                n_q * HASH_OPS + int(needed.sum()) * PROBE_OPS))
    emit({"phase": "kernel", "kernel": "bloom_probe", **rows["bloom_probe"]})
    del keys, bits, q, pos, bit, needed
    # merge: balanced with shared keys, skewed, and the u64 maximum
    top = np.array([2**64 - 1], dtype=np.uint64)
    cases = []
    shared = rng.integers(0, 2**64 - 1, 1_000_000, dtype=np.uint64)
    a = np.unique(np.concatenate([shared, rng.integers(
        0, 2**64 - 1, 4_000_000, dtype=np.uint64), top]))
    b = np.unique(np.concatenate([shared, rng.integers(
        0, 2**64 - 1, 4_000_000, dtype=np.uint64), top]))
    cases.append(("5M+5M shared", a, b))
    cases.append(("40k+10M skewed", np.unique(rng.integers(
        0, 2**64 - 1, 40_000, dtype=np.uint64)), np.unique(rng.integers(
            0, 2**64 - 1, 10_000_000, dtype=np.uint64))))
    cases.append(("u64 max", np.array([0, 5, 2**63, 2**64 - 1], np.uint64),
                  np.array([2**32 - 1, 5, 2**63 - 1, 2**64 - 1], np.uint64)))
    for name, a, b in cases:
        ta, tb = ops.keys_to_device(np.sort(a), dev), \
            ops.keys_to_device(np.sort(b), dev)
        gk, gs = merge.merge_pair_cuda(ta, tb)
        wk, ws = merge.merge_pair_plain(ta, tb)
        err = max(max_abs_err(torch, gk, wk), max_abs_err(torch, gs, ws))
        n = ta.numel() + tb.numel()
        row = dict(shape=name, max_abs_err=err,
                   ms=time_ms(torch, lambda: merge.merge_pair_cuda(ta, tb)),
                   plain_ms=time_ms(torch,
                                    lambda: merge.merge_pair_plain(ta, tb), 5),
                   **bound(n * 8 + n * 16, n * 4 + 5 * (
                       ta.numel() * math.ceil(math.log2(tb.numel() + 1))
                       + tb.numel() * math.ceil(math.log2(ta.numel() + 1)))),
                   library_ms=time_ms(torch, lambda: torch.sort(
                       torch.cat([ta, tb]), stable=True)))
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
        pairs = B * H * S * (S + 1) // 2
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
            **bound((2 * q.numel() + 2 * k.numel()) * esize,
                    4 * dh * pairs, peak))
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
        n_tok = int(lens.sum())
        live_bytes = (2 * q1.numel() + 2 * n_tok * KH * dh) * esize \
            + bt.numel() * 4 + B * 4
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
            **bound(live_bytes, 4 * H * dh * n_tok, peak))
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


# ------------------------------------------------------------ phase 4
def equivalence_phase(torch, rt, rng, n_entries: int) -> dict:
    """One seeded op sequence on a CUDA store and a CPU store."""
    cfg = rt.LSMConfig(memtable_bytes=64 << 10, base_level_bytes=256 << 10,
                       bits_per_key=10)
    stores = [rt.LSMStore(cfg, device="cuda"), rt.LSMStore(cfg, device="cpu")]
    space = n_entries // 2
    keys = rng.integers(0, space, n_entries, dtype=np.uint64)
    keys[:5] = [0, 2**32 - 1, 2**63 - 1, 2**63, 2**64 - 1]
    lens = rng.integers(0, 120, n_entries)
    vals = [bytes([int(k) & 0xFF]) * int(ln) for k, ln in zip(keys, lens)]
    dels = rng.choice(keys, n_entries // 20)
    load_s = []
    for s in stores:
        t0 = time.perf_counter()
        s.put_batch(keys[:n_entries // 2].tolist(), vals[:n_entries // 2])
        s.delete_batch(dels.tolist())
        for k in keys[n_entries // 2:n_entries // 2 + 500].tolist():
            s.put(k, b"single")
        s.delete(int(keys[0]))
        s.put_batch(keys[n_entries // 2:].tolist(), vals[n_entries // 2:])
        s.flush()
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
    batches = [rng.integers(0, space * 2, m, dtype=np.uint64).tolist()
               for m in (0, 1, 700, 65_536)] + [keys[:4096].tolist()]
    answers = [[s.multi_get(b) for b in batches] for s in stores]
    gets = [[s.get(int(k)) for k in keys[:64]] for s in stores]
    cols = [rt.columns_of(s) for s in stores]
    stats = [dataclasses.asdict(s.stats) for s in stores]
    same_tree = len(cols[0]["levels"]) == len(cols[1]["levels"]) and all(
        len(la) == len(lb) and all(
            ra.keys() == rb.keys() and all(
                np.array_equal(ra[f], rb[f]) and np.asarray(ra[f]).shape
                == np.asarray(rb[f]).shape for f in ra)
            for ra, rb in zip(la, lb))
        for la, lb in zip(cols[0]["levels"], cols[1]["levels"]))
    out = dict(phase="equivalence", entries=n_entries,
               runs=sum(len(lvl) for lvl in cols[0]["levels"]),
               levels=stores[0].num_levels_in_use,
               compactions=stats[0]["compactions"],
               cuda_load_s=load_s[0], cpu_load_s=load_s[1],
               same_tree=same_tree, same_stats=stats[0] == stats[1],
               same_answers=answers[0] == answers[1] and gets[0] == gets[1],
               same_memtable=cols[0]["memtable"] == cols[1]["memtable"])
    emit(out)
    if not (same_tree and out["same_stats"] and out["same_answers"]
            and out["same_memtable"]):
        raise AssertionError("CUDA store differs from the CPU store")
    return out


# ------------------------------------------------------------ phase 5
def profile_window(torch, fn) -> dict:
    """Wall time of ``fn`` and the device time of the kernels and copies
    it ran (torch.profiler), hence the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    if not by_name:     # no device-side events: read the op averages
        by_name = {e.key: e.self_device_time_total
                   for e in prof.key_averages()
                   if getattr(e, "self_device_time_total", 0) > 0}
    busy_us = sum(by_name.values())
    if not by_name:
        return dict(wall_ms=wall_us / 1e3, device_busy_ms="not measured")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                device_idle_share=1 - busy_us / wall_us,
                top_device_ms={name[:80]: us / 1e3 for name, us in top})


def dbbench_phase(torch, rt, ops, rng, n_entries: int) -> dict:
    """fillrandom then readrandom at LevelDB's db_bench defaults."""
    cfg = rt.LSMConfig(policy="garnering", T=2.0, c=0.8,
                       memtable_bytes=4 << 20, base_level_bytes=10 << 20,
                       l0_compaction_trigger=4, bits_per_key=10,
                       block_size=4096)
    store = rt.LSMStore(cfg)   # cuda:0
    torch.cuda.reset_peak_memory_stats()
    keys = rng.integers(0, 2**64 - 1, n_entries, dtype=np.uint64)
    keys = keys[np.sort(np.unique(keys, return_index=True)[1])]  # distinct
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
    t0 = time.perf_counter()
    chunk = 500_000
    for i in range(0, keys.size, chunk):
        kc = keys[i:i + chunk]
        store.put_batch(kc.tolist(), user_values(kc))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    deleted = rng.choice(keys, keys.size // 100, replace=False)
    store.delete_batch(deleted.tolist())
    torch.cuda.synchronize()
    load_stats = store.stats
    live = np.setdiff1d(keys, deleted)
    wave, n_waves = 65_536, 32
    before = store.stats
    wave_s, checked = [], 0
    for w in range(n_waves + 1):          # wave 0 warms up, untimed
        parts = [rng.choice(live, wave // 2),
                 rng.integers(0, 2**64 - 1, wave // 4, dtype=np.uint64),
                 rng.choice(deleted, wave // 4)]
        at = np.minimum(np.searchsorted(sorted_keys, parts[1]), keys.size - 1)
        if (sorted_keys[at] == parts[1]).any():
            raise AssertionError("absent key drawn from the live set")
        q = np.concatenate(parts)
        t = time.perf_counter()
        got = store.multi_get(q.tolist())
        dt = time.perf_counter() - t
        want = user_values(parts[0]) + [None] * (wave // 2)
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
    run_bytes = sum(t.numel() * t.element_size()
                    for lvl in store._levels for r in lvl
                    for t in (r.keys, r.seqs, r.vlens, r.vals, r.block_of,
                              r.fence_keys, r.block_crcs, r.bloom.bits))
    out = dict(
        phase="db_bench", entries=int(keys.size), deleted=int(deleted.size),
        value_bytes=100, key_bytes=cfg.key_bytes,
        config=dataclasses.asdict(cfg), load_s=load_s,
        load_entries_per_s=keys.size / load_s,
        compaction_s=spent["compaction"], flush_build_s=spent["flush_build"],
        host_write_path_s=load_s - spent["compaction"] - spent["flush_build"],
        compaction_mb_per_s=load_stats.bytes_compacted / 1e6
        / spent["compaction"] if spent["compaction"] else None,
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
                    if v})
    emit(out)
    return out


# ------------------------------------------------------------ phase 7
def serve_phase(torch, ops, dev, seed: int) -> dict:
    """qwen3_4b at full width over AutumnKV: the three waves of
    examples/serve_autumnkv.py at 4 x 512-token prompts (8 pages each) and
    16 decoded tokens, every check of the reference's semantics."""
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("qwen3_4b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    eng = ServeEngine(cfg, params, batch=4, s_max=1024, device=dev)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, 512, dtype=np.int32)
    other = rng.integers(0, cfg.vocab, 512, dtype=np.int32)
    gen = 16
    waves = [("cold", [shared] * 4), ("warm", [shared] * 4),
             ("mixed", [other] * 2 + [shared] * 2)]
    ops.reset_launch_counts()
    outs, per_wave = [], []
    for name, prompts in waves:
        t = time.perf_counter()
        out = eng.serve_batch([Request(p, gen) for p in prompts])
        wall = time.perf_counter() - t
        tm = eng.last_timings
        st = eng.kv.stats()
        per_wave.append(dict(
            wave=name, wall_ms=wall * 1e3, lookup_ms=tm["lookup_s"] * 1e3,
            prefill_ms=tm["prefill_s"] * 1e3, insert_ms=tm["insert_s"] * 1e3,
            decode_step_ms_p50=float(np.percentile(tm["decode_step_s"], 50)
                                     * 1e3),
            decoded_tokens_per_s=len(prompts) * gen
            / sum(tm["decode_step_s"]),
            hits=st["hits"], pages_written=st["pages_written"],
            pages_deduped=st["pages_deduped"]))
        emit({"phase": "serve_wave", **per_wave[-1]})
        outs.append(np.stack(out))
    launches = ops.launch_counts()
    plain = dict(ops.PLAIN_CALLS)
    st = eng.kv.stats()
    checks = {
        "hits_0_4_6": [w["hits"] for w in per_wave] == [0, 4, 6],
        "warm_equals_cold": np.array_equal(outs[1], outs[0]),
        "mixed_hits_equal_cold": np.array_equal(outs[2][2:], outs[0][2:]),
        "mixed_misses_agree": np.array_equal(outs[2][0], outs[2][1]),
        "pages_written_16": st["pages_written"] == 16,
        "pages_deduped_32": st["pages_deduped"] == 32,
        "tokens_in_vocab": all(((o >= 0) & (o < cfg.vocab)).all()
                               for o in outs),
        "no_plain_calls": not any(plain.values()),
        "every_kernel_launched": all(launches[k] > 0 for k in KERNELS),
    }
    # the device's idle share over one more warm wave, under the profiler
    prof = profile_window(torch, lambda: eng.serve_batch(
        [Request(shared, gen)] * 4))
    out = dict(phase="serve", model=cfg.name, params=count_params(cfg),
               batch=4, s_max=1024, prompt_tokens=512, gen_len=gen,
               setup_s=setup_s, waves=per_wave, warm_wave_profile=prof,
               levels=st["levels"], store_io={k: v for k, v in
                                              st["io"].items() if v},
               launches=launches, plain_calls=plain,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               checks=checks)
    emit(out)
    eng.close()
    del eng
    torch.cuda.empty_cache()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serve phase failed: {bad}")
    return out


def serve_equivalence(torch, dev, seed: int) -> dict:
    """The qwen3_4b smoke config served on the card (kernels) and on the
    CPU (plain versions) at float32 from the same weights: equal tokens."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_smoke("qwen3_4b"), compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, cfg.vocab, 128, dtype=np.int32)
            for _ in range(2))
    tokens = []
    for device in (dev, "cpu"):
        eng = ServeEngine(cfg, params, batch=2, s_max=160, device=device)
        tokens.append([np.stack(eng.serve_batch([Request(p, 40)] * 2))
                       for p in (a, b, a)])
    same = all(np.array_equal(x, y) for x, y in zip(*tokens))
    out = dict(phase="serve_equivalence", model=cfg.name,
               compute_dtype="float32", same_tokens=same)
    emit(out)
    if not same:
        raise AssertionError("CUDA serving differs from CPU serving")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entries", type=int, default=10_000_000,
                    help="phase-5 entry count (10M by default)")
    ap.add_argument("--equiv-entries", type=int, default=200_000,
                    help="phase-4 entry count")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch as rt
        from repro_torch import _build
        from repro_torch.kernels import attention, bloom, merge, ops
    except ImportError as e:
        print(f"chip_smoke: repro_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t = time.perf_counter()
    built = _build.build_all(force=True)
    build_s = time.perf_counter() - t
    mma = tensor_core_instructions(_build)
    flash_mma = {n: c for n, c in mma.items()
                 if n.startswith("flash_attention_bf16_kernel")}
    emit({"phase": "build", "built": built, "s": build_s,
          "ptxas": {n: ptxas_lines(log)
                    for n, log in _build.build_logs.items()},
          "tensor_core_instructions": mma})
    if not flash_mma or not all(flash_mma.values()):
        raise AssertionError(f"bf16 flash attention without tensor-core "
                             f"instructions in its SASS: {mma}")
    rng = np.random.default_rng(args.seed)
    rows = kernel_phase(torch, ops, bloom, merge, rng, dev)
    rows.update(attention_rows(torch, attention, dev, args.seed))
    torch.cuda.empty_cache()
    equivalence_phase(torch, rt, rng, args.equiv_entries)
    torch.cuda.empty_cache()
    dbbench_phase(torch, rt, ops, rng, args.entries)
    launches = ops.launch_counts()
    idle = [k for k in STORE_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on phase 5: {idle}")
    torch.cuda.empty_cache()
    serve = serve_phase(torch, ops, dev, args.seed)
    serve_equivalence(torch, dev, args.seed)
    # launches: the store kernels on phase 5, attention on the serve phase
    launches.update({k: serve["launches"][k] for k in KERNELS
                     if k not in STORE_KERNELS})
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    design=DESIGN[name], launches=launches[name],
                    max_abs_err=rows[name]["max_abs_err"],
                    ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
                    bound_ms=rows[name]["bound_ms"],
                    bound_by=rows[name]["bound_by"],
                    library_ms=rows[name]["library_ms"])
               for name, (src, rep) in KERNELS.items()]
    emit({"kernels": kernels})
    emit({"phase": "done", "s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
