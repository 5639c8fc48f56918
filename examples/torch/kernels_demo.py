"""The five hand-written Hopper kernels on the paper's hot paths, the twin
of examples/kernels_demo.py: each call beside its plain PyTorch version.

    PYTHONPATH=src python examples/torch/kernels_demo.py            # the card
    PYTHONPATH=src python examples/torch/kernels_demo.py --device cpu

On the CPU every call takes the kernel's plain version, so the errors
printed there are 0 by construction.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import attention, bloom, merge, ops


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def main(device=None, seed: int = 0) -> dict:
    """Runs each kernel on ``device`` (the card unless ``"cpu"``) on the
    reference example's inputs (drawn in its order from ``seed``); prints
    and returns what it prints, with the outputs."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}

    # 1. bloom filter: build, then probe (paper §3.1 CPU optimization)
    members = rng.integers(0, 2**62, 4096, dtype=np.uint64)
    mk = ops.keys_to_device(members, dev)
    bits = ops.bloom_build(mk, 2048, 7)
    absent = rng.integers(2**62, 2**63, 4096, dtype=np.uint64)
    ak = ops.keys_to_device(absent, dev)
    maybe = ops.bloom_probe(ak, bits, 7)
    out.update(
        members_all_hit=bool(ops.bloom_probe(mk, bits, 7).all()),
        fpr=float(maybe.float().mean()),
        bloom_mismatches=int((bits != bloom.build_plain(mk, 2048, 7)).sum())
        + int((maybe != bloom.probe_plain(ak, bits, 7)).sum()))
    print(f"bloom_probe      : members all hit={out['members_all_hit']}, "
          f"absent FPR={out['fpr']:.4f}, differs from plain at "
          f"{out['bloom_mismatches']}")

    # 2. pair merge: compaction's merge (two sorted runs -> one)
    a = np.sort(rng.integers(0, 1 << 30, 3000, dtype=np.uint32))
    b = np.sort(rng.integers(0, 1 << 30, 5000, dtype=np.uint32))
    ta, tb = ops.keys_to_device(a, dev), ops.keys_to_device(b, dev)
    keys, src = ops.merge_pair(ta, tb)
    pk, ps = merge.merge_pair_plain(ta, tb)
    out.update(merged=keys.numel(),
               from_b=int(((src & merge.FROM_B) != 0).sum()),
               merged_sorted=bool((keys[1:] >= keys[:-1]).all()),
               merge_mismatches=int((keys != pk).sum() + (src != ps).sum()))
    print(f"merge_pair       : {len(a)}+{len(b)} -> {out['merged']} sorted="
          f"{out['merged_sorted']} ({out['from_b']} from run B), differs "
          f"from plain at {out['merge_mismatches']}")

    # 3. paged attention: AutumnKV's decode read path (block table = fence
    # pointers)
    B, H, KH, dh, page, P = 4, 8, 2, 64, 16, 8
    q = torch.tensor(rng.standard_normal((B, H, dh)), dtype=torch.float32,
                     device=dev)
    kp = torch.tensor(rng.standard_normal((64, page, KH, dh)),
                      dtype=torch.float32, device=dev)
    vp = torch.tensor(rng.standard_normal((64, page, KH, dh)),
                      dtype=torch.float32, device=dev)
    bt = torch.tensor(rng.integers(0, 64, (B, P)), dtype=torch.int32,
                      device=dev)
    ln = torch.tensor(rng.integers(page, P * page, B), dtype=torch.int32,
                      device=dev)
    o = ops.paged_attention(q, kp, vp, bt, ln)
    out.update(paged_out=o.cpu().numpy(),
               paged_err=_err(o, attention.paged_plain(q, kp, vp, bt, ln)))
    print(f"paged_attention  : out {tuple(o.shape)}, max err vs plain "
          f"{out['paged_err']:.2e}")

    # 4. flash attention: the prefill hotspot
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            device=dev).to(torch.bfloat16)
               for s in ((2, 512, 8, 64), (2, 512, 2, 64), (2, 512, 2, 64)))
    o = ops.flash_attention(q, k, v, causal=True, window=128)
    out.update(flash_out=o.float().cpu().numpy(),
               flash_err=_err(o, attention.flash_plain(q, k, v, causal=True,
                                                       window=128)))
    print(f"flash_attention  : out {tuple(o.shape)}, max err vs plain "
          f"{out['flash_err']:.2e}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda:0 by default; cpu to run on the CPU")
    main(ap.parse_args().device)
