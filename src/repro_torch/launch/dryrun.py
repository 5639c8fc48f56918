"""Dry-run: trace every (arch x shape x mesh) cell on a fake process group
and estimate its cost on H100s.

Counterpart of ``repro.launch.dryrun``.  For each cell the port's own step
(``launch.specs.build_cell``) runs once on fake tensors, as rank 0 of a
fake process group of 256 ranks (the 16 x 16 production mesh) or 512 (2 x
16 x 16), under ``launch.trace_cost.CostMode``; nothing is allocated and
no card is needed.  Each cell writes a JSON artifact under
``dryrun_torch/`` (``--out``) with:

  memory_analysis -- per-device argument bytes and the peak of live bytes
                     over the step (``peak_estimate_bytes``); a peak above
                     the card's 80 GB is reported, not an error
  trace_cost      -- per-device product FLOPs by dtype, device-memory
                     bytes, collective wire bytes by kind and link, kernel
                     and aten launches (in place of the reference's
                     ``hlo_cost``; XLA's ``cost_analysis`` has no
                     counterpart and is left out)
  roofline        -- the three terms in seconds a step, the dominant one,
                     the model FLOPs a chip and the roofline fraction
  trace_s         -- seconds the trace took (the reference's lower_s and
                     compile_s)

The constants are an H100 SXM's at 700 W (NVIDIA data sheet): 989e12
FLOP/s for bf16 and fp16 products on the tensor cores, 67e12 for float32
products (TF32 stays off, as the port runs), 3.35e12 bytes/s of device
memory.  Collectives: 450e9 bytes/s each way over NVLink within a host,
50e9 bytes/s a card across hosts (400 Gb/s InfiniBand NDR, one NIC a
card, as a DGX H100 has).  Assumed layout: eight cards a host, ranks
numbered ``pod * 256 + data * 16 + model``, so a 'model' group of 16
spans two hosts and every production collective crosses InfiniBand.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun     # all cells, both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_135m
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod --force

Each mesh needs a fake process group of its own, so run it in a process
of its own (not beside a real group).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..models.params import count_params
from .mesh import make_production_mesh
from .specs import build_cell
from .trace_cost import TraceCost, trace

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "dryrun_torch"

# H100 SXM, 700 W (NVIDIA data sheet, dense, without sparsity)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_FLOPS_OTHER = 67e12         # any other dtype: the CUDA-core rate
HBM_BW = 3.35e12
NVLINK_BW = 450e9                # each way, within a host
IB_BW = 50e9                     # a card, across hosts
HBM_BYTES = 80e9                 # device memory of one card


def roofline_terms(cost: TraceCost, chips: int, cfg, shape) -> dict:
    """The three terms in seconds a step (per-device quantities over
    per-card rates) and the reference's derived fields."""
    compute_s = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS_OTHER)
                    for dt, f in cost.flops_by_dtype.items())
    memory_s = cost.hbm_bytes / HBM_BW
    collective_s = cost.coll_by_link.get("nvlink", 0.0) / NVLINK_BW \
        + cost.coll_by_link.get("ib", 0.0) / IB_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    n_active = count_params(cfg, active_only=True)
    tokens = shape.global_batch * (1 if shape.mode == "decode"
                                   else shape.seq_len)
    factor = 6.0 if shape.mode == "train" else 2.0    # fwd 2ND + bwd 4ND
    model_flops_per_chip = factor * n_active * tokens / chips
    worst = max(terms.values())
    return dict(terms, dominant=dom.replace("_s", ""),
                model_flops_per_chip=model_flops_per_chip,
                useful_flop_ratio=(model_flops_per_chip / cost.flops
                                   if cost.flops else 0.0),
                roofline_fraction=(model_flops_per_chip
                                   / PEAK_FLOPS["bfloat16"]) / worst
                if worst > 0 else 0.0)


def trace_cell(cell) -> tuple:
    """``(TraceCost, seconds)`` of one run of the cell's step."""
    t0 = time.perf_counter()
    cost = trace(cell.fn, cell.args, cell.fake_mode)
    return cost, time.perf_counter() - t0


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False, out_dir: Path = ARTIFACT_DIR) -> dict:
    """One cell's artifact (read back when it exists and did not fail,
    unless ``force``)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_path = Path(out_dir) / f"{arch}__{shape_name}__{mesh_name}.json"
    if out_path.exists() and not force:
        cached = json.loads(out_path.read_text())
        if cached.get("status") != "error":   # failed cells always retry
            return cached
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "mode": shape.mode}
    if not ok:
        result.update(status="skipped", reason=why)
        _write(out_path, result)
        return result
    t0 = time.perf_counter()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        cell = build_cell(arch, shape_name, mesh)
        cost, trace_s = trace_cell(cell)
        result.update(
            status="ok", chips=chips, mesh_shape=list(mesh.shape),
            trace_s=trace_s, accum=cell.accum,
            n_params=count_params(cfg),
            n_active_params=count_params(cfg, active_only=True),
            memory_analysis={
                "argument_bytes": cost.argument_bytes,
                "peak_estimate_bytes": cost.peak_bytes,
                "fits_80gb": cost.peak_bytes <= HBM_BYTES},
            trace_cost=cost.as_dict(),
            roofline=roofline_terms(cost, chips, cfg, shape))
    except Exception as e:  # record failures as artifacts too
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    result["wall_s"] = time.perf_counter() - t0
    _write(out_path, result)
    return result


def _write(path: Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1, default=float))


def summary_table(out_dir: Path = ARTIFACT_DIR) -> str:
    """The artifacts in ``out_dir`` as markdown: a table a mesh, a row an
    architecture, a column a shape; each entry the peak GB a device (bold
    above one card's 80 GB), the product TFLOP by dtype (bf16 / f32), the
    collective GB by kind (all-gather / all-reduce), and the dominant term
    with the roofline fraction."""
    arts = {}
    for f in sorted(Path(out_dir).glob("*.json")):
        a = json.loads(f.read_text())
        arts[(a["mesh"], a["arch"], a["shape"])] = a

    def entry(a) -> str:
        if a is None or a["status"] != "ok":
            return "—" if a is None else a["status"]
        c, rf = a["trace_cost"], a["roofline"]
        gb = a["memory_analysis"]["peak_estimate_bytes"] / 1e9
        peak = f"**{gb:.1f}**" if gb > HBM_BYTES / 1e9 else f"{gb:.1f}"
        tf = "/".join(f"{c['flops_by_dtype'].get(d, 0) / 1e12:.3g}"
                      for d in ("bfloat16", "float32"))
        coll = "/".join(f"{c['coll_by_kind'].get(k, 0) / 1e9:.3g}"
                        for k in ("all-gather", "all-reduce"))
        return (f"{peak}; {tf}; {coll}; {rf['dominant']} "
                f"{rf['roofline_fraction']:.2g}")

    out = []
    for mesh in ("pod16x16", "pod2x16x16"):
        out += [f"| {mesh} | " + " | ".join(SHAPES) + " |",
                "| --- |" + " --- |" * len(SHAPES)]
        out += [f"| {arch} | " + " | ".join(
            entry(arts.get((mesh, arch, s))) for s in SHAPES) + " |"
            for arch in ARCH_IDS]
        out.append("")
    return "\n".join(out[:-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true",
                    help="run only the 2x16x16 multi-pod mesh")
    ap.add_argument("--single-pod", action="store_true",
                    help="run only the 16x16 single-pod mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACT_DIR),
                    help="artifact directory (dryrun_torch/ by default)")
    ap.add_argument("--table", action="store_true",
                    help="print the artifacts in --out as a markdown table "
                         "and trace nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(summary_table(Path(args.out)))
        return 0
    torch.set_num_threads(1)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True]
    if args.multi_pod:
        meshes = [True]
    if args.single_pod:
        meshes = [False]
    n_ok = n_skip = n_err = 0
    t0 = time.perf_counter()
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, mp, force=args.force,
                             out_dir=Path(args.out))
                tag = {"ok": "OK ", "skipped": "SKIP", "error": "ERR "}[
                    r["status"]]
                extra = ""
                if r["status"] == "ok":
                    gb = r["memory_analysis"]["peak_estimate_bytes"] / 1e9
                    rf = r["roofline"]
                    extra = (f"peak/dev={gb:8.2f}GB "
                             f"{'' if gb * 1e9 <= HBM_BYTES else '>80GB '}"
                             f"trace={r['trace_s']:6.1f}s "
                             f"dom={rf['dominant']:10s} "
                             f"frac={rf['roofline_fraction']:.3f}")
                elif r["status"] == "error":
                    extra = r["error"][:120]
                    n_err += 1
                n_ok += r["status"] == "ok"
                n_skip += r["status"] == "skipped"
                print(f"[{tag}] {('2x16x16' if mp else '16x16  ')} "
                      f"{arch:24s} {shape:12s} {extra}", flush=True)
    print(f"done: ok={n_ok} skip={n_skip} err={n_err} "
          f"in {time.perf_counter() - t0:.1f}s")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
