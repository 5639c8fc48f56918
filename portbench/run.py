"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name from ``BENCHMARK.json``
(``portbench/cell.py``).  The last line of standard output is the result
as one JSON object; the numbers compared with the reference, each beside
its limit, are the last lines of standard error.  With no CUDA card, fewer
cards than the cell asks for, no ``repro_torch`` beside the benchmark, or
JAX or the JAX package loaded once the window has closed, it prints no
result and exits 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # caches of anything that compiles stay in the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    try:
        from portbench import cell, roofline
    except ImportError as e:
        return fail(f"the benchmark's files are incomplete ({e})")
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        chips = {w["name"]: w["chips"] for w in bench["workloads"]}
        need = chips[args.workload]
    except (OSError, KeyError, ValueError) as e:
        return fail(f"no workload {args.workload!r} ({e!r})")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        return fail(f"{args.workload} needs {need} CUDA card(s); "
                    f"found {torch.cuda.device_count()}; "
                    "nothing is run on the CPU")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return fail(f"repro_torch not found under {ROOT / 'src'} ({e})")
    torch.set_num_threads(1)
    print(json.dumps({"nvidia_smi": roofline.nvidia_smi()}), flush=True)
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda:0", chips=need, t_start=T_START)
    loaded = cell.forbidden_modules()
    if loaded:
        return fail(f"JAX or the JAX package was loaded: {loaded}")
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
