"""The check's control on the card: runs of one cell with every read served
from a snapshot taken before the load's last sixteenth (stale reads, which
break the configurations' guarantee that a read sees every write
acknowledged before it), beside sound runs, on several seeds in one
process.  The benchmark's own runs never run it.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--sound 1]

prints one JSON line a run: the seed, whether it was the control, and the
numbers compared with their limits.  The control has to come out not
correct on every seed.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", type=int, choices=(0, 1), default=1,
                    help="also run each seed without the control")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from portbench import cell
    modes = (True, False) if args.sound else (True,)
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in modes:
            out = cell.run(args.workload, seed, args.seconds, False,
                           control=control)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "control": control,
                "correct": out["correct"], "attempted": out["attempted"],
                "failed": out["failed"],
                "checked_answers": out["checked_answers"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "compared": out["compared"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
