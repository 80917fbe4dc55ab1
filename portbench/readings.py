"""The readings the limits are set from: the program's compared numbers on
many seeds, and the control's, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6

Each seed makes the cell's snapshots (at their full size), sends one
request (a whole snapshot) through the timed path, and runs the check.
The control is the same path fed the fields rounded to bfloat16, the
precision below the configuration's float32, and judged against the
float32 fields. One JSON line per run on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def control_compress(device):
    """The timed path on the fields rounded to bfloat16 and back."""
    import torch

    from portbench.harness import program_compress

    prog = program_compress(device)

    def compress(fields, policy):
        low = {k: v.to(torch.bfloat16).to(torch.float32) for k, v in fields.items()}
        return prog(low, policy)

    return compress


def readings(cell, seed: int, control: bool, device, shape=None, log=None) -> dict:
    from portbench.harness import log as _log
    from portbench.harness import run_cell

    res = run_cell(cell, seed, 0.0, False, device=device, t0=time.perf_counter(),
                   compress=control_compress(device) if control else None, shape=shape,
                   log=log or _log)
    return {"seed": seed, "control": control, "correct": res["correct"],
            "checks": {k: v["value"] for k, v in res["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    from portbench.spec import load_cell

    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        print(json.dumps(readings(cell, seed, control, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
