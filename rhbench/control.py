"""The readings the limits of `correct` are set from, on the card at a
cell's own size, for several seeds in one process:

    python3 rhbench/control.py --workload <cell> --seeds 1,2,3 --seconds 2

For each seed, a short window of the cell as `run.py` runs it; then the
sample of its reads mapped by the float32 reference (the lower reading:
the share of the sampled reads whose records the port's differ from) and
by the reference with its events stage in bfloat16, the precision below
the configured one (the control, the upper reading).  One JSON line per
seed.  The benchmark's own runs do not run the control."""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rhbench import run, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("rhbench: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, compared, info = run.run_cell(cell, seed, args.seconds, False, "cuda",
                                              time.perf_counter(),
                                              reference_dtype=torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": compared["records_differ_share"]["value"],
                          "results_missing": compared["results_missing"]["value"],
                          "control": info["control"]["records_differ_share"],
                          "sampled": info["control"]["sampled"],
                          "reference_s": info["reference_s"],
                          "engine_stats": info["engine_stats"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
