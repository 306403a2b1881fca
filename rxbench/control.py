"""Readings that the limits of ``correct`` are set from: the program and
its control, in one process, on the card.

    python3 rxbench/control.py --workload mcrx4.loaded \\
        --seeds 11,12,13 --seconds 8 --ingest c64,bf16

For each ingest and seed, one run of the cell's timed path as
``run.py`` makes it (the same set-up, window and comparison), printed as
one JSON line: the ingest, the seed and the numbers compared.  ``c64``
is the program as the configuration states it; ``bf16`` is the control,
the program's own bfloat16 ingest (IQ planes rounded to bfloat16 on the
host, the nearest precision below the configuration's float32).  The
benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--ingest", default="c64,bf16")
    args = ap.parse_args(argv)
    import torch
    from rxbench import harness, manifest
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    for ingest in args.ingest.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            out = harness.run_cell(cell, seed, args.seconds, False,
                                   "cuda:0", time.perf_counter(),
                                   ingest=ingest,
                                   log=lambda *a: print(*a, file=sys.stderr))
            print(json.dumps({"workload": args.workload, "ingest": ingest,
                              "seed": seed, "correct": out["correct"],
                              "attempted": out["attempted"],
                              "checks": {k: v["value"] for k, v in
                                         out["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
