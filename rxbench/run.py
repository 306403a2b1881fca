"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 rxbench/run.py --workload mcrx4.loaded --seed 7 --seconds 30 \\
        --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and
last ``checks``: each number the comparison with the reference read,
beside its limit.  The same numbers are the last lines of standard error.
Without as many CUDA devices as the cell asks for, it prints no result
and exits with 2; if JAX or the JAX package was imported, with 3.

A cell with ``chips`` = 1 runs in this process on ``cuda:0`` and forms no
process group.  A cell with ``chips`` = k > 1 runs as k spawned ranks
(``rxbench/ranks.py``), rank r on ``cuda:r``, and its entry may rely on
this: the default process group (NCCL, ``device_id`` = ``cuda:r``) is
formed before ``Entry(config, "cuda:r", ingest)`` is built, so the entry
reads its rank and the world's size from ``torch.distributed`` and builds
its mesh with the port's ``parallel.mesh.make_sdr_mesh``; every rank makes
the stream from the seed on its own card and set-up fails unless every
rank's host chunks hash as rank 0's; every rank is handed the same
buffers in the same number, rank 0's clock deciding when the window
closes; ``entry.rows()`` is called on every rank after the window and
rank 0's must be the global rows, the only ones judged.  A rank that fails
ends the run with its traceback on standard error, exit 1 and no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "liquid_usrp_tpu"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from rxbench import harness, manifest
    cell = manifest.cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card()}")
    if chips == 1:
        out = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda:0", T0, log=log)
    else:
        from rxbench import ranks
        try:
            out = ranks.launch(cell, args.seed, args.seconds,
                               bool(args.trace), T0, log=log)
        except ranks.RankFailure as e:
            log(e)
            return e.code
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        log(f"imported in this process: {', '.join(found)}")
        return 3
    for name, c in out["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)        # the checkout, not rxbench/
    sys.exit(main())
