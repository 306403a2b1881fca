"""How often ``torch.profiler`` loses kernel records at a window's start.

Traces B1 at M=48 (8 rows of 16,584 samples) and B2 at M=512 (8 rows of
101,760 samples, the wrapper launches two kernels) over windows of 100
wrapper calls, in fresh processes, three ways: B2 with nothing before the
calls (``bare``), with a spin kernel first (``spin``), and with 16 spin
kernels first (``spins``, as ``rxbench/profiling.py``'s ``open_window``
does: a loss of the first records falls on them).  B1's ten windows (``b1``) open with one spin
kernel.  For a window that did not show all 100 launches of
every kernel it prints the counts, whether the spin kernel's record was
there, and the start of the first kernel record after the trace's start.
Last, one JSON line: the windows and the lossy windows of each way.

    python3 scripts/profiler_edges.py [--processes 14]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 100
SPIN_CYCLES = 1_000_000
B2_NAMES = ("cand_sums_kernel", "cand_pick_kernel")
WAYS = {"b1": (1, 10), "bare": (0, 5), "spin": (1, 5), "spins": (16, 5)}


def trace(fn, names, spins: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(spins):
            torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    res = prof.profiler.kineto_results
    dev = [e for e in res.events() if e.device_type() == DeviceType.CUDA]
    first = min((e.start_ns() for e in dev), default=res.trace_start_ns())
    return dict(counts={k: sum(k in e.name() for e in dev) for k in names},
                spin=sum("spin" in e.name() for e in dev),
                first_us=(first - res.trace_start_ns()) / 1e3)


def one(seed: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from liquid_usrp_tpu_torch.ops import kernels
    gen = torch.Generator(device="cuda:0").manual_seed(seed)
    x2 = torch.randn((8, 101760), dtype=torch.complex64, device="cuda:0",
                     generator=gen)
    x1 = torch.randn((8, 16584), dtype=torch.complex64, device="cuda:0",
                     generator=gen)
    tmpl = np.exp(0.3j * np.arange(96)).astype(np.complex64)
    calls = {
        "b1": (lambda: kernels.detect_metric_xcorr_onepass(x1, tmpl, 24,
                                                           16481),
               ("xcorr_metric_kernel",)),
        "b2": (lambda: kernels.detect_candidates_onepass(
            x2, 128, 896, 512, 16384, 0.5, 8), B2_NAMES)}
    out = {}
    for way, (spins, n) in WAYS.items():
        fn, names = calls["b1" if way == "b1" else "b2"]
        out[way] = [trace(fn, names, spins) for _ in range(n)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processes", type=int, default=14)
    ap.add_argument("--one", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.one)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profiler_edges: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    tally = {w: [0, 0] for w in WAYS}
    for seed in range(1, args.processes + 1):
        proc = subprocess.run([sys.executable, __file__, "--one", str(seed)],
                              capture_output=True, text=True, check=True,
                              timeout=300)
        for way, windows in json.loads(proc.stdout.splitlines()[-1]).items():
            for w in windows:
                tally[way][0] += 1
                if any(c != ITERS for c in w["counts"].values()):
                    tally[way][1] += 1
                    print(f"process {seed}, {way}: {w['counts']} of "
                          f"{ITERS}, spin records {w['spin']}, first kernel "
                          f"record {w['first_us']:.1f} us after the "
                          f"trace's start", flush=True)
    print(json.dumps({w: dict(windows=n, lossy=k)
                      for w, (n, k) in tally.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
