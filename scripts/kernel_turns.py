"""Device and wrapper time of kernels B1-B3 at M=48 for two checkouts, in turns.

Times each kernel alone on the card (``torch.profiler`` over 100 launches
of its wrapper) and each wrapper call (host wall time of 100 back-to-back
calls, synchronized at the end, the least of 10 such means: the launch
path and the wrapper's own PyTorch work) at the main paths' shapes: B1
and B2 on 8 rows of 87,310 samples (the multichannel step's windows), B3
on 8 rows of 100,366 (the single-channel dispatch's), all seeded 0.1-rms
noise at M=48.  Each run is a fresh process that imports the package of
one checkout (its own kernel build); runs go this checkout, the other,
the other, this checkout, so that drift of the card shows as a
difference within one side.  Prints the card's name and power limit,
then one line per run.

    python3 scripts/kernel_turns.py --other DIR   # DIR: another checkout
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 100
BATCHES = 10
M = 48


def device_us(fn, kernel: str) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in ev)
    return sum(getattr(e, "self_device_time_total", None) or
               e.self_cuda_time_total for e in ev) / max(n, 1)


def wrapper_us(fn) -> float:
    """The least of ``BATCHES`` means over ``ITERS`` calls: the host's
    cost of a call with the least of the shared host's contention."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / ITERS * 1e6)
    return best


def run() -> dict:
    """One side: the three kernels' device microseconds, in this process's
    ``liquid_usrp_tpu_torch``."""
    import numpy as np
    import torch
    from liquid_usrp_tpu_torch.ops import kernels
    gen = torch.Generator().manual_seed(0)
    x = (0.1 * torch.randn(8, 87310, dtype=torch.complex64,
                           generator=gen)).cuda()
    x3 = (0.1 * torch.randn(8, 100366, dtype=torch.complex64,
                            generator=gen)).cuda()
    rng = np.random.default_rng(0)
    tmpl = (rng.normal(size=2 * M) + 1j * rng.normal(size=2 * M)).astype(
        np.complex64)
    lag, span = M // 4, 2 * M - M // 4
    calls = {
        "B1": (lambda: kernels.detect_metric_xcorr_onepass(
            x, tmpl, 24, 65536 + 2 * M + 1), "xcorr_metric_kernel"),
        "B2": (lambda: kernels.detect_candidates_onepass(
            x, lag, span, M, 65536, 0.5, 24), "detect_candidates_kernel"),
        "B3": (lambda: kernels.detect_metric_onepass(x3, lag, span),
               "autocorr_metric_kernel"),
    }
    out = {k: device_us(fn, kern) for k, (fn, kern) in calls.items()}
    out.update({f"{k} call": wrapper_us(fn) for k, (fn, _) in calls.items()})
    out["package"] = str(Path(kernels.__file__).resolve().parents[2])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout's root")
    ap.add_argument("--run", action="store_true",
                    help="time one side in this process")
    args = ap.parse_args(argv)
    if args.run:
        print(json.dumps(run()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sides = {"this": ROOT, "other": args.other.resolve()}
    for side in ("this", "other", "other", "this"):
        env = dict(os.environ, PYTHONPATH=str(sides[side]))
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--run"], cwd=sides[side], env=env,
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        t = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{side:>5} ({t['package']}): device B1 {t['B1']:.2f} us, "
              f"B2 {t['B2']:.2f} us, B3 {t['B3']:.2f} us; a wrapper call "
              f"B1 {t['B1 call']:.2f} us, B2 {t['B2 call']:.2f} us, B3 "
              f"{t['B3 call']:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
