"""Kernel B3's tuning sweep: its device time per chunk size and residency.

Builds ``csrc/autocorr_metric.cu`` once per variant under
``build/kernel_variants/``, each a copy with its ``#define`` of ``B3_R``
(offsets per thread), ``B3_BLOCKS_PER_SM`` and, optionally,
``B3_THREADS`` set to the variant's values; checks each against the plain
version
(``kernels.autocorr_metric``: metric max abs difference <= 1e-4, ``c``
within 1e-4 of max ``|c|``) and times it alone on the device
(``torch.profiler`` over 100 launches) at the single-channel path's shape,
8 rows of 100,366 samples at M=48 (seeded frames in noise).  ``--csrc``
adds the B3 of another checkout's sources (one build, its own defaults),
e.g. the parent's, to compare in the same run; its launch function must
take this checkout's arguments.  Prints one line per
variant: registers and spills (``ptxas``), error, device microseconds and
the share of the 4.79 us bound by bytes.

    python3 scripts/kernel_variants.py [--csrc DIR] [--sweep 9:3,9:6:128,...]
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from liquid_usrp_tpu_torch.ops import _build, kernels  # noqa: E402

OUT = ROOT / "build" / "kernel_variants"
ROWS, LENGTH, M = 8, 100366, 48
ITERS = 100
SWEEP = "9:3,9:2,9:1,5:3,5:4,7:2,7:3,11:2,11:1"


def build(label: str, csrc: Path, defines) -> tuple[ctypes.CDLL, str]:
    """``csrc``'s B3 with each ``#define NAME value`` of ``defines`` set,
    built into a library: (library, ptxas registers and spills)."""
    src = (csrc / "autocorr_metric.cu").read_text()
    for name, value in defines.items():
        src, n = re.subn(rf"^#define {name} \d+", f"#define {name} {value}",
                         src, flags=re.M)
        if n != 1:
            raise RuntimeError(f"{csrc}: no #define {name}")
    cu, so = OUT / f"b3_{label}.cu", OUT / f"b3_{label}.so"
    cu.write_text(src)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    log = proc.stdout + proc.stderr
    regs = "; ".join(m.group(0) for m in re.finditer(
        r"Used \d+ registers|\d+ bytes spill stores", log))
    lib = ctypes.CDLL(str(so))
    lib.autocorr_metric_launch.argtypes = \
        _build._SIGNATURES["autocorr_metric_launch"][0]
    return lib, regs


def device_us(launch) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            launch()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and "autocorr_metric_kernel" in e.key]
    n = sum(e.count for e in ev)
    if n != ITERS:
        raise AssertionError(f"profiler saw {n} launches, expected {ITERS}")
    return sum(getattr(e, "self_device_time_total", None) or
               e.self_cuda_time_total for e in ev) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, action="append", default=[],
                    help="another checkout's csrc directory to time too")
    ap.add_argument("--sweep", default=SWEEP,
                    help="R:blocks-per-SM[:threads] (R odd)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    here = ROOT / "liquid_usrp_tpu_torch" / "csrc"
    jobs = []
    for v in args.sweep.split(","):
        r, b, *t = v.split(":")
        jobs.append((f"R{r}_B{b}" + (f"_T{t[0]}" if t else ""), here,
                     {"B3_R": r, "B3_BLOCKS_PER_SM": b,
                      **({"B3_THREADS": t[0]} if t else {})}))
    jobs += [(f"csrc{i}", d.resolve(), {}) for i, d in enumerate(args.csrc)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))

    rng = np.random.default_rng(0)
    x = (0.1 * (rng.normal(size=(ROWS, LENGTH)) +
                1j * rng.normal(size=(ROWS, LENGTH)))).astype(np.complex64)
    x[:, 5000:5000 + 2 * M] += 1.0                  # a periodic burst
    x = torch.as_tensor(x).cuda()
    lag, span = M // 4, 2 * M - M // 4
    n_out = LENGTH - span - lag + 1
    floors = kernels._row_floor((x.real ** 2 + x.imag ** 2).sum(-1), LENGTH,
                                span, 1e-4).contiguous()
    mr, cr = kernels.autocorr_metric(x, lag, span)
    bound_us = (ROWS * LENGTH * 8 + ROWS * n_out * 12) / 3.35e12 * 1e6
    stream = torch.cuda.current_stream().cuda_stream
    for (label, csrc, _), (lib, regs) in zip(jobs, built):
        metric = torch.empty(ROWS, n_out, device="cuda")
        c = torch.empty(ROWS, n_out, device="cuda", dtype=torch.complex64)

        def launch():
            rc = lib.autocorr_metric_launch(
                x.data_ptr(), ROWS, LENGTH, lag, span, floors.data_ptr(),
                n_out, metric.data_ptr(), c.data_ptr(), None, stream)
            if rc:
                raise RuntimeError(f"{label}: CUDA error {rc}")
        launch()
        torch.cuda.synchronize()
        err = float((metric - mr).abs().max())
        c_rel = float((c - cr).abs().max() / cr.abs().max())
        ok = err <= 1e-4 and c_rel <= 1e-4
        us = device_us(launch)
        print(f"{label:>8} ({csrc.parent.parent.name}/.../{csrc.name}): "
              f"{regs}; metric err {err:.2e}, c {c_rel:.2e} "
              f"({'ok' if ok else 'WRONG'}); {us:.2f} us, "
              f"{bound_us / us:.1%} of {bound_us:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
