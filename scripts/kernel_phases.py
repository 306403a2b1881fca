"""Where the time goes inside kernels B1 and B2: per-block phase cycles.

Builds instrumented copies of ``csrc/xcorr_metric.cu`` (B1) and
``csrc/detect_candidates.cu`` (B2) under ``build/kernel_phases/``: thread 0
of every block reads the SM's cycle counter (``clock64``) at kernel entry,
after every ``__syncthreads()`` and at the end, and the launcher's copy of
the counters is read back.  Runs each kernel three times at the
multichannel path's shapes (8 rows of 87,310 samples, M=48; seeded
0.1-rms noise, so the work does not depend on frames) and prints, per
kernel, the phases' median and largest durations over the blocks, in SM
cycles and in microseconds at the card's maximum SM clock.  The phases:

* B1: staging, span-window power sums, correlation, result staging, the
  coalesced store;
* B2: staging, lag products, window sums, metric, NMS and the per-thread
  segment parts, the segment picks and writes.

The instrumented kernels are slower than the real ones by the counter
reads; compare phases with each other, not with ``chip_smoke.py``'s
device times.

    python3 scripts/kernel_phases.py
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from liquid_usrp_tpu_torch.ops import _build, kernels  # noqa: E402

CSRC = ROOT / "liquid_usrp_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernel_phases"
MAX_BLOCKS, MAX_STAMPS = 4096, 12
STAMPS = f"""
__device__ unsigned long long g_stamp[{MAX_BLOCKS}][{MAX_STAMPS}];
__device__ inline void stamp(int k) {{
  if (threadIdx.x == 0)
    g_stamp[blockIdx.y * gridDim.x + blockIdx.x][k] = clock64();
}}
extern "C" int read_stamps(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
}}
"""


def instrument(src: str, kernel: str, end: str):
    """``src`` with a stamp at the entry of ``kernel``, after each of its
    ``__syncthreads()`` and before its closing brace (the last ``}``
    before ``end``).  Returns (source, number of stamps)."""
    i = src.index("{", src.index(kernel + "(")) + 1
    stop = src.index(end, i)
    n = [0]

    def after(_):
        n[0] += 1
        return f"__syncthreads(); stamp({n[0]});"
    body = re.sub(r"__syncthreads\(\);", after, src[i:stop])
    k = body.rindex("}")
    if n[0] + 2 > MAX_STAMPS:
        raise RuntimeError(f"{kernel}: {n[0] + 2} stamps, room for "
                           f"{MAX_STAMPS}")
    body = f"\n  stamp(0);{body[:k]}  stamp({n[0] + 1});\n{body[k:]}"
    inc = src.index("#include <cuda_runtime.h>") + len(
        "#include <cuda_runtime.h>")
    return src[:inc] + STAMPS + src[inc:i] + body + src[stop:], n[0] + 2


def build(name: str, text: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(CSRC), "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def report(lib, n_stamps: int, name: str, phases, mhz: float) -> None:
    if n_stamps != len(phases) + 1:
        raise RuntimeError(f"{name}: {n_stamps} stamps for {len(phases)} "
                           f"phases: the kernel's barriers changed, so its "
                           f"phase labels must be written anew")
    buf = np.zeros((MAX_BLOCKS, MAX_STAMPS), np.uint64)
    if lib.read_stamps(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise RuntimeError("reading the stamps failed")
    t = buf[:, :n_stamps].astype(np.int64)
    t = t[t[:, 0] != 0]
    d = np.diff(t, axis=1)
    total = t[:, -1] - t[:, 0]
    print(f"{name}: {len(t)} blocks; block cycles median "
          f"{np.median(total):.0f}, max {total.max()} "
          f"({np.median(total) / mhz:.2f} / "
          f"{total.max() / mhz:.2f} us at {mhz:.0f} MHz)", flush=True)
    for i, label in enumerate(phases):
        print(f"  {label:>24}: median {np.median(d[:, i]):7.0f} cycles "
              f"({np.median(d[:, i]) / mhz:.2f} us), max {d[:, i].max():7d}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rows, length, M = 8, 87310, 48
    lag, span, win = M // 4, 2 * M - M // 4, M
    gen = torch.Generator().manual_seed(0)
    x = (0.1 * torch.randn(rows, length, dtype=torch.complex64,
                           generator=gen)).cuda()
    floors = torch.full((rows,), 1e-4, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    vp = ctypes.c_void_p

    rng = np.random.default_rng(0)
    tmpl = (rng.normal(size=2 * M) + 1j * rng.normal(size=2 * M)).astype(
        np.complex64)
    tre, tim, ea = kernels._xcorr_consts(tmpl.tobytes(), 24)
    n_metric = 65536 + 2 * M + 1
    out = torch.empty(rows, n_metric, device="cuda")
    src, n = instrument((CSRC / "xcorr_metric.cu").read_text(),
                        "xcorr_metric_kernel", "typedef void")
    lib = build("xcorr_metric", src)
    fn = lib.xcorr_metric_launch
    fn.argtypes = _build._SIGNATURES["xcorr_metric_launch"]
    for _ in range(3):
        if fn(x.data_ptr(), rows, length, tre.ctypes.data_as(vp),
              tim.ctypes.data_as(vp), ea.ctypes.data_as(vp), 2 * M, 24,
              n_metric, floors.data_ptr(), out.data_ptr(), stream):
            raise RuntimeError("B1 launch failed")
        torch.cuda.synchronize()
    report(lib, n, "B1", ["staging", "power sums W", "correlation",
                          "result staging", "store"], mhz)

    n_out = length - span - lag + 1
    n_seg = -(-n_out // 64)
    seg = [torch.empty(rows, n_seg, device="cuda", dtype=dt)
           for dt in (torch.float32, torch.int32, torch.float32,
                      torch.float32)]
    src, n = instrument((CSRC / "detect_candidates.cu").read_text(),
                        "detect_candidates_kernel", "typedef void")
    lib = build("detect_candidates", src)
    fn = lib.detect_candidates_launch
    fn.argtypes = _build._SIGNATURES["detect_candidates_launch"]
    for _ in range(3):
        if fn(x.data_ptr(), rows, length, lag, span, win, 65536, 0.5,
              floors.data_ptr(), n_out, n_seg,
              *(t.data_ptr() for t in seg), stream):
            raise RuntimeError("B2 launch failed")
        torch.cuda.synchronize()
    report(lib, n, "B2", ["staging", "lag products", "window sums",
                          "metric", "NMS + segment parts", "segment picks"],
           mhz)
    return 0


if __name__ == "__main__":
    sys.exit(main())
