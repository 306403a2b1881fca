"""Where the time goes inside kernels B1, B2 and B3: per-block phase cycles.

Builds instrumented copies of ``csrc/xcorr_metric.cu`` (B1),
``csrc/detect_candidates.cu`` (B2) and ``csrc/autocorr_metric.cu`` (B3)
under ``build/kernel_phases/``: thread 0 of every block reads the SM's
cycle counter (``clock64``) at kernel entry, after every
``__syncthreads()``, before a few marked statements and at the end, and
adds each interval to the phase that it ends (in shared memory, written
out once at the end, so that the counting itself waits on no device
memory); a block that walks several tiles (B3's persistent loop) sums its
tiles' phases.  Runs each kernel
three times and reads the last run: B1 and B2 at the multichannel path's
shapes (8 rows of 87,310 samples), B3 at the single-channel path's (8 rows
of 100,366 samples), all at M=48, on seeded 0.1-rms noise (so the work
does not depend on frames).  Prints, per kernel, the phases' median and
largest cycles over the blocks, in SM cycles and in microseconds at the
card's maximum SM clock.  The phases:

* B1: staging, span-window power sums, correlation, result staging, the
  coalesced store;
* B2: staging, lag products, window sums, metric, NMS and the per-thread
  segment parts, the segment picks and writes;
* B3: stores (with the first tile's copy issue), the next tile's copy
  issue, the wait for this tile's samples, lag products, window sums,
  metric and staging, the last tile's stores.  ``--csrc`` times another
  checkout's sources, whose launch functions must take this checkout's
  arguments.

The instrumented kernels are slower than the real ones by the counter
reads; compare phases with each other, not with
``scripts/kernel_turns.py``'s device times.

    python3 scripts/kernel_phases.py [--csrc DIR]
"""
from __future__ import annotations

import argparse
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

OUT = ROOT / "build" / "kernel_phases"
MAX_BLOCKS, MAX_STAMPS = 4096, 12
STAMPS = f"""
__device__ unsigned long long g_phase[{MAX_BLOCKS}][{MAX_STAMPS}];
__shared__ unsigned long long s_phase[{MAX_STAMPS}];
__shared__ unsigned long long s_last;
__device__ inline void stamp(int k) {{
  if (threadIdx.x == 0) {{
    const unsigned long long now = clock64();
    if (k == 0)
      for (int i = 0; i < {MAX_STAMPS}; ++i) s_phase[i] = 0;
    else
      s_phase[k] += now - s_last;
    s_last = now;
  }}
}}
__device__ inline void stamp_end(int k) {{
  stamp(k);
  if (threadIdx.x == 0)
    for (int i = 0; i < {MAX_STAMPS}; ++i)
      g_phase[blockIdx.y * gridDim.x + blockIdx.x][i] = s_phase[i];
}}
extern "C" int reset_stamps() {{
  void* p = 0;
  cudaError_t err = cudaGetSymbolAddress(&p, g_phase);
  return (int)(err ? err : cudaMemset(p, 0, sizeof(g_phase)));
}}
extern "C" int read_stamps(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}}
"""
# B3's phases by the number of stamps in its source
B3_PHASES = {
    8: ["stores (+ first copy issue)", "next tile's copy issue",
        "wait for the tile", "lag products", "window sums",
        "metric + staging", "last tile's stores"],
    3: ["staging + lag products", "span sums, metric, stores"],
}
B3_MARKS = ("const int nxt", 'asm volatile("cp.async.wait_group',
            "for (int q = threadIdx.x")


def instrument(src: str, kernel: str, marks=()):
    """``src`` with a stamp at the entry of ``kernel``, after each of its
    ``__syncthreads()``, before each statement of its body that starts
    with one of ``marks``, and before its closing brace.  Returns (source,
    number of stamps)."""
    i = src.index("{", src.index(kernel + "(")) + 1
    depth, stop = 1, i
    while depth:
        depth += {"{": 1, "}": -1}.get(src[stop], 0)
        stop += 1
    stop -= 1                                   # the closing brace
    pattern = "|".join([r"__syncthreads\(\);"] +
                       [f"(?={re.escape(m)})" for m in marks])
    n = [0]

    def stamp(m):
        n[0] += 1
        return f"{m.group(0)} stamp({n[0]}); "
    body = re.sub(pattern, stamp, src[i:stop])
    if n[0] + 2 > MAX_STAMPS:
        raise RuntimeError(f"{kernel}: {n[0] + 2} stamps, room for "
                           f"{MAX_STAMPS}")
    body = f"\n  stamp(0);{body}  stamp_end({n[0] + 1});\n"
    inc = src.index("#include <cuda_runtime.h>") + len(
        "#include <cuda_runtime.h>")
    return src[:inc] + STAMPS + src[inc:i] + body + src[stop:], n[0] + 2


def build(name: str, text: str, csrc: Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(csrc), "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    if lib.reset_stamps() != 0:
        raise RuntimeError("resetting the stamps failed")
    return lib


def run3(lib, launch) -> None:
    """Three runs of ``launch()``; the stamps hold the last one."""
    for _ in range(3):
        if lib.reset_stamps() != 0:
            raise RuntimeError("resetting the stamps failed")
        if launch():
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()


def report(lib, n_stamps: int, name: str, phases, mhz: float) -> None:
    if n_stamps != len(phases) + 1:
        raise RuntimeError(f"{name}: {n_stamps} stamps for {len(phases)} "
                           f"phases: the kernel's barriers changed, so its "
                           f"phase labels must be written anew")
    buf = np.zeros((MAX_BLOCKS, MAX_STAMPS), np.uint64)
    if lib.read_stamps(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise RuntimeError("reading the stamps failed")
    d = buf[:, 1:n_stamps].astype(np.int64)
    total = d.sum(axis=1)
    d = d[total != 0]
    total = total[total != 0]
    print(f"{name}: {len(d)} blocks; block cycles median "
          f"{np.median(total):.0f}, max {total.max()} "
          f"({np.median(total) / mhz:.2f} / "
          f"{total.max() / mhz:.2f} us at {mhz:.0f} MHz)", flush=True)
    for i, label in enumerate(phases):
        print(f"  {label:>28}: median {np.median(d[:, i]):7.0f} cycles "
              f"({np.median(d[:, i]) / mhz:.2f} us), max {d[:, i].max():7d}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path,
                    default=ROOT / "liquid_usrp_tpu_torch" / "csrc",
                    help="the kernel sources to instrument")
    args = ap.parse_args(argv)
    csrc = args.csrc.resolve()
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
    print(f"sources: {csrc}", flush=True)
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
    src, n = instrument((csrc / "xcorr_metric.cu").read_text(),
                        "xcorr_metric_kernel")
    lib = build("xcorr_metric", src, csrc)
    fn = lib.xcorr_metric_launch
    fn.argtypes = _build._SIGNATURES["xcorr_metric_launch"][0]
    # the M=48 template goes to __constant__ memory: no device copy
    run3(lib, lambda: fn(x.data_ptr(), rows, length, tre.ctypes.data_as(vp),
                         tim.ctypes.data_as(vp), ea.ctypes.data_as(vp),
                         None, None, 2 * M, 24, n_metric, floors.data_ptr(),
                         out.data_ptr(), stream))
    report(lib, n, "B1", ["staging", "power sums W", "correlation",
                          "result staging", "store"], mhz)

    n_out = length - span - lag + 1
    n_seg = -(-n_out // 64)
    seg = [torch.empty(rows, n_seg, device="cuda", dtype=dt)
           for dt in (torch.float32, torch.int32, torch.float32,
                      torch.float32)]
    src, n = instrument((csrc / "detect_candidates.cu").read_text(),
                        "detect_candidates_kernel")
    lib = build("detect_candidates", src, csrc)
    fn = lib.detect_candidates_launch
    fn.argtypes = _build._SIGNATURES["detect_candidates_launch"][0]
    # M=48 runs the one-pass kernel, which needs no scratch
    run3(lib, lambda: fn(x.data_ptr(), rows, length, lag, span, win, 65536,
                         0.5, floors.data_ptr(), n_out, n_seg,
                         *(t.data_ptr() for t in seg), None, stream))
    report(lib, n, "B2", ["staging", "lag products", "window sums",
                          "metric", "NMS + segment parts", "segment picks"],
           mhz)

    length = 100366
    x = (0.1 * torch.randn(rows, length, dtype=torch.complex64,
                           generator=gen)).cuda()
    n_out = length - span - lag + 1
    metric = torch.empty(rows, n_out, device="cuda")
    c = torch.empty(rows, n_out, device="cuda", dtype=torch.complex64)
    src, n = instrument((csrc / "autocorr_metric.cu").read_text(),
                        "autocorr_metric_kernel", B3_MARKS)
    lib = build("autocorr_metric", src, csrc)
    fn = lib.autocorr_metric_launch
    fn.argtypes = _build._SIGNATURES["autocorr_metric_launch"][0]
    run3(lib, lambda: fn(x.data_ptr(), rows, length, lag, span,
                         floors.data_ptr(), n_out, metric.data_ptr(),
                         c.data_ptr(), None, stream))
    report(lib, n, "B3", B3_PHASES.get(n, []), mhz)
    return 0


if __name__ == "__main__":
    sys.exit(main())
