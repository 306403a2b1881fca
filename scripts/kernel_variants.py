"""Device time per build variant of B1's fold, B2's window sums and B3.

Builds a copy of a kernel source once per variant under
``build/kernel_variants/``, each with its ``#define``s set to the
variant's values, checks each against the plain version and times each
CUDA kernel a call launches alone on the device (``torch.profiler`` over
100 calls, the window opened by spin kernels).  Three sweeps, each run
when its flag is given (``--b3`` with its default when none is):

* ``--b3 R:blocks[:threads]``: B3 at M=48 (``csrc/autocorr_metric.cu``'s
  ``B3_R`` offsets a thread, odd, ``B3_BLOCKS_PER_SM`` and, optionally,
  ``B3_THREADS``) at the single-channel path's shape, 8 rows of 100,366
  samples (seeded 0.1-rms noise with a periodic burst), with its share of
  the 4.79 us bound by bytes; ``--csrc DIR`` adds the B3 of another
  checkout's sources (one build, its own defaults), e.g. the parent's, to
  compare in the same run; its launch function must take this checkout's
  arguments;
* ``--fold threads:minblocks``: B1's period fold (``csrc/xcorr_fold.cu``'s
  ``XF_THREADS`` lanes a block and ``XF_MINB``, the blocks an SM must
  hold, which caps the registers) at M = 1,024 and 1,028;
* ``--w3 R:threads``: B3's window sums (``W3_R`` terms a thread, odd, and
  ``W3_THREADS``) at M = 1,152 and 4,096;
* ``--b2 minblocks[:pick_threads]``: B2's window-sum path
  (``csrc/detect_candidates.cu``'s ``B2_MINB``, the blocks an SM must
  hold, which caps the sums kernel's registers, and
  ``CAND_PICK_THREADS``, the pick kernel's block, whose warps share its
  segments that may score) at M = 512 and 4,096, at level 2's threshold
  0.5 and 8 candidates; a variant listed twice is built once and timed
  again, so ``5,4,4,5`` times the two in turns;

the last three on windows of the single-channel path's first dispatch (8
rows of its overlap + 16,384 samples at each M, seeded 0.01-rms noise with
the S0 template in every row).  Limits: B1 max abs difference <= 1e-4; B3
metric <= 1e-4, ``c`` within 1e-4 of max ``|c|``; B2 the detected mask
equal, values within 1e-4, offsets within 3.  Prints the card's name
and power limit, then one line per variant and M: registers and spills
per kernel (``ptxas``), error, and microseconds per kernel.

    python3 scripts/kernel_variants.py [--b3 9:3,9:2:128,...] [--csrc DIR]
        [--fold 256:2,128:4,...] [--w3 3:256,5:128,...] [--b2 5,4:256,...]
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
from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync  # noqa: E402
from liquid_usrp_tpu_torch.ops import _build, kernels  # noqa: E402

OUT = ROOT / "build" / "kernel_variants"
CSRC = ROOT / "liquid_usrp_tpu_torch" / "csrc"
ITERS = 100
SPINS, SPIN_CYCLES = 16, 1_000_000
# per sweep: its default, the source, the #defines a variant's fields set
# (in order), the sizes M it runs at
SWEEPS = {
    "b3": ("9:3,9:2,9:1,5:3,5:4,7:2,7:3,11:2,11:1", "autocorr_metric.cu",
           ("B3_R", "B3_BLOCKS_PER_SM", "B3_THREADS"), (48,)),
    "fold": ("256:2,256:3,128:4", "xcorr_fold.cu", ("XF_THREADS", "XF_MINB"),
             (1024, 1028)),
    "w3": ("3:256,5:256,5:128,7:128", "autocorr_metric.cu",
           ("W3_R", "W3_THREADS"), (1152, 4096)),
    "b2": ("5,4,6,5:256", "detect_candidates.cu",
           ("B2_MINB", "CAND_PICK_THREADS"), (512, 4096)),
}
M48_ROWS, M48_LENGTH = 8, 100366


def build(label: str, csrc: Path, source: str, defines: dict):
    """``csrc/<source>`` with each ``#define NAME value`` of ``defines``
    set (in the source or in a header of ``csrc`` that holds it), built
    into a library from copies under ``OUT/<label>/``: (library, ptxas
    registers and spills per kernel)."""
    files = {p.name: p.read_text() for p in
             [csrc / source, *sorted(csrc.glob("*.cuh"))]}
    for key, value in defines.items():
        n = 0
        for name, text in files.items():
            files[name], k = re.subn(rf"^#define {key} \d+",
                                     f"#define {key} {value}", text,
                                     flags=re.M)
            n += k
        if n != 1:
            raise RuntimeError(f"{csrc}: {n} #define {key} (want one)")
    where = OUT / label
    where.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        (where / name).write_text(text)
    cu, so = where / source, OUT / f"{label}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    regs = []
    for part in (proc.stdout + proc.stderr).split(
            "Compiling entry function")[1:]:
        name = re.search(r"_Z\d+(\w+?_kernel)", part)
        used = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        if name and used:
            regs.append(f"{name.group(1)} {used.group(1)} registers, "
                        f"{spill.group(1) if spill else 0} B spilled")
    lib = ctypes.CDLL(str(so))
    for fn in ("xcorr_fold_launch", "autocorr_metric_launch",
               "autocorr_metric_scratch", "detect_candidates_launch",
               "detect_candidates_scratch"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = \
                _build._SIGNATURES[fn]
    return lib, "; ".join(regs)


def per_kernel_us(launch) -> dict:
    """{CUDA kernel: device us a call} over ``ITERS`` calls; every kernel's
    launches must be a whole number of calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SPINS):
            torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(ITERS):
            launch()
        torch.cuda.synchronize()
    us, count = {}, {}
    for e in prof.key_averages():
        found = re.search(r"(\w+_kernel)", e.key)
        if (e.device_type == DeviceType.CUDA and found
                and "spin" not in e.key):
            name = found.group(1)
            count[name] = count.get(name, 0) + e.count
            us[name] = us.get(name, 0.0) + (
                getattr(e, "self_device_time_total", None) or
                e.self_cuda_time_total) / ITERS
    if not us or any(c % ITERS for c in count.values()):
        raise AssertionError(f"profiler saw {count} launches in "
                             f"{ITERS} calls")
    return us


def m48_rows():
    rng = np.random.default_rng(0)
    x = (0.1 * (rng.normal(size=(M48_ROWS, M48_LENGTH)) + 1j * rng.normal(
        size=(M48_ROWS, M48_LENGTH)))).astype(np.complex64)
    x[:, 5000:5000 + 2 * 48] += 1.0                 # a periodic burst
    return None, torch.as_tensor(x).cuda()


def dispatch_windows(m, rng):
    """(S0 template, windows of the single-channel first dispatch) at M."""
    params = ofdm.make_ofdm_params(m, m // 8, 4)
    tmpl = np.tile(params.s0_time, 2).astype(np.complex64)
    sync = ofdm_sync.make_sync(params, block_size=16384, max_payload=2048)
    shape = (8, sync.overlap + 16384)
    x = (0.01 * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
         ).astype(np.complex64)
    for r in range(8):
        pos = 3 * len(tmpl) + 611 * r
        x[r, pos:pos + len(tmpl)] += tmpl
    return tmpl, torch.as_tensor(x).cuda()


def fold_case(lib, label, tmpl, x, stream):
    """(launch, error) of B1's period fold on ``x``."""
    rows, length = x.shape
    m = len(tmpl) // 2
    span = ofdm_sync._xc_span(len(tmpl))
    n_metric = 16384 + 2 * m + 1
    P, J, g, _, _ = kernels._fold_geometry(tmpl.tobytes(), span)
    taps, meta = kernels._fold_device_consts(tmpl.tobytes(), span, "cuda:0")
    floors = kernels._row_floor(
        (x.real ** 2 + x.imag ** 2).sum(-1), max(
            length, kernels._xcorr_padded_len(n_metric, span, len(tmpl))),
        span, 1e-4).to(torch.float32).contiguous()
    part = torch.empty(rows, J, n_metric, device="cuda")
    out = torch.empty(rows, n_metric, device="cuda")
    ref = kernels.detect_metric_xcorr_plain(x, tmpl, span, n_metric)

    def launch():
        rc = lib.xcorr_fold_launch(
            x.data_ptr(), rows, length, span, len(tmpl) // span, P, J, g,
            n_metric, floors.data_ptr(), taps.data_ptr(), meta.data_ptr(),
            part.data_ptr(), out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"{label}: CUDA error {rc}")
    launch()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    return launch, f"{err:.2e} ({'ok' if err <= 1e-4 else 'WRONG'})"


def b3_case(lib, label, m, x, stream):
    """(launch, error) of B3 (``autocorr_metric_launch``) on ``x``."""
    rows, length = x.shape
    lag, span = m // 4, 2 * m - m // 4
    n_out = length - span - lag + 1
    floors = kernels._row_floor((x.real ** 2 + x.imag ** 2).sum(-1), length,
                                span, 1e-4).contiguous()
    scratch = None
    if hasattr(lib, "autocorr_metric_scratch"):
        nbytes = lib.autocorr_metric_scratch(rows, n_out, lag, span)
        if nbytes:
            scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    metric = torch.empty(rows, n_out, device="cuda")
    c = torch.empty(rows, n_out, device="cuda", dtype=torch.complex64)
    mr, cr = kernels.autocorr_metric(x, lag, span)

    def launch():
        rc = lib.autocorr_metric_launch(
            x.data_ptr(), rows, length, lag, span, floors.data_ptr(), n_out,
            metric.data_ptr(), c.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"{label}: CUDA error {rc}")
    launch()
    torch.cuda.synchronize()
    err = float((metric - mr).abs().max())
    c_rel = float((c - cr).abs().max() / cr.abs().max())
    ok = err <= 1e-4 and c_rel <= 1e-4
    return launch, f"{err:.2e}, c {c_rel:.2e} ({'ok' if ok else 'WRONG'})"


def b2_case(lib, label, m, x, stream):
    """(launch, error) of B2 (``detect_candidates_launch``) on ``x``, its
    segment maxima through the wrapper's top-k."""
    rows, length = x.shape
    lag, span, win, k = m // 4, 2 * m - m // 4, m, 8
    n_out = length - span - lag + 1
    n_seg = -(-n_out // kernels.CAND_SEG)
    floors = kernels._row_floor((x.real ** 2 + x.imag ** 2).sum(-1), length,
                                span, 1e-4).to(torch.float32).contiguous()
    nbytes = lib.detect_candidates_scratch(rows, n_out, lag, span, win,
                                           n_seg)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device="cuda")
    seg = [torch.empty(rows, n_seg, device="cuda", dtype=dt) for dt in
           (torch.float32, torch.int32, torch.float32, torch.float32)]
    args = (x, lag, span, win, 16384, 0.5, k)

    def launch():
        rc = lib.detect_candidates_launch(
            x.data_ptr(), rows, length, lag, span, win, 16384, 0.5,
            floors.data_ptr(), n_out, n_seg, *(t.data_ptr() for t in seg),
            scratch.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"{label}: CUDA error {rc}")
    launch()
    torch.cuda.synchronize()
    v, idx = torch.topk(seg[0], k, dim=-1)
    loc = torch.gather(seg[1], -1, idx)
    vr, lr, _ = kernels.detect_candidates_plain(*args)
    det = v > 0
    err = float((v - vr).abs().max())
    loc_err = max((int((loc[r][det[r]].sort()[0].long() -
                        lr[r][det[r]].sort()[0].long()).abs().max())
                   for r in range(rows) if bool(det[r].any())), default=0)
    ok = torch.equal(det, vr > 0) and err <= 1e-4 and loc_err <= 3
    return launch, (f"{err:.2e}, locs {loc_err}, {int(det.sum())} detected "
                    f"({'ok' if ok else 'WRONG'})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b3", help="R:blocks-per-SM[:threads],... (R odd)")
    ap.add_argument("--csrc", type=Path, action="append", default=[],
                    help="another checkout's csrc directory: its B3 at M=48")
    ap.add_argument("--fold", help="threads:minblocks,...")
    ap.add_argument("--w3", help="R:threads,... (R odd)")
    ap.add_argument("--b2", help="minblocks[:pick_threads],... in order")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    chosen = {k: getattr(args, k) for k in SWEEPS if getattr(args, k)}
    if not chosen:
        chosen = {"b3": SWEEPS["b3"][0]}
    jobs = []                       # (label, sweep, csrc, defines)
    for sweep, spec in chosen.items():
        _, source, names, _ = SWEEPS[sweep]
        for v in spec.split(","):
            fields = v.split(":")
            jobs.append((f"{sweep}_" + "_".join(fields), sweep, CSRC,
                         dict(zip(names, fields))))
    if "b3" in chosen:
        jobs += [(f"b3_csrc{i}", "b3", d.resolve(), {})
                 for i, d in enumerate(args.csrc)]
    once = {j[0]: j for j in jobs}      # a label listed twice builds once
    with ThreadPoolExecutor(len(once)) as pool:
        libs = dict(zip(once, pool.map(
            lambda j: build(j[0], j[2], SWEEPS[j[1]][1], j[3]),
            once.values())))
    built = [libs[j[0]] for j in jobs]
    rng = np.random.default_rng(0)
    data = {m: m48_rows() if m == 48 else dispatch_windows(m, rng)
            for sweep in chosen for m in SWEEPS[sweep][3]}
    stream = torch.cuda.current_stream().cuda_stream
    m48_bound_us = (M48_ROWS * M48_LENGTH * 8 + M48_ROWS * (
        M48_LENGTH - 84 - 12 + 1) * 12) / 3.35e12 * 1e6
    for (label, sweep, csrc, _), (lib, regs) in zip(jobs, built):
        for m in SWEEPS[sweep][3]:
            tmpl, x = data[m]
            if sweep == "fold":
                launch, err = fold_case(lib, label, tmpl, x, stream)
            elif sweep == "b2":
                launch, err = b2_case(lib, label, m, x, stream)
            else:
                launch, err = b3_case(lib, label, m, x, stream)
            us = per_kernel_us(launch)
            total = sum(us.values())
            share = (f", {m48_bound_us / total:.1%} of {m48_bound_us:.2f} us"
                     if m == 48 else "")
            print(f"{label} ({csrc.parent.parent.name}/.../{csrc.name}) "
                  f"M={m}: {regs}; err {err}; " + ", ".join(
                      f"{k} {v:.2f} us" for k, v in us.items()) +
                  f"; total {total:.2f} us{share}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
