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

``--large`` times instead B1 at M = 64, 256, 1,024, 1,028 and 4,096, B2
at M = 512, 1,024, 2,048 and 4,096 (its window-sum path; at 512 also on
``chip_smoke.py`` phase 29's windows, made by each side's own script)
and at 64, 256, 400 and 472 (its one-pass generic instance), and B3 at
M = 1,152, 2,048,
4,096 and at lag 2, span 9, on the single-channel path's first-dispatch
windows at each M (8 rows of its overlap + 16,384 samples, seeded
0.1-rms noise, the S0 template of that M; B2 at level 2's threshold 0.5,
8 candidates): the device microseconds a wrapper call spends in its CUDA
kernels (every kernel of the package's sources a call launches: B1's
names hold ``xcorr``, B2's ``detect_candidates``, ``cand_``, ``w3_`` or
``ws_lag_sums``, B3's ``autocorr_`` or ``w3_``).  ``--conv`` times the GMSK
``--conv`` path of ``chip_smoke.py`` (its gmskframe_tx stream of 40 v27
frames: ms per 8-block dispatch, and the Viterbi stage inside it) and
the v27 sweep points of ``apps/ber_sweep.py`` (200 frames; GMSK hard at
-2 and -1 dB, where headers fail, GMSK soft at -3 dB, OFDM hard at 3 dB
and flexframe hard at 1 dB): seconds and BER a point, with each side's
own ``chip_smoke.py`` and package.

    python3 scripts/kernel_turns.py --other DIR [--large | --conv]
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


def kernels_us(fn, names) -> float:
    """Device microseconds a call of ``fn`` spends in the CUDA kernels
    whose names hold one of ``names``, each launched once a call: the sum
    of each kernel's mean over the launches the profiler recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    return sum((getattr(e, "self_device_time_total", None) or
                e.self_cuda_time_total) / e.count
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count and
               any(n in e.key for n in names))


def run_large() -> dict:
    """B1-B3 at the sizes where they leave their M=48 instances."""
    import numpy as np
    import torch
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.ops import kernels
    gen = torch.Generator().manual_seed(0)
    out = {}

    def windows(m):
        sync = ofdm_sync.make_sync(ofdm.make_ofdm_params(m, m // 8, 4),
                                   block_size=16384, max_payload=2048)
        return (0.1 * torch.randn(8, sync.overlap + 16384,
                                  dtype=torch.complex64,
                                  generator=gen)).cuda()
    for m in (64, 256, 1024, 1028, 4096):
        x = windows(m)
        tmpl = np.tile(ofdm.make_ofdm_params(m, m // 8, 4).s0_time, 2)
        span = ofdm_sync._xc_span(len(tmpl))
        out[f"B1 M={m}"] = kernels_us(
            lambda: kernels.detect_metric_xcorr_onepass(
                x, tmpl, span, 16384 + 2 * m + 1), ("xcorr",))
    b2 = ("detect_candidates", "cand_", "w3_", "ws_lag_sums")
    x = phase29_windows(512)
    out["B2 M=512 phase 29"] = kernels_us(
        lambda: kernels.detect_candidates_onepass(x, 128, 896, 512, 16384,
                                                  0.5, 8), b2)
    for m in (512, 1024, 2048, 4096, 64, 256, 400, 472):
        x = windows(m)
        out[f"B2 M={m}"] = kernels_us(
            lambda: kernels.detect_candidates_onepass(
                x, m // 4, 2 * m - m // 4, m, 16384, 0.5, 8), b2)
    b3 = ("autocorr_", "w3_")
    for m in (1152, 2048, 4096):
        x = windows(m)
        out[f"B3 M={m}"] = kernels_us(
            lambda: kernels.detect_metric_onepass(x, m // 4, 2 * m - m // 4),
            b3)
    x = windows(48)
    out["B3 lag=2 span=9"] = kernels_us(
        lambda: kernels.detect_metric_onepass(x, 2, 9), b3)
    out["package"] = str(Path(kernels.__file__).resolve().parents[2])
    return out


def phase29_windows(m):
    """``chip_smoke.py`` phase 29's B2 windows at M = ``m``, made by this
    side's ``chip_smoke.py``: the app's first dispatch of its 4-frame
    stream in 0.01-rms noise."""
    import tempfile

    import numpy as np
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from liquid_usrp_tpu_torch.framing import ofdm
    with tempfile.TemporaryDirectory() as tmpdir:
        stream, _ = cs.sc_transmit(str(Path(tmpdir) / "s.iq"), m, m // 8,
                                   cs.LM_FRAMES, cs.LM_PAYLOAD)
    rng = np.random.default_rng(m)
    n = cs.SC_BATCH * cs.SC_BLOCK
    padded = (0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
              ).astype(np.complex64)
    padded[:len(stream)] += stream[:n]
    return cs.sc_windows(ofdm.make_ofdm_params(m, m // 8, cs.TAPER), padded,
                         "cuda")


def run_conv() -> dict:
    """The GMSK ``--conv`` dispatch and the v27 sweep points, with this
    side's ``chip_smoke.py``."""
    import tempfile

    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from liquid_usrp_tpu_torch.apps import ber_sweep as bs
    out = {}
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmpdir:
        sync = cs.gm_sync(conv=True)
        sent = cs.tx_draws(cs.GM_FRAMES, cs.GM_SEED, 8, cs.GM_PAYLOAD)
        stream = cs.gm_transmit(str(Path(tmpdir) / "gm.iq"), "-c", "v27",
                                "-k", "none")
        _, out["gmsk conv dispatch ms"] = cs.gm_timing(
            sync, stream, sent, dev, "GMSK --conv", "the card")
        out["gmsk conv viterbi ms"] = cs.viterbi_ms(sync, stream, dev,
                                                    "the card")
    for fam, snr, soft in (("gmsk", -2.0, False), ("gmsk", -1.0, False),
                           ("gmsk", -3.0, True), ("ofdm", 3.0, False),
                           ("flex", 1.0, False)):
        cfg = bs.make_config(fam, 200, "v27", "none", soft=soft)
        st = bs.build_stream(cfg, 200, 0, dev)
        noisy = bs.add_noise(st, snr)
        row, _, sec, _, _ = cs.fid_point(bs, cfg, st, noisy, snr, dev)
        key = f"{fam} v27 {'soft' if soft else 'hard'} {snr:g} dB"
        out[key + " s"] = sec
        out[key + " ber"] = row["payload_ber"]
        out[key + " per"] = row["packet_error_rate"]
    torch.cuda.synchronize()
    out["package"] = str(Path(bs.__file__).resolve().parents[2])
    return out


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
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--large", action="store_true",
                      help="B1-B3 at the sizes past M=48")
    mode.add_argument("--conv", action="store_true",
                      help="the GMSK --conv dispatch and v27 sweep points")
    args = ap.parse_args(argv)
    if args.run:
        fn = run_large if args.large else run_conv if args.conv else run
        print(json.dumps(fn()), flush=True)
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
        flags = ["--large"] if args.large else ["--conv"] if args.conv \
            else []
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--run", *flags], cwd=sides[side], env=env,
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        t = json.loads(out.stdout.strip().splitlines()[-1])
        if flags:
            print(f"{side:>5} ({t.pop('package')}): " + ", ".join(
                f"{k} {v:.6g}" for k, v in t.items()), flush=True)
            continue
        print(f"{side:>5} ({t['package']}): device B1 {t['B1']:.2f} us, "
              f"B2 {t['B2']:.2f} us, B3 {t['B3']:.2f} us; a wrapper call "
              f"B1 {t['B1 call']:.2f} us, B2 {t['B2 call']:.2f} us, B3 "
              f"{t['B3 call']:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
