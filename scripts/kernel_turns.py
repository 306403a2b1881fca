"""Device and wrapper time of the port's CUDA kernels for two checkouts, in turns.

The source of ``PERF.md``'s kernel table.  Each kernel alone on the card
(``torch.profiler`` over 100 launches of its wrapper) and a wrapper call
(host time of 100 back-to-back calls, the least of 10 such means) at its
main path's shape, seeded 0.1-rms noise at M=48: B1 (the S0 template) and
B2 on the multichannel step's 8 x 87,310 windows, B3-B5 on the
single-channel dispatch's 8 x 100,366, the Viterbi on the
``ofdm1_conv.v27`` cell's 10 rows of v27 costs (16,422 steps), the
nearest-point scan on ``mcrx4.loaded``'s payload EVM call (192 x 12,416
points, 256 entries); beside each, the share of its bound (bytes over the
HBM rate or float32 operations over the float32 peak:
``rxbench/profiling.py``).  Runs go this checkout, the other, the other,
this checkout, each a fresh process with its side's package and kernel
build and this script's helpers, so that drift of the card shows within
a side.

``--large``: the device microseconds a call spends in the CUDA kernels of
B1 at M = 64-4,096, B2 at 512-4,096 (window sums; at 512 also on the
``ofdmflexframe_rx`` app's first-dispatch windows) and 64-472 (one pass),
B3 at 1,152-4,096 and at lag 2, span 9, on single-channel first-dispatch
windows of each M.  ``--conv``: the GMSK ``--conv`` dispatch (40 v27
frames of ``gmskframe_tx``: ms a dispatch and its Viterbi stage) and the
v27 sweep points of ``apps/ber_sweep.py`` (200 frames: seconds, BER, PER).

    python3 scripts/kernel_turns.py --other DIR [--large | --conv]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 100
BATCHES = 10
M = 48
VIT_ROWS, VIT_BYTES = 10, 2052
# the ofdmflexframe_rx app's first dispatch at M=512: its TX's defaults
SC_SEED, SC_BLOCK, SC_BATCH, SC_MAX_PAYLOAD, TAPER = 42, 16384, 8, 2048, 4
LM_FRAMES, LM_PAYLOAD = 4, 200
# the GMSK --conv stream (gmskframe_tx defaults) and its timed dispatch
GM_FRAMES, GM_PAYLOAD, GM_SEED = 40, 200, 42
GM_BLOCK, GM_MAX_PAYLOAD, GM_MAX_FRAMES, GM_BATCH = 8192, 1024, 4, 8
GM_DISPATCH, GM_TIMED_RUNS = 1, 2          # blocks 8..15, timed twice


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


def run_app(main_fn, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}, {out.getvalue()[-400:]}")
    return out.getvalue()


def sc_transmit(path, m, cp, frames, payload):
    """``ofdmflexframe_tx`` with ``frames`` of ``payload`` bytes at M =
    ``m``, cyclic prefix ``cp``, into ``path``: the stream."""
    from liquid_usrp_tpu_torch.apps import ofdmflexframe_tx
    from liquid_usrp_tpu_torch.io.streams import read_iq
    run_app(ofdmflexframe_tx.main, [
        "-o", path, "-N", str(frames), "-P", str(payload), "-s",
        str(SC_SEED), "-g", "-12", "-M", str(m), "-C", str(cp), "-T",
        str(TAPER), "-m", "qpsk", "-c", "none", "-k", "g2412"])
    return read_iq(path)


def sc_windows(params, stream, dev):
    """The extended windows of the single-channel path's first dispatch."""
    import torch
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    sync = ofdm_sync.make_sync(params, block_size=SC_BLOCK,
                               max_payload=SC_MAX_PAYLOAD)
    blocks = torch.as_tensor(stream[:SC_BATCH * SC_BLOCK].reshape(
        1, SC_BATCH, SC_BLOCK), device=dev)
    return ofdm_sync.extended_windows(
        sync, ofdm_sync.sync_init(sync, dev).tail[None], blocks)[1]


def app_windows(m):
    """The ``ofdmflexframe_rx`` app's first-dispatch windows at M = ``m``:
    its TX's 4 frames of 200 bytes, then 0.01-rms noise."""
    import numpy as np
    from liquid_usrp_tpu_torch.framing import ofdm
    with tempfile.TemporaryDirectory() as tmpdir:
        stream = sc_transmit(str(Path(tmpdir) / "s.iq"), m, m // 8,
                             LM_FRAMES, LM_PAYLOAD)
    rng = np.random.default_rng(m)
    n = SC_BATCH * SC_BLOCK
    padded = (0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
              ).astype(np.complex64)
    padded[:len(stream)] += stream[:n]
    return sc_windows(ofdm.make_ofdm_params(m, m // 8, TAPER), padded,
                      "cuda")


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
    x = app_windows(512)
    out["B2 M=512 app windows"] = kernels_us(
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


def gm_sync(conv=False):
    """The gmskframe_rx synchronizer (with ``--conv``: ``conv``)."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    return gf.make_gmsk_sync(gf.make_gmsk_params(), block_size=GM_BLOCK,
                             max_payload=GM_MAX_PAYLOAD,
                             max_frames=GM_MAX_FRAMES, enable_conv=conv)


def gm_dispatch_input(sync, stream, dev):
    """The GMSK sync state carried into dispatch ``GM_DISPATCH`` of
    ``stream`` and that dispatch's ``[GM_BATCH, block]`` blocks."""
    import numpy as np
    import torch
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    bs, first = sync.block_size, GM_DISPATCH * GM_BATCH
    full = np.zeros(sync.overlap + (first + GM_BATCH) * bs, np.complex64)
    body = stream[:(first + GM_BATCH) * bs]
    full[sync.overlap:sync.overlap + len(body)] = body
    exts = torch.as_tensor(full).unfold(0, sync.overlap + bs, bs)[first:]
    st = gf.GmskSyncState(
        tail=exts[0, :sync.overlap].to(dev),
        base=torch.tensor(first * bs - sync.overlap, dtype=torch.int32,
                          device=dev))
    return st, exts[:, sync.overlap:].contiguous().to(dev)


def dispatch_ms(sync, stream, dev):
    """ms of one 8-block dispatch from the state the sync carries into it
    (CUDA events over ``GM_TIMED_RUNS`` after two warm-up calls), each
    decoding the same frames."""
    import torch
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    st, blocks = gm_dispatch_input(sync, stream, dev)
    counts = []

    def dispatch():
        _, res = gf.gmsk_sync_blocks_batched(sync, st, blocks)
        counts.append(int(_to_host(res).payload_valid.sum()))
    dispatch()
    dispatch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GM_TIMED_RUNS):
        dispatch()
    end.record()
    torch.cuda.synchronize()
    if len(set(counts)) != 1 or counts[0] <= 0:
        raise AssertionError(f"GMSK --conv dispatches decoded {counts}")
    return start.elapsed_time(end) / GM_TIMED_RUNS


def viterbi_ms(sync, stream, dev):
    """The Viterbi's ms per dispatch inside the timed ``--conv`` dispatch:
    the host-clock time of its second FEC stage (``_fec_batch`` in
    ``fec0``, v27 over the dispatch's detected rows; the first, ``fec1``,
    is ``none``) with a sync before and after it, mean over
    ``GM_TIMED_RUNS`` dispatches after a warm-up one."""
    import torch
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.framing import payload as payload_codec
    st, blocks = gm_dispatch_input(sync, stream, dev)
    fec_batch = payload_codec._fec_batch
    stages = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fec_batch(*args, **kw)
        torch.cuda.synchronize()
        stages.append((time.perf_counter() - t0) * 1e3)
        return out

    payload_codec._fec_batch = timed
    try:
        for _ in range(GM_TIMED_RUNS + 1):
            gf.gmsk_sync_blocks_batched(sync, st, blocks)
    finally:
        payload_codec._fec_batch = fec_batch
    f0 = stages[3::2]     # two stages a dispatch; the first warms up
    if len(f0) != GM_TIMED_RUNS:
        raise AssertionError(f"--conv dispatch FEC stages: {stages}")
    return sum(f0) / len(f0)


def run_conv() -> dict:
    """The GMSK ``--conv`` dispatch and the v27 sweep points."""
    import torch
    from liquid_usrp_tpu_torch.apps import ber_sweep as bs
    from liquid_usrp_tpu_torch.apps import gmskframe_tx
    from liquid_usrp_tpu_torch.io.streams import read_iq
    out = {}
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmpdir:
        path = str(Path(tmpdir) / "gm.iq")
        run_app(gmskframe_tx.main, [
            "-o", path, "-N", str(GM_FRAMES), "-P", str(GM_PAYLOAD), "-s",
            str(GM_SEED), "-c", "v27", "-k", "none"])
        stream = read_iq(path)
    sync = gm_sync(conv=True)
    out["gmsk conv dispatch ms"] = dispatch_ms(sync, stream, dev)
    out["gmsk conv viterbi ms"] = viterbi_ms(sync, stream, dev)
    for fam, snr, soft in (("gmsk", -2.0, False), ("gmsk", -1.0, False),
                           ("gmsk", -3.0, True), ("ofdm", 3.0, False),
                           ("flex", 1.0, False)):
        cfg = bs.make_config(fam, 200, "v27", "none", soft=soft)
        st = bs.build_stream(cfg, 200, 0, dev)
        noisy = bs.add_noise(st, snr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = bs.receive(cfg, noisy)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        row = bs.row(bs.score(dets, st.positions, st.payloads, 200), snr)
        key = f"{fam} v27 {'soft' if soft else 'hard'} {snr:g} dB"
        out[key + " s"] = sec
        out[key + " ber"] = row["payload_ber"]
        out[key + " per"] = row["packet_error_rate"]
    out["package"] = str(Path(bs.__file__).resolve().parents[2])
    return out


def main_path_calls():
    """{name: (call, CUDA kernel name, work)} of each kernel at its main
    path's shape; ``work()`` gives the call's (bytes, float32
    operations)."""
    import numpy as np
    import torch
    from liquid_usrp_tpu_torch.framing import ofdm, payload
    from liquid_usrp_tpu_torch.ops import conv, fec, kernels
    gen = torch.Generator().manual_seed(0)
    x = (0.1 * torch.randn(8, 87310, dtype=torch.complex64,
                           generator=gen)).cuda()
    x3 = (0.1 * torch.randn(8, 100366, dtype=torch.complex64,
                            generator=gen)).cuda()
    tmpl = np.tile(ofdm.make_ofdm_params(M, 6, 4).s0_time, 2)
    lag, span = M // 4, 2 * M - M // 4
    n_metric = 65536 + 2 * M + 1
    rows, length = x.shape
    rows3, length3 = x3.shape
    n_out = length - span - lag + 1
    n_out3 = length3 - span - lag + 1
    prefix = rows3 * (2 * (length3 - lag + 1) + length3 + 1) * 4 + \
        rows3 * n_out3 * 12
    rng = np.random.default_rng(0)
    s = fec.FEC_CONV_V27
    data = rng.integers(0, 256, (VIT_ROWS, VIT_BYTES), dtype=np.uint8)
    bits = np.unpackbits(fec.fec_encode(s, torch.as_tensor(data)).numpy(),
                         axis=-1)
    noisy = np.packbits(bits ^ (rng.random(bits.shape) < 0.02), axis=-1)
    costs = conv._hard_costs(s, torch.as_tensor(noisy).cuda(), VIT_BYTES)
    R, n, C = 192, 12416, 256
    tab = payload._stacked_tables()[rng.integers(
        0, len(payload.PAYLOAD_MODS), R)][:, :C]
    pts = torch.as_tensor((rng.normal(size=(R, n)) + 1j * rng.normal(
        size=(R, n))).astype(np.complex64)).cuda()
    tab = torch.as_tensor(np.ascontiguousarray(tab)).cuda()

    def b1_work():
        # the bytes the metric reaches, as the benchmark counts them
        from rxbench.profiling import xcorr_work
        return xcorr_work(rows, n_metric, tmpl, 24)

    # B2/B3: the lag product, power and three window sums as running sums,
    # the metric and, for B2, the NMS max; B4/B5: four window differences
    # and the metric; the Viterbi: its costs read and bits written once;
    # the scan: 5 operations a (point, entry) pair
    return {
        "B1": (lambda: kernels.detect_metric_xcorr_onepass(
            x, tmpl, 24, n_metric), "xcorr_metric_kernel", b1_work),
        "B2": (lambda: kernels.detect_candidates_onepass(
            x, lag, span, M, 65536, 0.5, 24), "detect_candidates_kernel",
            lambda: (rows * length * 8 + rows * -(-n_out // 64) * 16,
                     rows * n_out * 25)),
        "B3": (lambda: kernels.detect_metric_onepass(x3, lag, span),
               "autocorr_metric_kernel",
               lambda: (rows3 * length3 * 8 + rows3 * n_out3 * 12,
                        rows3 * n_out3 * 21)),
        "B4": (lambda: kernels.detect_metric_fused_2d(x3, lag, span),
               "autocorr_prefix_kernel",
               lambda: (prefix, rows3 * n_out3 * 10)),
        "B5": (lambda: kernels.detect_metric_fused(x3, lag, span),
               "autocorr_prefix_kernel",
               lambda: (prefix, rows3 * n_out3 * 10)),
        "viterbi": (lambda: conv._viterbi(s, costs, conv.BIG_HARD),
                    "viterbi_warp_kernel",
                    lambda: (costs.numel() * 4 + costs.shape[0] *
                             costs.shape[1], 0)),
        "nearest": (lambda: payload._nearest_sym(pts, tab), "nearest_kernel",
                    lambda: (R * n * 20 + R * C * 8, 5 * R * n * C)),
    }


def run() -> dict:
    """One side: each kernel's device microseconds and a wrapper call's
    host microseconds, in this process's ``liquid_usrp_tpu_torch``."""
    from liquid_usrp_tpu_torch.ops import kernels
    calls = main_path_calls()
    out = {k: device_us(fn, kern) for k, (fn, kern, _) in calls.items()}
    out.update({f"{k} call": wrapper_us(fn)
                for k, (fn, _, _) in calls.items()})
    out["package"] = str(Path(kernels.__file__).resolve().parents[2])
    return out


def bounds() -> dict:
    """{name: (least microseconds, what sets it)} at the main paths'
    shapes (``rxbench.profiling.bound``)."""
    from rxbench.profiling import bound
    out = {}
    for k, (_, _, work) in main_path_calls().items():
        sec, by = bound(*work())
        out[k] = (sec * 1e6, by)
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
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    flags = ["--large"] if args.large else ["--conv"] if args.conv else []
    least = {} if flags else bounds()
    if least:
        print("bounds: " + ", ".join(f"{k} {us:.2f} us ({by})"
                                     for k, (us, by) in least.items()),
              flush=True)
    sides = {"this": ROOT, "other": args.other.resolve()}
    for side in ("this", "other", "other", "this"):
        env = dict(os.environ, PYTHONPATH=str(sides[side]))
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--run", *flags], cwd=sides[side], env=env,
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        t = json.loads(out.stdout.strip().splitlines()[-1])
        pkg = t.pop("package")
        if flags:
            print(f"{side:>5} ({pkg}): " + ", ".join(
                f"{k} {v:.6g}" for k, v in t.items()), flush=True)
            continue
        print(f"{side:>5} ({pkg}): device " + ", ".join(
            f"{k} {t[k]:.2f} us ({least[k][0] / t[k]:.1%})" for k in least)
            + "; a wrapper call " + ", ".join(
                f"{k} {t[k + ' call']:.2f} us" for k in least), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
