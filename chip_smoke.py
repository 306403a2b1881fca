"""On-card smoke run of the PyTorch/CUDA port (``liquid_usrp_tpu_torch``).

Drives the port's main path — the multichannel OFDM receiver (NCO
mix-down -> 2N-bin PFB analyzer -> batched N-channel detect + decode) — once
on one CUDA device at the full bench configuration, and checks it:

1. the card's name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``liquid_usrp_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (B1 max abs difference <= 1e-4; B2
   ``detected`` identical, ``vals`` atol 1e-4, detected offsets equal or
   within 3 samples, and ``c_at`` within 1e-4 of ``|c|`` of the plain lag
   correlation at the kernel's offsets), with times;
4. the main path at N=4, M=48, cp=6, taper=4, 400-byte payloads,
   ``block_size=65536``, ``n_blocks=2``, ``max_frames=24``,
   ``max_payload=512`` for detect levels ``use_pallas`` 0, 1 and 2, on a
   mixture built by the port's own TX exactly as ``bench.py`` builds its
   mixture: every injected frame must decode (88/88) with each channel's
   count and uint32 payload fingerprint as ``bench.py`` expects; the same
   frames with a carrier frequency offset of 0.035-0.05 rad/sample per
   channel must decode too, each with its offset estimated within 1.5e-3
   (this fails if B2's ``c_at``, which seeds the coarse estimate, is
   wrong); and the kernels of levels 1 and 2 must have launched during
   that run;
5. the class entry point, ``MultichannelRx.execute + flush``, on a short
   mixture;
6. decode-verified samples/s per level, timed with CUDA events over
   ``TIMED_STEPS`` steps (a smoke window, not a benchmark): each timed
   step decodes the loaded chunk from the initial state, and each must
   give the count and fingerprint of the checked first step.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero without that line; so does a machine without CUDA.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N = 4
M, CP, TAPER = 48, 6, 4
PAYLOAD = 400
BLOCK = 65536
N_BLOCKS = 2
MAX_FRAMES = 24
MAX_PAYLOAD = 512
TIMED_STEPS = 10
CFOS = (0.045, -0.04, 0.035, -0.05)    # rad/sample, per channel
CFO_ATOL = 1.5e-3
KERNELS = {
    "detect_metric_xcorr_onepass": dict(
        level=1, source="liquid_usrp_tpu_torch/csrc/xcorr_metric.cu",
        replaces="liquid_usrp_tpu/ops/pallas_kernels.py:616"),
    "detect_candidates_onepass": dict(
        level=2, source="liquid_usrp_tpu_torch/csrc/detect_candidates.cu",
        replaces="liquid_usrp_tpu/ops/pallas_kernels.py:491"),
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls (CUDA events,
    after two warm-up calls)."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_mixture(params, props, total, margin, dev, cfos=None):
    """``bench.py::_build_loaded_mixture`` with the port's TX: per-channel
    back-to-back frames (random headers/payloads from ``default_rng(0)``)
    through the m=13 synthesizer -> (mixture [2N*total], payloads).
    ``cfos``: a frequency offset (rad/sample) per channel stream."""
    from liquid_usrp_tpu_torch.framing import ofdm
    from liquid_usrp_tpu_torch.models.multichannel import make_mctx_step
    rng = np.random.default_rng(0)
    flen = ofdm.frame_length(params, props, PAYLOAD)
    gap = 128
    n_frames = max(1, (total - margin) // (flen + gap))
    streams = np.zeros((total, N), np.complex64)
    payloads = []
    for ch in range(N):
        per_ch, pos = [], 0
        for _ in range(n_frames):
            h = rng.integers(0, 256, 8, dtype=np.uint8)
            p = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
            per_ch.append(p)
            w = ofdm.assemble_frame(params, props,
                                    torch.as_tensor(h, device=dev),
                                    torch.as_tensor(p, device=dev))
            streams[pos:pos + flen, ch] = w.cpu().numpy()
            pos += flen + gap
        payloads.append(per_ch)
    if cfos is not None:
        n = np.arange(total)
        for ch, cfo in enumerate(cfos):
            streams[:, ch] *= np.exp(1j * cfo * n).astype(np.complex64)
    init, step = make_mctx_step(N, dev)
    Y = np.zeros((total, 2 * N), np.complex64)
    Y[:, :N] = streams
    st, out = init(), []
    for lo in range(0, total, 1 << 15):
        st, y = step(st, torch.as_tensor(Y[lo:lo + (1 << 15)], device=dev))
        out.append(y.cpu().numpy())
    return np.concatenate(out), payloads


def expected_fingerprints(payloads, weights):
    """``bench.py::_expected_fingerprints``: per-channel frame counts and
    order-independent uint32 payload fingerprints."""
    fps, counts = [], []
    for per_ch in payloads:
        acc = 0
        for p in per_ch:
            pad = np.zeros(MAX_PAYLOAD, np.uint64)
            pad[:len(p)] = p
            acc = (acc + int((pad * weights.astype(np.uint64)).sum())) \
                & 0xFFFFFFFF
        fps.append(acc)
        counts.append(len(per_ch))
    return counts, fps


def fingerprint(res, w64):
    """Per-channel (count, uint32 fingerprint) of the payload-valid rows, as
    device tensors ``[N]`` (the fingerprint not yet reduced mod 2^32)."""
    ok = res.payload_valid
    row_fp = (res.payload.to(torch.int64) * w64).sum(-1) & 0xFFFFFFFF
    red = tuple(range(1, ok.dim()))
    fp = torch.where(ok, row_fp, torch.zeros_like(row_fp)).sum(red)
    return ok.sum(red), fp


def check_decoded(what, cnt, fp, expected):
    """Raise unless every channel's count and fingerprint are expected."""
    cnt = cnt.cpu().numpy()
    fp = fp.cpu().numpy() & 0xFFFFFFFF
    exp_cnt, exp_fp = expected
    for ch in range(N):
        if int(cnt[ch]) != exp_cnt[ch]:
            raise AssertionError(f"{what} channel {ch}: decoded "
                                 f"{int(cnt[ch])} frames, injected "
                                 f"{exp_cnt[ch]}")
        if int(fp[ch]) != exp_fp[ch]:
            raise AssertionError(f"{what} channel {ch}: payload "
                                 f"fingerprint mismatch")
    return fp


def decode_stream(step, init, blocks, flush, n_flush, w64):
    """One loaded chunk then ``n_flush`` flush chunks from the initial
    state: (count, fingerprint) per channel of the whole run, the first
    step's (count, fingerprint), and the results of every step."""
    st, res = step(init(), blocks)
    first = fingerprint(res, w64)
    cnt, fp = first
    out = [res]
    for _ in range(n_flush):
        st, res = step(st, flush)
        c2, f2 = fingerprint(res, w64)
        cnt, fp = cnt + c2, fp + f2
        out.append(res)
    return (cnt, fp), first, out


def check_kernels(sync, rx, blocks):
    """Each kernel vs its plain version at the main path's shapes (the
    extended windows of the first chunk).  Returns per-kernel stats."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.ops import kernels
    st = rx.init_state()
    _, _, chans = rx.front_end(st, blocks)
    _, exts = ofdm_sync.extended_windows(sync, st.syncs.tail, chans)
    print(f"kernel inputs: {tuple(exts.shape)} {exts.dtype}", flush=True)
    tmpl = rx.tables.xc_tmpl
    span = ofdm_sync._xc_span(len(tmpl))
    n_metric = sync.block_size + 2 * M + 1
    d, L = M // 4, 2 * M - M // 4
    b1_args = (exts, tmpl, span, n_metric)
    b2_args = (exts, d, L, M, sync.block_size, sync.threshold,
               sync.max_frames)

    got = kernels.detect_metric_xcorr_onepass(*b1_args)
    torch.cuda.synchronize()
    ref = kernels.detect_metric_xcorr_plain(*b1_args)
    torch.cuda.synchronize()
    b1_err = float((got - ref).abs().max())
    print(f"B1 kernel vs plain: max abs diff {b1_err:.3e} (limit 1e-4), "
          f"metric peak {float(ref.max()):.4f}", flush=True)
    if not b1_err <= 1e-4:
        raise AssertionError(f"B1 disagrees with its plain version: {b1_err}")

    v, loc, c = kernels.detect_candidates_onepass(*b2_args)
    torch.cuda.synchronize()
    vr, lr, _ = kernels.detect_candidates_plain(*b2_args)
    _, c_full = kernels.autocorr_metric(exts, d, L)
    torch.cuda.synchronize()
    det, detr = v > 0, vr > 0
    if not torch.equal(det, detr):
        raise AssertionError("B2 detected mask differs from its plain "
                             "version")
    b2_err = float((v - vr).abs().max())
    loc_err = 0
    for row in range(exts.shape[0]):
        a = np.sort(loc[row][det[row]].cpu().numpy())
        b = np.sort(lr[row][detr[row]].cpu().numpy())
        if len(a):
            loc_err = max(loc_err, int(np.abs(a.astype(np.int64) - b).max()))
    # c_at against the plain lag correlation at the kernel's own offsets
    c_ref = torch.gather(c_full, -1, loc.to(torch.int64))[det]
    c_rel = float(((c[det] - c_ref).abs() / c_ref.abs()).max())
    print(f"B2 kernel vs plain: {int(det.sum())} detected (identical), vals "
          f"max abs diff {b2_err:.3e} (limit 1e-4), locs max diff {loc_err} "
          f"(limit 3), c_at max rel diff {c_rel:.3e} (limit 1e-4)",
          flush=True)
    if not (b2_err <= 1e-4 and loc_err <= 3 and bool(det.any())):
        raise AssertionError("B2 disagrees with its plain version")
    if not c_rel <= 1e-4:
        raise AssertionError(f"B2 c_at disagrees with the plain lag "
                             f"correlation: {c_rel}")

    times = {
        "detect_metric_xcorr_onepass": (
            cuda_ms(lambda: kernels.detect_metric_xcorr_onepass(*b1_args),
                    50),
            cuda_ms(lambda: kernels.detect_metric_xcorr_plain(*b1_args), 10),
            b1_err),
        "detect_candidates_onepass": (
            cuda_ms(lambda: kernels.detect_candidates_onepass(*b2_args), 50),
            cuda_ms(lambda: kernels.detect_candidates_plain(*b2_args), 10),
            b2_err),
    }
    for name, (ms, plain_ms, _) in times.items():
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({tuple(exts.shape)} rows)", flush=True)
    return times


def run_level(level, params, mixes, flush, weights, expected, dev, label):
    """The main path at one detect level: decode each loaded chunk of
    ``mixes`` (the bench mixture, then the same frames with ``CFOS``) and
    the flush chunks, check counts, fingerprints and the estimated
    offsets, then time steps of the bench chunk and check each."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import \
        make_mcrx_batched_step
    from liquid_usrp_tpu_torch.ops import kernels
    sync = ofdm_sync.make_sync(params, block_size=BLOCK,
                               max_payload=MAX_PAYLOAD,
                               max_frames=MAX_FRAMES, use_pallas=level)
    init, step = make_mcrx_batched_step(N, sync, N_BLOCKS, dev)
    w64 = torch.as_tensor(weights.astype(np.int64), device=dev)
    n_flush = -(-(sync.overlap // sync.block_size + 1) // N_BLOCKS)
    blocks, cfo_blocks = mixes
    kernels.reset_launch_counts()
    total, first, _ = decode_stream(step, init, blocks, flush, n_flush, w64)
    cfo_total, _, cfo_res = decode_stream(step, init, cfo_blocks, flush,
                                          n_flush, w64)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    fp = check_decoded(f"level {level}", *total, expected)
    check_decoded(f"level {level} with CFO", *cfo_total, expected)
    want = torch.tensor(CFOS, device=dev)[:, None, None]
    cfo_err = max(float(torch.where(r.payload_valid, (r.cfo - want).abs(),
                                    torch.zeros_like(r.cfo)).max())
                  for r in cfo_res)
    if not cfo_err <= CFO_ATOL:
        raise AssertionError(f"level {level}: CFO estimate off by {cfo_err}")
    for name, k in KERNELS.items():
        if k["level"] == level and launches[name] <= 0:
            raise AssertionError(f"level {level}: kernel {name} was not "
                                 f"launched on the main path")
    n_dec, n_exp = int(total[0].sum()), sum(expected[0])
    print(f"main path use_pallas={level}: {n_dec}/{n_exp} frames decoded, "
          f"fingerprints match ({[hex(int(f)) for f in fp]}); with CFO "
          f"{int(cfo_total[0].sum())}/{n_exp}, offsets within "
          f"{cfo_err:.2e} (limit {CFO_ATOL}); kernel launches {launches}",
          flush=True)

    # every timed step decodes the loaded chunk from the initial state and
    # must reproduce the checked first step
    st0, timed = init(), []

    def one():
        _, res = step(st0, blocks)
        timed.append(fingerprint(res, w64))

    ms = cuda_ms(one, TIMED_STEPS)
    for cnt, fpr in timed:
        if not (torch.equal(cnt, first[0]) and torch.equal(fpr, first[1])):
            raise AssertionError(f"level {level}: a timed step decoded "
                                 f"other frames than the checked first step")
    sps = blocks.shape[-1] / (ms * 1e-3)
    print(f"main path use_pallas={level}: {ms:.3f} ms/step, "
          f"{sps / 1e6:.3f} MS/s decode-verified over {TIMED_STEPS} steps "
          f"({blocks.shape[-1]} samples/step, {int(first[0].sum())} frames "
          f"each) on {label}", flush=True)
    return launches, ms


def check_class_entry(dev):
    """MultichannelRx.execute + flush on a short two-frames-per-channel
    mixture from MultichannelTx."""
    from liquid_usrp_tpu_torch.models.multichannel import (MultichannelRx,
                                                           MultichannelTx)
    rng = np.random.default_rng(5)
    tx = MultichannelTx(N, M=M, cp_len=CP, taper_len=TAPER, device=dev)
    rx = MultichannelRx(N, M=M, cp_len=CP, taper_len=TAPER, device=dev)
    sent, chunks = {}, []
    for _ in range(2):
        for ch in range(N):
            h = rng.integers(0, 256, 8, dtype=np.uint8)
            h[2] = ch
            p = rng.integers(0, 256, 100, dtype=np.uint8)
            tx.update_data(ch, h, p)
            sent[bytes(h)] = p
        chunks.append(tx.generate_samples(
            max(len(q) for q in tx._queues) + 64))
    frames = rx.execute(np.concatenate(chunks)) + rx.flush()
    valid = {bytes(f["header"]): f for f in frames if f["payload_valid"]}
    if set(valid) != set(sent):
        raise AssertionError(f"MultichannelRx decoded {len(valid)} of "
                             f"{len(sent)} frames")
    for h, p in sent.items():
        if not np.array_equal(valid[h]["payload"], p):
            raise AssertionError("MultichannelRx payload mismatch")
    print(f"MultichannelRx.execute + flush: {len(valid)}/{len(sent)} frames "
          f"payload-exact", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import liquid_usrp_tpu_torch
    here = Path(__file__).resolve().parent
    if Path(liquid_usrp_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: liquid_usrp_tpu_torch is not the checkout beside "
              "this script", file=sys.stderr)
        return 1
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import Mcrx
    from liquid_usrp_tpu_torch.ops import _build
    t_start = time.perf_counter()
    label = card()
    print(label, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({'built' if info['built'] else 'cached'} {info['path']})",
          flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    params = ofdm.make_ofdm_params(M, CP, TAPER)
    props = ofdm.default_props()
    sync1 = ofdm_sync.make_sync(params, block_size=BLOCK,
                                max_payload=MAX_PAYLOAD,
                                max_frames=MAX_FRAMES, use_pallas=1)
    margin = sync1.overlap + 8 * M
    total = BLOCK * N_BLOCKS
    t0 = time.perf_counter()
    mixture, payloads = build_mixture(params, props, total, margin, dev)
    nrng = np.random.default_rng(1)
    noise = (nrng.normal(size=mixture.shape) +
             1j * nrng.normal(size=mixture.shape)).astype(np.complex64)
    g = 2 * N * BLOCK * N_BLOCKS
    blocks = torch.as_tensor((mixture + 0.01 * noise).reshape(g), device=dev)
    # the same frames and noise, each channel offset by its CFOS entry
    cfo_mixture, _ = build_mixture(params, props, total, margin, dev, CFOS)
    cfo_blocks = torch.as_tensor((cfo_mixture + 0.01 * noise).reshape(g),
                                 device=dev)
    flush = torch.as_tensor((0.01 * (nrng.normal(size=g) + 1j *
                                     nrng.normal(size=g))
                             ).astype(np.complex64), device=dev)
    weights = np.random.default_rng(0xF1B5).integers(
        0, 1 << 32, MAX_PAYLOAD, dtype=np.uint32)
    expected = expected_fingerprints(payloads, weights)
    print(f"mixtures: {len(mixture)} samples, {sum(expected[0])} frames "
          f"({expected[0]} per channel), without and with CFO {CFOS}, "
          f"built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    times = check_kernels(sync1, Mcrx(N, sync1, N_BLOCKS, dev), blocks)

    launches, step_ms = {}, {}
    for level in (0, 1, 2):
        lv_launch, step_ms[level] = run_level(
            level, params, (blocks, cfo_blocks), flush, weights, expected,
            dev, label)
        for name, k in KERNELS.items():
            if k["level"] == level:
                launches[name] = lv_launch[name]

    check_class_entry(dev)
    print(f"main path ms/step by level {step_ms}; total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[name],
         "max_abs_err": times[name][2], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, k in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
