"""Profile of the PyTorch/CUDA port's four paths on one CUDA device.

Builds the bench mixture as ``chip_smoke.py`` does (N=4, M=48, 400-byte
payloads, ``block_size=65536``, ``n_blocks=2``), the single-channel stream
of ``chip_smoke.py`` (``ofdmflexframe_tx`` defaults, 40 frames) and its
flexframe stream (``flexframe_tx`` defaults, 40 frames of 1024 bytes,
resampled at 0.5 as ``flexframe_rx`` does), and measures:

* per ported kernel, at its path's shapes (B1/B2 on the multichannel
  windows, B3/B4/B5 on the single-channel path's first 8 windows): the
  wrapper's time (CUDA events over back-to-back calls), the host time to
  enqueue one call, the kernel's own device time and the device kernels
  per call (``torch.profiler``), and the kernel's bound (its bytes over
  the HBM rate or its float32 operations over the float32 peak, as
  ``chip_smoke.py`` counts them) with the share of it the kernel reaches;
* per detect level (``use_pallas`` 0, 1, 2) of the multichannel path: the
  host self time a step of each stage's span in the profiled steps
  (``rx.front_end``, ``rx.detect``, ``rx.decode`` less its ``rx.codec``,
  and ``rx.codec``; ``rxbench/spans.py``), the step wall time, the device
  busy time and its share of the wall, device kernels per step, peak
  device memory and the top device kernels;
* per detect config of the single-channel path: the same for one 8-block
  ``sync_blocks_batched`` dispatch with its results copied to the host;
* for the flexframe receiver: the same for one 8-block
  ``flex_sync_blocks_batched`` dispatch (blocks 16-23, ``chip_smoke.py``'s
  timed dispatch), with its stage times (front end, candidate decode,
  results and host copy);
* for the GMSK receiver, on ``chip_smoke.py``'s GMSK streams (the
  ``gmskframe_tx`` defaults, 40 frames; and with a v27 payload through the
  ``--conv`` sync): the same for one 8-block ``gmsk_sync_blocks_batched``
  dispatch (blocks 8-15), its stages split into front end, candidate
  decode (timing, CFO, phase tracking, header), payload decode (demap and
  FEC: the Viterbi under ``--conv``) and results with the host copy; the
  Viterbi's own stage inside that dispatch (``chip_smoke.viterbi_ms``);
  and the Viterbi's peak device memory at the largest input a dispatch
  gives it (v29, 32 rows at the ``fec1`` stage's budget);
* for the 802.11a receiver, on ``wlanframe_tx`` streams (rate 6, 200 and
  1,500-byte PSDUs): the same for one detecting block at ``-p 256`` and
  ``-p 1500``, its stages split into detect, the SIGNAL and the DATA soft
  Viterbi, and the rest of the candidate decode with the host copy.

Steps after the first feed the same chunk from the carried state; their
results are not checked (``chip_smoke.py`` checks decoding).  Prints one
JSON line per measurement and writes them all to ``--out``.

    python3 scripts/profile_port.py [--out build/profile_port.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _traced(fn, n: int):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof


def _profile(fn, n: int):
    return _device_events(_traced(fn, n))


def _stage_ms(prof, steps: int) -> dict:
    """Host self time a step of each stage's ``rx.*`` span."""
    from rxbench import spans
    from rxbench.profiling import Op, Trace
    host = [Op(e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(spans.PREFIX)]
    trace = Trace(0.0, 0.0, steps, [], host)
    return {stage: spans.self_ms_per_dispatch(trace, "rx." + stage)
            for stage in ("front_end", "detect", "decode", "codec")}


def profile_kernels(s1, blocks, dev):
    """Wrapper time vs the kernel's own device time, per ported kernel."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import Mcrx
    from liquid_usrp_tpu_torch.ops import kernels
    rx = Mcrx(cs.N, s1, cs.N_BLOCKS, dev)
    st = rx.init_state()
    _, _, chans = rx.front_end(st, blocks)
    _, exts = ofdm_sync.extended_windows(s1, st.syncs.tail, chans)
    tmpl = rx.tables.xc_tmpl
    span = ofdm_sync._xc_span(len(tmpl))
    d, L = cs.M // 4, 2 * cs.M - cs.M // 4
    calls = {
        "detect_metric_xcorr_onepass": (
            "xcorr_metric_kernel",
            lambda: kernels.detect_metric_xcorr_onepass(
                exts, tmpl, span, s1.block_size + 2 * cs.M + 1)),
        "detect_candidates_onepass": (
            "detect_candidates_kernel",
            lambda: kernels.detect_candidates_onepass(
                exts, d, L, cs.M, s1.block_size, s1.threshold,
                s1.max_frames)),
    }
    rows, length = exts.shape
    work = {
        "detect_metric_xcorr_onepass": cs.work(
            "detect_metric_xcorr_onepass", rows, length,
            n_metric=s1.block_size + 2 * cs.M + 1, tmpl=tmpl, span=span),
        "detect_candidates_onepass": cs.work(
            "detect_candidates_onepass", rows, length, span=L, lag=d)}
    return _profile_calls(calls, work)


def profile_sc_kernels(exts):
    """B3, B4 and B5 on the single-channel path's first 8 windows."""
    from liquid_usrp_tpu_torch.ops import kernels
    lag = cs.M // 4
    span = 2 * cs.M - lag
    calls = {name: (kname, lambda f=getattr(kernels, name): f(exts, lag,
                                                                span))
             for name, kname in (
                 ("detect_metric_onepass", "autocorr_metric_kernel"),
                 ("detect_metric_fused_2d", "autocorr_prefix_kernel"),
                 ("detect_metric_fused", "autocorr_prefix_kernel"))}
    return _profile_calls(calls, {name: cs.work(name, *exts.shape,
                                                span=span, lag=lag)
                                  for name in calls})


def _profile_calls(calls, work):
    """Per kernel: wrapper and host times, device time alone, and the bound
    (``chip_smoke.work`` bytes and operations at the published peaks) with
    the share of it the kernel reaches."""
    out = {}
    for name, (kname, fn) in calls.items():
        wrapper_ms = cs.cuda_ms(fn, 100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_ms = (time.perf_counter() - t0) * 10.0
        torch.cuda.synchronize()
        ev = _profile(fn, 20)
        kern = [e for e in ev if kname in e.key]
        dev_us = sum(_device_us(e) for e in kern) / max(
            1, sum(e.count for e in kern))
        nbytes, flops = work[name]
        bound_ms, bound_by = cs.bound(nbytes, flops)
        out[name] = dict(
            wrapper_ms=wrapper_ms, host_enqueue_ms=host_ms,
            kernel_device_us=dev_us,
            all_device_us_per_call=sum(_device_us(e) for e in ev) / 20,
            device_kernels_per_call=sum(e.count for e in ev) / 20,
            bytes=nbytes, flops=flops, bound_us=bound_ms * 1e3,
            bound_by=bound_by, share_of_bound=bound_ms * 1e3 / dev_us)
        print(name, json.dumps(out[name]), flush=True)
    return out


def profile_level(level, params, blocks, dev, wall_steps=5, prof_steps=3):
    """Stage times, wall time, busy share and top kernels at one level."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import Mcrx
    sync = ofdm_sync.make_sync(params, block_size=cs.BLOCK,
                               max_payload=cs.MAX_PAYLOAD,
                               max_frames=cs.MAX_FRAMES, use_pallas=level)
    rx = Mcrx(cs.N, sync, cs.N_BLOCKS, dev)
    st = rx.init_state()
    for _ in range(2):
        st, _ = rx.step(st, blocks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(wall_steps):
        st, _ = rx.step(st, blocks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / wall_steps
    peak = torch.cuda.max_memory_allocated()
    state = [st]

    def one():
        state[0], _ = rx.step(state[0], blocks)

    prof = _traced(one, prof_steps)
    kev = _device_events(prof)
    busy_ms = sum(_device_us(e) for e in kev) / prof_steps / 1e3
    top = sorted(kev, key=_device_us, reverse=True)[:8]
    rec = dict(stage_ms=_stage_ms(prof, prof_steps), step_wall_ms=wall_ms,
               device_busy_ms_per_step=busy_ms,
               busy_share_of_wall=busy_ms / wall_ms,
               kernels_per_step=sum(e.count for e in kev) / prof_steps,
               peak_mem_bytes=peak,
               top=[(e.key[:90], _device_us(e) / prof_steps / 1e3,
                     e.count / prof_steps) for e in top])
    print("level", level, json.dumps(rec), flush=True)
    return rec


def profile_sc_config(config, params, stream, dev, wall_calls=5,
                      prof_calls=3):
    """One 8-block dispatch of the single-channel path at one detect
    config, from the initial state, results copied to the host: wall time,
    device busy time and share, kernels and the top device kernels."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    xcorr, level = config
    sync = ofdm_sync.make_sync(params, block_size=cs.SC_BLOCK,
                               max_payload=cs.SC_MAX_PAYLOAD,
                               use_pallas=level, xcorr_detect=xcorr)
    blocks = torch.as_tensor(stream[:cs.SC_BATCH * cs.SC_BLOCK].reshape(
        cs.SC_BATCH, cs.SC_BLOCK), device=dev)
    st0 = ofdm_sync.sync_init(sync, dev)

    def one():
        _to_host(ofdm_sync.sync_blocks_batched(sync, st0, blocks)[1])

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(wall_calls):
        one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / wall_calls
    kev = _profile(one, prof_calls)
    busy_ms = sum(_device_us(e) for e in kev) / prof_calls / 1e3
    top = sorted(kev, key=_device_us, reverse=True)[:8]
    rec = dict(dispatch_wall_ms=wall_ms, device_busy_ms=busy_ms,
               busy_share_of_wall=busy_ms / wall_ms,
               kernels_per_dispatch=sum(e.count for e in kev) / prof_calls,
               top=[(e.key[:90], _device_us(e) / prof_calls / 1e3,
                     e.count / prof_calls) for e in top])
    print("single channel", config, json.dumps(rec), flush=True)
    return rec


def profile_ff_dispatch(rx_stream, dev, stage_calls=5, wall_calls=5,
                        prof_calls=3):
    """One 8-block dispatch of the flexframe receiver (``chip_smoke.py``'s
    timed dispatch) with its results copied to the host: stage times
    (front end, candidate decode, results and host copy; CUDA events with
    a sync between them), wall time, device busy time and share, kernels,
    peak memory and the top device kernels."""
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    sync = cs.ff_sync()
    st0, blocks = cs.ff_dispatch_input(sync, rx_stream, dev)
    n_blocks, bs = blocks.shape
    K = sync.max_frames

    def one():
        _to_host(fs.flex_sync_blocks_batched(sync, st0, blocks)[1])

    for _ in range(2):
        one()
    stages = {"front_end": 0.0, "decode": 0.0, "results_to_host": 0.0}
    for _ in range(stage_calls):
        torch.cuda.synchronize()
        e0 = _event()
        full = torch.cat([st0.tail, blocks.reshape(-1)])
        exts = full.unfold(0, sync.overlap + bs, bs)
        mf, metric, c1, c2, det, locs = fs._mf_and_detect(sync, exts)
        e1 = _event()
        row_of = torch.arange(n_blocks, device=dev).repeat_interleave(K)
        locs_f = locs.reshape(-1)
        decoded = fs._gated_decode(sync, mf, metric, bool(det.any()),
                                   row_of, locs_f,
                                   fs._row_gather(c1, row_of, locs_f),
                                   fs._row_gather(c2, row_of, locs_f),
                                   det.reshape(-1))
        e2 = _event()
        t_base = st0.base + (torch.arange(n_blocks, dtype=torch.int32,
                                          device=dev) * bs)[:, None]
        _to_host(fs._results(det, locs, t_base, decoded, (n_blocks, K)))
        e3 = _event()
        torch.cuda.synchronize()
        stages["front_end"] += e0.elapsed_time(e1) / stage_calls
        stages["decode"] += e1.elapsed_time(e2) / stage_calls
        stages["results_to_host"] += e2.elapsed_time(e3) / stage_calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(wall_calls):
        one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / wall_calls
    peak = torch.cuda.max_memory_allocated()
    kev = _profile(one, prof_calls)
    busy_ms = sum(_device_us(e) for e in kev) / prof_calls / 1e3
    top = sorted(kev, key=_device_us, reverse=True)[:8]
    rec = dict(stage_ms=stages, dispatch_wall_ms=wall_ms,
               device_busy_ms=busy_ms, busy_share_of_wall=busy_ms / wall_ms,
               kernels_per_dispatch=sum(e.count for e in kev) / prof_calls,
               peak_mem_bytes=peak,
               top=[(e.key[:90], _device_us(e) / prof_calls / 1e3,
                     e.count / prof_calls) for e in top])
    print("flexframe dispatch", json.dumps(rec), flush=True)
    return rec


def profile_gm_dispatch(stream, dev, conv, stage_calls=3, wall_calls=3,
                        prof_calls=2):
    """One 8-block dispatch of the GMSK receiver (``chip_smoke.py``'s
    timed dispatch) with its results copied to the host: stage times
    (front end, candidate decode, payload decode, results and host copy;
    CUDA events with a sync after each, so that each stage's time holds
    its own host launches and nothing of the next), their sum, the wall
    time of whole dispatches (a loop of its own), device busy time and
    share, kernels, peak memory and the top device kernels."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.framing import payload as payload_codec
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    from liquid_usrp_tpu_torch.ops import modem
    sync = cs.gm_sync(conv)
    st0, blocks = cs.gm_dispatch_input(sync, stream, dev)
    n_blocks, bs = blocks.shape
    K = sync.max_frames

    def one():
        _to_host(gf.gmsk_sync_blocks_batched(sync, st0, blocks)[1])

    for _ in range(2):
        one()
    stages = {"front_end": 0.0, "candidate_decode": 0.0,
              "payload_decode": 0.0, "results_to_host": 0.0}
    for _ in range(stage_calls):
        torch.cuda.synchronize()
        e0 = _event()
        full = torch.cat([st0.tail, blocks.reshape(-1)])
        exts = full.unfold(0, sync.overlap + bs, bs)
        z, metric, det, locs = gf._front_end(sync, exts)
        e1 = _event()
        torch.cuda.synchronize()
        row_of = torch.arange(n_blocks, device=dev).repeat_interleave(K)
        (user, ppts, plen, mod_f, f0, f1, check, hvalid, rssi, evm,
         cfo) = gf._decode_candidates(sync, z, metric, exts, row_of,
                                      locs.reshape(-1))
        e2 = _event()
        torch.cuda.synchronize()
        mod_bpsk = torch.full_like(plen, modem.MOD_BPSK)
        payload, pvalid = payload_codec.decode_payload_batch(
            sync.enc_max, sync.dec_max, sync.max_payload, ppts, mod_bpsk,
            f0, f1, check, plen, hvalid, sync.fecs, rows=det.reshape(-1))
        e3 = _event()
        torch.cuda.synchronize()
        t_base = st0.base + (torch.arange(n_blocks, dtype=torch.int32,
                                          device=dev) * bs)[:, None]
        _to_host(gf._results(det, locs, t_base, (
            user, payload, plen, mod_f, f0, f1, check, hvalid, pvalid,
            rssi, evm, cfo), (n_blocks, K)))
        e4 = _event()
        torch.cuda.synchronize()
        for name, a, b in (("front_end", e0, e1),
                           ("candidate_decode", e1, e2),
                           ("payload_decode", e2, e3),
                           ("results_to_host", e3, e4)):
            stages[name] += a.elapsed_time(b) / stage_calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(wall_calls):
        one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / wall_calls
    peak = torch.cuda.max_memory_allocated()
    kev = _profile(one, prof_calls)
    busy_ms = sum(_device_us(e) for e in kev) / prof_calls / 1e3
    top = sorted(kev, key=_device_us, reverse=True)[:8]
    rec = dict(stage_ms=stages, stage_sum_ms=sum(stages.values()),
               dispatch_wall_ms=wall_ms,
               device_busy_ms=busy_ms, busy_share_of_wall=busy_ms / wall_ms,
               kernels_per_dispatch=sum(e.count for e in kev) / prof_calls,
               peak_mem_bytes=peak,
               top=[(e.key[:90], _device_us(e) / prof_calls / 1e3,
                     e.count / prof_calls) for e in top])
    if conv:
        rec["viterbi_ms"] = cs.viterbi_ms(sync, stream, dev, cs.card())
        rec["viterbi_v29_memory"] = profile_viterbi_memory(sync, dev)
    print("GMSK dispatch", "--conv" if conv else "", json.dumps(rec),
          flush=True)
    return rec


def profile_viterbi_memory(sync, dev, rows=32):
    """Peak device memory and time of one v29 ``conv_decode`` of ``rows``
    rows at the ``fec1`` stage's budget of ``sync`` (the most trellis
    steps a dispatch's stage gives it, with ``S = 256`` states), above
    what was allocated before it."""
    from liquid_usrp_tpu_torch.framing import payload as payload_codec
    from liquid_usrp_tpu_torch.ops import fec
    s = fec.FEC_CONV_V29
    n = payload_codec._fit_bytes(s, sync.enc_max, sync.enc_max)
    rng = np.random.default_rng(0x29)
    data = torch.as_tensor(rng.integers(0, 256, (rows, n), dtype=np.uint8),
                           device=dev)
    enc = fec.fec_encode(s, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dec = fec.fec_decode(s, enc, n)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - before
    if not torch.equal(dec, data):
        raise AssertionError("v29 at the fec1 budget: wrong decode")
    rec = dict(rows=rows, n_bytes=n, trellis_steps=n * 8 + 8,
               peak_mem_bytes=peak, ms=ms)
    print("Viterbi v29 memory", json.dumps(rec), flush=True)
    return rec


def profile_wlan_block(max_psdu, stream, dev, calls=3, prof_calls=1):
    """One detecting block of the 802.11a receiver (the first block of
    ``stream`` that decodes a frame) at a ``max_psdu`` budget: its stages
    (detect: the metric and the candidates; the SIGNAL and the DATA soft
    Viterbi, each timed inside the block by CUDA events with a sync before
    and after; the rest of the candidate decode and the host copy), the
    block's wall time (a loop of its own), device busy time and share,
    kernels per block, peak memory and the top device kernels."""
    from liquid_usrp_tpu_torch.framing import wlan
    from liquid_usrp_tpu_torch.ops.corr import find_candidates
    sync = wlan.make_wlan_sync(max_psdu=max_psdu)
    st0, blk = cs.first_detecting_block(stream, sync, dev)

    def one():
        _, res = wlan.wlan_sync_block(sync, st0, blk)
        return [v.cpu() for v in res]

    for _ in range(2):
        one()
    vit = {"signal_viterbi": 0.0, "data_viterbi": 0.0}
    orig = wlan._viterbi_soft

    def timed_viterbi(pairs):
        torch.cuda.synchronize()
        a = _event()
        bits = orig(pairs)
        b = _event()
        torch.cuda.synchronize()
        name = "signal_viterbi" if pairs.shape[1] == 24 else "data_viterbi"
        vit[name] += a.elapsed_time(b) / calls
        return bits

    detect = block = 0.0
    wlan._viterbi_soft = timed_viterbi
    try:
        for _ in range(calls):
            torch.cuda.synchronize()
            e0 = _event()
            ext = torch.cat([st0.tail, blk])
            find_candidates(wlan._wlan_metric(sync, ext), wlan._DET_WIN,
                            sync.block_size, sync.threshold,
                            sync.max_frames)
            e1 = _event()
            torch.cuda.synchronize()
            detect += e0.elapsed_time(e1) / calls
            t0 = time.perf_counter()
            one()
            block += (time.perf_counter() - t0) * 1e3 / calls
    finally:
        wlan._viterbi_soft = orig
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(calls):
        one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    peak = torch.cuda.max_memory_allocated()
    kev = _profile(one, prof_calls)
    busy_ms = sum(_device_us(e) for e in kev) / prof_calls / 1e3
    top = sorted(kev, key=_device_us, reverse=True)[:8]
    stages = dict(detect=detect, **vit)
    stages["rest_and_host_copy"] = block - sum(stages.values())
    rec = dict(max_psdu=max_psdu, trellis_steps=24 + sync.nb,
               candidates=sync.max_frames, stage_ms=stages,
               block_wall_ms=wall_ms, device_busy_ms=busy_ms,
               busy_share_of_wall=busy_ms / wall_ms,
               kernels_per_block=sum(e.count for e in kev) / prof_calls,
               peak_mem_bytes=peak,
               top=[(e.key[:90], _device_us(e) / prof_calls / 1e3,
                     e.count / prof_calls) for e in top])
    print(f"WLAN block -p {max_psdu}", json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_port.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    from liquid_usrp_tpu_torch.apps import wlanframe_tx
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.io.streams import read_iq
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"card": cs.card()}
    print(out["card"], flush=True)
    params = ofdm.make_ofdm_params(cs.M, cs.CP, cs.TAPER)
    s1 = ofdm_sync.make_sync(params, block_size=cs.BLOCK,
                             max_payload=cs.MAX_PAYLOAD,
                             max_frames=cs.MAX_FRAMES, use_pallas=1)
    mixture, _ = cs.build_mixture(params, ofdm.default_props(),
                                  cs.BLOCK * cs.N_BLOCKS,
                                  s1.overlap + 8 * cs.M, dev)
    nrng = np.random.default_rng(1)
    noise = (nrng.normal(size=mixture.shape) +
             1j * nrng.normal(size=mixture.shape)).astype(np.complex64)
    blocks = torch.as_tensor((mixture + 0.01 * noise).reshape(-1),
                             device=dev)
    with tempfile.TemporaryDirectory() as tmpdir:
        stream, _ = cs.sc_transmit(str(Path(tmpdir) / "sc.iq"))
        _, ff_stream = cs.ff_transmit(str(Path(tmpdir) / "ff.iq"), dev)
        gm_stream = cs.gm_transmit(str(Path(tmpdir) / "gm.iq"))
        gm_conv_stream = cs.gm_transmit(str(Path(tmpdir) / "gmc.iq"), "-c",
                                        "v27", "-k", "none")
        wlan_streams = {}
        for p in (cs.WLAN_PSDU, cs.WLAN_MTU):
            f = str(Path(tmpdir) / f"w{p}.iq")
            cs.run_app(wlanframe_tx.main, ["-o", f, "-N", "2", "-P", str(p)])
            wlan_streams[p] = read_iq(f)
    out["kernels"] = profile_kernels(s1, blocks, dev)
    out["sc_kernels"] = profile_sc_kernels(cs.sc_windows(params, stream,
                                                         dev))
    out["levels"] = {level: profile_level(level, params, blocks, dev)
                     for level in (0, 1, 2)}
    out["sc_configs"] = {str(c): profile_sc_config(c, params, stream, dev)
                         for c in cs.SC_CONFIGS}
    out["flexframe_dispatch"] = profile_ff_dispatch(ff_stream, dev)
    out["gmsk_dispatch"] = profile_gm_dispatch(gm_stream, dev, False)
    out["gmsk_conv_dispatch"] = profile_gm_dispatch(gm_conv_stream, dev,
                                                    True)
    out["wlan_block"] = {p: profile_wlan_block(
        {cs.WLAN_PSDU: 256}.get(p, p), wlan_streams[p], dev)
        for p in wlan_streams}
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
