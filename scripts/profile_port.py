"""Profile of the PyTorch/CUDA port's flexframe, GMSK and 802.11a receivers
on one CUDA device.

The OFDM receivers' stages are the benchmark's ``rx.*`` spans
(``python3 rxbench/run.py --trace 1``), and a kernel's own device time is
``scripts/kernel_turns.py``'s.  The other receivers have no spans yet, so
this script splits their dispatches with CUDA events and syncs, on the
streams of their TX apps at the defaults, and measures:

* for the flexframe receiver (``flexframe_tx``: 40 frames of 1,024 bytes,
  resampled at 0.5 as ``flexframe_rx`` does): one 8-block
  ``flex_sync_blocks_batched`` dispatch (blocks 16-23) with its results
  copied to the host, its stage times (front end, candidate decode,
  results and host copy);
* for the GMSK receiver (``gmskframe_tx``: 40 frames; and with a v27
  payload through the ``--conv`` sync): one 8-block
  ``gmsk_sync_blocks_batched`` dispatch (blocks 8-15), its stages split
  into front end, candidate decode (timing, CFO, phase tracking, header),
  payload decode (demap and FEC: the Viterbi under ``--conv``) and results
  with the host copy; and the Viterbi's peak device memory at the largest
  input a dispatch gives it (v29, 32 rows at the ``fec1`` stage's budget);
* for the 802.11a receiver, on ``wlanframe_tx`` streams (rate 6, 200 and
  1,500-byte PSDUs): one detecting block at ``-p 256`` and ``-p 1500``,
  its stages split into detect, the SIGNAL and the DATA soft Viterbi, and
  the rest of the candidate decode with the host copy;

each with the wall time of whole dispatches, the device busy time and its
share of the wall, device kernels, peak device memory and the top device
kernels.  Decoding is checked by the ``gpu`` tests, not here.  Prints one
JSON line per measurement and writes them all to ``--out``.

    python3 scripts/profile_port.py [--out build/profile_port.json]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# the flexframe and GMSK apps' defaults and their profiled dispatches
FF_BLOCK, FF_BATCH, FF_MAX_PAYLOAD, FF_MAX_FRAMES = 8192, 8, 2048, 4
FF_FRAMES, FF_PAYLOAD, FF_RX_RATE, FF_DISPATCH = 40, 1024, 0.5, 2
GM_BLOCK, GM_MAX_PAYLOAD, GM_MAX_FRAMES, GM_DISPATCH = 8192, 1024, 4, 1
GM_FRAMES, GM_PAYLOAD = 40, 200
WLAN_PSDU, WLAN_MTU = 200, 1500


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run_app(main_fn, argv) -> None:
    with contextlib.redirect_stdout(io.StringIO()):
        if main_fn(argv) != 0:
            raise AssertionError(f"{argv}: nonzero exit")


def dispatch_input(sync, state_cls, stream, first_block, dev):
    """The state (a ``state_cls``) a flexframe or GMSK sync carries into
    blocks ``first_block`` .. of ``stream`` and those 8 blocks, on
    ``dev``."""
    bs = sync.block_size
    full = np.zeros(sync.overlap + (first_block + FF_BATCH) * bs,
                    np.complex64)
    body = stream[:(first_block + FF_BATCH) * bs]
    full[sync.overlap:sync.overlap + len(body)] = body
    exts = torch.as_tensor(full).unfold(0, sync.overlap + bs, bs)[
        first_block:]
    st = state_cls(tail=exts[0, :sync.overlap].to(dev),
             base=torch.tensor(first_block * bs - sync.overlap,
                               dtype=torch.int32, device=dev))
    return st, exts[:, sync.overlap:].contiguous().to(dev)


def first_detecting_block(stream, sync, dev):
    """(state before, block) of the first block of ``stream`` whose sync
    step detects a frame, on ``dev``."""
    from liquid_usrp_tpu_torch.framing import wlan
    bs = sync.block_size
    x = np.zeros((-(-len(stream) // bs) + sync.overlap // bs + 1) * bs,
                 np.complex64)
    x[:len(stream)] = stream
    state = wlan.wlan_sync_init(sync, dev)
    for blk in torch.as_tensor(x.reshape(-1, bs), device=dev):
        new, res = wlan.wlan_sync_block(sync, state, blk)
        if bool(res.psdu_valid.any()):
            return state, blk
        state = new
    raise AssertionError("no detecting block")


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


def profile_ff_dispatch(rx_stream, dev, stage_calls=5, wall_calls=5,
                        prof_calls=3):
    """One 8-block dispatch of the flexframe receiver (blocks 16-23) with
    its results copied to the host: stage times (front end, candidate
    decode, results and host copy; CUDA events with a sync between them),
    wall time, device busy time and share, kernels, peak memory and the top
    device kernels."""
    from liquid_usrp_tpu_torch.framing import flexframe as ff
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    sync = fs.make_flex_sync(ff.make_flex_params(), block_size=FF_BLOCK,
                             max_payload=FF_MAX_PAYLOAD,
                             max_frames=FF_MAX_FRAMES)
    st0, blocks = dispatch_input(sync, fs.FlexSyncState, rx_stream,
                                 FF_DISPATCH * FF_BATCH, dev)
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
    """One 8-block dispatch of the GMSK receiver (blocks 8-15) with its
    results copied to the host: stage times (front end, candidate decode, payload decode, results and host copy;
    CUDA events with a sync after each, so that each stage's time holds
    its own host launches and nothing of the next), their sum, the wall
    time of whole dispatches (a loop of its own), device busy time and
    share, kernels, peak memory and the top device kernels."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.framing import payload as payload_codec
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    from liquid_usrp_tpu_torch.ops import modem
    sync = gf.make_gmsk_sync(gf.make_gmsk_params(), block_size=GM_BLOCK,
                             max_payload=GM_MAX_PAYLOAD,
                             max_frames=GM_MAX_FRAMES, enable_conv=conv)
    st0, blocks = dispatch_input(sync, gf.GmskSyncState, stream,
                                 GM_DISPATCH * FF_BATCH, dev)
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
    st0, blk = first_detecting_block(stream, sync, dev)

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
    sys.path.insert(0, str(ROOT))
    from liquid_usrp_tpu_torch.apps import (flexframe_tx, gmskframe_tx,
                                            wlanframe_tx)
    from liquid_usrp_tpu_torch.apps.common import resample_stream
    from liquid_usrp_tpu_torch.io.streams import read_iq
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"card": card()}
    print(out["card"], flush=True)
    with tempfile.TemporaryDirectory() as tmpdir:
        def tx(main_fn, name, *argv):
            f = str(Path(tmpdir) / name)
            run_app(main_fn.main, ["-o", f, *argv])
            return read_iq(f)
        ff_stream = resample_stream(tx(flexframe_tx, "ff.iq", "-N",
                                       str(FF_FRAMES), "-P", str(FF_PAYLOAD),
                                       "-s", "42"), FF_RX_RATE, dev)
        gm = ("-N", str(GM_FRAMES), "-P", str(GM_PAYLOAD), "-s", "42")
        gm_stream = tx(gmskframe_tx, "gm.iq", *gm)
        gm_conv_stream = tx(gmskframe_tx, "gmc.iq", *gm, "-c", "v27", "-k",
                            "none")
        wlan_streams = {p: tx(wlanframe_tx, f"w{p}.iq", "-N", "2", "-P",
                              str(p)) for p in (WLAN_PSDU, WLAN_MTU)}
    out["flexframe_dispatch"] = profile_ff_dispatch(ff_stream, dev)
    out["gmsk_dispatch"] = profile_gm_dispatch(gm_stream, dev, False)
    out["gmsk_conv_dispatch"] = profile_gm_dispatch(gm_conv_stream, dev,
                                                    True)
    out["wlan_block"] = {p: profile_wlan_block(
        {WLAN_PSDU: 256}.get(p, p), wlan_streams[p], dev)
        for p in wlan_streams}
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
