"""The port's receive paths, apps and layers on the card, end to end.

Every test here is marked ``gpu`` and skips without a CUDA device; the file
imports no JAX, so it runs with ``--noconftest`` beside
``tests/test_torch_gpu.py``.  The frames, seeds, counts and limits are
those the port's bring-up held the card to: the bench mixture
(``bench.py::_build_loaded_mixture`` through the port's TX, 88 frames) at
every detect level, the apps' loopbacks at their defaults, the TX worker,
a 1-rank NCCL world and the BER/PER sweep against the JAX package's curves
(``docs/ber_*.json``).  Every run holds B4 and B5, which lie on no path,
at 0 launches.
"""
import contextlib
import io
import json
import re
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from liquid_usrp_tpu_torch.ops import kernels

B1, B2, B3 = ("detect_metric_xcorr_onepass", "detect_candidates_onepass",
              "detect_metric_onepass")
DETECT = (B1, B2, B3, "detect_metric_fused_2d", "detect_metric_fused")
# the bench mixture and the multichannel path
N = 4
M, CP, TAPER = 48, 6, 4
PAYLOAD = 400
BLOCK = 65536
N_BLOCKS = 2
MAX_FRAMES = 24
MAX_PAYLOAD = 512
CFOS = (0.045, -0.04, 0.035, -0.05)    # rad/sample, per channel
CFO_ATOL = 1.5e-3
V27_FRAMES, VIT_BYTES = 20, 2052      # the ofdm1_conv.v27 cell's budget
VIT_ROWS = 10                         # its Viterbi rows a dispatch
# the single-channel path at the ofdmflexframe_tx/rx defaults
SC_FRAMES, SC_PAYLOAD, SC_SEED = 40, 1200, 42
SC_BLOCK, SC_BATCH, SC_MAX_PAYLOAD = 16384, 8, 2048
SC_CFO = 0.045                 # rad/sample, above pi / (2 M)
# detect configs (xcorr_detect, use_pallas) and the kernel each launches
SC_CONFIGS = {(True, 0): None, (True, 1): B1, (False, 0): None,
              (False, 1): B3, (False, 2): B2}
# the flexframe, packet and GMSK paths at their apps' defaults
FF_FRAMES, FF_PAYLOAD, FF_SEED = 40, 1024, 42
FF_BLOCK, FF_BATCH, FF_MAX_PAYLOAD, FF_MAX_FRAMES = 8192, 8, 2048, 4
FF_RX_RATE = 0.5               # flexframe_rx/packet_rx -r default
FF_CFO = 0.01                  # rad/sample at the file rate (k = 4)
FF_CFO_ATOL = 2e-3
METRIC_LOUD = 100.0            # metric held where energy >= this x floor
M16, CP16, TAPER16 = 16, 4, 2
GM_FRAMES, GM_PAYLOAD, GM_SEED = 40, 200, 42
GM_BLOCK, GM_MAX_PAYLOAD, GM_MAX_FRAMES = 8192, 1024, 4
GM_CFO, GM_CFO_ATOL = 0.01, 1e-3
CV_FRAMES = 10
SOFT_FRAMES, SOFT_SEED = 10, 42
SOFT_SNR = "-1.5"              # the low-SNR GMSK v27 file: soft above hard
# the streaming plumbing: the TX worker's step and bound
TXW_CHUNK, TXW_AHEAD, TXW_PACKETS = 256, 65536, 3
# 802.11a at the wlanframe_tx/rx defaults
WLAN_FRAMES, WLAN_PSDU, WLAN_SEED = 5, 200, 42
WLAN_MTU, WLAN_MTU_FRAMES = 1500, 3
WLAN_CFO_ATOL, WLAN_RSSI_ATOL = 1e-5, 1e-4
PAR_RANKS, PAR_TIMEOUT_S = 4, 600
# the BER/PER sweep at apps/ber_sweep.py's configs, against docs/ber_*.json
FID_PAYLOAD, FID_FRAMES = 200, 200
FID_WATERFALL = (0.02, 0.95)   # the JAX PERs whose points are checked
FID_SHIFT_DB = 0.5             # rule (a): PER_J(s + 0.5) <= PER <= ...
FID_SIGMAS = 3.0               # ... PER_J(s - 0.5), each widened so
FID_LEVEL_SNRS = (7.0, 8.0)    # OFDM: bracket 10 % PER, levels 0, 1, 2
FID_LEVEL_FLIPS = 2            # level 1's payload_valid flips vs level 0
FID_SOFT_SNR = {"ofdm": 2.0, "flex": 0.0, "gmsk": -3.0}
FID_INVALID_SNRS = (-2.0, -1.0)  # GMSK v27 hard: headers fail (fault C6)
LM_FRAMES, LM_PAYLOAD = 4, 200
DOCS = Path(__file__).resolve().parents[1] / "docs"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("apps")


def assert_launched(launches, *names, only=False):
    """Each kernel of ``names`` launched; B4 and B5, on no path, not; with
    ``only`` no other kernel of B1-B5 either."""
    for name in names:
        assert launches[name] > 0, (name, launches)
    idle = [k for k in DETECT if k not in names] if only else DETECT[3:]
    assert not any(launches[k] for k in idle), launches


# ---------------------------------------------------------------------------
# the bench mixture
# ---------------------------------------------------------------------------

def bench_streams(params, props, total, margin, dev, cfos=None):
    """The per-channel baseband of ``bench.py::_build_loaded_mixture``:
    back-to-back frames (random headers/payloads from ``default_rng(0)``)
    -> (streams [total, N], payloads).  ``cfos``: a frequency offset
    (rad/sample) per channel stream."""
    from liquid_usrp_tpu_torch.framing import ofdm
    rng = np.random.default_rng(0)
    flen = ofdm.frame_length(params, props, PAYLOAD)
    n_frames = max(1, (total - margin) // (flen + 128))
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
            pos += flen + 128
        payloads.append(per_ch)
    if cfos is not None:
        n = np.arange(total)
        for ch, cfo in enumerate(cfos):
            streams[:, ch] *= np.exp(1j * cfo * n).astype(np.complex64)
    return streams, payloads


def build_mixture(params, props, total, margin, dev, cfos=None):
    """:func:`bench_streams` through the m=13 synthesizer -> (mixture
    [2N * total], payloads)."""
    from liquid_usrp_tpu_torch.models.multichannel import make_mctx_step
    streams, payloads = bench_streams(params, props, total, margin, dev,
                                      cfos)
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
    """Per-channel (count, fingerprint not yet reduced mod 2^32) of the
    payload-valid rows."""
    ok = res.payload_valid
    row_fp = (res.payload.to(torch.int64) * w64).sum(-1) & 0xFFFFFFFF
    red = tuple(range(1, ok.dim()))
    fp = torch.where(ok, row_fp, torch.zeros_like(row_fp)).sum(red)
    return ok.sum(red), fp


def check_decoded(what, cnt, fp, expected):
    """Every channel's count and fingerprint as injected."""
    cnt = cnt.cpu().numpy()
    fp = fp.cpu().numpy() & 0xFFFFFFFF
    for ch in range(N):
        assert int(cnt[ch]) == expected[0][ch], (what, ch, cnt)
        assert int(fp[ch]) == expected[1][ch], (what, ch, "fingerprint")


def decode_stream(step, init, blocks, flush, n_flush, w64):
    """One loaded chunk then ``n_flush`` flush chunks from the initial
    state: the whole run's (count, fingerprint) and every step's results."""
    st, res = step(init(), blocks)
    cnt, fp = fingerprint(res, w64)
    out = [res]
    for _ in range(n_flush):
        st, res = step(st, flush)
        c2, f2 = fingerprint(res, w64)
        cnt, fp = cnt + c2, fp + f2
        out.append(res)
    return (cnt, fp), out


@pytest.fixture(scope="module")
def bench(dev):
    """The bench mixture of 88 frames in 0.01-rms noise, the same frames
    with ``CFOS``, a flush chunk of noise, the fingerprint weights and the
    expected counts and fingerprints."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    params = ofdm.make_ofdm_params(M, CP, TAPER)
    props = ofdm.default_props()
    sync1 = ofdm_sync.make_sync(params, block_size=BLOCK,
                                max_payload=MAX_PAYLOAD,
                                max_frames=MAX_FRAMES, use_pallas=1)
    margin, total = sync1.overlap + 8 * M, BLOCK * N_BLOCKS
    mixture, payloads = build_mixture(params, props, total, margin, dev)
    nrng = np.random.default_rng(1)
    noise = (nrng.normal(size=mixture.shape) +
             1j * nrng.normal(size=mixture.shape)).astype(np.complex64)
    g = 2 * N * BLOCK * N_BLOCKS
    blocks = torch.as_tensor((mixture + 0.01 * noise).reshape(g), device=dev)
    cfo_mixture, _ = build_mixture(params, props, total, margin, dev, CFOS)
    cfo_blocks = torch.as_tensor((cfo_mixture + 0.01 * noise).reshape(g),
                                 device=dev)
    flush = torch.as_tensor((0.01 * (nrng.normal(size=g) + 1j *
                                     nrng.normal(size=g))
                             ).astype(np.complex64), device=dev)
    weights = np.random.default_rng(0xF1B5).integers(
        0, 1 << 32, MAX_PAYLOAD, dtype=np.uint32)
    expected = expected_fingerprints(payloads, weights)
    assert sum(expected[0]) == 88
    return SimpleNamespace(
        params=params, sync1=sync1, mixture=mixture, noise=noise,
        blocks=blocks, cfo_blocks=cfo_blocks, flush=flush, weights=weights,
        expected=expected,
        w64=torch.as_tensor(weights.astype(np.int64), device=dev),
        n_flush=-(-(sync1.overlap // BLOCK + 1) // N_BLOCKS))


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def b1_vs_plain(args):
    got = kernels.detect_metric_xcorr_onepass(*args)
    ref = kernels.detect_metric_xcorr_plain(*args)
    assert float((got - ref).abs().max()) <= 1e-4


def b2_vs_plain(args):
    exts, d, L = args[:3]
    v, loc, c = kernels.detect_candidates_onepass(*args)
    vr, lr, _ = kernels.detect_candidates_plain(*args)
    _, c_full = kernels.autocorr_metric(exts, d, L)
    det = v > 0
    assert torch.equal(det, vr > 0) and bool(det.any())
    assert float((v - vr).abs().max()) <= 1e-4
    for row in range(exts.shape[0]):
        a = np.sort(loc[row][det[row]].cpu().numpy()).astype(np.int64)
        b = np.sort(lr[row][vr[row] > 0].cpu().numpy())
        assert np.abs(a - b).max(initial=0) <= 3, row
    c_ref = torch.gather(c_full, -1, loc.to(torch.int64))[det]
    assert float(((c[det] - c_ref).abs() / c_ref.abs()).max()) <= 1e-4


def metric_vs_plain(name, plain, limit, exts, m):
    lag, span = m // 4, 2 * m - m // 4
    got, c = getattr(kernels, name)(exts, lag, span)
    mr, cr = plain(exts, lag, span)
    assert got.shape == mr.shape
    assert float((got - mr).abs().max()) <= limit
    assert float((c - cr).abs().max() / cr.abs().max()) <= limit


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [B1, B2])
def test_detect_kernel_matches_plain_at_the_bench_windows(dev, bench,
                                                          kernel):
    """B1 (and B2, with k = ``max_frames``) against its plain version on
    the extended windows of the bench mixture's first chunk, as the
    multichannel front end gives them (8 rows of ``BLOCK`` plus the
    overlap)."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import Mcrx
    sync = bench.sync1
    rx = Mcrx(N, sync, N_BLOCKS, dev)
    st = rx.init_state()
    _, exts = ofdm_sync.extended_windows(
        sync, st.syncs.tail, rx.front_end(st, bench.blocks)[2])
    assert exts.shape[0] == N * N_BLOCKS
    if kernel == B1:
        tmpl = rx.tables.xc_tmpl
        b1_vs_plain((exts, tmpl, ofdm_sync._xc_span(len(tmpl)),
                     sync.block_size + 2 * M + 1))
    else:
        b2_vs_plain((exts, M // 4, 2 * M - M // 4, M, sync.block_size,
                     sync.threshold, sync.max_frames))


@pytest.mark.gpu
def test_viterbi_kernel_at_the_v27_cell_shape(dev):
    """The Viterbi kernel at the ``ofdm1_conv.v27`` cell's shape: 10 words
    of v27 over 2,052 bytes at 2 % bit errors, the last with a third of
    its steps erased; every bit of every step equal to the plain
    version's, and the 9 unerased rows decoded."""
    from liquid_usrp_tpu_torch.ops import conv, fec
    from liquid_usrp_tpu_torch.utils.bits import pack_bits
    s = fec.FEC_CONV_V27
    rng = np.random.default_rng(0x7E5B)
    data = rng.integers(0, 256, (VIT_ROWS, VIT_BYTES), dtype=np.uint8)
    bits = np.unpackbits(fec.fec_encode(s, torch.as_tensor(data)).numpy(),
                         axis=-1)
    noisy = np.packbits(bits ^ (rng.random(bits.shape) < 0.02), axis=-1)
    costs = conv._hard_costs(s, torch.as_tensor(noisy, device=dev),
                             VIT_BYTES)
    T = costs.shape[1]
    costs[-1, T // 3:2 * T // 3] = 0
    got = conv._viterbi(s, costs, conv.BIG_HARD)
    assert torch.equal(got, conv._viterbi_plain(s, costs, conv.BIG_HARD))
    ok = (pack_bits(got[:, :VIT_BYTES * 8]).cpu().numpy() == data).all(-1)
    assert ok[:-1].all(), ok


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["dd", "demap", "evm"])
def test_nearest_kernel_at_the_loaded_dispatch_shapes(dev, call):
    """The nearest-point kernel against the plain loop at the
    ``mcrx4.loaded`` dispatch's call shapes (192 candidate rows: the
    decision-directed pass's 64 symbols against 256 entries, the codec's
    demap and the payload EVM over the whole payload against 64 and 256),
    points at 20 dB around a random scheme's constellation a row: ``arg``
    equal and ``best`` bit-equal."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync, payload
    from liquid_usrp_tpu_torch.ops import modem
    params = ofdm.make_ofdm_params(M, CP, TAPER)
    sync = ofdm_sync.make_sync(params, block_size=BLOCK,
                               max_payload=MAX_PAYLOAD, max_frames=MAX_FRAMES)
    R = N * N_BLOCKS * MAX_FRAMES
    n_data = len(params.data_idx)
    dd = min(ofdm_sync._DD_SYMS, sync.max_psym)
    rng = np.random.default_rng(0x5CA7)
    stacked = payload._stacked_tables()
    # the three shapes draw from one generator in turn
    for label, n_sym, C in (("dd", dd, 256), ("demap", sync.max_psym, 64),
                            ("evm", sync.max_psym, 256)):
        n = n_sym * n_data
        mods = rng.integers(0, len(payload.PAYLOAD_MODS), R)
        tab = stacked[mods][:, :C]
        size = [min(C, 1 << modem.bits_per_symbol(int(m))) for m in mods]
        pick = (rng.random((R, n)) * np.array(size)[:, None]).astype(np.int64)
        x = np.take_along_axis(tab, pick, axis=-1) + 0.07 * (
            rng.normal(size=(R, n)) + 1j * rng.normal(size=(R, n)))
        if label == call:
            break
    args = (torch.as_tensor(x.astype(np.complex64), device=dev),
            torch.as_tensor(np.ascontiguousarray(tab), device=dev))
    kernels.reset_launch_counts()
    got = payload._nearest_sym(*args)
    assert kernels.launches["nearest"] == 1
    want = payload._nearest_sym_plain(*args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


# ---------------------------------------------------------------------------
# the multichannel path
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("level", [0, 1, 2])
def test_mcrx_decodes_the_bench_mixture(dev, bench, level):
    """88/88 with ``bench.py``'s fingerprints, and again with a carrier
    offset a channel, each estimate within 1.5e-3 (B2's ``c_at`` seeds the
    coarse estimate); the level's kernel launched."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import \
        make_mcrx_batched_step
    sync = ofdm_sync.make_sync(bench.params, block_size=BLOCK,
                               max_payload=MAX_PAYLOAD,
                               max_frames=MAX_FRAMES, use_pallas=level)
    init, step = make_mcrx_batched_step(N, sync, N_BLOCKS, dev)
    kernels.reset_launch_counts()
    total, _ = decode_stream(step, init, bench.blocks, bench.flush,
                             bench.n_flush, bench.w64)
    cfo_total, cfo_res = decode_stream(step, init, bench.cfo_blocks,
                                       bench.flush, bench.n_flush, bench.w64)
    check_decoded(f"level {level}", *total, bench.expected)
    check_decoded(f"level {level} with CFO", *cfo_total, bench.expected)
    want = torch.tensor(CFOS, device=dev)[:, None, None]
    cfo_err = max(float(torch.where(r.payload_valid, (r.cfo - want).abs(),
                                    torch.zeros_like(r.cfo)).max())
                  for r in cfo_res)
    assert cfo_err <= CFO_ATOL
    assert_launched(kernels.launches, *{1: [B1], 2: [B2]}.get(level, []))


@pytest.mark.gpu
def test_mcrx_class_entry(dev):
    """``MultichannelRx.execute + flush`` on two frames a channel from
    ``MultichannelTx``: every frame payload-exact."""
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
    mc_frames_check(rx.execute(np.concatenate(chunks)) + rx.flush(), sent)


@pytest.mark.gpu
def test_mcrx_m16_runs_b3_not_b2(dev, bench):
    """At M=16 (``use_pallas=2``) every frame decodes with the bench
    fingerprints through B3, not B2 (its segments need M >= 32); B3's
    generic instance matches its plain version on that path's windows."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import (
        Mcrx, make_mcrx_batched_step)
    params = ofdm.make_ofdm_params(M16, CP16, TAPER16)
    sync = ofdm_sync.make_sync(params, block_size=BLOCK,
                               max_payload=MAX_PAYLOAD,
                               max_frames=MAX_FRAMES, use_pallas=2)
    mixture, payloads = build_mixture(params, ofdm.default_props(),
                                      BLOCK * N_BLOCKS,
                                      sync.overlap + 8 * M16, dev)
    blocks = torch.as_tensor((mixture + 0.01 * bench.noise).reshape(-1),
                             device=dev)
    init, step = make_mcrx_batched_step(N, sync, N_BLOCKS, dev)
    kernels.reset_launch_counts()
    total, _ = decode_stream(step, init, blocks, bench.flush,
                             -(-(sync.overlap // BLOCK + 1) // N_BLOCKS),
                             bench.w64)
    check_decoded("M=16", *total,
                  expected_fingerprints(payloads, bench.weights))
    assert_launched(kernels.launches, B3)
    assert kernels.launches[B2] == 0
    # B3's generic instance on the extended windows of the first chunk
    rx = Mcrx(N, sync, N_BLOCKS, dev)
    st = rx.init_state()
    chans = rx.front_end(st, blocks)[2]
    exts = ofdm_sync.extended_windows(sync, st.syncs.tail, chans)[1]
    metric_vs_plain(B3, kernels.autocorr_metric, 1e-4, exts, M16)


# ---------------------------------------------------------------------------
# the apps: shared helpers
# ---------------------------------------------------------------------------

def run_app(main_fn, argv) -> str:
    """One CLI ``main(argv)`` with its standard output captured; it must
    return 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    assert rc == 0, (argv, out.getvalue()[-400:])
    return out.getvalue()


def transmit(app, path, *argv):
    """The TX app ``app`` writes ``path`` with ``argv``: the stream."""
    from liquid_usrp_tpu_torch.io.streams import read_iq
    run_app(app.main, ["-o", str(path), *argv])
    return read_iq(str(path))


def app_count(text: str, what: str) -> int:
    """A count of an RX app's report, 0 when the line is absent."""
    got = re.search(what + r"\s+:\s+(\d+)", text)
    return int(got.group(1)) if got else 0


def tx_draws(n, seed, user, payload):
    """The (header, payload) of each packet id as the flexframe, packet
    and GMSK TX apps draw them: the id in header bytes 0-1."""
    rng = np.random.default_rng(seed)
    out = []
    for pid in range(n):
        h = np.empty(user, np.uint8)
        h[0], h[1] = (pid >> 8) & 0xFF, pid & 0xFF
        h[2:] = rng.integers(0, 256, user - 2, dtype=np.uint8)
        out.append((h, rng.integers(0, 256, payload, dtype=np.uint8)))
    return out


def ofdm_draws(n, seed, payload):
    """{packet id: payload} as ``ofdmflexframe_tx`` draws them."""
    rng = np.random.default_rng(seed)
    sent = {}
    for pid in range(n):
        rng.integers(0, 256, 6, dtype=np.uint8)      # header bytes 2..7
        sent[pid] = rng.integers(0, 256, payload, dtype=np.uint8)
    return sent


def sc_transmit(path, m=M, cp=CP, frames=SC_FRAMES, payload=SC_PAYLOAD):
    """``ofdmflexframe_tx`` at its defaults (or ``frames`` of ``payload``
    bytes at M = ``m``) into ``path``: (stream, sent payloads by id)."""
    from liquid_usrp_tpu_torch.apps import ofdmflexframe_tx
    return transmit(ofdmflexframe_tx, path, "-N", str(frames), "-P",
                    str(payload), "-s", str(SC_SEED), "-g", "-12", "-M",
                    str(m), "-C", str(cp), "-T", str(TAPER), "-m", "qpsk",
                    "-c", "none", "-k", "g2412"), \
        ofdm_draws(frames, SC_SEED, payload)


def check_sc_frames(frames, sent, cfo=None):
    """``frames`` hold exactly the sent packets, payload-exact (each
    offset within ``CFO_ATOL`` of ``cfo``)."""
    ok = {(int(f["header"][0]) << 8) | int(f["header"][1]): f
          for f in frames if f["payload_valid"]}
    assert sum(f["payload_valid"] for f in frames) == len(sent)
    assert set(ok) == set(sent)
    for pid, p in sent.items():
        assert np.array_equal(ok[pid]["payload"], p), pid
    if cfo is not None:
        assert max(abs(f["stats"]["cfo"] - cfo)
                   for f in ok.values()) <= CFO_ATOL


def sc_receiver(dev, config=None):
    """``OfdmTxRx`` at the app defaults; ``config = (xcorr_detect,
    use_pallas)`` replaces its synchronizer's detect config."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.ofdmtxrx import OfdmTxRx
    rx = OfdmTxRx(M=M, cp_len=CP, taper_len=TAPER, block_size=SC_BLOCK,
                  batch_blocks=SC_BATCH, max_payload=SC_MAX_PAYLOAD,
                  device=dev)
    if config is not None:
        rx._sync = ofdm_sync.make_sync(
            rx.params, block_size=SC_BLOCK, max_payload=SC_MAX_PAYLOAD,
            use_pallas=config[1], xcorr_detect=config[0])
        rx._step = ofdm_sync.make_sync_step(rx._sync)
        rx.reset_rx()
    rx.start_rx()
    return rx


def sc_decode(rx, stream):
    """One whole-stream ``run_rx`` with a flush, from the initial state."""
    rx.reset_rx()
    return rx.run_rx(stream, flush=True)


@pytest.fixture(scope="module")
def sc(dev, tmp):
    """``ofdmflexframe_tx``'s default stream: 40 frames of 1,200 bytes."""
    path = tmp / "ofdmflexframe.iq"
    stream, sent = sc_transmit(path)
    return SimpleNamespace(stream=stream, sent=sent, path=str(path))


def ff_sync(frame64=False, **kw):
    """The flexframe_rx (or, with ``frame64``, packet_rx) synchronizer."""
    from liquid_usrp_tpu_torch.framing import flexframe as ff
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    if frame64:
        kw = dict(max_payload=ff.FRAME64_PAYLOAD,
                  header_user=ff.FRAME64_HEADER_USER)
    return fs.make_flex_sync(ff.make_flex_params(), block_size=FF_BLOCK,
                             max_frames=FF_MAX_FRAMES,
                             **{"max_payload": FF_MAX_PAYLOAD, **kw})


def gm_sync(conv=False):
    """The gmskframe_rx synchronizer (with ``--conv``: ``conv``)."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    return gf.make_gmsk_sync(gf.make_gmsk_params(), block_size=GM_BLOCK,
                             max_payload=GM_MAX_PAYLOAD,
                             max_frames=GM_MAX_FRAMES, enable_conv=conv)


def ff_decode(sync, stream, dev, gmsk=False):
    """``stream`` through ``iter_sync_results`` as the RX apps drive it
    (8-block dispatches): every detected frame, in stream order."""
    from liquid_usrp_tpu_torch.apps.common import iter_sync_results
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    step, init, batched = (
        (gf.make_gmsk_sync_step, gf.gmsk_sync_init,
         gf.gmsk_sync_blocks_batched) if gmsk else
        (fs.make_flex_sync_step, fs.flex_sync_init,
         fs.flex_sync_blocks_batched))
    frames = []
    for r in iter_sync_results(
            step(sync), init(sync, dev), stream, sync.block_size,
            sync.overlap, batched_fn=lambda st, b: batched(sync, st, b),
            batch_blocks=FF_BATCH):
        for i in np.nonzero(r.detected)[0]:
            frames.append(dict(
                t=int(r.t_start[i]), valid=bool(r.payload_valid[i]),
                header=r.header[i].copy(), cfo=float(r.cfo[i]),
                payload=r.payload[i][:int(r.payload_len[i])].copy()))
    return sorted(frames, key=lambda f: f["t"])


def check_ff_frames(frames, sent, cfo=None, exact_count=True,
                    atol=FF_CFO_ATOL):
    """The payload-valid ``frames`` are the ``sent`` (header, payload)
    pairs byte for byte in stream order (with ``exact_count`` nothing else
    was detected), each offset within ``atol`` of ``cfo``."""
    ok = [f for f in frames if f["valid"]]
    assert len(ok) == len(sent), (len(ok), len(frames), len(sent))
    assert not exact_count or len(frames) == len(sent)
    for f, (h, p) in zip(ok, sent):
        assert np.array_equal(f["header"], h), f["t"]
        assert np.array_equal(f["payload"], p), f["t"]
    if cfo is not None:
        assert max(abs(f["cfo"] - cfo) for f in ok) <= atol


def ff_windows(sync, stream, first_block, n=FF_BATCH):
    """The host extended windows of blocks ``first_block ..`` of
    ``stream``, as the sync sees them from its initial state."""
    bs = sync.block_size
    full = np.zeros(sync.overlap + (first_block + n) * bs, np.complex64)
    body = stream[:(first_block + n) * bs]
    full[sync.overlap:sync.overlap + len(body)] = body
    return torch.as_tensor(full).unfold(0, sync.overlap + bs, bs)[
        first_block:first_block + n]


def impaired(stream, **flags):
    """``stream`` through the RX apps' ``--snr``/``--cfo`` channel."""
    from liquid_usrp_tpu_torch.apps.common import (apply_channel,
                                                   occupied_power)
    return apply_channel(stream, {k: str(v) for k, v in flags.items()},
                         signal_power=occupied_power(stream))


@pytest.fixture(scope="module")
def ff(dev, tmp):
    """``flexframe_tx``'s default stream (40 frames of 1,024 bytes, ``-r
    2.0``): the file and the stream the RX apps decode (resampled at 0.5)."""
    from liquid_usrp_tpu_torch.apps import flexframe_tx
    from liquid_usrp_tpu_torch.apps.common import resample_stream
    path = str(tmp / "flexframe.iq")
    file_stream = transmit(flexframe_tx, path, "-N", str(FF_FRAMES), "-P",
                           str(FF_PAYLOAD), "-s", str(FF_SEED))
    return SimpleNamespace(path=path, file=file_stream, rx=resample_stream(
        file_stream, FF_RX_RATE, dev))


def gm_transmit(path, *extra):
    """``gmskframe_tx`` at its defaults (40 frames of 200 bytes, seed 42)
    and ``extra`` flags into ``path``: the stream."""
    from liquid_usrp_tpu_torch.apps import gmskframe_tx
    return transmit(gmskframe_tx, path, "-N", str(GM_FRAMES), "-P",
                    str(GM_PAYLOAD), "-s", str(GM_SEED), *extra)


@pytest.fixture(scope="module")
def gm(dev, tmp):
    path = tmp / "gmsk.iq"
    return SimpleNamespace(path=str(path), stream=gm_transmit(path))


# ---------------------------------------------------------------------------
# the single-channel OFDM path
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_ofdmtxrx_and_app_decode_the_default_stream(dev, sc):
    from liquid_usrp_tpu_torch.apps import ofdmflexframe_rx
    check_sc_frames(sc_decode(sc_receiver(dev), sc.stream), sc.sent)
    text = run_app(ofdmflexframe_rx.main, ["-i", sc.path, "-q"])
    assert app_count(text, "valid packets") == SC_FRAMES


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(SC_CONFIGS), ids=str)
def test_single_channel_detect_configs(dev, sc, config):
    """``run_rx`` at each detect config decodes 40/40 payload-exact with
    its kernel launched; the legacy detector at level 1 (B3) also through
    ``--snr 20 --cfo 0.045``, every offset within 1.5e-3."""
    rx = sc_receiver(dev, config)
    kernel = SC_CONFIGS[config]
    kernels.reset_launch_counts()
    check_sc_frames(sc_decode(rx, sc.stream), sc.sent)
    assert_launched(kernels.launches, *([kernel] if kernel else []))
    if config == (False, 1):
        kernels.reset_launch_counts()
        check_sc_frames(sc_decode(rx, impaired(sc.stream, snr=20,
                                               cfo=SC_CFO)), sc.sent, SC_CFO)
        assert_launched(kernels.launches, B3)


@pytest.mark.gpu
def test_debug_print_launches_b3(dev, sc, tmp):
    rx = sc_receiver(dev)
    rx.debug_enable()
    rx.run_rx(sc.stream[:3 * SC_BLOCK])
    kernels.reset_launch_counts()
    path = rx.debug_print(str(tmp / "sc"))
    assert_launched(kernels.launches, B3)
    assert "metric = [" in Path(path).read_text()


@pytest.mark.gpu
@pytest.mark.parametrize("name,plain,limit", [
    (B3, "autocorr_metric", 1e-4),
    ("detect_metric_fused_2d", "autocorr_metric_prefix", 1e-5),
    ("detect_metric_fused", "autocorr_metric_prefix", 1e-5)])
def test_autocorr_kernel_at_the_single_channel_windows(dev, sc, name, plain,
                                                       limit):
    """B3, B4 and B5 against their plain versions on the extended windows
    of the single-channel path's first dispatch (8 rows of ``SC_BLOCK``
    plus the overlap) over the app's default stream."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    sync = ofdm_sync.make_sync(ofdm.make_ofdm_params(M, CP, TAPER),
                               block_size=SC_BLOCK,
                               max_payload=SC_MAX_PAYLOAD)
    blocks = torch.as_tensor(sc.stream[:SC_BATCH * SC_BLOCK].reshape(
        1, SC_BATCH, SC_BLOCK), device=dev)
    _, exts = ofdm_sync.extended_windows(
        sync, ofdm_sync.sync_init(sync, dev).tail[None], blocks)
    assert exts.shape[0] == SC_BATCH
    metric_vs_plain(name, getattr(kernels, plain), limit, exts, M)


# ---------------------------------------------------------------------------
# the flexframe, packet and GMSK paths (no detect kernel)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_flexframe_app_and_sync_decode_the_default_stream(dev, ff):
    """``flexframe_rx`` 40/40, the sync byte for byte in stream order; the
    same through ``--snr 20 --cfo 0.01``, every offset within 2e-3 of 0.02
    (the offset after the RX resampler)."""
    from liquid_usrp_tpu_torch.apps import flexframe_rx
    from liquid_usrp_tpu_torch.apps.common import resample_stream
    from liquid_usrp_tpu_torch.framing import flexframe as ff_mod
    sent = tx_draws(FF_FRAMES, FF_SEED, ff_mod.FLEX_HEADER_USER, FF_PAYLOAD)
    sync = ff_sync()
    kernels.reset_launch_counts()
    text = run_app(flexframe_rx.main, ["-i", ff.path, "-q"])
    assert app_count(text, "valid packets") == FF_FRAMES
    check_ff_frames(ff_decode(sync, ff.rx, dev), sent)
    text = run_app(flexframe_rx.main, ["-i", ff.path, "-q", "--snr", "20",
                                       "--cfo", str(FF_CFO)])
    assert app_count(text, "valid packets") == FF_FRAMES
    noisy = resample_stream(impaired(ff.file, snr=20, cfo=FF_CFO),
                            FF_RX_RATE, dev)
    check_ff_frames(ff_decode(sync, noisy, dev), sent, FF_CFO / FF_RX_RATE,
                    exact_count=False)
    assert not any(kernels.launches[k] for k in DETECT)


@pytest.mark.gpu
def test_packet_app_and_sync_decode(dev, tmp):
    """``packet_tx`` -> ``packet_rx``: 40/40 valid, no foreign burst; the
    frame64 sync returns the regenerated payloads byte for byte."""
    from liquid_usrp_tpu_torch.apps import packet_rx, packet_tx
    from liquid_usrp_tpu_torch.apps.common import resample_stream
    from liquid_usrp_tpu_torch.framing import flexframe as ff_mod
    path = str(tmp / "packet.iq")
    sent = tx_draws(FF_FRAMES, FF_SEED, ff_mod.FRAME64_HEADER_USER,
                    ff_mod.FRAME64_PAYLOAD)
    kernels.reset_launch_counts()
    stream = transmit(packet_tx, path, "-N", str(FF_FRAMES))
    text = run_app(packet_rx.main, ["-i", path, "-q"])
    assert app_count(text, "valid packets") == FF_FRAMES
    assert app_count(text, "non-frame64 bursts") == 0
    check_ff_frames(ff_decode(ff_sync(frame64=True), resample_stream(
        stream, FF_RX_RATE, dev), dev), sent)
    assert not any(kernels.launches[k] for k in DETECT)


@pytest.mark.gpu
def test_gmsk_app_and_sync_decode_the_default_stream(dev, gm):
    """``gmskframe_rx`` 40/40 and the sync byte for byte (its detector
    also fires on 2 spots of the clean stream, header-invalid, as JAX's
    does); the same through ``--snr 20 --cfo 0.01``, offsets within
    1e-3."""
    from liquid_usrp_tpu_torch.apps import gmskframe_rx
    sent = tx_draws(GM_FRAMES, GM_SEED, 8, GM_PAYLOAD)
    sync = gm_sync()
    kernels.reset_launch_counts()
    text = run_app(gmskframe_rx.main, ["-i", gm.path, "-q"])
    assert app_count(text, "valid packets") == GM_FRAMES
    check_ff_frames(ff_decode(sync, gm.stream, dev, gmsk=True), sent,
                    exact_count=False)
    text = run_app(gmskframe_rx.main, ["-i", gm.path, "-q", "--snr", "20",
                                       "--cfo", str(GM_CFO)])
    assert app_count(text, "valid packets") == GM_FRAMES
    check_ff_frames(ff_decode(sync, impaired(gm.stream, snr=20, cfo=GM_CFO),
                              dev, gmsk=True), sent, GM_CFO,
                    exact_count=False, atol=GM_CFO_ATOL)
    assert not any(kernels.launches[k] for k in DETECT)


@pytest.mark.gpu
def test_gmsk_front_end_cuda_matches_cpu(dev, gm):
    """Over every 8-block dispatch of the default stream: the same detected
    offsets in every window (their top-k slot order may differ), ``z``
    within 1e-5 of max |z|, the metric within 1e-4 where the template
    span's energy is at least 100x its silence floor (its float32 cumsum
    rounds in another order on each device)."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.ops.corr import comb_moving_sum
    sync = gm_sync()
    bs, k = sync.block_size, sync.params.k
    n_t = gf.PRE_BITS + gf.SYNC_BITS
    seg, n_seg = gf.DETECT_SEG, n_t // gf.DETECT_SEG
    shift = seg * k
    n_blocks = -(-len(gm.stream) // bs) + -(-sync.overlap // bs) + 1
    n_det = 0
    for first in range(0, n_blocks - FF_BATCH + 1, FF_BATCH):
        ext = ff_windows(sync, gm.stream, first)
        got = [v.cpu() for v in gf._front_end(sync, ext.to(dev))]
        z, metric, det, locs = gf._front_end(sync, ext)
        assert torch.equal(got[2].sum(-1), det.sum(-1)), first
        for r in range(det.shape[0]):
            assert torch.equal(got[3][r][got[2][r]].sort().values,
                               locs[r][det[r]].sort().values), (first, r)
        assert float((got[0] - z).abs().max() /
                     z.abs().max().clamp(min=1e-30)) <= 1e-5
        n = metric.shape[-1]
        pz = z.abs() ** 2
        e = comb_moving_sum(pz, seg, k, n + (n_seg - 1) * shift)
        energy = sum(e[..., s * shift:s * shift + n] for s in range(n_seg))
        loud = energy >= METRIC_LOUD * 1e-3 * n_t * pz.mean(-1, keepdim=True)
        if bool(loud.any()):
            assert float((got[1] - metric).abs()[loud].max()) <= 1e-4
        n_det += int(det.sum())
    assert n_det > 0


# ---------------------------------------------------------------------------
# the conv/RS layer and the soft decode path
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_conv_and_rs_cuda_match_cpu(dev):
    """``fec_decode`` of v27, v29 and v27p34 at 3 % bit errors and of RS8
    at 0/8/16/24 byte errors equals the CPU's bit for bit; RS8 corrects up
    to 16."""
    from liquid_usrp_tpu_torch.ops import fec
    rng = np.random.default_rng(0xC0DE)
    for s in (fec.FEC_CONV_V27, fec.FEC_CONV_V29, fec.FEC_CONV_V27P34):
        data = rng.integers(0, 256, (4, 200), dtype=np.uint8)
        bits = np.unpackbits(fec.fec_encode(s, torch.as_tensor(data))
                             .numpy(), axis=-1)
        noisy = torch.as_tensor(np.packbits(
            bits ^ (rng.random(bits.shape) < 0.03), axis=-1))
        assert torch.equal(fec.fec_decode(s, noisy.to(dev), 200).cpu(),
                           fec.fec_decode(s, noisy, 200)), fec.fec_name(s)
    data = rng.integers(0, 256, (4, 300), dtype=np.uint8)
    enc = fec.fec_encode(fec.FEC_RS8, torch.as_tensor(data)).numpy()
    for row, n_err in enumerate((0, 8, 16, 24)):
        for p in rng.choice(255, size=n_err, replace=False):
            enc[row, p] ^= int(rng.integers(1, 256))
    bad = torch.as_tensor(enc)
    want = fec.fec_decode(fec.FEC_RS8, bad, 300)
    assert torch.equal(fec.fec_decode(fec.FEC_RS8, bad.to(dev), 300).cpu(),
                       want)
    assert (want.numpy() == data).all(-1)[:3].all()


@pytest.mark.gpu
@pytest.mark.parametrize("app", ["gmsk v27", "ofdmflexframe rs8",
                                 "flexframe v27"])
def test_conv_loopbacks(dev, tmp, app):
    """``gmskframe_tx -c v27 -k none`` (40 frames) -> ``gmskframe_rx
    --conv`` 40/40 and the sync byte for byte; ``ofdmflexframe_tx -k rs8``
    (10 frames of 442 bytes: whole RS blocks) -> ``--conv -p 512`` and
    ``flexframe_tx -c v27 -k none`` (10 of 100) -> ``--conv -p 256``:
    every frame detected and valid.  Only the OFDM app launches a detect
    kernel, B1."""
    from liquid_usrp_tpu_torch.apps import (flexframe_rx, flexframe_tx,
                                            gmskframe_rx, ofdmflexframe_rx,
                                            ofdmflexframe_tx)
    kernels.reset_launch_counts()
    if app == "gmsk v27":
        path = tmp / "gmsk_v27.iq"
        stream = gm_transmit(path, "-c", "v27", "-k", "none")
        text = run_app(gmskframe_rx.main, ["-i", str(path), "-q", "--conv"])
        assert app_count(text, "valid packets") == GM_FRAMES
        check_ff_frames(ff_decode(gm_sync(conv=True), stream, dev, gmsk=True),
                        tx_draws(GM_FRAMES, GM_SEED, 8, GM_PAYLOAD),
                        exact_count=False)
        assert not any(kernels.launches[k] for k in DETECT)
        return
    tx, rx, tx_argv, rx_argv = {
        "ofdmflexframe rs8": (ofdmflexframe_tx, ofdmflexframe_rx,
                              ["-P", "442", "-k", "rs8"], ["-p", "512"]),
        "flexframe v27": (flexframe_tx, flexframe_rx,
                          ["-P", "100", "-c", "v27", "-k", "none"],
                          ["-p", "256"])}[app]
    path = str(tmp / f"{app.split()[0]}_conv.iq")
    run_app(tx.main, ["-o", path, "-N", str(CV_FRAMES), *tx_argv])
    text = run_app(rx.main, ["-i", path, "-q", "--conv", *rx_argv])
    assert app_count(text, "valid packets") == CV_FRAMES
    assert app_count(text, "frames detected") == CV_FRAMES
    if app.startswith("ofdm"):
        assert_launched(kernels.launches, B1, only=True)
    else:
        assert not any(kernels.launches[k] for k in DETECT)


@pytest.mark.gpu
def test_v27_cell_receiver_launches(dev, tmp):
    """The ``ofdm1_conv.v27`` cell's receiver (``OfdmTxRx(enable_conv=
    True)``) over 20 frames of ``ofdmflexframe_tx -c v27 -k none``, one
    8-block dispatch a ``run_rx`` call: every frame valid; in each dispatch
    that decodes a frame the Viterbi kernel launches once over the
    2,052-byte budget's 16,422 steps and the nearest-point kernel three
    times (the decision-directed pass, the demap, the payload EVM); of
    B1-B5 only B1."""
    from liquid_usrp_tpu_torch.apps import ofdmflexframe_tx
    from liquid_usrp_tpu_torch.models.ofdmtxrx import OfdmTxRx
    from liquid_usrp_tpu_torch.utils import profiling
    stream = transmit(ofdmflexframe_tx, tmp / "ofdm_v27.iq", "-N",
                      str(V27_FRAMES), "-c", "v27", "-k", "none")
    txrx = OfdmTxRx(enable_conv=True)
    txrx.start_rx()
    bs, nb = txrx._sync.block_size, txrx._batch_blocks
    # zeros after the stream until the carried overlap has drained
    blocks = -(-len(stream) // bs) + 1 + txrx._sync.overlap // bs + 1
    chunks = np.zeros((-(-blocks // nb), nb * bs), np.complex64)
    chunks.reshape(-1)[:len(stream)] = stream
    log_dir = tmp / "ofdm_v27_trace"
    kernels.reset_launch_counts()
    with profiling.trace(str(log_dir)):
        per = [txrx.run_rx(chunk) for chunk in chunks]
        torch.cuda.synchronize()
    launches = dict(kernels.launches)
    counters = json.loads((log_dir / "counters.json").read_text())
    rows = [r for got in per for r in got]
    assert sorted((int(r["header"][0]) << 8) | int(r["header"][1])
                  for r in rows) == list(range(V27_FRAMES))
    assert all(r["header_valid"] and r["payload_valid"] and
               r["payload_len"] == 1200 for r in rows)
    decoding = sum(1 for got in per if got)
    assert (launches["viterbi"], counters.get("viterbi_steps", 0),
            launches["nearest"]) == (decoding,
                                     decoding * (VIT_BYTES * 8 + 6),
                                     3 * decoding)
    assert_launched(launches, B1, only=True)


def frames_key(frames):
    return [(f["t"], f["header"].tobytes(), f["payload"].tobytes())
            for f in frames if f["valid"]]


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["ofdm", "flex", "gmsk"])
def test_soft_loopbacks(dev, tmp, family):
    """10 v27 frames -> RX ``--conv --soft``: every frame valid, and the
    receiver with ``soft=True`` byte for byte.  GMSK also through ``--snr
    -1.5``, near the header waterfall: the card's soft decode gives the
    CPU's payload-valid frames and bytes, and at least as many as the hard
    decode.  Only the OFDM receiver launches a detect kernel, B1."""
    from liquid_usrp_tpu_torch.apps import (flexframe_rx, flexframe_tx,
                                            gmskframe_rx, gmskframe_tx,
                                            ofdmflexframe_rx,
                                            ofdmflexframe_tx)
    from liquid_usrp_tpu_torch.apps.common import resample_stream
    from liquid_usrp_tpu_torch.framing import flexframe as ff_mod
    from liquid_usrp_tpu_torch.models.ofdmtxrx import OfdmTxRx
    tx, rx, tx_argv, rx_argv = {
        "ofdm": (ofdmflexframe_tx, ofdmflexframe_rx, ["-P", "100"],
                 ["-p", "512"]),
        "flex": (flexframe_tx, flexframe_rx, ["-P", "100"], ["-p", "256"]),
        "gmsk": (gmskframe_tx, gmskframe_rx, ["-P", str(GM_PAYLOAD)],
                 [])}[family]
    kernels.reset_launch_counts()
    path = str(tmp / f"{family}_soft.iq")
    stream = transmit(tx, path, "-N", str(SOFT_FRAMES), "-s",
                      str(SOFT_SEED), "-c", "v27", "-k", "none", *tx_argv)
    text = run_app(rx.main, ["-i", path, "-q", "--conv", "--soft", *rx_argv])
    assert app_count(text, "valid packets") == SOFT_FRAMES
    if family == "ofdm":
        txrx = OfdmTxRx(M=M, cp_len=CP, taper_len=TAPER, block_size=SC_BLOCK,
                        batch_blocks=SC_BATCH, max_payload=512,
                        enable_conv=True, soft=True, device=dev)
        txrx.start_rx()
        check_sc_frames(sc_decode(txrx, stream),
                        ofdm_draws(SOFT_FRAMES, SOFT_SEED, 100))
        assert_launched(kernels.launches, B1, only=True)
        return
    if family == "flex":
        sync = ff_sync(max_payload=256, enable_conv=True, soft=True)
        check_ff_frames(ff_decode(sync, resample_stream(stream, FF_RX_RATE,
                                                        dev), dev),
                        tx_draws(SOFT_FRAMES, SOFT_SEED,
                                 ff_mod.FLEX_HEADER_USER, 100))
        assert not any(kernels.launches[k] for k in DETECT)
        return
    soft, hard = gm_sync(conv=True)._replace(soft=True), gm_sync(conv=True)
    sent = tx_draws(SOFT_FRAMES, SOFT_SEED, 8, GM_PAYLOAD)
    check_ff_frames(ff_decode(soft, stream, dev, gmsk=True), sent,
                    exact_count=False)
    low = impaired(stream, snr=SOFT_SNR)
    card_ok = frames_key(ff_decode(soft, low, dev, gmsk=True))
    assert card_ok == frames_key(ff_decode(soft, low, torch.device("cpu"),
                                           gmsk=True))
    good = {(h.tobytes(), p.tobytes()) for h, p in sent}
    assert all((h, p) in good for _, h, p in card_ok)
    assert len(card_ok) >= len(frames_key(ff_decode(hard, low, dev,
                                                    gmsk=True)))
    assert not any(kernels.launches[k] for k in DETECT)


# ---------------------------------------------------------------------------
# the small CLIs
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_narrowband_asgram_and_rssi_cuda_match_cpu(dev, tmp, monkeypatch):
    """``narrowband_tx`` -> ``asgram_rx -L 8`` and ``rssi -L 4096`` on the
    card against the same apps on the CPU: 8 equal peak frequencies, the
    levels within 0.01 dB; no detect kernel."""
    from liquid_usrp_tpu_torch.apps import asgram_rx, narrowband_tx, rssi
    from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV
    f = str(tmp / "nb.iq")
    kernels.reset_launch_counts()
    run_app(narrowband_tx.main, ["-o", f, "-n", "20000"])
    texts = {}
    for where in ("card", "cpu"):
        if where == "cpu":
            monkeypatch.setenv(DEVICE_ENV, "cpu")
        texts[where] = (run_app(asgram_rx.main, ["-i", f, "-L", "8"]),
                        run_app(rssi.main, ["-i", f, "-L", "4096"]))
    peaks = {w: re.findall(r"f=([-+.\d]+)", t[0]) for w, t in texts.items()}
    levels = {w: [float(v) for v in re.findall(r"rssi =\s+([-.\d]+)", t[1])]
              for w, t in texts.items()}
    assert len(peaks["card"]) == 8 and peaks["card"] == peaks["cpu"]
    assert len(levels["card"]) == len(levels["cpu"]) > 0
    assert max(abs(a - b) for a, b in zip(levels["card"],
                                          levels["cpu"])) <= 0.011
    assert not any(kernels.launches[k] for k in DETECT)


@pytest.mark.gpu
def test_duplex_apps(dev):
    """``halfduplex_txrx -N 2`` delivers 2/2 and ``fullduplex_txrx`` (its
    defaults) 5/5 both ways; their endpoints detect with B1 only."""
    from liquid_usrp_tpu_torch.apps import fullduplex_txrx, halfduplex_txrx
    kernels.reset_launch_counts()
    assert "2/2 delivered" in run_app(halfduplex_txrx.main, ["-N", "2", "-q"])
    text = run_app(fullduplex_txrx.main, ["-q"])
    assert text.count("valid packets       :      5 (100.00%)") == 2
    assert_launched(kernels.launches, B1, only=True)


@pytest.mark.gpu
def test_large_m_apps(dev, tmp):
    """``ofdmflexframe_rx -M 1028`` decodes 4/4 of its TX's frames and
    ``multichannel_rx -M 1028`` 6/6, through B1."""
    from liquid_usrp_tpu_torch.apps import (multichannel_rx, multichannel_tx,
                                            ofdmflexframe_rx)
    path = tmp / "ofdm1028.iq"
    sc_transmit(path, 1028, 128, LM_FRAMES, LM_PAYLOAD)
    kernels.reset_launch_counts()
    text = run_app(ofdmflexframe_rx.main, ["-i", str(path), "-M", "1028",
                                           "-C", "128", "-T", str(TAPER),
                                           "-q"])
    assert app_count(text, "valid packets") == LM_FRAMES
    mc = str(tmp / "mc1028.iq")
    run_app(multichannel_tx.main, ["-o", mc, "-n", "2", "-N", "3", "-P",
                                   str(LM_PAYLOAD), "-M", "1028", "-C",
                                   "128"])
    text = run_app(multichannel_rx.main, ["-i", mc, "-n", "2", "-M", "1028",
                                          "-C", "128"])
    assert app_count(text, "valid packets") == 6
    assert_launched(kernels.launches, B1)


# ---------------------------------------------------------------------------
# the streaming plumbing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def worker_errors():
    """Fail when a thread dies inside the block."""
    seen, old = [], threading.excepthook
    threading.excepthook = lambda args: seen.append(args.exc_value)
    try:
        yield
    finally:
        threading.excepthook = old
    assert not seen, seen


def mc_frames_check(frames, sent):
    """Every sent (header bytes -> payload) payload-exact among the
    ``MultichannelRx`` frames."""
    valid = {bytes(f["header"]): f for f in frames if f["payload_valid"]}
    for h, p in sent.items():
        assert h in valid and np.array_equal(valid[h]["payload"], p), h


@pytest.mark.gpu
def test_tx_worker_producer_and_txrx_cli(dev):
    """The TX worker at N=4 (``chunk=256``, ``max_ahead=65536``) with
    400-byte packets queued on every channel mid-stream while this thread
    runs ``MultichannelRx`` on the card: every frame payload-exact, at most
    ``max_ahead + 2N * chunk`` samples ahead; ``AsyncTxProducer``'s frames
    payload-exact; ``multichannel_txrx`` at its defaults and at ``-n 4 -P
    400 -R 4`` payload-exact.  B1 only."""
    from liquid_usrp_tpu_torch.apps import multichannel_txrx
    from liquid_usrp_tpu_torch.io.pipeline import AsyncTxProducer
    from liquid_usrp_tpu_torch.models.multichannel import (MultichannelRx,
                                                           MultichannelTx)
    rng = np.random.default_rng(24)
    tx = MultichannelTx(N, M=M, cp_len=CP, taper_len=TAPER, device=dev)
    rx = MultichannelRx(N, M=M, cp_len=CP, taper_len=TAPER,
                        max_payload=MAX_PAYLOAD, device=dev)
    kernels.reset_launch_counts()
    sent, frames = {}, []
    with worker_errors():
        tx.start_worker(chunk=TXW_CHUNK, max_ahead=TXW_AHEAD)
        try:
            deadline = time.time() + 60
            while tx.samples_ahead < TXW_AHEAD and time.time() < deadline:
                time.sleep(0.005)
            peak = tx.samples_ahead
            for rep in range(TXW_PACKETS):
                for ch in range(N):
                    h = rng.integers(0, 256, 8, dtype=np.uint8)
                    h[:2] = rep, ch
                    p = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
                    tx.update_data(ch, h, p)
                    sent[bytes(h)] = p
                while not all(tx.is_channel_ready(c) for c in range(N)):
                    peak = max(peak, tx.samples_ahead)
                    frames += rx.execute(tx.read_samples(16384))
        finally:
            tx.stop_worker()
        peak = max(peak, tx.samples_ahead)
        frames += rx.execute(tx.read_samples(
            tx.samples_ahead + 2 * N * (2 * tx.chz.P + 64))) + rx.flush()
        mc_frames_check(frames, sent)
        assert TXW_AHEAD <= peak <= TXW_AHEAD + 2 * N * TXW_CHUNK

        prod = AsyncTxProducer(MultichannelTx(N, M=M, cp_len=CP,
                                              taper_len=TAPER, device=dev),
                               block_channel_samples=256, depth=8)
        sent = {}
        for rep in range(2):
            for ch in range(N):
                h = rng.integers(0, 256, 8, dtype=np.uint8)
                h[:2] = 0x40 + rep, ch
                p = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
                prod.transmit_packet(ch, h, p)
                sent[bytes(h)] = p
        prod.close()
        air = np.concatenate(list(prod.blocks()))
        rx = MultichannelRx(N, M=M, cp_len=CP, taper_len=TAPER,
                            max_payload=MAX_PAYLOAD, device=dev)
        mc_frames_check(rx.execute(air) + rx.flush(), sent)
        for argv in (["-q"], ["-n", str(N), "-P", str(PAYLOAD), "-R", "4",
                              "-q"]):
            text = run_app(multichannel_txrx.main, argv)
            ok, n_sent = map(int, re.search(
                r"payload-exact\s+:\s+(\d+) / (\d+) sent", text).groups())
            assert ok == n_sent > 0, argv
    assert_launched(kernels.launches, B1, only=True)


# ---------------------------------------------------------------------------
# 802.11a
# ---------------------------------------------------------------------------

def wlan_padded(stream, sync):
    """A host stream padded with the blocks that drain the sync's overlap,
    as ``[n_blocks, block_size]``."""
    bs = sync.block_size
    n_blocks = -(-len(stream) // bs) + sync.overlap // bs + 1
    x = np.zeros(n_blocks * bs, np.complex64)
    x[:len(stream)] = stream
    return x.reshape(n_blocks, bs)


def wlan_rows(stream, sync, dev):
    """The WLAN sync over a host stream on ``dev``: the detected rows
    (t_start, rate, length, signal_valid, psdu_valid, PSDU bytes, cfo,
    rssi) in stream order."""
    from liquid_usrp_tpu_torch.framing import wlan
    step = wlan.make_wlan_sync_step(sync)
    state, rows = wlan.wlan_sync_init(sync, dev), []
    for blk in torch.as_tensor(wlan_padded(stream, sync), device=dev):
        state, res = step(state, blk)
        res = wlan.WlanResults(*(v.cpu().numpy() for v in res))
        for i in np.nonzero(res.detected)[0]:
            rows.append((int(res.t_start[i]), int(res.rate[i]),
                         int(res.length[i]), bool(res.signal_valid[i]),
                         bool(res.psdu_valid[i]),
                         res.psdu[i][: int(res.length[i])].tobytes(),
                         float(res.cfo[i]), float(res.rssi[i])))
    return sorted(rows)


def wlan_rows_equal(got, want):
    """Card rows against CPU rows: exact but cfo (1e-5) and rssi (1e-4)."""
    assert [r[:6] for r in got] == [r[:6] for r in want]
    for a, b in zip(got, want):
        assert abs(a[6] - b[6]) <= WLAN_CFO_ATOL
        assert abs(a[7] - b[7]) <= WLAN_RSSI_ATOL


def wlan_draws(n, P, seed=WLAN_SEED):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, P, dtype=np.uint8) for _ in range(n)]


def wlan_check_psdus(rows, psdus, n_want):
    """The PSDU-valid rows carry the regenerated PSDUs in order."""
    assert [r[5] for r in rows if r[4]] == [p.tobytes()
                                            for p in psdus[:n_want]]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [6, 9, 12, 18, 24, 36, 48, 54])
def test_wlan_apps_at_every_rate(dev, tmp, rate):
    """``wlanframe_tx -r R -N 5`` -> ``wlanframe_rx``: 5/5 valid PSDUs; the
    sync returns the regenerated PSDUs byte for byte at their frame
    starts, with the CPU port's rows; no detect kernel."""
    from liquid_usrp_tpu_torch.apps import wlanframe_rx, wlanframe_tx
    from liquid_usrp_tpu_torch.framing import wlan
    assert rate in wlan.WLAN_RATES
    sync = wlan.make_wlan_sync()
    f = tmp / f"w{rate}.iq"
    kernels.reset_launch_counts()
    stream = transmit(wlanframe_tx, f, "-r", str(rate), "-N", str(WLAN_FRAMES))
    text = run_app(wlanframe_rx.main, ["-i", str(f), "-q"])
    assert app_count(text, "valid PSDUs") == WLAN_FRAMES
    got = wlan_rows(stream, sync, dev)
    wlan_check_psdus(got, wlan_draws(WLAN_FRAMES, WLAN_PSDU), WLAN_FRAMES)
    flen = wlan.wlan_frame_length(rate, WLAN_PSDU)
    assert [r[0] for r in got] == [200 + k * (flen + 200)
                                   for k in range(WLAN_FRAMES)]
    wlan_rows_equal(got, wlan_rows(stream, sync, "cpu"))
    assert not any(kernels.launches.values())


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [6, 54])
def test_wlan_1500_byte_frames(dev, tmp, rate):
    from liquid_usrp_tpu_torch.apps import wlanframe_rx, wlanframe_tx
    from liquid_usrp_tpu_torch.framing import wlan
    f = tmp / f"mtu{rate}.iq"
    stream = transmit(wlanframe_tx, f, "-r", str(rate), "-N", str(WLAN_MTU_FRAMES),
                           "-P", str(WLAN_MTU))
    text = run_app(wlanframe_rx.main, ["-i", str(f), "-p", str(WLAN_MTU),
                                       "-q"])
    assert app_count(text, "valid PSDUs") == WLAN_MTU_FRAMES
    wlan_check_psdus(wlan_rows(stream, wlan.make_wlan_sync(max_psdu=WLAN_MTU),
                               dev),
                     wlan_draws(WLAN_MTU_FRAMES, WLAN_MTU), WLAN_MTU_FRAMES)


# ---------------------------------------------------------------------------
# the parallel layer: four ranks sharing the card, a 1-rank NCCL world
# ---------------------------------------------------------------------------

def time_padded(stream, sync, n_ranks=PAR_RANKS):
    """``stream`` padded with zeros to ``n_ranks`` equal chunks of whole
    blocks, each covering the sync's overlap, with at least one overlap of
    zeros after the stream: (padded, blocks per rank)."""
    bs = sync.block_size
    cb = max(-(-sync.overlap // bs),
             -(-(len(stream) + sync.overlap) // (n_ranks * bs)))
    x = np.zeros(n_ranks * cb * bs, np.complex64)
    x[:len(stream)] = stream
    return x, cb


def sequential_rows(sync, stream, dev):
    """The port's own block loop (each family's ``*_sync_block``) over a
    host stream on ``dev``: the results of every block stacked as host
    arrays ``[n_blocks * max_frames, ...]``, the rows the time-sharded run
    gives."""
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.framing import ofdm_sync, wlan
    block_fn, init = {
        ofdm_sync.OfdmSync: (ofdm_sync.sync_block, ofdm_sync.sync_init),
        fs.FlexSync: (fs.flex_sync_block, fs.flex_sync_init),
        gf.GmskSync: (gf.gmsk_sync_block, gf.gmsk_sync_init),
        wlan.WlanSync: (wlan.wlan_sync_block, wlan.wlan_sync_init),
    }[type(sync)]
    blocks = torch.as_tensor(stream.reshape(-1, sync.block_size), device=dev)
    state, rows = init(sync, dev), []
    for blk in blocks:
        state, res = block_fn(sync, state, blk)
        rows.append(res)
    return {f: torch.cat([getattr(r, f) for r in rows]).cpu().numpy()
            for f in rows[0]._fields}


def keyed_rows(res) -> dict:
    """The detected rows of host results by ``(channel, t_start)`` (by
    ``t_start`` alone for one stream)."""
    det = res["detected"]
    return {tuple(int(i) for i in idx[:-1]) + (int(res["t_start"][idx]),):
            idx for idx in zip(*np.nonzero(det))}


def rows_equal(got, want):
    """The detected rows of two host results are the same: flags, lengths,
    scheme fields and ``t_start`` exact, the valid bytes equal, ``rssi``
    within 1e-3 dB, ``evm`` 0.05 dB, ``cfo`` 1e-5."""
    kg, kw = keyed_rows(got), keyed_rows(want)
    assert kg.keys() == kw.keys(), (sorted(kg)[:8], sorted(kw)[:8])
    tol = {"rssi": 1e-3, "evm": 0.05, "cfo": 1e-5}
    for key, ig in kg.items():
        iw = kw[key]
        for f in got:
            a, b = got[f][ig], want[f][iw]
            if f in tol:
                ok = abs(float(a) - float(b)) <= tol[f]
            elif f in ("payload", "psdu"):
                n = int(got["payload_len" if f == "payload" else "length"][ig])
                ok = np.array_equal(a[:n], b[:n])
            elif f == "header":
                ok = not got["header_valid"][ig] or np.array_equal(a, b)
            else:
                ok = np.array_equal(a, b)
            assert ok, (key, f, a, b)
    return len(kg)


def family_frames(name, res):
    """The frames of a time-sharded result in the form each family's
    check takes (``check_sc_frames``, ``check_ff_frames``, the WLAN rows
    of ``wlan_rows``)."""
    rows = sorted(np.nonzero(res["detected"])[0],
                  key=lambda r: int(res["t_start"][r]))
    if name == "wlan":
        return [(int(res["t_start"][r]), int(res["rate"][r]),
                 int(res["length"][r]), bool(res["signal_valid"][r]),
                 bool(res["psdu_valid"][r]),
                 res["psdu"][r][:int(res["length"][r])].tobytes(),
                 float(res["cfo"][r]), float(res["rssi"][r]))
                for r in rows]
    return [dict(t=int(res["t_start"][r]), valid=bool(res["payload_valid"][r]),
                 payload_valid=bool(res["payload_valid"][r]),
                 header=res["header"][r], cfo=float(res["cfo"][r]),
                 payload=res["payload"][r][:int(res["payload_len"][r])])
            for r in rows]


def host_decoded(what, res, bench):
    """:func:`check_decoded` on host results ``[N, rows]``."""
    check_decoded(what, *fingerprint(SimpleNamespace(
        payload_valid=torch.as_tensor(res["payload_valid"]),
        payload=torch.as_tensor(res["payload"])), bench.w64.cpu()),
        bench.expected)


@pytest.fixture(scope="module")
def world(dev, bench, sc, ff, gm, tmp):
    """:func:`torch_parallel_ranks.card_world` in a spawned world of four
    ranks that share the card (gloo, their tensors through pinned host
    copies; NCCL on a host with a card per rank, as ``spawn`` chooses),
    over the bench mixture and its flush chunk, the bench baseband, and
    the app-default streams of the OFDM (the legacy detector at level 1:
    B3), flexframe, GMSK and 802.11a receivers, each zero-padded to four
    chunks; beside each family's sequential rows on the card."""
    import torch_parallel_ranks as ranks
    from liquid_usrp_tpu_torch.apps import wlanframe_tx
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync, wlan
    from liquid_usrp_tpu_torch.parallel import distributed
    syncs = {"ofdm": ofdm_sync.make_sync(
                 bench.params, block_size=SC_BLOCK,
                 max_payload=SC_MAX_PAYLOAD, use_pallas=1,
                 xcorr_detect=False),
             "flex": ff_sync(), "gmsk": gm_sync(),
             "wlan": wlan.make_wlan_sync()}
    raw = {"ofdm": sc.stream, "flex": ff.rx, "gmsk": gm.stream,
           "wlan": transmit(wlanframe_tx, tmp / "par_wlan.iq", "-r", "6",
                            "-N", str(WLAN_FRAMES))}
    padded = {k: time_padded(v, syncs[k]) for k, v in raw.items()}
    seq = {k: sequential_rows(syncs[k], padded[k][0], dev) for k in raw}
    streams, _ = bench_streams(bench.params, ofdm.default_props(),
                               BLOCK * N_BLOCKS, bench.sync1.overlap + 8 * M,
                               dev)
    inp = {"N": N, "mix": np.concatenate([bench.blocks.cpu().numpy(),
                                          bench.flush.cpu().numpy()]),
           "flush": bench.flush.cpu().numpy(),
           "tx_streams": np.ascontiguousarray(streams.T),
           "sync": dict(block_size=BLOCK, max_payload=MAX_PAYLOAD,
                        max_frames=MAX_FRAMES),
           "time": {k: (syncs[k],) + padded[k] for k in raw}}
    outs = distributed.spawn(ranks.card_world, PAR_RANKS, inp,
                             timeout_s=PAR_TIMEOUT_S)
    own = PAR_RANKS <= torch.cuda.device_count()
    for rank, out in enumerate(outs):
        assert (out["backend"], out["device"]) == (
            "nccl" if own else "gloo", f"cuda:{rank if own else 0}"), rank
    for name in outs[0]["launches"]:
        print(name, "launches a rank:",
              [{k: v for k, v in o["launches"][name].items() if v}
               for o in outs])
    return SimpleNamespace(res=outs[0]["res"], seq=seq, raw=raw,
                           launches=[o["launches"] for o in outs])


@pytest.mark.gpu
@pytest.mark.parametrize("run,kernel", [("a2a", B1), ("dup", B2),
                                        ("piped", B1)])
def test_sharded_receivers_on_ranks_sharing_the_card(bench, world, run,
                                                     kernel):
    """``sharded_mcrx`` (level 1), ``make_sharded_mcrx`` (level 2) and
    ``sharded_mcrx`` with ``n_steps=2`` over the mixture and three flush
    chunks: 88/88 with the bench fingerprints, every rank launching the
    level's detect kernel and no other; the ``n_steps=2`` rows equal the
    one-shot run's."""
    host_decoded(run, world.res[run], bench)
    for launched in world.launches:
        assert_launched(launched[run], kernel, only=True)
    if run == "piped":
        assert rows_equal(world.res["piped"], world.res["a2a"]) > 0


@pytest.mark.gpu
def test_sharded_mctx_on_ranks_sharing_the_card(dev, bench, world):
    """``make_sharded_mctx`` on the bench baseband within 1e-5 of its peak
    of ``make_mctx_step``'s mixture, no detect kernel launched, and 88/88
    through the single-process receiver."""
    from liquid_usrp_tpu_torch.models.multichannel import \
        make_mcrx_batched_step
    tx_mix, ref = world.res["mctx"], bench.mixture
    assert float(np.abs(tx_mix - ref).max() / np.abs(ref).max()) <= 1e-5
    for launched in world.launches:
        assert_launched(launched["mctx"], only=True)
    init, step = make_mcrx_batched_step(N, bench.sync1, N_BLOCKS, dev)
    blocks = torch.as_tensor((tx_mix + 0.01 * bench.noise).reshape(-1)
                             .astype(np.complex64), device=dev)
    total, _ = decode_stream(step, init, blocks, bench.flush, bench.n_flush,
                             bench.w64)
    check_decoded("make_sharded_mctx -> single-process RX", *total,
                  bench.expected)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["ofdm", "flex", "gmsk", "wlan"])
def test_time_sharded_sync_on_ranks_sharing_the_card(sc, world, family):
    """``make_time_sharded_sync`` over a family's app-default stream on
    four ranks: the detected rows equal the sequential block loop's, every
    frame decoded (40/40, 40/40, 40/40, 5/5), B3 launched by every rank
    for OFDM and no detect kernel for the others."""
    from liquid_usrp_tpu_torch.framing import flexframe as ff_mod
    got = world.res[f"time_{family}"]
    assert rows_equal(got, world.seq[family]) > 0
    frames = family_frames(family, got)
    if family == "ofdm":
        check_sc_frames(frames, sc.sent)
    elif family == "flex":
        check_ff_frames(frames, tx_draws(FF_FRAMES, FF_SEED,
                                         ff_mod.FLEX_HEADER_USER, FF_PAYLOAD))
    elif family == "gmsk":
        check_ff_frames(frames, tx_draws(GM_FRAMES, GM_SEED, 8, GM_PAYLOAD),
                        exact_count=False)
    else:
        wlan_check_psdus(frames, wlan_draws(WLAN_FRAMES, WLAN_PSDU),
                         WLAN_FRAMES)
    for launched in world.launches:
        assert_launched(launched[f"time_{family}"],
                        *([B3] if family == "ofdm" else []), only=True)


@pytest.mark.gpu
def test_sharded_mcrx_in_a_one_rank_nccl_world(bench, world):
    """``sharded_mcrx`` (level 1, four blocks a chunk) in a spawned 1-rank
    world on the card, over NCCL (its results gathered through
    ``gather_tree``): 88/88 with the bench fingerprints, B1 only, and the
    rows of the four-rank world's ``sharded_mcrx``."""
    import torch_parallel_ranks as ranks
    from liquid_usrp_tpu_torch.parallel import distributed
    inp = {"N": N, "mix": np.concatenate([bench.blocks.cpu().numpy(),
                                          bench.flush.cpu().numpy()]),
           "sync": dict(block_size=BLOCK, max_payload=MAX_PAYLOAD,
                        max_frames=MAX_FRAMES)}
    (out,) = distributed.spawn(ranks.card_nccl, 1, inp,
                               timeout_s=PAR_TIMEOUT_S)
    assert out["backend"] == "nccl"
    host_decoded("1-rank NCCL world", out["res"], bench)
    assert_launched(out["launches"], B1, only=True)
    assert rows_equal(out["res"], world.res["a2a"]) > 0


# ---------------------------------------------------------------------------
# the BER/PER sweep against the JAX package's curves
# ---------------------------------------------------------------------------

def jax_curve(name):
    """The rows of ``docs/ber_{name}.json``, by SNR."""
    return sorted(json.loads((DOCS / f"ber_{name}.json").read_text())
                  ["rows"], key=lambda r: r["snr_db"])


def curve_at(rows, value, s, log):
    """``value(row)`` at ``s`` dB between the rows, held flat beyond them:
    log-linear where both neighbours are positive (``log``), else
    linear."""
    x = [r["snr_db"] for r in rows]
    y = [value(r) for r in rows]
    if s <= x[0]:
        return y[0]
    if s >= x[-1]:
        return y[-1]
    i = next(k for k in range(len(x)) if x[k] >= s)
    t = (s - x[i - 1]) / (x[i] - x[i - 1])
    if log and y[i - 1] > 0 and y[i] > 0:
        return float(np.exp(np.log(y[i - 1]) + t * (np.log(y[i]) -
                                                    np.log(y[i - 1]))))
    return y[i - 1] + t * (y[i] - y[i - 1])


def rule_a(row, rows):
    """Rule (a): the port's PER at s lies between the JAX curve's at s +
    0.5 dB and at s - 0.5 dB, and its detections (a fraction of the frames
    sent) between the curve's at s - 0.5 and s + 0.5, each bound widened
    by 3 binomial standard deviations of the port's frame count."""
    n, s = row["frames_sent"], row["snr_db"]

    def sd(p):
        p = min(max(p, 0.0), 1.0)
        return (p * (1.0 - p) / n) ** 0.5

    def window(value, log, falling):
        a = curve_at(rows, value, s + FID_SHIFT_DB, log)
        b = curve_at(rows, value, s - FID_SHIFT_DB, log)
        lo, hi = (a, b) if falling else (b, a)
        return lo - FID_SIGMAS * sd(lo), hi + FID_SIGMAS * sd(hi)

    per_w = window(lambda r: r["packet_error_rate"], True, True)
    det_w = window(lambda r: r["frames_detected"] / r["frames_sent"], False,
                   False)
    assert per_w[0] <= row["packet_error_rate"] <= per_w[1], (row, per_w)
    assert det_w[0] <= row["frames_detected"] / n <= det_w[1], (row, det_w)


def fid_point(bs, cfg, stream, noisy, snr, level_kernel=None):
    """(row, score, dispatches) of one sweep point on the card; of B1-B5
    only ``level_kernel`` may launch."""
    kernels.reset_launch_counts()
    dets = bs.receive(cfg, noisy)
    assert not any(kernels.launches[k] for k in DETECT
                   if k != level_kernel), kernels.launches
    sc_ = bs.score(dets, stream.positions, stream.payloads, FID_PAYLOAD)
    return bs.row(sc_, snr), sc_, dets.dispatches


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["ofdm", "flex", "gmsk"])
def test_sweep_uncoded_waterfall_holds_to_jax(dev, family):
    """200 frames at each point of the JAX waterfall (PER 0.02-0.95) and
    the first point below 1 % after it, under rule (a); OFDM at level 1
    (B1)."""
    from liquid_usrp_tpu_torch.apps import ber_sweep as bs
    rows = jax_curve(family)
    cfg = bs.make_config(family, FID_PAYLOAD)
    stream = bs.build_stream(cfg, FID_FRAMES, 0, dev)
    pts = [r["snr_db"] for r in rows
           if FID_WATERFALL[0] <= r["packet_error_rate"] <= FID_WATERFALL[1]]
    pts += [r["snr_db"] for r in rows
            if r["packet_error_rate"] < 0.01 and r["snr_db"] > max(pts)][:1]
    for snr in pts:
        noisy = bs.add_noise(stream, snr)
        assert noisy.device == dev
        row, _, _ = fid_point(bs, cfg, stream, noisy, snr,
                              B1 if family == "ofdm" else None)
        rule_a(row, rows)


@pytest.mark.gpu
@pytest.mark.parametrize("snr", FID_LEVEL_SNRS)
def test_sweep_ofdm_levels_on_one_stream(dev, snr):
    """Levels 0, 1 (B1) and 2 (B2) on the same noisy stream around 10 %
    PER: level 1 within one detection of level 0 and its
    ``payload_valid`` differing in at most 2 frames; B1 and B2 launched
    once in every dispatch, each held to its plain version at the sweep's
    shapes (the first dispatch's windows)."""
    from liquid_usrp_tpu_torch.apps import ber_sweep as bs
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    stream = bs.build_stream(bs.make_config("ofdm", FID_PAYLOAD), FID_FRAMES,
                             0, dev)
    noisy = bs.add_noise(stream, snr)
    got = {0: fid_point(bs, bs.make_config("ofdm", FID_PAYLOAD,
                                           use_pallas=0), stream, noisy, snr)}
    for level, kernel in ((1, B1), (2, B2)):
        cfg = bs.make_config("ofdm", FID_PAYLOAD, use_pallas=level)
        kernels.reset_launch_counts()
        results = []
        for res in bs.dispatches(cfg, noisy):
            results.append(res)
            counted = dict(kernels.launches)
            kernels.reset_launch_counts()
            assert counted[kernel] == 1, (level, len(results), counted)
            assert not any(counted[k] for k in DETECT if k != kernel)
        sc_ = bs.score(bs.collect(results), stream.positions,
                       stream.payloads, FID_PAYLOAD)
        got[level] = (bs.row(sc_, snr), sc_, len(results))
        sync = cfg.sync
        m = sync.params.M
        blocks = torch.zeros(bs.BLOCKS * sync.block_size,
                             dtype=torch.complex64, device=dev)
        head = noisy[:blocks.shape[0]]
        blocks[:head.shape[0]] = head
        exts = ofdm_sync.extended_windows(
            sync, ofdm_sync.sync_init(sync, dev).tail[None],
            blocks.reshape(1, bs.BLOCKS, sync.block_size))[1]
        if kernel == B1:
            tmpl = ofdm_sync.sync_tables(sync, dev).xc_tmpl
            b1_vs_plain((exts, tmpl, ofdm_sync._xc_span(len(tmpl)),
                         sync.block_size + 2 * m + 1))
        else:
            b2_vs_plain((exts, m // 4, 2 * m - m // 4, m, sync.block_size,
                         sync.threshold, sync.max_frames))
    (r0, s0, _), (r1, s1, _) = got[0], got[1]
    assert abs(r1["frames_detected"] - r0["frames_detected"]) <= 1
    assert int((s1.frame_ok != s0.frame_ok).sum()) <= FID_LEVEL_FLIPS


@pytest.mark.gpu
@pytest.mark.parametrize("family", list(FID_SOFT_SNR))
def test_sweep_v27_soft_beats_hard(dev, family):
    """v27 at one waterfall point (OFDM 2 dB, flexframe 0 dB, GMSK -3 dB),
    soft and hard on one stream, each under rule (a) against its JAX
    curve, the soft PER below the hard."""
    from liquid_usrp_tpu_torch.apps import ber_sweep as bs
    snr = FID_SOFT_SNR[family]
    soft = bs.make_config(family, FID_PAYLOAD, "v27", "none", soft=True)
    hard = bs.make_config(family, FID_PAYLOAD, "v27", "none")
    stream = bs.build_stream(soft, FID_FRAMES, 0, dev)
    noisy = bs.add_noise(stream, snr)
    per = {}
    for what, cfg in (("soft", soft), ("hard", hard)):
        row, _, _ = fid_point(bs, cfg, stream, noisy, snr,
                              B1 if family == "ofdm" else None)
        rule_a(row, jax_curve(f"{family}_v27_{what}"))
        per[what] = row["packet_error_rate"]
    assert per["soft"] < per["hard"]


@pytest.mark.gpu
def test_sweep_gmsk_v27_decodes_header_invalid_rows(dev):
    """GMSK v27 hard at -2 and -1 dB, where headers fail (fault C6): the
    points run on the card with no detect kernel."""
    from liquid_usrp_tpu_torch.apps import ber_sweep as bs
    hard = bs.make_config("gmsk", FID_PAYLOAD, "v27", "none")
    stream = bs.build_stream(hard, FID_FRAMES, 0, dev)
    for snr in FID_INVALID_SNRS:
        row, _, n = fid_point(bs, hard, stream, bs.add_noise(stream, snr),
                              snr)
        assert n > 0 and row["frames_sent"] == FID_FRAMES
