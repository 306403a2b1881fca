"""The measurement ops, DPSK, the filter designs and the small CLIs against
the JAX package: ``ops/agc.py``, ``ops/spectrum.py``, ``ops/window.py``,
``modem.dpsk_modulate/dpsk_demodulate``, ``filter_design.firdes_prototype``
over ``PULSE_TYPES``, and the ``rssi``, ``asgram_rx``, ``narrowband_tx``,
``halfduplex_txrx`` and ``fullduplex_txrx`` CLIs (mirroring
``tests/test_measurement_ops.py``, ``tests/test_dpsk.py`` and
``tests/test_apps.py``).

Tolerances: filter designs, window tables, ring logs, symbol decisions and
spectral peak bins exact.  AGC levels, outputs and RSSI within a relative
1e-5 of JAX's (the port's Hillis-Steele scan composes the affine maps in
another order than ``lax.associative_scan``; measured 2e-6).  The
spectrogram's dB within 1e-4 dB.  DPSK points within 5e-5 of JAX's over
2,048 symbols (a complex ``cumprod`` rounds in its own order on each
backend, and the magnitude of each drifts from 1 by a few 1e-5 over the
run; measured 2.0e-5 apart); decisions exact.  ``narrowband_tx``'s
samples within 1e-6 of max |x| of JAX's (the interpolator's float32 sums),
and the same length.  The apps' printed RSSI within 0.01 dB and peaks
within 0.1 dB of JAX's apps, peak frequencies and ASCII rows equal.
"""
import contextlib
import io
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.apps import asgram_rx as j_asgram
from liquid_usrp_tpu.apps import narrowband_tx as j_nbtx
from liquid_usrp_tpu.apps import rssi as j_rssi
from liquid_usrp_tpu.ops import agc as jagc
from liquid_usrp_tpu.ops import filter_design as jfd
from liquid_usrp_tpu.ops import modem as jmodem
from liquid_usrp_tpu.ops import spectrum as jspec
from liquid_usrp_tpu.ops import window as jwin
from liquid_usrp_tpu_torch.apps import (asgram_rx, fullduplex_txrx,
                                        halfduplex_txrx, narrowband_tx, rssi)
from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.framing import payload as tpc
from liquid_usrp_tpu_torch.io.streams import read_iq
from liquid_usrp_tpu_torch.ops import agc, spectrum, window
from liquid_usrp_tpu_torch.ops import filter_design as tfd
from liquid_usrp_tpu_torch.ops import modem
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

AGC_RTOL = 1e-5
DPSK_ATOL = 5e-5       # over 2,048 symbols of cumulative rotation


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


# --- AGC --------------------------------------------------------------------

def _agc_input(rng, n):
    """Complex noise whose amplitude steps 0.2 -> 3.5 -> 0.05."""
    amp = np.repeat([0.2, 3.5, 0.05], -(-n // 3))[:n]
    return (amp * (rng.normal(size=n) + 1j * rng.normal(size=n)) /
            np.sqrt(2)).astype(np.complex64)


@pytest.mark.parametrize("bw,n", [(0.01, 12000), (0.02, 4096),
                                  (0.2, 1000), (0.01, 1)])
def test_agc_matches_jax(bw, n):
    """Output, level, RSSI and the carried level against JAX, over blocks
    longer than the 10,300 samples where ``(1-a)**n`` leaves float32."""
    x = _agc_input(_rng(f"agc {bw} {n}"), n)
    jst, jy, jl, jr = jagc.agc_block(jagc.agc_init(bw, 0.7), jnp.asarray(x))
    st, y, level, r = agc.agc_block(agc.agc_init(bw, 0.7, device="cpu"),
                                    torch.as_tensor(x))
    for got, want in ((y, jy), (level, jl), (st.level, jst.level)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=AGC_RTOL, atol=0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0,
                               atol=20 * AGC_RTOL)
    assert torch.isfinite(y).all() and torch.isfinite(level).all()


def test_agc_converges_and_is_block_invariant():
    rng = _rng("agc unity")
    x = (3.5 * (rng.normal(size=8192) + 1j * rng.normal(size=8192)) /
         np.sqrt(2)).astype(np.complex64)
    st0 = agc.agc_init(bandwidth=0.02, device="cpu")
    _, y, _, r = agc.agc_block(st0, torch.as_tensor(x))
    assert abs(float(y[-2000:].abs().mean()) - 1.0) < 0.15
    assert abs(float(r[-1]) - 20 * np.log10(3.5)) < 1.5
    st, y1, _, _ = agc.agc_block(st0, torch.as_tensor(x[:1000]))
    _, y2, _, _ = agc.agc_block(st, torch.as_tensor(x[1000:]))
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), y.numpy(),
                               rtol=AGC_RTOL, atol=1e-6)


# --- spectrogram and ring log -----------------------------------------------

def test_spectrogram_matches_jax():
    rng = _rng("spectrogram")
    jsg = jspec.spectrogram_create(nfft=64)
    sg = spectrum.spectrogram_create(nfft=64)
    np.testing.assert_array_equal(sg.window, jsg.window)
    assert sg._replace(window=None) == jsg._replace(window=None)
    t = np.arange(64 * 8)
    x = (np.exp(2j * np.pi * (10 / 64) * t) + 0.1 * rng.normal(size=t.size)
         ).astype(np.complex64)
    psd, pk, pf = spectrum.spectrogram_block(sg, torch.as_tensor(x))
    jpsd, jpk, jpf = jspec.spectrogram_block(jsg, jnp.asarray(x))
    np.testing.assert_allclose(psd.numpy(), np.asarray(jpsd), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jpf))
    np.testing.assert_allclose(pf.numpy(), 10 / 64, atol=1e-6)
    for row in np.asarray(jpsd):
        assert spectrum.ascii_row(sg, row) == jspec.ascii_row(jsg, row)
    assert len(spectrum.ascii_row(sg, psd[0].numpy())) == 64


def test_ring_log_matches_jax():
    r = window.ring_init(16, device="cpu")
    jr = jwin.ring_init(16)
    for x in (np.arange(10), 10 + np.arange(10), np.arange(5),
              np.arange(100), np.arange(3)):
        r = window.ring_push(r, torch.as_tensor(x.astype(np.complex64)))
        jr = jwin.ring_push(jr, jnp.asarray(x.astype(np.complex64)))
        np.testing.assert_array_equal(window.ring_read(r).numpy(),
                                      np.asarray(jwin.ring_read(jr)))
        assert int(window.ring_valid(r)) == int(jwin.ring_valid(jr))
        assert window.ring_valid(r).dtype == torch.int32
    np.testing.assert_array_equal(window.ring_read(r).numpy().real,
                                  np.concatenate([np.arange(87, 100),
                                                  np.arange(3)]))
    half = window.ring_push(window.ring_init(16, torch.float32, "cpu"),
                            torch.arange(5, dtype=torch.float32))
    assert int(window.ring_valid(half)) == 5
    assert half.buf.dtype == torch.float32
    np.testing.assert_array_equal(half.buf.numpy()[-5:], np.arange(5))


# --- DPSK -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dpsk2", "dpsk4", "dpsk8", "dpsk16",
                                  "dpsk256"])
def test_dpsk_matches_jax(name):
    s = modem.mod_from_name(name)
    rng = _rng(name)
    sym = rng.integers(0, 1 << modem.bits_per_symbol(s), 2048)
    for ref in (None, np.complex64(np.exp(0.3j))):
        pts, last = modem.dpsk_modulate(s, torch.as_tensor(sym), ref)
        jpts, jlast = jmodem.dpsk_modulate(
            s, jnp.asarray(sym), None if ref is None else jnp.asarray(ref))
        np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0,
                                   atol=DPSK_ATOL)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                                   atol=DPSK_ATOL)
        # a static phase cancels: the data rides the increments
        rx = (pts * complex(np.exp(1.1j))).numpy()
        rx += (0.01 * (rng.normal(size=rx.shape) + 1j *
                       rng.normal(size=rx.shape))).astype(np.complex64)
        r0 = None if ref is None else ref * np.complex64(np.exp(1.1j))
        dec, nref = modem.dpsk_demodulate(s, torch.as_tensor(rx), r0)
        jdec, jnref = jmodem.dpsk_demodulate(
            s, jnp.asarray(rx), None if r0 is None else jnp.asarray(r0))
        np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
        assert complex(nref) == complex(jnref)
        if ref is not None and modem.bits_per_symbol(s) <= 3:
            np.testing.assert_array_equal(dec.numpy(), sym)
    with pytest.raises(ValueError):
        modem.dpsk_modulate(modem.MOD_QPSK, torch.as_tensor(sym))
    with pytest.raises(ValueError):
        modem.dpsk_demodulate(modem.MOD_QPSK, torch.as_tensor(rx))


def _codec_points(props, payload):
    enc = tpc.encode_payload(props, torch.as_tensor(payload))
    bps = modem.bits_per_symbol(props.mod)
    pbits = tpc.unpack_bits(enc)
    pbits = torch.nn.functional.pad(
        pbits, (0, -(-pbits.shape[-1] // bps) * bps - pbits.shape[-1]))
    pts = modem.modulate(props.mod, modem.bits_to_symbols(pbits, bps))
    if modem.is_differential(props.mod):
        pts = tpc.diff_encode_points(pts)
    return pts


@pytest.mark.parametrize("mod,soft", [(modem.MOD_DPSK2, False),
                                      (modem.MOD_DPSK4, True),
                                      (modem.MOD_DPSK8, False),
                                      (modem.MOD_QPSK, False)])
def test_dpsk_codec_survives_static_phase(mod, soft):
    """A DPSK payload decodes under a static phase offset with no
    equalizer (hard and soft); the same offset breaks coherent QPSK."""
    payload = _rng("dpsk codec").integers(0, 256, 96, dtype=np.uint8)
    props = ofdm.FrameProps(mod=mod)
    pts = _codec_points(props, payload) * complex(np.exp(0.8j))
    enc_max = 256 * 3
    P = torch.nn.functional.pad(pts, (0, enc_max * 8 + 1 - pts.shape[0]))

    def one(v):
        return torch.tensor([v], dtype=torch.int32)
    fn = tpc.decode_payload_batch_soft if soft else tpc.decode_payload_batch
    dec, ok = fn(enc_max, 260, 256, P[None], one(props.mod),
                 one(props.fec0), one(props.fec1), one(props.check),
                 one(96), torch.tensor([True]))
    if mod == modem.MOD_QPSK:
        assert not bool(ok[0])
    else:
        assert bool(ok[0])
        np.testing.assert_array_equal(dec[0, :96].numpy(), payload)


def test_dpsk_ofdm_loopback():
    """A dpsk4 payload through the OFDM frame and synchronizer."""
    params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    sync = ofdm_sync.make_sync(params, block_size=8192, max_payload=512,
                               max_frames=4)
    rng = _rng("dpsk ofdm")
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 200, dtype=np.uint8)
    samples = ofdm.assemble_frame(
        params, ofdm.FrameProps(mod=modem.MOD_DPSK4),
        torch.as_tensor(header), torch.as_tensor(payload)).numpy()
    n = -(-(3000 + len(samples) + sync.overlap) // 8192) + 1
    stream = np.zeros(n * 8192, np.complex64)
    stream[1200:1200 + len(samples)] = samples
    _, res = ofdm_sync.sync_blocks_batched(
        sync, ofdm_sync.sync_init(sync, "cpu"),
        torch.as_tensor(stream.reshape(n, 8192)))
    ok = res.payload_valid.numpy()
    assert int(ok.sum()) == 1 and int(res.detected.sum()) == 1
    np.testing.assert_array_equal(res.payload.numpy()[ok][0, :200], payload)


# --- filter designs --------------------------------------------------------

@pytest.mark.parametrize("ptype", list(jfd.PULSE_TYPES) + ["rrc"])
def test_firdes_prototype_equals_jax(ptype):
    assert tfd.PULSE_TYPES == jfd.PULSE_TYPES
    for k, m, beta in ((2, 9, 0.2), (4, 3, 0.35), (2, 4, 0.5)):
        got = tfd.firdes_prototype(ptype, k, m, beta)
        assert got.shape == (2 * k * m + 1,)
        np.testing.assert_array_equal(got, jfd.firdes_prototype(ptype, k, m,
                                                                beta))
    with pytest.raises(ValueError):
        tfd.firdes_prototype("nope", 2, 9, 0.2)


# --- the CLIs ---------------------------------------------------------------

@pytest.mark.parametrize("argv", [["-n", "2048", "-t", "rrcos"],
                                  ["-n", "512", "-t", "hm3", "-m", "qam16",
                                   "-r", "1.5", "-s", "3"],
                                  ["-n", "512", "-t", "fexp", "-m", "dpsk4",
                                   "-r", "0.75", "-k", "4", "-M", "3"]])
def test_narrowband_tx_file_equals_jax(cpu_env, tmp_path, argv):
    f, jf = str(tmp_path / "nb.iq"), str(tmp_path / "nb_jax.iq")
    rc, out = _capture(narrowband_tx.main, ["-o", f, *argv])
    jrc, jout = _capture(j_nbtx.main, ["-o", jf, *argv])
    assert rc == 0 and jrc == 0
    assert out.replace(f, jf) == jout
    got, want = read_iq(f), read_iq(jf)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _numbers(text, pattern):
    return [float(v) for v in re.findall(pattern, text)]


def test_narrowband_asgram_rssi_match_jax(cpu_env, tmp_path):
    """``narrowband_tx -> asgram_rx / rssi``: the same rows, peaks and
    RSSI values as JAX's apps on the same file, and the octave dumps."""
    f = str(tmp_path / "nb.iq")
    assert _capture(narrowband_tx.main,
                    ["-o", f, "-n", "6000", "-t", "rrcos"])[0] == 0
    for argv in (["-i", f, "-L", "4"], ["-i", f, "-L", "6", "-n", "128",
                                        "-r", "0.5"]):
        rc, out = _capture(asgram_rx.main, argv)
        jrc, jout = _capture(j_asgram.main, argv)
        assert rc == 0 and jrc == 0 and "peak:" in out
        assert re.findall(r"\[(.*)\]", out) == re.findall(r"\[(.*)\]", jout)
        assert _numbers(out, r"f=([-+.\d]+)") == _numbers(jout,
                                                          r"f=([-+.\d]+)")
        np.testing.assert_allclose(
            _numbers(out, r"peak:\s+([-.\d]+) dB"),
            _numbers(jout, r"peak:\s+([-.\d]+) dB"), atol=0.1 + 1e-9)
    m, jm = str(tmp_path / "rssi_log.m"), str(tmp_path / "rssi_jax.m")
    for argv, dump in ((["-i", f, "-L", "2048"], (m, jm)),
                       (["-i", f, "-L", "1500", "-r", "0.5", "-b", "0.05"],
                        None)):
        extra = ["-o", dump[0]] if dump else []
        rc, out = _capture(rssi.main, argv + extra)
        jextra = ["-o", dump[1]] if dump else []
        jrc, jout = _capture(j_rssi.main, argv + jextra)
        assert rc == 0 and jrc == 0
        vals = _numbers(out, r"rssi =\s+([-.\d]+)")
        assert vals and len(vals) == len(_numbers(jout,
                                                   r"rssi =\s+([-.\d]+)"))
        np.testing.assert_allclose(vals, _numbers(jout,
                                                  r"rssi =\s+([-.\d]+)"),
                                   atol=0.01 + 1e-9)
    text = open(m).read()
    assert "figure; plot(rssi)" in text
    r = [float(v) for v in text.split("rssi = [")[1].split("]")[0].split()]
    jr = [float(v) for v in open(jm).read().split("rssi = [")[1]
          .split("]")[0].split()]
    np.testing.assert_allclose(r, jr, atol=0.001 + 1e-9)


def test_rssi_asgram_msresamp_stage(cpu_env, tmp_path):
    """``-r`` resamples before the measurement: a unit tone at 0.15 keeps
    its RSSI and moves its peak to 0.15 / r."""
    n = 16384
    tone = np.exp(2j * np.pi * 0.15 * np.arange(n)).astype(np.complex64)
    f = str(tmp_path / "tone.iq")
    tone.tofile(f)
    rc, out = _capture(rssi.main, ["-i", f, "-r", "0.5", "-L", "2048"])
    vals = _numbers(out, r"rssi =\s+([-.\d]+)")
    assert rc == 0 and vals and all(abs(v) < 1.5 for v in vals[1:])
    for rate, want in (("0.5", 0.30), ("2.0", 0.075)):
        rc, out = _capture(asgram_rx.main,
                           ["-i", f, "-r", rate, "-L", "4", "-n", "64"])
        peaks = _numbers(out, r"f=([-+.\d]+)")
        assert rc == 0 and peaks and all(abs(p - want) < 0.05
                                         for p in peaks)
    # a file shorter than one print interval still reports once
    tone[:100].tofile(f)
    rc, out = _capture(rssi.main, ["-i", f])
    assert rc == 0 and len(_numbers(out, r"rssi =\s+([-.\d]+)")) == 1
    o = str(tmp_path / "iq.m")
    rc, out = _capture(asgram_rx.main, ["-i", f, "-L", "1", "-O", o])
    assert rc == 0 and "x = [" in open(o).read()


def test_halfduplex_txrx(cpu_env):
    rc, out = _capture(halfduplex_txrx.main,
                       ["-N", "2", "-P", "32", "--snr", "30"])
    assert rc == 0
    assert "2/2 delivered, 2 transmissions" in out
    assert out.count("delivered (1 attempt)") == 2


def test_fullduplex_txrx(cpu_env):
    """Both directions deliver every frame, each with its derived offset
    measured; ``-R`` swaps the carriers."""
    rc, out = _capture(fullduplex_txrx.main, ["-N", "2", "-P", "100", "-q"])
    assert rc == 0
    assert out.count("valid packets       :      2 (100.00%)") == 2
    assert "A tx 462.0 MHz / rx 562.0 MHz" in out
    for exp, meas in re.findall(r"derived cfo\s+: ([-+.\d]+) rad/sample "
                                r"\(measured ([-+.\d]+)\)", out):
        assert abs(float(exp) - float(meas)) < 1e-3
    rc, out = _capture(fullduplex_txrx.main,
                       ["-N", "1", "-P", "60", "-q", "-R"])
    assert rc == 0 and "(-R swapped)" in out


def test_usage_screens():
    for mod in (asgram_rx, fullduplex_txrx, halfduplex_txrx, narrowband_tx,
                rssi):
        rc, out = _capture(mod.main, ["-h"])
        assert rc == 0 and "[options]" in out
    for mod in (asgram_rx, rssi, narrowband_tx):
        assert _capture(mod.main, [])[0] == 1
    with pytest.raises(SystemExit):
        rssi.main(["-Z"])
