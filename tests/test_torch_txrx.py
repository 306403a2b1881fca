"""The single-channel OFDM transceiver slice against the JAX package:
``OfdmTxRx``, the channel model and virtual air, the ingest converters, the
block prefetcher, the state checkpoint and the ``ofdmflexframe_tx/rx``
apps.

Tolerances: the TX waveform atol 1e-5; RX rows (``t``, header, payload,
flags, length) exact, ``rssi`` atol 1e-3 dB, ``evm`` atol 0.05 dB, ``cfo``
atol 1e-5 rad/sample; the channel model without noise atol 1e-6; the AWGN
standard deviation within 2 % of ``snr_to_noise_std`` (the port draws from
a ``torch.Generator``, so only the distribution can match JAX's); ingest
planes bit-exact.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.io import channel_model as jchan
from liquid_usrp_tpu.io import native as jnative
from liquid_usrp_tpu.models.ofdmtxrx import OfdmTxRx as JTxRx
from liquid_usrp_tpu.ops import iqfmt as jiq
from liquid_usrp_tpu_torch.apps import ofdmflexframe_rx, ofdmflexframe_tx
from liquid_usrp_tpu_torch.io import channel_model as tchan
from liquid_usrp_tpu_torch.io import native as tnative
from liquid_usrp_tpu_torch.io.pipeline import BlockPrefetcher
from liquid_usrp_tpu_torch.io.radio import VirtualAir
from liquid_usrp_tpu_torch.io.streams import read_iq, write_iq
from liquid_usrp_tpu_torch.models.ofdmtxrx import OfdmTxRx
from liquid_usrp_tpu_torch.ops import iqfmt as tiq
from liquid_usrp_tpu_torch.ops import kernels
from liquid_usrp_tpu_torch.utils.checkpoint import load_state, save_state
from liquid_usrp_tpu_torch.utils.convert import from_jax_tree
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV, default_device

KW = dict(block_size=4096, max_payload=256, batch_blocks=2)
CUT = 2 * 4096 + 1234           # mid-stream split: 2 blocks + a partial one


@pytest.fixture
def cpu_env(monkeypatch):
    """The CLIs take no device flag: ask for the CPU through the
    environment, as the JAX apps run under ``JAX_PLATFORMS=cpu``."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")


def _rows_equal(got, want):
    assert [f["t"] for f in got] == [f["t"] for f in want]
    for g, w in zip(got, want):
        for k in ("header_valid", "payload_valid", "payload_len"):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g["header"], w["header"])
        np.testing.assert_array_equal(g["payload"], w["payload"])
        np.testing.assert_allclose(g["stats"]["rssi"], w["stats"]["rssi"],
                                   atol=1e-3)
        np.testing.assert_allclose(g["stats"]["evm"], w["stats"]["evm"],
                                   atol=0.05)
        np.testing.assert_allclose(g["stats"]["cfo"], w["stats"]["cfo"],
                                   atol=1e-5)


@pytest.fixture(scope="module")
def jax_run():
    """JAX ``OfdmTxRx``: three frames (soft gain -6 dB) with gaps and a
    0.02 rad/sample offset in noise; ``run_rx`` over the stream up to
    ``CUT``, then the rest with a flush (both dispatch kinds run).  Returns
    the sent (header, payload, samples), the stream, both calls' rows, and
    the synchronizer state and pending samples at the cut."""
    rng = np.random.default_rng(31)
    tx = JTxRx(**KW)
    tx.set_tx_gain_soft(-6.0)
    sent, pieces = [], []
    for n in (100, 60, 140):
        h = rng.integers(0, 256, 8, dtype=np.uint8)
        p = rng.integers(0, 256, n, dtype=np.uint8)
        pieces += [np.zeros(900, np.complex64), tx.transmit_packet(h, p)]
        sent.append((h, p, pieces[-1]))
    air = np.concatenate(pieces)
    air = air * np.exp(0.02j * np.arange(len(air))).astype(np.complex64)
    air += (0.005 * (rng.normal(size=air.shape) +
                     1j * rng.normal(size=air.shape))).astype(np.complex64)
    rx = JTxRx(**KW)
    rx.start_rx()
    rows_a = rx.run_rx(air[:CUT])
    state = jax.device_get(rx._rx_state)
    pending = np.array(rx._pending)
    rows_b = rx.run_rx(air[CUT:], flush=True)
    return sent, air, rows_a, rows_b, state, pending


def test_transmit_packet_matches_jax(jax_run):
    sent, *_ = jax_run
    tx = OfdmTxRx(**KW, device="cpu")
    tx.set_tx_gain_soft(-6.0)
    for h, p, want in sent:
        got = tx.transmit_packet(h, p)
        assert got.dtype == np.complex64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert len(tx.drain_tx()) == sum(len(w) for _, _, w in sent)


def test_run_rx_matches_jax_and_resumes(jax_run):
    """The same rows as JAX for the stream in two calls; and the port,
    given JAX's mid-stream state and pending samples, continues to JAX's
    rows.  Every frame decodes payload-exact."""
    sent, air, rows_a, rows_b, state, pending = jax_run
    rx = OfdmTxRx(**KW, device="cpu")
    rx.start_rx()
    got_a = rx.run_rx(air[:CUT])
    np.testing.assert_array_equal(rx._pending, pending)
    _rows_equal(got_a, rows_a)
    _rows_equal(rx.run_rx(air[CUT:], flush=True), rows_b)
    ok = sorted((f for f in rows_a + rows_b if f["payload_valid"]),
                key=lambda f: f["t"])
    assert len(ok) == len(sent)
    for f, (h, p, _) in zip(ok, sent):
        np.testing.assert_array_equal(f["header"], h)
        np.testing.assert_array_equal(f["payload"], p)
    resumed = OfdmTxRx(**KW, device="cpu")
    resumed._rx_state = from_jax_tree(state, "cpu")
    resumed._pending = pending
    resumed.start_rx()
    _rows_equal(resumed.run_rx(air[CUT:], flush=True), rows_b)


def test_txrx_surface(tmp_path):
    """Mirrors ``tests/test_models_extra.py``: constructor checks,
    ``write_symbol`` draining the whole frame, ``end_transmit_frame`` and
    ``reset_tx``, the ``rx_transform`` hook, the debug capture roundtrip
    (``debug_print`` takes B3's metric: its plain version here, no
    launch), and the ingest formats decoding identically."""
    for bad in (dict(M=4), dict(cp_len=0), dict(cp_len=2, taper_len=3),
                dict(rx_ingest="f16")):
        with pytest.raises(ValueError):
            OfdmTxRx(**bad)
    rng = np.random.default_rng(3)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 64, dtype=np.uint8)
    txrx = OfdmTxRx(max_payload=128, block_size=4096, device="cpu")
    assert txrx.device == torch.device("cpu")
    whole = txrx.transmit_packet(header, payload)
    txrx.assemble_frame(header, payload)
    chunks = []
    while True:
        c, last = txrx.write_symbol()
        chunks.append(c)
        if last:
            break
    np.testing.assert_allclose(np.concatenate(chunks), whole, atol=1e-6)
    txrx.assemble_frame(header, payload)
    c0, last = txrx.write_symbol()
    assert not last
    np.testing.assert_allclose(
        np.concatenate([c0, txrx.end_transmit_frame()]), whole, atol=1e-6)
    assert len(txrx.end_transmit_frame()) == 0
    txrx.assemble_frame(header, payload)
    txrx.write_symbol()
    txrx.reset_tx()
    assert len(txrx.drain_tx()) == 0
    with pytest.raises(RuntimeError):
        txrx.write_symbol()

    air = np.concatenate([np.zeros(2000, np.complex64), whole,
                          np.zeros(2000, np.complex64)])
    air += (0.01 * (rng.normal(size=air.shape) +
                    1j * rng.normal(size=air.shape))).astype(np.complex64)
    air /= np.abs(np.stack([air.real, air.imag])).max()      # sc8 AGC
    phase = 1.3
    calls = []

    def derotate(blk):
        calls.append(1)
        return blk * complex(np.exp(-1j * phase))

    for ingest in ("c64", "bf16", "sc8"):
        rx = OfdmTxRx(max_payload=128, block_size=4096, rx_ingest=ingest,
                      rx_transform=derotate if ingest == "c64" else None,
                      device="cpu")
        rx.debug_enable()
        rx.start_rx()
        rot = air * np.exp(1j * phase).astype(np.complex64) \
            if ingest == "c64" else air
        kernels.reset_launch_counts()
        ok = [f for f in rx.run_rx(rot, flush=True) if f["payload_valid"]]
        assert len(ok) == 1, ingest
        np.testing.assert_array_equal(ok[0]["payload"], payload)
        np.testing.assert_array_equal(ok[0]["header"], header)
    assert calls
    path = rx.debug_print(str(tmp_path / "cap"))
    text = open(path).read()
    assert "metric = [" in text and "x = [" in text
    assert kernels.launches["detect_metric_onepass"] == 0
    rx.debug_disable()
    with pytest.raises(RuntimeError):
        rx.debug_print(str(tmp_path / "cap2"))


def test_virtual_air_frequency_mistuning():
    """A 200 Hz mistuning at 500 kS/s through the virtual air becomes a
    frequency offset that the synchronizer recovers."""
    a = OfdmTxRx(max_payload=128, device="cpu")
    b = OfdmTxRx(max_payload=128, device="cpu")
    a.set_tx_freq(462.0e6 + 200.0)
    b.set_rx_freq(462.0e6)
    rng = np.random.default_rng(0)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 64, dtype=np.uint8)
    rx_samples = VirtualAir(snr_db=30.0).propagate(
        a.radio, b.radio, a.transmit_packet(header, payload))
    b.start_rx()
    ok = [f for f in b.run_rx(rx_samples, flush=True) if f["payload_valid"]]
    assert len(ok) == 1
    np.testing.assert_array_equal(ok[0]["payload"], payload)
    np.testing.assert_allclose(ok[0]["stats"]["cfo"],
                               2 * np.pi * 200.0 / 500e3, atol=5e-4)


def test_channel_model_matches_jax():
    """Noise off: gain, multipath, delay, frequency offset and phase equal
    JAX's.  AWGN: the noise has the standard deviation
    ``snr_to_noise_std`` gives, and one seed gives one stream.  A
    sample-rate offset resamples as JAX's does."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=3000) + 1j * rng.normal(size=3000)
         ).astype(np.complex64)
    ch = dict(gain=0.7, multipath=(1.0, 0.3 - 0.2j, 0.1j), delay=17,
              cfo=0.01, phase=0.3)
    gen = torch.Generator().manual_seed(0)
    got = tchan.channel_apply(tchan.Channel(**ch), gen, torch.as_tensor(x))
    want = jchan.channel_apply(jchan.Channel(**ch), jax.random.PRNGKey(0),
                               jnp.asarray(x))
    assert got.shape == (3017,) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for snr, power in ((10.0, 2.0), (20.0, 0.5)):
        clean = torch.as_tensor(x)
        big = clean.repeat(40)
        noisy = tchan.channel_apply(tchan.Channel(snr_db=snr), gen, big,
                                    signal_power=power)
        std = float((noisy - big).abs().pow(2).mean().sqrt())
        want_std = tchan.snr_to_noise_std(snr, power)
        assert want_std == jchan.snr_to_noise_std(snr, power)
        assert abs(std / want_std - 1) < 0.02
    a = tchan.awgn(torch.Generator().manual_seed(7), clean, 10.0)
    b = tchan.awgn(torch.Generator().manual_seed(7), clean, 10.0)
    assert torch.equal(a, b)
    got = tchan.channel_apply(tchan.Channel(sro_ppm=10.0), gen, clean)
    want = jchan.channel_apply(jchan.Channel(sro_ppm=10.0),
                               jax.random.PRNGKey(0), jnp.asarray(x))
    assert got.shape == (3002,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ingest_converters_and_prefetcher(tmp_path):
    """The native converters give the planes of ``ops/iqfmt.py`` and of the
    JAX package bit for bit; the native file I/O and block reader round
    trip; the prefetcher yields blocks in order and raises a source's
    error in the consumer."""
    rng = np.random.default_rng(6)
    x = (0.4 * (rng.normal(size=5000) + 1j * rng.normal(size=5000))
         ).astype(np.complex64)
    bf = tnative.cf32_to_bf16_planes(x)
    assert bf.dtype == torch.bfloat16 and bf.shape == (2, 5000)
    assert torch.equal(bf, tiq.iq_to_planes(torch.as_tensor(x)))
    np.testing.assert_array_equal(
        bf.view(torch.int16).numpy(),
        np.asarray(jnative.cf32_to_bf16_planes(x)).view(np.int16))
    np.testing.assert_array_equal(
        bf.view(torch.int16).numpy(),
        np.asarray(jiq.iq_to_planes(jnp.asarray(x))).view(np.int16))
    sc8 = tnative.cf32_to_sc8_planes(x)
    assert torch.equal(sc8, tiq.iq_to_planes_sc8(torch.as_tensor(x)))
    np.testing.assert_array_equal(sc8.numpy(),
                                  np.asarray(jnative.cf32_to_sc8_planes(x)))
    np.testing.assert_array_equal(
        tiq.iq_to_planes_sc8(torch.as_tensor(x)).numpy(),
        np.asarray(jiq.iq_to_planes_sc8(jnp.asarray(x))))
    path = str(tmp_path / "x.iq")
    tnative.write_file(path, x)
    np.testing.assert_array_equal(tnative.read_file(path), x)
    np.testing.assert_array_equal(read_iq(path), x)
    if tnative.available():
        blocks = list(BlockPrefetcher(tnative.NativeReader(path, 1024)))
        assert [len(b) for b in blocks] == [1024] * 4 + [904]
        np.testing.assert_array_equal(np.concatenate(blocks), x)

    def failing():
        yield x[:10]
        raise IOError("disk gone")
    it = iter(BlockPrefetcher(failing()))
    np.testing.assert_array_equal(next(it), x[:10])
    with pytest.raises(IOError, match="disk gone"):
        next(it)


def test_checkpoint_roundtrip_and_mismatch(tmp_path):
    rx = OfdmTxRx(**KW, device="cpu")
    rx._rx_state = rx._rx_state._replace(
        tail=torch.arange(rx._sync.overlap).to(torch.complex64),
        base=torch.tensor(12345, dtype=torch.int32))
    state = {"sync": rx._rx_state, "pending_len": torch.tensor(7),
             "pending": torch.ones(5, dtype=torch.complex64)}
    path = str(tmp_path / "st")
    save_state(path, state)
    back = load_state(path, state)
    assert list(back) == list(state)
    assert type(back["sync"]) is type(rx._rx_state)
    for k in ("pending_len", "pending"):
        assert torch.equal(back[k], state[k])
    assert torch.equal(back["sync"].tail, state["sync"].tail)
    assert int(back["sync"].base) == 12345
    for bad in ({**state, "pending": torch.ones(6, dtype=torch.complex64)},
                {**state, "pending_len": torch.tensor(7, dtype=torch.int32)},
                {**state, "extra": torch.zeros(1)},
                {"sync": state["sync"], "pending_len": state["pending_len"],
                 "other": state["pending"]}):
        with pytest.raises(ValueError):
            load_state(path, bad)


def _packets(out: str) -> int:
    return int(re.search(r"valid packets\s+:\s+(\d+)", out).group(1))


def test_ofdmflexframe_apps(cpu_env, tmp_path, capsys):
    """The TX -> RX pair decodes every packet; a stream split mid-frame with
    ``--save-state``/``--load-state`` decodes the same packets as one run;
    ``-d`` writes the octave dump; ``--snr/--cfo`` impairments and
    ``--stream --bf16`` decode; the split stream decodes through
    ``--soft``; a v27 payload decodes through ``--conv``; unknown flags
    exit 1; ``-h`` prints the usage."""
    iq = str(tmp_path / "tx.iq")
    assert ofdmflexframe_tx.main(["-o", iq, "-N", "3", "-P", "200"]) == 0
    dbg = str(tmp_path / "dbg")
    assert ofdmflexframe_rx.main(["-i", iq, "-q", "-p", "256",
                                  "-d", dbg]) == 0
    out = capsys.readouterr().out
    assert "valid packets       :      3 (100.00%)" in out
    text = open(dbg + "_framesync_debug.m").read()
    assert "metric = [" in text and "syms_pay = [" in text
    assert "detected=1 hdr_valid=1" in text
    assert ofdmflexframe_rx.main(["-i", iq, "-q", "-p", "256", "--snr", "25",
                                  "--cfo", "0.002", "--seed", "3"]) == 0
    assert _packets(capsys.readouterr().out) == 3
    # block-streamed input (native reader + prefetch thread), bf16 ingest
    assert ofdmflexframe_rx.main(["-i", iq, "-q", "-p", "256", "--stream",
                                  "--bf16"]) == 0
    assert _packets(capsys.readouterr().out) == 3
    assert ofdmflexframe_rx.main(["-i", iq, "--stream", "--snr", "9"]) == 1

    assert ofdmflexframe_tx.main(["-o", iq, "-N", "12", "-P", "200"]) == 0
    s = read_iq(iq)
    cut = 20001                   # mid-frame, off the 16384-sample grid
    assert len(s) > cut + 4096
    a_iq, b_iq = str(tmp_path / "a.iq"), str(tmp_path / "b.iq")
    write_iq(a_iq, s[:cut])
    write_iq(b_iq, s[cut:])
    st = str(tmp_path / "st")
    capsys.readouterr()
    assert ofdmflexframe_rx.main(["-i", iq, "-q", "-p", "256"]) == 0
    full = _packets(capsys.readouterr().out)
    assert ofdmflexframe_rx.main(["-i", a_iq, "-q", "-p", "256",
                                  "--save-state", st]) == 0
    a = _packets(capsys.readouterr().out)
    assert ofdmflexframe_rx.main(["-i", b_iq, "-q", "-p", "256",
                                  "--load-state", st]) == 0
    b = _packets(capsys.readouterr().out)
    assert full == 12 and a + b == 12 and a > 0

    assert ofdmflexframe_rx.main(["-i", iq, "-q", "-p", "256",
                                  "--soft"]) == 0
    assert _packets(capsys.readouterr().out) == 12
    with pytest.raises(SystemExit) as exc:
        ofdmflexframe_rx.main(["-Z"])
    assert exc.value.code == 1
    # a v27 payload through --conv
    assert ofdmflexframe_tx.main(["-o", iq, "-N", "2", "-P", "48", "-c",
                                  "v27", "-k", "none"]) == 0
    capsys.readouterr()
    assert ofdmflexframe_rx.main(["-i", iq, "-q", "-p", "64",
                                  "--conv"]) == 0
    assert _packets(capsys.readouterr().out) == 2
    with pytest.raises(SystemExit) as exc:
        ofdmflexframe_tx.main(["-Z"])
    assert exc.value.code == 1
    capsys.readouterr()
    for mod in (ofdmflexframe_tx, ofdmflexframe_rx):
        assert mod.main(["-h"]) == 0
        assert "usage" in capsys.readouterr().out


def test_no_card_raises_instead_of_running_on_the_cpu(tmp_path,
                                                      monkeypatch):
    """Without a CUDA device and without the CPU asked for, the class and
    the RX app raise; they ran on the CPU before (ROADMAP Queue C, C2).
    The CPU is taken only when asked for, by argument or environment."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    iq = str(tmp_path / "x.iq")
    write_iq(iq, np.zeros(4096, np.complex64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OfdmTxRx()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ofdmflexframe_rx.main(["-i", iq, "-q"])
    assert OfdmTxRx(device="cpu").device == torch.device("cpu")
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert default_device() == torch.device("cpu")
    assert OfdmTxRx().device == torch.device("cpu")
