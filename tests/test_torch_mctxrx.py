"""The multichannel TX worker and ``MultichannelTxRx`` of the port, on the
CPU, mirroring ``tests/test_multichannel.py`` at its sizes (N=2, M=48,
64-byte payloads, ``block_size=2048``, ``max_payload=128``), and the
``multichannel_txrx`` CLI against the JAX package's.

Every frame must decode payload-exact.  A worker whose generation raises
wakes its consumer, and the exception reaches ``threading.excepthook``;
``update_data`` from many threads beside a running worker loses no packet.
"""
import contextlib
import io
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from liquid_usrp_tpu.apps import multichannel_txrx as j_txrx
from liquid_usrp_tpu_torch.apps import multichannel_txrx
from liquid_usrp_tpu_torch.models.multichannel import (MultichannelRx,
                                                       MultichannelTx,
                                                       MultichannelTxRx)
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

N = 2
PAYLOAD = 64
CFG = dict(M=48, cp_len=6, taper_len=4)
RX = dict(CFG, block_size=2048, max_payload=128, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several processes at once, and a full intra-op pool in each
    oversubscribes the cores, which slows these small-op decodes many
    times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _frames(rx, samples):
    return rx.execute(samples) + rx.flush()


def test_txrx_availability_polling():
    txrx = MultichannelTxRx(N, **RX)
    rng = np.random.default_rng(1)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
    assert txrx.is_channel_available(0)
    assert txrx.transmit_packet(0, header, payload)
    assert not txrx.is_channel_available(0)      # busy until drained
    assert txrx.get_available_channel() == 1
    assert not txrx.transmit_packet(0, header, payload)  # refused, no wait
    samples = txrx.wait_for_tx_to_complete()
    assert txrx.is_channel_available(0)
    assert len(samples) > 0
    valid = [f for f in _frames(txrx.rx, samples)
             if f["payload_valid"] and f["channel"] == 0]
    assert len(valid) == 1
    np.testing.assert_array_equal(valid[0]["payload"], payload)


def test_reference_surface_parity():
    """``GetNumChannels``/``Reset`` casing, the radio setters, the
    ``start_rx`` gate of ``run_rx``, and the sync's detect level and
    device from ``rx_kwargs``."""
    txrx = MultichannelTxRx(N, use_pallas=0, **RX)
    assert txrx.rx.sync.use_pallas == 0
    assert str(txrx.tx.device) == str(txrx.rx.rx.device) == "cpu"
    assert txrx.tx.GetNumChannels() == N
    assert txrx.rx.GetNumChannels() == N
    txrx.set_tx_freq(462e6)
    txrx.set_rx_freq(462.1e6)
    txrx.set_tx_antenna("TX/RX")
    txrx.set_tx_rate(1e6)
    txrx.set_tx_gain_soft(-6.0)
    txrx.set_tx_gain_uhd(30.0)
    txrx.set_rx_rate(1e6)
    txrx.set_rx_gain_uhd(10.0)
    txrx.set_rx_antenna("RX2")
    assert txrx.radio.rx_freq == 462.1e6 and txrx.radio.tx_gain_soft == -6.0
    rng = np.random.default_rng(3)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
    assert txrx.transmit_packet(0, header, payload)
    samples = txrx.wait_for_tx_to_complete()
    assert txrx.run_rx(samples) == []            # not started
    txrx.start_rx()
    frames = txrx.run_rx(samples) + txrx.rx.flush()
    assert any(f["payload_valid"] for f in frames)
    txrx.stop_rx()
    txrx.transmit_packet(1, header, payload)
    txrx.reset_tx()
    assert txrx.is_channel_available(1)
    txrx.reset_rx()
    assert txrx.run_rx(samples) == []            # stopped again


def test_async_tx_worker_ahead_of_cursor():
    """The worker fills its ahead-buffer while the consumer is idle, stays
    bounded, and packets queued mid-stream come out decodable."""
    tx = MultichannelTx(N, **CFG, device="cpu")
    rx = MultichannelRx(N, **RX)
    rng = np.random.default_rng(7)
    max_ahead = 8192
    tx.start_worker(chunk=128, max_ahead=max_ahead)
    try:
        deadline = time.time() + 30
        while tx.samples_ahead < max_ahead and time.time() < deadline:
            time.sleep(0.01)
        assert tx.samples_ahead >= max_ahead
        assert tx.samples_ahead <= max_ahead + 2 * N * 128
        sent = {}
        for ch in range(N):
            header = rng.integers(0, 256, 8, dtype=np.uint8)
            header[2] = ch
            payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
            tx.update_data(ch, header, payload)
            sent[ch] = (header, payload)
        chunks = []
        deadline = time.time() + 60
        while (not all(tx.is_channel_ready(c) for c in range(N))
               and time.time() < deadline):
            chunks.append(tx.read_samples(1024))
        assert all(tx.is_channel_ready(c) for c in range(N))
    finally:
        tx.stop_worker()
    # a read after the stop generates here (drain + channelizer flush)
    chunks.append(tx.read_samples(tx.samples_ahead +
                                  2 * N * (2 * tx.chz.P + 64)))
    got = {f["channel"]: f for f in _frames(rx, np.concatenate(chunks))
           if f["payload_valid"]}
    assert set(got) == set(range(N))
    for ch, (header, payload) in sent.items():
        np.testing.assert_array_equal(got[ch]["header"], header)
        np.testing.assert_array_equal(got[ch]["payload"], payload)


def test_async_worker_read_past_ahead_bound_and_txrx_drain():
    """``read_samples(n > max_ahead)`` does not livelock (the producer
    parks at the bound); ``wait_for_tx_to_complete`` with the worker
    running consumes its ahead-buffer and still yields decodable air."""
    tx = MultichannelTx(N, **CFG, device="cpu")
    tx.start_worker(chunk=64, max_ahead=1024)
    try:
        assert len(tx.read_samples(5000)) == 5000
    finally:
        tx.stop_worker()
    txrx = MultichannelTxRx(N, **RX)
    rng = np.random.default_rng(9)
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
    txrx.start_tx(chunk=128, max_ahead=4096)
    try:
        assert txrx.transmit_packet(0, header, payload)
        samples = txrx.wait_for_tx_to_complete()
        assert len(txrx.read_tx_samples(100)) == 100
    finally:
        txrx.stop_tx()
    ok = [f for f in _frames(txrx.rx, samples)
          if f["payload_valid"] and f["channel"] == 0]
    assert len(ok) == 1
    np.testing.assert_array_equal(ok[0]["payload"], payload)


def test_failed_worker_wakes_its_consumer(monkeypatch):
    """A generation that raises on the worker thread clears the running
    flag and wakes the consumer, whose read then raises the same error;
    the worker's exception goes to ``threading.excepthook``."""
    seen = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(args.exc_value))
    tx = MultichannelTx(N, **CFG, device="cpu")

    def broken(state, Y):
        raise RuntimeError("synthesis failed")
    tx._step = broken
    tx.start_worker(chunk=64, max_ahead=1 << 20)
    out = {}

    def consume():
        try:
            tx.read_samples(512)
        except RuntimeError as e:
            out["error"] = str(e)
    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive()
    tx.stop_worker()
    assert out == {"error": "synthesis failed"}
    assert [str(e) for e in seen] == ["synthesis failed"]


def test_update_data_from_many_threads_beside_the_worker():
    """Twelve threads race check-then-act ``update_data`` calls on two
    channels, two packets each, while the worker generates (a short switch
    interval makes the race likely): every accepted packet appears in the
    air exactly once, and every refusal is the not-ready error."""
    tx = MultichannelTx(N, **CFG, device="cpu")
    rx = MultichannelRx(N, **RX)
    # build the TX tables first: the air's length follows the wall time
    tx.update_data(0, np.zeros(8, np.uint8), np.zeros(PAYLOAD, np.uint8))
    tx.Reset()
    accepted, errors, lock = [], [], threading.Lock()
    chunks = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        tx.start_worker(chunk=128, max_ahead=4096)

        def sender(k):
            rng = np.random.default_rng(100 + k)
            done, deadline = 0, time.time() + 60
            while done < 2 and time.time() < deadline:
                ch = int(rng.integers(0, N))
                header = np.zeros(8, np.uint8)
                header[0], header[1], header[2] = k, done, 0x5A
                payload = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
                try:
                    tx.update_data(ch, header, payload)
                except RuntimeError as e:
                    with lock:
                        errors.append(str(e))
                    time.sleep(0.001)
                    continue
                with lock:
                    accepted.append((ch, header, payload))
                done += 1

        def reader(stop):
            # read only while a frame is queued, so the air (and the
            # decode below) stays the frames' length however slow the
            # senders run
            while not stop.is_set():
                if all(tx.is_channel_ready(c) for c in range(N)):
                    time.sleep(0.001)
                    continue
                chunks.append(tx.read_samples(1024))

        stop = threading.Event()
        rt = threading.Thread(target=reader, args=(stop,))
        rt.start()
        threads = [threading.Thread(target=sender, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        deadline = time.time() + 30
        while (not all(tx.is_channel_ready(c) for c in range(N))
               and time.time() < deadline):
            time.sleep(0.01)
        stop.set()
        rt.join(timeout=30)
        assert not rt.is_alive()
    finally:
        sys.setswitchinterval(old)
        tx.stop_worker()
    chunks.append(tx.read_samples(tx.samples_ahead +
                                  2 * N * (2 * tx.chz.P + 64)))
    assert len(accepted) == 24 and errors
    assert all("not ready" in e for e in errors)
    frames = [f for f in _frames(rx, np.concatenate(chunks))
              if f["payload_valid"]]
    assert len(frames) == len(accepted)
    got = sorted((f["channel"], bytes(f["header"]), bytes(f["payload"]))
                 for f in frames)
    want = sorted((ch, bytes(h), bytes(p)) for ch, h, p in accepted)
    assert got == want


def _payload_exact(text: str):
    return re.search(r"payload-exact\s+:\s+(\d+) / (\d+) sent",
                     text).groups()


def test_multichannel_txrx_cli_matches_jax(monkeypatch):
    """``multichannel_txrx -R 2 -n 1 -P 40`` in both packages: every packet
    sent is received payload-exact, the same count (one channel keeps
    JAX's compiles to the fewest)."""
    out = {}
    for name, main in (("jax", j_txrx.main),
                       ("port", multichannel_txrx.main)):
        if name == "port":
            monkeypatch.setenv(DEVICE_ENV, "cpu")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["-R", "2", "-n", "1", "-P", "40", "-q"]) == 0
        out[name] = _payload_exact(buf.getvalue())
    assert out["port"] == out["jax"] == ("4", "4")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert multichannel_txrx.main(["-h"]) == 0
    assert "TDD rounds" in buf.getvalue()
    with pytest.raises(SystemExit):
        multichannel_txrx.main(["--bogus"])
    assert multichannel_txrx.main(["-n", "0"]) == 1
