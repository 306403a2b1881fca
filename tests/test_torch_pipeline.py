"""The port's streaming plumbing against the JAX package: ``run_pipelined``
over a file (complex blocks, and bfloat16 and SC8 planes), the order in
which it hands results over, ``AsyncTxProducer``, ``NativeWriter``, the
typed configuration layer, ``profiling.trace``, ``ThroughputMeter`` and
``Timer``.

Frames through ``run_pipelined`` are payload-exact and at JAX's
``t_start``; ``NativeWriter`` files are byte for byte JAX's; the
configuration dataclasses have JAX's defaults and raise JAX's errors.
JAX's step is compiled once (complex blocks): the planes runs are held to
the same frames.
"""
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jsync
from liquid_usrp_tpu.io import native as jnative
from liquid_usrp_tpu.io.pipeline import run_pipelined as j_run_pipelined
from liquid_usrp_tpu.utils import config as jconfig
from liquid_usrp_tpu.utils import profiling as jprof
from liquid_usrp_tpu.utils import timer as jtimer
from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.io import native, streams
from liquid_usrp_tpu_torch.io.pipeline import AsyncTxProducer, run_pipelined
from liquid_usrp_tpu_torch.models.multichannel import (MultichannelRx,
                                                       MultichannelTx)
from liquid_usrp_tpu_torch.utils import config, profiling, timer

BS = 4096


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


@functools.lru_cache(maxsize=None)
def _file(tmpdir: str):
    """Two frames (the second across a block seam) in 40,000 samples of
    light noise, written as CF32: (path, [(header, payload)])."""
    params = jofdm.make_ofdm_params(48, 6, 4)
    rng = np.random.default_rng(0)
    stream = (0.005 * (rng.normal(size=40000) + 1j * rng.normal(size=40000))
              ).astype(np.complex64)
    sent = []
    for pos in (3000, 8000):
        header = rng.integers(0, 256, 8, dtype=np.uint8)
        payload = rng.integers(0, 256, 100, dtype=np.uint8)
        frame = np.asarray(jofdm.assemble_frame(
            params, jofdm.default_props(), jnp.asarray(header),
            jnp.asarray(payload)))
        stream[pos:pos + len(frame)] += 0.5 * frame
        sent.append((header, payload))
    path = os.path.join(tmpdir, "pipe.iq")
    streams.write_iq(path, stream)
    return path, sent


@pytest.fixture(scope="module")
def pipe_file(tmp_path_factory):
    return _file(str(tmp_path_factory.mktemp("pipe")))


def _collector(got):
    def on_results(res):
        det = np.asarray(res.detected)
        for i in np.nonzero(det)[0]:
            if bool(res.payload_valid[i]):
                n = int(res.payload_len[i])
                got.append((int(res.t_start[i]),
                            np.asarray(res.header[i]).tolist(),
                            np.asarray(res.payload[i])[:n].tolist()))
    return on_results


@functools.lru_cache(maxsize=None)
def _jax_frames(path):
    sync = jsync.make_sync(jofdm.make_ofdm_params(48, 6, 4), block_size=BS,
                           max_payload=128, max_frames=4)
    got = []
    j_run_pipelined(streams.iq_blocks(path, 1000), jsync.make_sync_step(sync),
                    jsync.sync_init(sync), _collector(got), block_size=BS)
    return got


def _port_sync():
    return ofdm_sync.make_sync(ofdm.make_ofdm_params(48, 6, 4),
                               block_size=BS, max_payload=128, max_frames=4)


def _planes(path, kind):
    x = streams.read_iq(path)
    for lo in range(0, len(x), BS):
        blk = np.zeros(BS, np.complex64)
        blk[:len(x[lo:lo + BS])] = x[lo:lo + BS]
        yield (native.cf32_to_bf16_planes(blk) if kind == "bf16"
               else native.cf32_to_sc8_planes(blk).numpy())


@pytest.mark.parametrize("kind", ["complex", "bf16", "sc8"])
def test_run_pipelined_over_a_file_matches_jax(pipe_file, kind):
    path, sent = pipe_file
    want = _jax_frames(path)
    assert [(h, p) for _, h, p in want] == \
        [(h.tolist(), p.tolist()) for h, p in sent]
    sync = _port_sync()
    got = []
    if kind == "complex":
        source, bs = streams.iq_blocks(path, 1000), BS
    else:
        source, bs = _planes(path, kind), None
    state = run_pipelined(source, ofdm_sync.make_sync_step(sync),
                          ofdm_sync.sync_init(sync, "cpu"), _collector(got),
                          block_size=bs)
    assert got == want
    assert int(state.base) == -sync.overlap + 10 * BS


def test_run_pipelined_hands_results_over_after_the_next_launch():
    """Step k's results reach ``on_results`` after step k+1 was called;
    a complex block arrives as complex64 on the state's device, planes and
    wire codes keep their dtype."""
    log = []

    def step(state, blk):
        log.append(("step", state[0], blk.dtype, blk.device.type))
        return (state[0] + 1, state[1]), state[0]

    blocks = [np.ones(8, np.complex128), np.zeros((2, 8), np.int8),
              np.zeros((2, 8), np.int16),
              torch.zeros((2, 8), dtype=torch.bfloat16)]
    state = run_pipelined(iter(blocks), step, (0, torch.zeros(1)),
                          lambda r: log.append(("results", r)))
    assert state[0] == 4
    assert log == [
        ("step", 0, torch.complex64, "cpu"), ("step", 1, torch.int8, "cpu"),
        ("results", 0), ("step", 2, torch.int16, "cpu"), ("results", 1),
        ("step", 3, torch.bfloat16, "cpu"), ("results", 2), ("results", 3)]


def test_async_tx_producer():
    """The worker generates ahead of the consumer; every submitted packet
    decodes at the receiver (``tests/test_pipeline.py``'s case)."""
    import time
    N = 2
    rng = np.random.default_rng(9)
    tx = MultichannelTx(N, 48, 6, 4, device="cpu")
    prod = AsyncTxProducer(tx, block_channel_samples=256, depth=6)
    sent = {}
    pid = 0
    for rep in range(2):
        for ch in range(N):
            header = np.zeros(8, np.uint8)
            header[0], header[1], header[2] = pid >> 8, pid & 0xFF, ch
            payload = rng.integers(0, 256, 96, dtype=np.uint8)
            prod.transmit_packet(ch, header, payload)
            sent[pid] = (ch, payload)
            pid += 1
    prod.close()
    deadline = time.time() + 60
    while prod.queued_blocks() < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert prod.queued_blocks() >= 2
    stream = np.concatenate(list(prod.blocks()))
    rx = MultichannelRx(N, 48, 6, 4, block_size=4096, max_payload=128,
                        device="cpu")
    frames = rx.execute(stream) + rx.flush()
    got = {((int(f["header"][0]) << 8) | int(f["header"][1])): f
           for f in frames if f["payload_valid"]}
    assert set(got) == set(sent)
    for p, (ch, payload) in sent.items():
        assert got[p]["channel"] == ch
        np.testing.assert_array_equal(got[p]["payload"], payload)


class _IdleTx:
    num_channels = 1

    def __init__(self, fail=False):
        self.fail = fail

    def is_channel_ready(self, ch):
        return True

    def update_data(self, *args, **kwargs):
        pass

    def generate_samples(self, n):
        if self.fail:
            raise RuntimeError("generation failed")
        return np.zeros(2 * n, np.complex64)


def test_async_tx_producer_stop_and_failure(monkeypatch):
    """``stop()`` ends ``blocks()`` after the buffered blocks, with the
    worker parked on a full queue; a worker that raises ends ``blocks()``
    with its exception (JAX's consumer would wait on for ever)."""
    monkeypatch.setattr("threading.excepthook", lambda args: None)
    prod = AsyncTxProducer(_IdleTx(), block_channel_samples=16, depth=3)
    import time
    deadline = time.time() + 10
    while prod.queued_blocks() < 3 and time.time() < deadline:
        time.sleep(0.01)
    prod.stop()
    assert not prod._t.is_alive()
    assert 3 <= len(list(prod.blocks())) <= 4
    prod = AsyncTxProducer(_IdleTx(fail=True))
    with pytest.raises(RuntimeError, match="generation failed"):
        list(prod.blocks())


@pytest.mark.parametrize("fmt", ["cf32", "sc16"])
def test_native_writer_file_equals_jax(tmp_path, fmt):
    if not (native.available() and jnative.available()):
        pytest.skip("native library unavailable")
    f = {"cf32": native.FORMAT_CF32, "sc16": native.FORMAT_SC16}[fmt]
    rng = np.random.default_rng(0)
    x = (rng.uniform(-0.9, 0.9, 5000) +
         1j * rng.uniform(-0.9, 0.9, 5000)).astype(np.complex64)
    paths = []
    for name, mod in (("port", native), ("jax", jnative)):
        p = str(tmp_path / f"{name}.{fmt}")
        with mod.NativeWriter(p, fmt=f) as w:
            for lo in range(0, len(x), 700):
                w.push(x[lo:lo + 700])
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        data = a.read()
        assert data == b.read() and len(data) == 5000 * (8 if f == 0 else 4)
    back = native.read_file(paths[0], f)
    np.testing.assert_allclose(back, x, atol=0 if f == 0 else 2.0 / 32767)
    w = native.NativeWriter(str(tmp_path / "c.iq"))
    w.close()
    with pytest.raises(RuntimeError, match="writer closed"):
        w.push(x)
    with pytest.raises(IOError):
        native.NativeWriter(str(tmp_path / "no" / "such" / "dir.iq"))


_CONFIGS = {
    "ofdm": lambda m: m.OfdmConfig(),
    "single_carrier": lambda m: m.SingleCarrierConfig(),
    "gmsk": lambda m: m.GmskConfig(),
    "sync": lambda m: m.SyncConfig(),
    "ofdm_bad_subcarriers": lambda m: m.OfdmConfig(num_subcarriers=4),
    "ofdm_bad_cp": lambda m: m.OfdmConfig(cp_len=0),
    "ofdm_bad_taper": lambda m: m.OfdmConfig(taper_len=10, cp_len=6),
    "ofdm_bad_block": lambda m: m.OfdmConfig(
        sync=m.SyncConfig(block_size=512)),
    "sync_bad_threshold": lambda m: m.SyncConfig(threshold=1.5),
    "sc_bad_sps": lambda m: m.SingleCarrierConfig(samples_per_symbol=0),
    "sc_bad_semilength": lambda m: m.SingleCarrierConfig(
        filter_semilength=0),
    "sc_bad_excess_bw": lambda m: m.SingleCarrierConfig(
        excess_bandwidth=1.0),
    "gmsk_bad_sps": lambda m: m.GmskConfig(samples_per_symbol=0),
    "gmsk_bad_bt": lambda m: m.GmskConfig(bt=0.0),
    "gmsk_bad_semilength": lambda m: m.GmskConfig(filter_semilength=0),
    "gmsk_bad_threshold": lambda m: m.GmskConfig(
        sync=m.SyncConfig(threshold=0.0)),
    "props_bad_crc": lambda m: m.OfdmConfig(
        props=m.FramePropsConfig(check="bogus")),
    "props_bad_fec": lambda m: m.OfdmConfig(
        props=m.FramePropsConfig(fec0="bogus")),
    "props_bad_mod": lambda m: m.OfdmConfig(
        props=m.FramePropsConfig(mod="bogus")),
    "props_other": lambda m: m.OfdmConfig(props=m.FramePropsConfig(
        check="crc16", fec0="h74", fec1="none", mod="qam16")),
}


def _outcome(module, case):
    cfg = _CONFIGS[case](module)
    try:
        cfg.validate()
        props = getattr(cfg, "props", None)
        return ("ok", repr(cfg), props and tuple(int(v) for v in
                                                props.to_props()))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", sorted(_CONFIGS))
def test_config_matches_jax(case):
    """Each configuration: the same fields and defaults, the same parsed
    frame props, or the same ``ValueError`` with the same message."""
    assert _outcome(config, case) == _outcome(jconfig, case)
    for name in ("crc32", "CRC16", "none"):
        assert config.parse_crc(name) == jconfig.parse_crc(name)


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        torch.fft.fft(torch.ones(256, dtype=torch.complex64)).abs().sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


def test_throughput_meter_and_timer_match_jax(monkeypatch):
    ticks = [10.0, 10.5, 20.0, 20.25, 30.0, 30.125]
    out = {}
    for name, prof, tim in (("jax", jprof, jtimer),
                            ("port", profiling, timer)):
        clock = iter(ticks)
        monkeypatch.setattr(prof.time, "perf_counter", lambda: next(clock))
        m = prof.ThroughputMeter(ema_alpha=0.3)
        with pytest.raises(RuntimeError, match="without start"):
            m.stop(1)
        rates = []
        for n in (1000, 4000, 500):
            m.start()
            rates.append(m.stop(n))
        wall = iter([5.0, 7.5, 8.0, 9.25])
        monkeypatch.setattr(tim.time, "time", lambda: next(wall))
        t = tim.timer_create()
        first = t.toc()
        t.tic()
        out[name] = (rates, m.ema_sps, m.mean_sps, m.total_samples,
                     m.total_time, first, t.toc())
        monkeypatch.undo()
    assert out["port"] == out["jax"]
    assert out["port"][0] == [2000.0, 16000.0, 4000.0]
