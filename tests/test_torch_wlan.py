"""The 802.11a frame family against the JAX package: ``wlan_assemble``
and ``wlan_frame_length`` at every rate, the soft demapper, the soft
Viterbi, ``wlan_decode`` at every rate, the streaming sync (with JAX's
offset/CFO/noise stream, noise alone, the two-stage CFO case, two block
sizes, a JAX state resumed mid-stream, the int32 base's wrap), and the
``wlanframe_tx/rx`` CLIs across the two packages.

Tolerances: TX waveforms within 1e-6 of the largest |x| (the port's
``torch.fft.ifft`` against JAX's DFT matmul); soft LLRs within 1e-6 of
the largest |LLR| with equal signs beyond; Viterbi bits exact on the same
float32 pairs; rate, length, flags, PSDU bytes and ``t_start`` exact on
detected rows, ``cfo`` within 1e-5 rad/sample and ``rssi`` within 1e-4
dB.  Per-rate cases are seeded by ``zlib.crc32`` of their name.
"""
import contextlib
import functools
import io
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.apps import wlanframe_rx as j_rx
from liquid_usrp_tpu.apps import wlanframe_tx as j_tx
from liquid_usrp_tpu.framing import wlan as jw
from liquid_usrp_tpu_torch.apps import wlanframe_rx, wlanframe_tx
from liquid_usrp_tpu_torch.framing import wlan as tw
from liquid_usrp_tpu_torch.io.streams import read_iq
from liquid_usrp_tpu_torch.utils.convert import from_jax_tree
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

RATES = sorted(tw.WLAN_RATES)


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


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _valid_psdus(text: str) -> int:
    return int(re.search(r"valid PSDUs\s+:\s+(\d+)", text).group(1))


@pytest.mark.parametrize("rate", RATES)
def test_assemble_matches_jax(rate):
    rng = _rng(f"wlan tx {rate}")
    length = int(rng.integers(1, 300))
    psdu = rng.integers(0, 256, length, dtype=np.uint8)
    want = np.asarray(jw.wlan_assemble(rate, psdu))
    got = tw.wlan_assemble(rate, psdu, device="cpu").numpy()
    assert tw.wlan_frame_length(rate, length) == \
        jw.wlan_frame_length(rate, length) == len(got) == len(want)
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_assemble_rejects_a_bad_rate():
    with pytest.raises(ValueError, match="invalid rate 7"):
        tw.wlan_assemble(7, np.zeros(4, np.uint8), device="cpu")


@pytest.mark.parametrize("bpsc", [1, 2, 4, 6])
def test_soft_demap_matches_jax(bpsc):
    rng = _rng(f"wlan demap {bpsc}")
    pts = ((rng.normal(size=3000) + 1j * rng.normal(size=3000)) *
           0.8).astype(np.complex64)
    want = np.asarray(jw._demap_soft_jax(jnp.asarray(pts), bpsc))
    got = tw._demap_soft(torch.as_tensor(pts), bpsc).numpy()
    assert got.shape == want.shape == (3000, bpsc)
    big = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * big
    loud = np.abs(want) > 1e-6 * big
    np.testing.assert_array_equal(np.sign(got[loud]), np.sign(want[loud]))


@functools.lru_cache(maxsize=None)
def _jax_viterbi_rows():
    return jax.jit(jax.vmap(jw._viterbi_soft))


@pytest.mark.parametrize("n", [24, 700])
def test_viterbi_bits_equal_jax(n):
    """Random float32 pairs, with erasures (zeros) and values on a coarse
    grid so that candidate metrics tie exactly; several rows in one
    trellis."""
    rng = _rng(f"wlan viterbi {n}")
    B = 6
    pairs = rng.normal(size=(B, n, 2)).astype(np.float32)
    pairs[1] = np.round(pairs[1] * 2) / 2             # exact ties
    pairs[2] = rng.integers(-1, 2, size=(n, 2))       # ties and erasures
    pairs[3, n // 2:] = 0.0                           # erased tail
    pairs[4] = 0.0                                    # all erased
    pairs[5, rng.random((n, 2)) < 0.3] = 0.0
    want = np.asarray(_jax_viterbi_rows()(jnp.asarray(pairs)))
    got = tw._viterbi_soft(torch.as_tensor(pairs)).numpy()
    assert got.dtype == np.uint8 and got.shape == (B, n)
    np.testing.assert_array_equal(got, want)


def test_viterbi_decodes_the_encoder():
    rng = _rng("wlan viterbi encode")
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    bits[-6:] = 0
    coded = tw._conv_encode_bits(bits).astype(np.float32) * 2 - 1
    noisy = coded + 0.5 * rng.normal(size=coded.shape).astype(np.float32)
    got = tw._viterbi_soft(torch.as_tensor(noisy.reshape(1, -1, 2)))
    np.testing.assert_array_equal(got.numpy()[0], bits)


@pytest.mark.parametrize("rate", RATES)
def test_decode_matches_jax(rate):
    """As ``test_wlan_loopback_all_rates``: a frame through gain, phase
    and AWGN; both packages decode the same samples."""
    rng = _rng(f"wlan decode {rate}")
    psdu = rng.integers(0, 256, 100, dtype=np.uint8)
    f = np.asarray(jw.wlan_assemble(rate, psdu))
    noise = 0.02 * (rng.normal(size=f.shape) + 1j * rng.normal(size=f.shape))
    x = (0.8 * np.exp(1j * 0.7) * f + noise).astype(np.complex64)
    want = jw.wlan_decode(x)
    got = tw.wlan_decode(x, device="cpu")
    for key in ("rate", "length", "signal_valid", "psdu_valid"):
        assert got[key] == want[key], key
    assert got["rate"] == rate and got["psdu_valid"]
    np.testing.assert_array_equal(got["psdu"], want["psdu"])
    np.testing.assert_array_equal(got["psdu"], psdu)


def test_decode_rejects_a_corrupted_signal_field():
    rng = _rng("wlan corrupt")
    f = tw.wlan_assemble(12, rng.integers(0, 256, 60, dtype=np.uint8),
                         device="cpu").numpy()
    bad = f.copy()
    bad[336:400] = 0.3 * (rng.normal(size=64) + 1j * rng.normal(size=64))
    got = tw.wlan_decode(bad, device="cpu")
    assert not got["signal_valid"]
    assert got == jw.wlan_decode(bad)
    assert tw.wlan_decode(f[:399], device="cpu")["rate"] == 0


@functools.lru_cache(maxsize=None)
def _offset_cfo_stream():
    """JAX's ``test_wlan_sync_finds_frames_with_offset_cfo_noise`` stream."""
    rng = np.random.default_rng(21)
    psdu1 = rng.integers(0, 256, 100, dtype=np.uint8)
    psdu2 = rng.integers(0, 256, 60, dtype=np.uint8)
    f1 = np.asarray(jw.wlan_assemble(24, psdu1))
    f2 = np.asarray(jw.wlan_assemble(12, psdu2))
    stream = np.zeros(723 + len(f1) + 911 + len(f2) + 500, np.complex64)
    stream[723:723 + len(f1)] = f1
    p2 = 723 + len(f1) + 911
    stream[p2:p2 + len(f2)] = f2
    cfo = 2 * np.pi * 0.003
    stream = (0.7 * np.exp(1j * 0.9) * stream *
              np.exp(1j * cfo * np.arange(len(stream)))).astype(np.complex64)
    stream += (0.02 * (rng.normal(size=stream.shape) +
                       1j * rng.normal(size=stream.shape))
               ).astype(np.complex64)
    noise = (0.1 * (rng.normal(size=20000) +
                    1j * rng.normal(size=20000))).astype(np.complex64)
    return stream, noise, (psdu1, psdu2), p2, cfo


def _blocks(stream, sync):
    bs = sync.block_size
    n_blocks = -(-len(stream) // bs) + sync.overlap // bs + 1
    x = np.zeros(n_blocks * bs, np.complex64)
    x[:len(stream)] = stream
    return x.reshape(n_blocks, bs)


@functools.lru_cache(maxsize=None)
def _jax_run(key, block_size, max_psdu, base=None):
    """JAX's sync over a stream: (per-block results, states after each)."""
    stream = {"cfo": _offset_cfo_stream,
              "seam": _seam_stream,
              "early": functools.partial(_seam_stream, 7900)}[key]()[0]
    sync = jw.make_wlan_sync(block_size=block_size, max_psdu=max_psdu)
    step = jw.make_wlan_sync_step(sync)
    state = jw.wlan_sync_init(sync)
    if base is not None:
        state = state._replace(base=jnp.int32(base))
    out, states = [], []
    for blk in _blocks(stream, sync):
        state, res = step(state, jnp.asarray(blk))
        out.append(jax.tree.map(np.asarray, res))
        states.append(jax.tree.map(np.asarray, state))
    return out, states


def _check_results(got, want):
    """Detected rows: exact fields, cfo within 1e-5, rssi within 1e-4."""
    np.testing.assert_array_equal(got.detected, want.detected)
    d = want.detected
    for f in ("signal_valid", "psdu_valid", "rate", "length", "t_start"):
        np.testing.assert_array_equal(getattr(got, f)[d],
                                      getattr(want, f)[d], err_msg=f)
    np.testing.assert_array_equal(got.psdu[d], want.psdu[d])
    assert np.abs(got.cfo[d] - want.cfo[d]).max(initial=0) <= 1e-5
    assert np.abs(got.rssi[d] - want.rssi[d]).max(initial=0) <= 1e-4


def _port_run(stream, sync, state):
    step = tw.make_wlan_sync_step(sync)
    out = []
    for blk in _blocks(stream, sync):
        state, res = step(state, torch.as_tensor(blk))
        out.append(tw.WlanResults(*(v.numpy() for v in res)))
    return out, state


def test_sync_matches_jax_with_offset_cfo_noise():
    stream, noise, (psdu1, psdu2), p2, cfo = _offset_cfo_stream()
    want, jstates = _jax_run("cfo", 8192, 256)
    sync = tw.make_wlan_sync(max_psdu=256)
    got, state = _port_run(stream, sync, tw.wlan_sync_init(sync, "cpu"))
    assert sum(int(r.detected.sum()) for r in want) == 2
    for g, w in zip(got, want):
        _check_results(g, w)
    np.testing.assert_array_equal(state.tail.numpy(), jstates[-1].tail)
    assert int(state.base) == int(jstates[-1].base)
    res = tw.wlan_sync(stream, device="cpu")
    assert [d["start"] for d in res] == [723, p2]
    assert [d["rate"] for d in res] == [24, 12]
    assert all(d["psdu_valid"] for d in res)
    np.testing.assert_array_equal(res[0]["psdu"], psdu1)
    np.testing.assert_array_equal(res[1]["psdu"], psdu2)
    assert abs(res[0]["cfo"] - cfo) < 5e-4
    assert tw.wlan_sync(noise, device="cpu") == []


def test_metric_matches_jax_where_loud():
    stream = _offset_cfo_stream()[0]
    sync_j = jw.make_wlan_sync()
    ext = np.concatenate([np.zeros(sync_j.overlap, np.complex64),
                          _blocks(stream, sync_j)[0]])
    want = np.asarray(jw._wlan_metric(sync_j, jnp.asarray(ext)))
    got = tw._wlan_metric(tw.make_wlan_sync(), torch.as_tensor(ext)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    assert want.max() > 0.2


def test_sync_large_cfo_two_stage():
    """JAX's 0.15 rad/sample case: coarse (ST) + fine (LT) CFO."""
    rng = np.random.default_rng(22)
    psdu = rng.integers(0, 256, 80, dtype=np.uint8)
    f = tw.wlan_assemble(36, psdu, device="cpu").numpy()
    stream = np.zeros(400 + len(f) + 400, np.complex64)
    stream[400:400 + len(f)] = f
    cfo = 0.15
    stream = (stream * np.exp(1j * cfo * np.arange(len(stream)))
              ).astype(np.complex64)
    stream += (0.01 * (rng.normal(size=stream.shape) +
                       1j * rng.normal(size=stream.shape))
               ).astype(np.complex64)
    res = tw.wlan_sync(stream, device="cpu")
    assert len(res) == 1 and res[0]["start"] == 400
    assert res[0]["rate"] == 36 and res[0]["psdu_valid"]
    np.testing.assert_array_equal(res[0]["psdu"], psdu)
    assert abs(res[0]["cfo"] - cfo) < 1e-3


@functools.lru_cache(maxsize=None)
def _seam_stream(pos2: int = 8000):
    """Two frames, the second across the 8192-sample block seam."""
    rng = np.random.default_rng(33)
    psdus = [rng.integers(0, 256, 70, dtype=np.uint8),
             rng.integers(0, 256, 110, dtype=np.uint8)]
    stream = np.zeros(20000, np.complex64)
    starts = (5111, pos2)
    for pos, rate, psdu in zip(starts, (18, 48), psdus):
        f = np.asarray(jw.wlan_assemble(rate, psdu))
        stream[pos:pos + len(f)] += f
    stream += (0.02 * (rng.normal(size=20000) +
                       1j * rng.normal(size=20000))).astype(np.complex64)
    return stream, starts, psdus


def test_sync_is_block_size_invariant():
    stream, starts, psdus = _seam_stream()

    def run(bs):
        sync = tw.make_wlan_sync(block_size=bs, max_psdu=128)
        out, _ = _port_run(stream, sync, tw.wlan_sync_init(sync, "cpu"))
        got = []
        for r in out:
            for i in np.nonzero(r.detected & r.psdu_valid)[0]:
                got.append((int(r.t_start[i]), int(r.rate[i]),
                            r.psdu[i][: int(r.length[i])].tolist()))
        return sorted(got)

    a, b = run(4096), run(8192)
    assert a == b
    assert [(t, r) for t, r, _ in a] == [(starts[0], 18), (starts[1], 48)]
    for (_, _, got), psdu in zip(a, psdus):
        np.testing.assert_array_equal(got, psdu)


def test_sync_resumes_a_jax_state_mid_stream():
    """A JAX ``WlanSyncState`` taken after the first block (the second
    frame straddles the seam) resumes in the port with JAX's frames; the
    int32 ``base`` wraps at 2^31 in both."""
    stream = _seam_stream()[0]
    want, jstates = _jax_run("seam", 8192, 128)
    sync = tw.make_wlan_sync(max_psdu=128)
    state = from_jax_tree(jstates[0], "cpu")
    assert isinstance(state, tw.WlanSyncState)
    assert state.base.dtype == torch.int32
    got, _ = _port_run(stream[8192:], sync, state)
    assert sum(int(r.psdu_valid.sum()) for r in want[1:]) == 2
    for g, w in zip(got, want[1:]):
        _check_results(g, w)
    results = from_jax_tree(want[1], "cpu")
    assert isinstance(results, tw.WlanResults)
    assert results.psdu.dtype == torch.uint8
    # the wrap: a base just below 2^31 overflows to negative in both
    base = (1 << 31) - 8192 - 100
    wrapped, _ = _jax_run("seam", 8192, 128, base)
    st = tw.wlan_sync_init(sync, "cpu")._replace(
        base=torch.tensor(base, dtype=torch.int32))
    got, st = _port_run(stream, sync, st)
    assert int(st.base) < 0
    for g, w in zip(got, wrapped):
        _check_results(g, w)


def test_wlanframe_cli_pair(cpu_env, tmp_path):
    """The port's pair through JAX's ``test_wlanframe_rx_app_pair``
    impairments; ``-h`` and a missing file flag as in JAX."""
    f = str(tmp_path / "w.iq")
    rc, text = _run(wlanframe_tx.main, ["-o", f, "-N", "3", "-r", "24",
                                        "-P", "90"])
    assert rc == 0 and "wrote 3 frames at 24 Mb/s" in text
    rc, text = _run(wlanframe_rx.main, ["-i", f, "--snr", "15", "--cfo",
                                        "0.002"])
    assert rc == 0
    assert "valid PSDUs         :      3 (100.00%)" in text
    for main in (wlanframe_tx.main, wlanframe_rx.main):
        assert _run(main, ["-h"])[0] == 0
        assert _run(main, [])[0] == 1


def test_wlanframe_files_cross_packages(cpu_env, tmp_path):
    """Port TX decodes in JAX's RX and JAX's TX in the port's RX; the two
    TX files agree within the waveform tolerance."""
    tf, jf = str(tmp_path / "t.iq"), str(tmp_path / "j.iq")
    argv = ["-N", "2", "-r", "54", "-P", "150", "-s", "9"]
    assert _run(wlanframe_tx.main, ["-o", tf, *argv])[0] == 0
    assert _run(j_tx.main, ["-o", jf, *argv])[0] == 0
    a, b = read_iq(tf), read_iq(jf)
    assert len(a) == len(b)
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    rc, text = _run(j_rx.main, ["-i", tf, "-q"])
    assert rc == 0 and _valid_psdus(text) == 2
    rc, text = _run(wlanframe_rx.main, ["-i", jf, "-q"])
    assert rc == 0 and _valid_psdus(text) == 2


def test_sync_mirrors_the_window_clamp_near_the_extended_start():
    """Reference behaviour, mirrored: a frame whose LT1 lands fewer than
    192 samples into a block's extended window (detected there, since the
    detect region starts at 96) has its window start clamped to 0, so the
    frame reads shifted by the difference and its PSDU fails.  At 4096
    samples the frame at 7900 lands at 172; both packages report it
    detected, SIGNAL-valid and PSDU-invalid (at 8192 it decodes)."""
    stream = _seam_stream(7900)[0]
    want, _ = _jax_run("early", 4096, 128)
    sync = tw.make_wlan_sync(block_size=4096, max_psdu=128)
    got, _ = _port_run(stream, sync, tw.wlan_sync_init(sync, "cpu"))
    for g, w in zip(got, want):
        _check_results(g, w)
    rows = [(int(r.t_start[i]), bool(r.signal_valid[i]),
             bool(r.psdu_valid[i]))
            for r in got for i in np.nonzero(r.detected)[0]]
    assert rows == [(5111, True, True), (7900, True, False)]
