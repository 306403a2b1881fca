"""The single-carrier flexframe/frame64 slice against the JAX package:
``make_flex_params``, ``flex_assemble``/``frame64_assemble``, the flexframe
synchronizer (``flex_sync_block``, ``flex_sync_blocks_batched``,
``iter_sync_results``), state carry-over and the ``flexframe_tx/rx`` and
``packet_tx/rx`` apps.

Tolerances: params exact; TX waveforms within 1e-6 of max |x| (1e-5 for
DPSK, whose cumulative phase product rounds in another order); sync rows
masked by ``detected``: bytes, flags, ``t_start``, ``payload_len``, mod,
FEC and check exact, ``cfo``, ``rssi`` and ``evm`` within 1e-4.  The
port's batched dispatch against its own single-block steps: the same
(its floats are not bit-equal: a batched FFT rounds as a single one need
not).  Small sizes: ``block_size=4096``, ``max_payload=128``.
"""
import functools
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.apps import common as japps
from liquid_usrp_tpu.framing import flexframe as jff
from liquid_usrp_tpu.framing import flexframe_sync as jfs
from liquid_usrp_tpu_torch.apps import (common as tapps, flexframe_rx,
                                        flexframe_tx, packet_rx, packet_tx)
from liquid_usrp_tpu_torch.framing import flexframe as tff
from liquid_usrp_tpu_torch.framing import flexframe_sync as tfs
from liquid_usrp_tpu_torch.io.streams import read_iq, write_iq
from liquid_usrp_tpu_torch.ops import crc, fec, modem
from liquid_usrp_tpu_torch.utils.checkpoint import load_state, save_state
from liquid_usrp_tpu_torch.utils.convert import from_jax_tree, to_numpy_tree
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

BS, MAX_PAYLOAD, MAX_FRAMES, BATCH = 4096, 128, 4, 3
CFOS = (0.003, 0.04)
FLOATS = ("rssi", "evm", "cfo")


@pytest.fixture
def cpu_env(monkeypatch):
    """The CLIs take no device flag: ask for the CPU through the
    environment, as the JAX apps run under ``JAX_PLATFORMS=cpu``."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")


@functools.lru_cache(maxsize=None)
def _bursts():
    """Five bursts of mixed props (the port's TX, held to JAX's by the
    assemble tests) with their headers, payloads and trailing gaps."""
    rng = np.random.default_rng(zlib.crc32(b"flexframe stream"))
    p = tff.make_flex_params()
    kinds = [tff.FrameProps(), tff.FrameProps(mod=modem.MOD_BPSK,
                                              fec1=fec.FEC_NONE),
             tff.FrameProps(mod=modem.MOD_QAM16, fec1=fec.FEC_GOLAY2412,
                            check=crc.CRC_16),
             tff.FrameProps(mod=modem.MOD_DPSK4, fec0=fec.FEC_HAMMING74,
                            fec1=fec.FEC_NONE),
             tff.FrameProps()]
    out = []
    for props, n, gap in zip(kinds, (100, 128, 60, 40, 90),
                             (700, 1100, 300, 900, 9000)):
        h = rng.integers(0, 256, tff.FLEX_HEADER_USER, dtype=np.uint8)
        pay = rng.integers(0, 256, n, dtype=np.uint8)
        w = tff.flex_assemble(p, props, torch.as_tensor(h),
                              torch.as_tensor(pay)).numpy()
        out.append((h, pay, w, gap))
    return out


def _stream(cfo):
    """The bursts after 2,500 zeros (two of them across block seams), at
    ``cfo`` rad/sample in 0.01-rms noise: (stream, [(header, payload,
    start)] in stream order)."""
    rng = np.random.default_rng(zlib.crc32(b"flexframe noise"))
    pieces, sent, pos = [np.zeros(2500, np.complex64)], [], 2500
    for h, pay, w, gap in _bursts():
        pieces += [w * 0.5, np.zeros(gap, np.complex64)]
        sent.append((h, pay, pos))
        pos += len(w) + gap
    x = np.concatenate(pieces)
    x = x * np.exp(1j * cfo * np.arange(len(x))).astype(np.complex64)
    x += (0.01 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
          ).astype(np.complex64)
    return x, sent


@pytest.fixture(scope="module")
def jax_ref():
    """Per CFO: the stream, what was sent, JAX's rows of
    ``iter_sync_results`` (batched dispatches of 3 blocks and single-block
    steps), and JAX's sync state after 5 blocks with its next 5 blocks'
    rows."""
    sync = jfs.make_flex_sync(jff.make_flex_params(), block_size=BS,
                              max_payload=MAX_PAYLOAD, max_frames=MAX_FRAMES)
    step = jfs.make_flex_sync_step(sync)

    def batched(st, b):
        return jfs.flex_sync_blocks_batched(sync, st, b)

    out = {}
    for cfo in CFOS:
        x, sent = _stream(cfo)
        rows = list(japps.iter_sync_results(
            step, jfs.flex_sync_init(sync), x, BS, sync.overlap,
            batched_fn=batched, batch_blocks=BATCH))
        st = jfs.flex_sync_init(sync)
        for b in range(5):
            st, _ = step(st, jnp.asarray(x[b * BS:(b + 1) * BS]))
        mid = jax.device_get(st)
        later = []
        for b in range(5, 10):
            blk = np.zeros(BS, np.complex64)
            seg = x[b * BS:(b + 1) * BS]
            blk[:len(seg)] = seg
            st, r = step(st, jnp.asarray(blk))
            later.append(jax.device_get(r))
        out[cfo] = (x, sent, rows, mid, later)
    return out


def _tsync():
    return tfs.make_flex_sync(tff.make_flex_params(), block_size=BS,
                              max_payload=MAX_PAYLOAD, max_frames=MAX_FRAMES)


def _rows_equal(got, want, ftol=1e-4):
    """Two results (NamedTuples, one block) equal on the detected rows."""
    det = np.asarray(want.detected)
    np.testing.assert_array_equal(np.asarray(got.detected), det)
    for f in want._fields:
        a, b = np.asarray(getattr(got, f))[det], np.asarray(
            getattr(want, f))[det]
        if f in FLOATS:
            np.testing.assert_allclose(a, b, atol=ftol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _host(res):
    return type(res)(*(v.numpy() for v in res))


def test_flex_params_and_frame_lengths_equal_jax():
    for k, m, beta in ((2, 7, 0.3), (4, 4, 0.25)):
        a, b = tff.make_flex_params(k, m, beta), jff.make_flex_params(k, m,
                                                                      beta)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert tff.FRAME64_LEN == jff.FRAME64_LEN
    for props in (tff.default_props(), tff.frame64_props()):
        for n in (1, 64, 200):
            assert tff.flex_frame_length(tff.make_flex_params(), props, n) \
                == jff.flex_frame_length(jff.make_flex_params(), props, n)
    assert tff.frame64_props() == jff.frame64_props()


@pytest.mark.parametrize("mod,fec0,fec1,check,user", [
    ("qpsk", "none", "h128", crc.CRC_32, 14),
    ("dpsk4", "h74", "none", crc.CRC_NONE, 14),
    ("psk8", "secded7264", "none", crc.CRC_16, 3)])
def test_flex_assemble_matches_jax(mod, fec0, fec1, check, user):
    rng = np.random.default_rng(zlib.crc32(mod.encode()))
    props = dict(mod=modem.mod_from_name(mod), fec0=fec.fec_from_name(fec0),
                 fec1=fec.fec_from_name(fec1), check=check)
    h = rng.integers(0, 256, user, dtype=np.uint8)
    p = rng.integers(0, 256, 77, dtype=np.uint8)
    got = tff.flex_assemble(tff.make_flex_params(), tff.FrameProps(**props),
                            torch.as_tensor(h), torch.as_tensor(p))
    want = np.asarray(jff.flex_assemble(
        jff.make_flex_params(), jff.FrameProps(**props), jnp.asarray(h),
        jnp.asarray(p)))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert got.shape[0] == tff.flex_frame_length(
        tff.make_flex_params(), tff.FrameProps(**props), 77, user)
    # DPSK: the cumulative product of the phase increments rounds in
    # another order than JAX's scan
    tol = 1e-5 if modem.is_differential(props["mod"]) else 1e-6
    assert float(np.abs(got.numpy() - want).max()) <= \
        tol * float(np.abs(want).max())


def test_frame64_assemble_matches_jax():
    rng = np.random.default_rng(zlib.crc32(b"frame64"))
    h = rng.integers(0, 256, 8, dtype=np.uint8)
    p = rng.integers(0, 256, 64, dtype=np.uint8)
    got = tff.frame64_assemble(tff.make_flex_params(), torch.as_tensor(h),
                               torch.as_tensor(p))
    want = np.asarray(jff.frame64_assemble(jff.make_flex_params(),
                                           jnp.asarray(h), jnp.asarray(p)))
    assert got.shape == want.shape == (tff.FRAME64_LEN,)
    assert float(np.abs(got.numpy() - want).max()) <= \
        1e-6 * float(np.abs(want).max())
    for bad_h, bad_p in ((h, p[:63]), (h[:7], p)):
        with pytest.raises(ValueError):
            tff.frame64_assemble(tff.make_flex_params(),
                                 torch.as_tensor(bad_h),
                                 torch.as_tensor(bad_p))


@pytest.mark.parametrize("cfo", CFOS)
def test_flex_sync_matches_jax(jax_ref, cfo):
    """``iter_sync_results`` (batched and single-block dispatches) gives
    JAX's rows, and so do the port's single-block steps alone; every burst
    decodes payload-exact, with its offset and start in stream order."""
    x, sent, rows, _, _ = jax_ref[cfo]
    sync = _tsync()
    got = list(tapps.iter_sync_results(
        tfs.make_flex_sync_step(sync), tfs.flex_sync_init(sync, "cpu"), x,
        BS, sync.overlap,
        batched_fn=lambda st, b: tfs.flex_sync_blocks_batched(sync, st, b),
        batch_blocks=BATCH))
    seq = list(tapps.iter_sync_results(
        tfs.make_flex_sync_step(sync), tfs.flex_sync_init(sync, "cpu"), x,
        BS, sync.overlap))
    assert len(got) == len(seq) == len(rows)
    for g, s, w in zip(got, seq, rows):
        _rows_equal(g, w)
        _rows_equal(s, w)
        _rows_equal(g, s)
    ok = sorted(((int(r.t_start[i]), r.header[i], r.payload[i],
                  int(r.payload_len[i]), float(r.cfo[i]))
                 for r in got for i in np.nonzero(r.payload_valid)[0]),
                key=lambda t: t[0])
    assert len(ok) == len(sent)
    for (t, h, pay, n, c), (h0, p0, pos) in zip(ok, sent):
        assert abs(t - pos) <= 1
        np.testing.assert_array_equal(h, h0)
        np.testing.assert_array_equal(pay[:n], p0)
        assert abs(c - cfo) < 2e-3


def test_flex_batched_dispatch_equals_single_steps(jax_ref):
    """``flex_sync_blocks_batched`` over 8 blocks (IQ planes too) against
    8 ``flex_sync_block`` steps: the same detected rows and carried
    state."""
    x = jax_ref[CFOS[1]][0]
    sync = _tsync()
    padded = np.zeros(8 * BS, np.complex64)
    padded[:len(x)] = x
    blocks = torch.as_tensor(padded.reshape(8, BS))
    st = tfs.flex_sync_init(sync, "cpu")
    steps = []
    for b in range(8):
        st, r = tfs.flex_sync_block(sync, st, blocks[b])
        steps.append(_host(r))
    for inp in (blocks, torch.stack([blocks.real, blocks.imag])):
        bst, res = tfs.flex_sync_blocks_batched(
            sync, tfs.flex_sync_init(sync, "cpu"), inp)
        res = _host(res)
        assert res.detected.shape == (8, MAX_FRAMES)
        for b in range(8):
            _rows_equal(type(res)(*(v[b] for v in res)), steps[b])
        assert torch.equal(bst.tail, st.tail)
        assert int(bst.base) == int(st.base) and bst.base.dtype == \
            torch.int32
    assert sum(int(s.payload_valid.sum()) for s in steps) >= 4
    with pytest.raises(ValueError):
        tfs.flex_sync_block(sync, st, blocks[0, :100])


def test_flex_state_carries_over_and_checkpoints(jax_ref, tmp_path):
    """JAX's ``FlexSyncState`` after 5 blocks, moved with
    ``from_jax_tree`` (and back with ``to_numpy_tree``, and through the
    port's checkpoint), continues to JAX's rows; results convert too."""
    x, _, _, mid, later = jax_ref[CFOS[0]]
    sync = _tsync()
    st = from_jax_tree(mid, "cpu")
    assert type(st) is tfs.FlexSyncState and st.base.dtype == torch.int32
    back = to_numpy_tree(st)
    np.testing.assert_array_equal(back.tail, mid.tail)
    path = str(tmp_path / "flex")
    save_state(path, st)
    loaded = load_state(path, tfs.flex_sync_init(sync, "cpu"))
    assert torch.equal(loaded.tail, st.tail)
    for s in (st, loaded):
        for b, want in zip(range(5, 10), later):
            blk = np.zeros(BS, np.complex64)
            seg = x[b * BS:(b + 1) * BS]
            blk[:len(seg)] = seg
            s, r = tfs.flex_sync_block(sync, s, torch.as_tensor(blk))
            _rows_equal(_host(r), want)
            res = from_jax_tree(want, "cpu")
            assert type(res) is tfs.FlexResults
    assert any(bool(w.payload_valid.any()) for w in later)


def test_stream_counter_wraps_at_2_31():
    sync = _tsync()
    st = tfs.flex_sync_init(sync, "cpu")._replace(
        base=torch.tensor(2 ** 31 - 100, dtype=torch.int32))
    st, _ = tfs.flex_sync_block(sync, st, torch.zeros(BS,
                                                      dtype=torch.complex64))
    assert int(st.base) == 2 ** 31 - 100 + BS - 2 ** 32


def test_candidates_near_the_window_end_are_clamped():
    """A candidate at the last metric offset, or past the window, reads
    clamped samples as JAX's gathers do: the decode runs and flags it
    invalid (on the card an unclamped index would be a device assert)."""
    sync = _tsync()
    rng = np.random.default_rng(3)
    ext = torch.as_tensor((0.1 * (rng.normal(size=(2, sync.overlap + BS)) +
                                  1j * rng.normal(size=(2, sync.overlap + BS))
                                  )).astype(np.complex64))
    mf, metric, c1, c2, _, _ = tfs._mf_and_detect(sync, ext)
    n = metric.shape[-1]
    locs = torch.tensor([n - 1, n + 5000, 0, 2 ** 30], dtype=torch.int32)
    row_of = torch.tensor([0, 1, 1, 0])
    out = tfs._decode_candidate(sync, mf, metric, row_of, locs,
                                tfs._row_gather(c1, row_of, locs),
                                tfs._row_gather(c2, row_of, locs))
    assert out[0].shape == (4, sync.header_user)
    assert not bool(out[7].any())


def test_unported_options_raise():
    """``soft=True`` gives JAX's soft sync config (the soft decode itself
    is held to JAX's in ``test_torch_soft_sync.py``); ``enable_conv``
    takes JAX's extended scheme set (the conv/RS decode itself is held to
    JAX's in ``test_torch_conv_rs.py``); a zero budget raises."""
    p = tff.make_flex_params()
    soft = tfs.make_flex_sync(p, enable_conv=True, soft=True)
    assert soft.soft is True
    assert soft._replace(params=None) == jfs.make_flex_sync(
        jff.make_flex_params(), enable_conv=True,
        soft=True)._replace(params=None)
    conv = tfs.make_flex_sync(p, enable_conv=True)
    assert conv.fecs == jfs.make_flex_sync(jff.make_flex_params(),
                                           enable_conv=True).fecs
    assert conv._replace(fecs=()) == tfs.make_flex_sync(p)._replace(fecs=())
    with pytest.raises(ValueError):
        tfs.make_flex_sync(p, expansion=0)


def _count(out: str, what: str) -> int:
    return int(re.search(what + r"\s+:\s+(\d+)", out).group(1))


def test_flexframe_and_packet_apps(cpu_env, tmp_path, capsys):
    """TX -> RX loopbacks of both CLI pairs (through ``--snr/--cfo`` and
    ``--soft``, and a v27 payload through ``--conv``); ``packet_rx`` counts
    a valid burst of another format as foreign; unknown flags exit 1;
    ``-h`` prints the usage."""
    iq = str(tmp_path / "ff.iq")
    assert flexframe_tx.main(["-o", iq, "-N", "3", "-P", "100"]) == 0
    assert flexframe_rx.main(["-i", iq, "-p", "256", "--snr", "20",
                              "--cfo", "0.01"]) == 0
    out = capsys.readouterr().out
    assert _count(out, "valid packets") == 3
    assert "pid=    2" in out
    pk = str(tmp_path / "pk.iq")
    assert packet_tx.main(["-o", pk, "-N", "4", "-s", "7"]) == 0
    s = read_iq(pk)
    # a valid 8-byte-header burst that is not Frame64 (32-byte payload)
    other = tff.flex_assemble(tff.make_flex_params(), tff.frame64_props(),
                              torch.zeros(8, dtype=torch.uint8),
                              torch.arange(32, dtype=torch.uint8)).numpy()
    other = tapps.resample_stream(other * 0.25, 2.0, "cpu", trim=False)
    write_iq(pk, np.concatenate([s, other, np.zeros(500, np.complex64)]))
    capsys.readouterr()
    assert packet_rx.main(["-i", pk]) == 0
    out = capsys.readouterr().out
    assert _count(out, "valid packets") == 4
    assert _count(out, "non-frame64 bursts") == 1
    assert "non-frame64 burst ignored (len=32)" in out
    capsys.readouterr()
    assert flexframe_rx.main(["-i", iq, "-q", "-p", "256", "--soft"]) == 0
    assert _count(capsys.readouterr().out, "valid packets") == 3
    with pytest.raises(SystemExit) as exc:
        flexframe_rx.main(["-Z"])
    assert exc.value.code == 1
    capsys.readouterr()
    assert flexframe_tx.main(["-o", iq, "-N", "2", "-P", "40", "-c", "v27",
                              "-k", "none"]) == 0
    assert "--conv" in capsys.readouterr().out
    assert flexframe_rx.main(["-i", iq, "-q", "-p", "64", "--conv"]) == 0
    assert _count(capsys.readouterr().out, "valid packets") == 2
    capsys.readouterr()
    for mod in (flexframe_tx, flexframe_rx, packet_tx, packet_rx):
        assert mod.main(["-h"]) == 0
        assert "usage" in capsys.readouterr().out


def test_no_card_raises_instead_of_running_on_the_cpu(tmp_path,
                                                      monkeypatch):
    """Without a CUDA device and without the CPU asked for, the state
    constructors and the four apps raise, as the OFDM ones do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    iq = str(tmp_path / "x.iq")
    write_iq(iq, np.zeros(4096, np.complex64))
    from liquid_usrp_tpu_torch.ops import resamp
    for build in (lambda: tfs.flex_sync_init(_tsync()),
                  lambda: resamp.msresamp_state(resamp.msresamp_create(0.5)),
                  lambda: flexframe_rx.main(["-i", iq, "-q"]),
                  lambda: packet_rx.main(["-i", iq, "-q"]),
                  lambda: flexframe_tx.main(["-o", iq, "-N", "1"]),
                  lambda: packet_tx.main(["-o", iq, "-N", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert tfs.flex_sync_init(_tsync(), "cpu").tail.device.type == "cpu"
