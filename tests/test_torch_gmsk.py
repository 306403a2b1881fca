"""The GMSK frame family against the JAX package: ``gaussian_pulse``,
``make_gmsk_params`` and the host tables, ``gmsk_assemble`` (and TX/RX
across the two packages), the front end, ``gmsk_sync_blocks_batched``
with block-code and v27 payloads, the single-block steps, small-m frames
across block seams, and the ``gmskframe_tx/rx`` apps.

Tolerances: host parameters and tables exact.  TX waveforms within 1e-4
of JAX's and of unit envelope within 1e-5 (the phase is a float32 cumsum
over the frame, which each backend rounds in its own order).  Front end on
the same windows: ``detected`` and detected offsets exact, ``z`` within
1e-5 of max |z|, the metric within 1e-4 on windows with a detection.  Sync
rows masked by ``detected``: flags, header, ``payload_len``, ``t_start``,
mod, FEC and check exact, the payload exact on header-valid rows (the
port decodes the conv/RS schemes only for header-valid rows), ``cfo``
within 1e-5 rad/sample, ``evm`` and ``rssi`` within 1e-3 dB; the carried
tail and base exact.  Streams are built once with NumPy (frames from one
package, AWGN from ``default_rng``), so TX rounding does not enter the RX
comparison.  Small sizes: ``block_size=4096``, ``max_payload=128``.
"""
import functools
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import gmskframe as jg
from liquid_usrp_tpu.ops import filter_design as jfd
from liquid_usrp_tpu_torch.apps import gmskframe_rx, gmskframe_tx
from liquid_usrp_tpu_torch.framing import gmskframe as tg
from liquid_usrp_tpu_torch.ops import crc, fec
from liquid_usrp_tpu_torch.ops import filter_design as tfd
from liquid_usrp_tpu_torch.utils.convert import from_jax_tree
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

BS, MAX_PAYLOAD, MAX_FRAMES = 4096, 128, 4
FLOATS = {"cfo": 1e-5, "evm": 1e-3, "rssi": 1e-3}


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _props(kind: str):
    if kind == "v27":
        return tg.gmsk_default_props()._replace(fec0=fec.FEC_CONV_V27,
                                                fec1=fec.FEC_NONE)
    if kind == "g2412":
        return tg.FrameProps(check=crc.CRC_32, fec0=fec.FEC_NONE,
                             fec1=fec.FEC_GOLAY2412, mod=0)
    return tg.gmsk_default_props()


def _jprops(props):
    return jg.FrameProps(*props)


@functools.lru_cache(maxsize=None)
def _stream(conv: bool):
    """Four bursts of mixed props (JAX's TX) after 1,500 zeros, at 0.03-rms
    AWGN, padded with the flush blocks: (blocks [n, BS], [(header,
    payload, start)])."""
    rng = _rng(f"gmsk stream {conv}")
    kinds = ("v27", "default", "v27", "g2412") if conv else \
        ("default", "g2412", "default", "default")
    p = jg.make_gmsk_params()
    pieces, sent, pos = [np.zeros(1500, np.complex64)], [], 1500
    for i, kind in enumerate(kinds):
        h = rng.integers(0, 256, 8, dtype=np.uint8)
        pay = rng.integers(0, 256, 40 + 25 * i, dtype=np.uint8)
        w = np.asarray(jg.gmsk_assemble(p, _jprops(_props(kind)),
                                        jnp.asarray(h), jnp.asarray(pay)))
        gap = int(rng.integers(300, 1500))
        pieces += [0.5 * w, np.zeros(gap, np.complex64)]
        sent.append((h, pay, pos))
        pos += len(w) + gap
    x = np.concatenate(pieces)
    sync = _tsync(conv)
    n_blocks = -(-len(x) // BS) + -(-sync.overlap // BS) + 1
    full = np.zeros(n_blocks * BS, np.complex64)
    full[:len(x)] = x
    full += (0.03 * (rng.normal(size=full.shape) + 1j *
                     rng.normal(size=full.shape))).astype(np.complex64)
    return full.reshape(n_blocks, BS), sent


def _tsync(conv: bool):
    return tg.make_gmsk_sync(tg.make_gmsk_params(), block_size=BS,
                             max_payload=MAX_PAYLOAD, max_frames=MAX_FRAMES,
                             enable_conv=conv)


@pytest.fixture(scope="module")
def jax_ref():
    """Per config (block codes, and ``enable_conv``): JAX's batched
    dispatch over the whole stream, and its state."""
    out = {}
    for conv in (False, True):
        blocks, _ = _stream(conv)
        sync = jg.make_gmsk_sync(jg.make_gmsk_params(), block_size=BS,
                                 max_payload=MAX_PAYLOAD,
                                 max_frames=MAX_FRAMES, enable_conv=conv)
        st, res = jg.gmsk_sync_blocks_batched(sync, jg.gmsk_sync_init(sync),
                                              jnp.asarray(blocks))
        out[conv] = (jax.device_get(st), jax.device_get(res))
    return out


def _rows_equal(got, want):
    """Two results (NamedTuples of arrays) equal on the detected rows."""
    det = np.asarray(want.detected)
    np.testing.assert_array_equal(np.asarray(got.detected), det)
    hv = np.asarray(want.header_valid)
    for f in want._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if f in FLOATS:
            np.testing.assert_allclose(a[det], b[det], atol=FLOATS[f],
                                       rtol=0, err_msg=f)
        elif f == "payload":
            np.testing.assert_array_equal(a[hv], b[hv], err_msg=f)
        else:
            np.testing.assert_array_equal(a[det], b[det], err_msg=f)


def _host(res):
    return type(res)(*(v.numpy() for v in res))


def test_params_and_tables_equal_jax():
    for k, m, bt in ((2, 3, 0.5), (2, 1, 0.5), (4, 2, 0.3)):
        np.testing.assert_array_equal(tfd.gaussian_pulse(k, m, bt),
                                      jfd.gaussian_pulse(k, m, bt))
        a, b = tg.make_gmsk_params(k, m, bt), jg.make_gmsk_params(k, m, bt)
        for f, u, v in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                          err_msg=f)
        np.testing.assert_array_equal(tg._detect_kernel_np(k, m, bt),
                                      jg._detect_kernel_np(k, m, bt))
        np.testing.assert_array_equal(tg._mf_freq_np(k, m, bt, 4096),
                                      jg._mf_freq_np(k, m, bt, 4096))
    for kind in ("default", "v27", "g2412"):
        for n in (1, 100, 200):
            assert tg.gmsk_frame_length(tg.make_gmsk_params(), _props(kind),
                                        n) == jg.gmsk_frame_length(
                jg.make_gmsk_params(), _jprops(_props(kind)), n)
    for kw in (dict(), dict(enable_conv=True), dict(expansion=5),
               dict(enable_conv=True, soft=True)):
        a = tg.make_gmsk_sync(tg.make_gmsk_params(), **kw)
        b = jg.make_gmsk_sync(jg.make_gmsk_params(), **kw)
        assert a._replace(params=None) == b._replace(params=None)
    assert tg.make_gmsk_sync(tg.make_gmsk_params(), soft=True).soft is True
    with pytest.raises(ValueError):
        tg.make_gmsk_sync(tg.make_gmsk_params(), expansion=0)


@pytest.mark.parametrize("kind", ["default", "v27", "g2412"])
def test_assemble_matches_jax(kind):
    rng = _rng(f"assemble {kind}")
    h = rng.integers(0, 256, 8, dtype=np.uint8)
    pay = rng.integers(0, 256, 200, dtype=np.uint8)
    got = tg.gmsk_assemble(tg.make_gmsk_params(), _props(kind),
                           torch.as_tensor(h), torch.as_tensor(pay))
    want = np.asarray(jg.gmsk_assemble(jg.make_gmsk_params(),
                                       _jprops(_props(kind)),
                                       jnp.asarray(h), jnp.asarray(pay)))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    np.testing.assert_allclose(np.abs(got.numpy()), 1.0, atol=1e-5)
    with pytest.raises(ValueError):
        tg.gmsk_assemble(tg.make_gmsk_params(), _props(kind),
                         torch.as_tensor(h), torch.as_tensor(pay),
                         rx_max_payload=100)


def test_tx_of_each_package_decodes_in_the_other():
    """The port's frames decode byte for byte in JAX's synchronizer, and
    JAX's frames in the port's."""
    rng = _rng("cross")
    sent = [(rng.integers(0, 256, 8, dtype=np.uint8),
             rng.integers(0, 256, 90, dtype=np.uint8)) for _ in range(2)]
    props = tg.gmsk_default_props()
    ours = tg.gmsk_assemble(tg.make_gmsk_params(), props,
                            torch.as_tensor(sent[0][0]),
                            torch.as_tensor(sent[0][1])).numpy()
    theirs = np.asarray(jg.gmsk_assemble(
        jg.make_gmsk_params(), _jprops(props), jnp.asarray(sent[1][0]),
        jnp.asarray(sent[1][1])))
    sync = _tsync(False)
    n_blocks = 5 + -(-sync.overlap // BS)
    x = np.zeros(n_blocks * BS, np.complex64)
    x[900:900 + len(ours)] = 0.5 * ours
    x[9000:9000 + len(theirs)] = 0.5 * theirs
    blocks = x.reshape(n_blocks, BS)
    js = jg.make_gmsk_sync(jg.make_gmsk_params(), block_size=BS,
                           max_payload=MAX_PAYLOAD, max_frames=MAX_FRAMES)
    _, jr = jg.gmsk_sync_blocks_batched(js, jg.gmsk_sync_init(js),
                                        jnp.asarray(blocks))
    _, tr = tg.gmsk_sync_blocks_batched(
        sync, tg.gmsk_sync_init(sync, "cpu"), torch.as_tensor(blocks))
    for r in (jax.device_get(jr), _host(tr)):
        ok = np.asarray(r.payload_valid)
        t = np.asarray(r.t_start)[ok]
        assert ok.sum() == 2 and t[0] < t[1]
        for j, (h, pay) in enumerate(sent):
            np.testing.assert_array_equal(np.asarray(r.header)[ok][j], h)
            np.testing.assert_array_equal(
                np.asarray(r.payload)[ok][j][:len(pay)], pay)


def test_front_end_matches_jax():
    blocks, _ = _stream(False)
    sync = _tsync(False)
    js = jg.make_gmsk_sync(jg.make_gmsk_params(), block_size=BS,
                           max_payload=MAX_PAYLOAD, max_frames=MAX_FRAMES)
    full = np.concatenate([np.zeros(sync.overlap, np.complex64),
                           blocks.reshape(-1)])
    exts = torch.as_tensor(full).unfold(0, sync.overlap + BS, BS)[:8]
    z, metric, det, locs = tg._front_end(sync, exts)
    jz, jm, jdet, jlocs = jax.vmap(lambda e: jg._front_end(js, e))(
        jnp.asarray(exts.numpy()))
    jdet = np.asarray(jdet)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_array_equal(locs.numpy()[jdet], np.asarray(jlocs)[jdet])
    jz = np.asarray(jz)
    assert float(np.abs(z.numpy() - jz).max()) <= 1e-5 * np.abs(jz).max()
    rows = jdet.any(-1)
    assert rows.sum() >= 2
    np.testing.assert_allclose(metric.numpy()[rows], np.asarray(jm)[rows],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("conv", [False, True])
def test_sync_matches_jax(jax_ref, conv):
    """``gmsk_sync_blocks_batched`` over the whole stream gives JAX's rows
    and state; every burst decodes byte for byte at its start."""
    blocks, sent = _stream(conv)
    jst, jres = jax_ref[conv]
    sync = _tsync(conv)
    st, res = tg.gmsk_sync_blocks_batched(
        sync, tg.gmsk_sync_init(sync, "cpu"), torch.as_tensor(blocks))
    res = _host(res)
    _rows_equal(res, jres)
    np.testing.assert_array_equal(st.tail.numpy(), np.asarray(jst.tail))
    assert int(st.base) == int(jst.base) and st.base.dtype == torch.int32
    moved = from_jax_tree(jst, "cpu")
    assert type(moved) is tg.GmskSyncState
    assert torch.equal(moved.tail, st.tail)
    ok = sorted((int(res.t_start[b, i]), res.header[b, i],
                 res.payload[b, i][:int(res.payload_len[b, i])])
                for b, i in zip(*np.nonzero(res.payload_valid)))
    assert len(ok) == len(sent)
    for (t, h, pay), (h0, p0, pos) in zip(ok, sent):
        assert abs(t - pos) <= 2
        np.testing.assert_array_equal(h, h0)
        np.testing.assert_array_equal(pay, p0)
    if conv:
        assert set(res.fec0[res.payload_valid]) == {fec.FEC_NONE,
                                                    fec.FEC_CONV_V27}


def test_batched_dispatch_equals_single_steps():
    """8 blocks as one ``gmsk_sync_blocks_batched`` call (IQ planes too)
    against 8 ``make_gmsk_sync_step`` steps: the same detected rows and
    carried state."""
    blocks, _ = _stream(False)
    blocks = torch.as_tensor(blocks[:8])
    sync = _tsync(False)
    step = tg.make_gmsk_sync_step(sync)
    st = tg.gmsk_sync_init(sync, "cpu")
    steps = []
    for b in range(8):
        st, r = step(st, blocks[b])
        steps.append(_host(r))
    for inp in (blocks, torch.stack([blocks.real, blocks.imag])):
        bst, res = tg.gmsk_sync_blocks_batched(
            sync, tg.gmsk_sync_init(sync, "cpu"), inp)
        res = _host(res)
        for b in range(8):
            _rows_equal(type(res)(*(v[b] for v in res)), steps[b])
        assert torch.equal(bst.tail, st.tail) and int(bst.base) == \
            int(st.base)
    assert sum(int(s.payload_valid.sum()) for s in steps) >= 2
    with pytest.raises(ValueError):
        tg.gmsk_sync_block(sync, st, blocks[0, :100])


def test_stream_counter_wraps_at_2_31():
    sync = _tsync(False)
    st = tg.gmsk_sync_init(sync, "cpu")._replace(
        base=torch.tensor(2 ** 31 - 100, dtype=torch.int32))
    st, _ = tg.gmsk_sync_block(sync, st,
                               torch.zeros(BS, dtype=torch.complex64))
    assert int(st.base) == 2 ** 31 - 100 + BS - 2 ** 32


def test_candidates_past_the_window_are_clamped():
    """Candidates at and past the window's end read clamped samples, as
    JAX's gathers do: the decode runs and flags them invalid."""
    sync = _tsync(False)
    rng = _rng("clamp")
    L = sync.overlap + BS
    ext = torch.as_tensor((0.1 * (rng.normal(size=(2, L)) + 1j *
                                  rng.normal(size=(2, L)))
                           ).astype(np.complex64))
    z, metric, _, _ = tg._front_end(sync, ext)
    locs = torch.tensor([metric.shape[-1] - 1, L + 5000, 0, 2 ** 30])
    out = tg._decode_candidates(sync, z, metric, ext,
                                torch.tensor([0, 1, 1, 0]), locs)
    assert out[0].shape == (4, 8)
    assert not bool(out[7].any())


def test_small_m_frames_decode_at_every_block_position():
    """m=1: frames whose tail reaches deep into the overlap margin decode
    at every start across the block seam."""
    params = tg.make_gmsk_params(k=2, m=1, bt=0.5)
    sync = tg.make_gmsk_sync(params, block_size=4096, max_payload=64,
                             max_frames=2)
    rng = _rng("small m")
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 48, dtype=np.uint8)
    frame = tg.gmsk_assemble(params, tg.gmsk_default_props(),
                             torch.as_tensor(header),
                             torch.as_tensor(payload)).numpy()
    bs = sync.block_size
    for pos in range(bs - len(frame) - 40, bs - len(frame) + 40, 8):
        stream = np.zeros(3 * bs, np.complex64)
        stream[pos:pos + len(frame)] = frame
        _, r = tg.gmsk_sync_blocks_batched(
            sync, tg.gmsk_sync_init(sync, "cpu"),
            torch.as_tensor(stream.reshape(3, bs)))
        ok = r.payload_valid.numpy()
        assert ok.sum() == 1, f"pos={pos}"
        np.testing.assert_array_equal(r.payload.numpy()[ok][0][:48], payload)


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


def _count(out: str, what: str) -> int:
    return int(re.search(what + r"\s+:\s+(\d+)", out).group(1))


def test_gmskframe_apps(cpu_env, tmp_path, capsys):
    """The TX -> RX pair at ``-N 2 -P 100``, ``-p 256 --snr 22``: 2/2 valid
    and a PER line; the same with a v27 payload through ``--conv``; the
    output rate chain, also through ``--soft``; unknown flags exit 1;
    ``-h`` prints the usage."""
    iq = str(tmp_path / "g.iq")
    assert gmskframe_tx.main(["-o", iq, "-N", "2", "-P", "100"]) == 0
    assert gmskframe_rx.main(["-i", iq, "-p", "256", "--snr", "22"]) == 0
    out = capsys.readouterr().out
    assert "valid packets       :      2 (100.00%)" in out
    assert "packet error rate" in out and "average SNR" in out
    assert gmskframe_tx.main(["-o", iq, "-N", "2", "-P", "100", "-c", "v27",
                              "-k", "none"]) == 0
    assert "--conv" in capsys.readouterr().out
    assert gmskframe_rx.main(["-i", iq, "-p", "256", "--snr", "22",
                              "--conv", "-q"]) == 0
    assert _count(capsys.readouterr().out, "valid packets") == 2
    # the output rate chain (half-band interp + arbitrary) and back
    assert gmskframe_tx.main(["-o", iq, "-N", "2", "-P", "60", "-r",
                              "2.0"]) == 0
    assert gmskframe_rx.main(["-i", iq, "-p", "128", "-r", "0.5",
                              "-q"]) == 0
    assert _count(capsys.readouterr().out, "valid packets") == 2
    assert gmskframe_rx.main(["-i", iq, "-p", "128", "-r", "0.5", "-q",
                              "--soft"]) == 0
    assert _count(capsys.readouterr().out, "valid packets") == 2
    with pytest.raises(SystemExit) as exc:
        gmskframe_rx.main(["-Z"])
    assert exc.value.code == 1
    assert gmskframe_tx.main(["-o", iq, "-c", "nope"]) == 1
    capsys.readouterr()
    for mod in (gmskframe_tx, gmskframe_rx):
        assert mod.main(["-h"]) == 0
        assert "usage" in capsys.readouterr().out
