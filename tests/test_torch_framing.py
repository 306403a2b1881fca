"""Parity of the port's framing layer (payload codec, OFDM TX, OFDM sync)
with the JAX package.

Tolerances: the header/payload codec is exact (bytes, decisions, CRC,
validity); the ``assemble_frame`` waveform atol 1e-5; the OfdmParams
tables exact.  ``sync_block`` and ``sync_channels_batched`` at detect
levels 0, 1 and 2 on a loaded stream with frames straddling block edges,
against JAX at the same level:
``detected``, ``header_valid``, ``payload_valid`` exact, and where detected
``header``/``payload``/``payload_len``/``mod``/``fec0``/``fec1``/
``check``/``t_start`` exact, ``rssi`` atol 1e-3 dB, ``evm`` atol 0.05 dB,
``cfo`` atol 1e-5 rad/sample.  Detected frames are matched by ``t_start``
within each block (the top-k slot order of near-equal scores is not part
of the contract).  Each channel carries a carrier frequency offset above
pi / (2 M), so a wrong coarse estimate (the lag correlation ``c_at`` that
detect level 2 takes from kernel B2) is beyond what the fine stage can
correct; the port's estimate must be within 1.5e-3 rad/sample of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jsync
from liquid_usrp_tpu.framing import payload as jpay
from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.framing import ofdm_sync as tsync
from liquid_usrp_tpu_torch.framing import payload as tpay
from liquid_usrp_tpu_torch.ops import fec as tfec
from liquid_usrp_tpu_torch.ops import modem as tmodem

BS = 4096
CFOS = (0.045, -0.04)           # rad/sample, per channel of ``streams``
PROPS_QAM = dict(check=1, fec0=tfec.FEC_HAMMING84, fec1=tfec.FEC_NONE,
                 mod=tmodem.MOD_QAM16)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# payload codec
# ---------------------------------------------------------------------------

def test_header_codec_exact():
    rng = np.random.default_rng(0)
    props = tofdm.FrameProps(**PROPS_QAM)
    jprops = jofdm.FrameProps(**PROPS_QAM)
    hdr = rng.integers(0, 256, 8, dtype=np.uint8)
    enc = tpay.encode_header(_t(hdr), 100, props).numpy()
    np.testing.assert_array_equal(
        enc, np.asarray(jpay.encode_header(jnp.asarray(hdr), 100, jprops)))
    noisy = np.stack([enc] * 4)
    for r in range(4):                     # 0..3 bit errors (Golay fixes 3)
        for k in range(r):
            noisy[r, 3 * k + 1] ^= np.uint8(1 << k)
    noisy[3, 0] ^= np.uint8(0xFF)          # and a row beyond correction
    got = tpay.decode_header(_t(noisy), 128)
    want = jax.vmap(lambda h: jpay.decode_header(h, 128))(
        jnp.asarray(noisy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[-1][:3].all() and not bool(got[-1][3])
    np.testing.assert_array_equal(got[0][0].numpy(), hdr)


def test_demap_primitives_exact():
    rng = np.random.default_rng(1)
    tabs = tpay._stacked_tables()
    np.testing.assert_array_equal(tabs, jpay._stacked_tables())
    mods = np.array([0, 1, 10, 14, 5, 40])
    x = (rng.normal(size=(6, 70)) + 1j * rng.normal(size=(6, 70))
         ).astype(np.complex64)
    sym, dmin = tpay._nearest_sym(_t(x), _t(tabs[mods]))
    pt, _ = tpay._nearest_point(_t(x), _t(tabs[mods]))
    js, jd = jax.vmap(jpay._nearest_sym)(jnp.asarray(x),
                                         jnp.asarray(tabs[mods]))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        pt.numpy(), np.take_along_axis(tabs[mods], np.asarray(js), -1))
    # the decisions are exact; the distance itself may round one ulp
    # apart (XLA may contract the squares into an FMA)
    np.testing.assert_allclose(dmin.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    # bits from symbols, including a stream that runs past its end
    syms = rng.integers(0, 256, (4, 30))
    off = np.array([0, 1, 0, 1])
    bps = np.array([1, 3, 8, 8])
    got = tpay._bits_from_syms(_t(syms), _t(off), _t(bps), 300)
    want = jax.vmap(lambda s, o, b: jpay._bits_from_syms(s, o, b, 300))(
        jnp.asarray(syms, jnp.int32), jnp.asarray(off, jnp.int32),
        jnp.asarray(bps, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_payload_batch():
    """Encoded payloads of several props as noisy constellation points
    decode to the injected bytes with the right validity (the decisions
    feeding it are held bit-exact to JAX above and end to end in the sync
    tests); point counts exact vs JAX; CRC check per scheme."""
    rng = np.random.default_rng(2)
    sync = tsync.make_sync(tofdm.make_ofdm_params(48, 6, 4), block_size=BS,
                           max_payload=64, max_frames=4)
    props = [dict(check=2, fec0=0, fec1=5, mod=1),
             dict(check=1, fec0=3, fec1=6, mod=10),
             dict(check=0, fec0=1, fec1=0, mod=5),
             dict(check=2, fec0=9, fec1=0, mod=14)]
    n_pts = sync.max_psym * 32
    pts = np.zeros((4, n_pts), np.complex64)
    plens = np.array([50, 40, 7, 33])
    sent = []
    for r, pr in enumerate(props):
        p = rng.integers(0, 256, plens[r], dtype=np.uint8)
        sent.append(p)
        enc = tpay.encode_payload(tofdm.FrameProps(**pr), _t(p)).numpy()
        bps = tmodem.bits_per_symbol(pr["mod"])
        bits = np.unpackbits(enc)
        bits = np.concatenate([bits, np.zeros(-len(bits) % bps, np.uint8)])
        sy = bits.reshape(-1, bps) @ (1 << np.arange(bps - 1, -1, -1))
        v = tmodem._table_np(pr["mod"])[sy]
        if tmodem.is_differential(pr["mod"]):
            v = np.concatenate([[1.0], np.cumprod(v)])
        pts[r, :len(v)] = v
    pts += (0.03 * (rng.normal(size=pts.shape) +
                    1j * rng.normal(size=pts.shape))).astype(np.complex64)
    cols = {k: np.array([p[k] for p in props])
            for k in ("mod", "fec0", "fec1", "check")}
    hv = np.array([True, True, True, False])
    tp, tv = tpay.decode_payload_batch(
        sync.enc_max, sync.dec_max, sync.max_payload, _t(pts),
        _t(cols["mod"]), _t(cols["fec0"]), _t(cols["fec1"]),
        _t(cols["check"]), _t(plens), _t(hv))
    assert tv.numpy().tolist() == [True, True, True, False]
    for r in range(4):
        np.testing.assert_array_equal(tp[r, :plens[r]].numpy(), sent[r])
        assert not tp[r, plens[r]:].any()
    args = [cols[k] for k in ("mod", "fec0", "fec1", "check")]
    used = tpay.payload_points_used(sync.fecs, sync.dec_max, sync.enc_max,
                                    _t(plens), *map(_t, args))
    jused = jpay.payload_points_used(sync.fecs, sync.dec_max, sync.enc_max,
                                     jnp.asarray(plens),
                                     *map(jnp.asarray, args))
    np.testing.assert_array_equal(used.numpy(), np.asarray(jused))
    assert float(tpay.payload_evm_mse(_t(pts), _t(cols["mod"]),
                                      used).max()) < 0.01
    dec = np.zeros((3, 20), np.uint8)
    dec[:, :10] = rng.integers(0, 256, (3, 10))
    for scheme, w in ((1, 2), (2, 4)):
        c = tpay.crc_mod.crc_compute(scheme, _t(dec[:, :10])).numpy()
        for k in range(w):
            dec[scheme, 10 + k] = (int(c[scheme]) >> (8 * (w - 1 - k))) & 255
    chk3 = np.array([0, 1, 2])
    assert tpay.crc_check_dynamic(_t(chk3), _t(dec), _t(np.array(
        [10, 10, 10]))).numpy().tolist() == [True, True, True]
    bad = dec.copy()
    bad[1:, 3] ^= 1
    assert tpay.crc_check_dynamic(_t(chk3), _t(bad), _t(np.array(
        [10, 10, 19]))).numpy().tolist() == [True, False, False]


# ---------------------------------------------------------------------------
# OFDM TX
# ---------------------------------------------------------------------------

def test_ofdm_params_exact():
    for M, cp in ((48, 6), (64, 8)):
        tp, jp = tofdm.make_ofdm_params(M, cp, 4), jofdm.make_ofdm_params(
            M, cp, 4)
        for name in tp._fields:
            np.testing.assert_array_equal(getattr(tp, name),
                                          getattr(jp, name))
        assert tofdm.header_symbol_count(tp) == jofdm.header_symbol_count(jp)


@pytest.mark.parametrize("props", [{}, PROPS_QAM])
def test_assemble_frame_waveform(props):
    """The TX waveform (atol 1e-5) for the default props and a QAM16 one."""
    rng = np.random.default_rng(3)
    params = tofdm.make_ofdm_params(48, 6, 4)
    jparams = jofdm.make_ofdm_params(48, 6, 4)
    hdr = rng.integers(0, 256, 8, dtype=np.uint8)
    pay = rng.integers(0, 256, 100, dtype=np.uint8)
    got = tofdm.assemble_frame(params, tofdm.FrameProps(**props), _t(hdr),
                               _t(pay)).numpy()
    want = np.asarray(jofdm.assemble_frame(
        jparams, jofdm.FrameProps(**props), jnp.asarray(hdr),
        jnp.asarray(pay)))
    assert got.shape == want.shape == (tofdm.frame_length(
        params, tofdm.FrameProps(**props), 100),)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# OFDM sync, levels 0/1/2
# ---------------------------------------------------------------------------

N_BLOCKS = 6


@pytest.fixture(scope="module")
def streams():
    """Two channels of 3 loaded blocks + flush (frames from the port's TX,
    which is held to JAX's above), each channel offset by its ``CFOS``
    entry: channel 0 carries a frame straddling the first block edge;
    channel 1 one frame early and one (QAM16/CRC16/Hamming(8,4))
    straddling the second block edge."""
    rng = np.random.default_rng(4)
    params = tofdm.make_ofdm_params(48, 6, 4)
    out = np.zeros((2, N_BLOCKS * BS), np.complex64)
    sent = []
    for ch, pos, pr in ((0, 3000, {}), (1, 500, {}), (1, 7000, PROPS_QAM)):
        hdr = rng.integers(0, 256, 8, dtype=np.uint8)
        pay = rng.integers(0, 256, 90, dtype=np.uint8)
        f = tofdm.assemble_frame(params, tofdm.FrameProps(**pr), _t(hdr),
                                 _t(pay)).numpy()
        out[ch, pos:pos + len(f)] = f
        sent.append((ch, pos, hdr, pay))
    out *= np.exp(1j * np.outer(CFOS, np.arange(out.shape[1]))
                  ).astype(np.complex64)
    out[:, :3 * BS] += (0.01 * (rng.normal(size=(2, 3 * BS)) + 1j *
                                rng.normal(size=(2, 3 * BS)))
                        ).astype(np.complex64)
    return out, sent


def _rows(res):
    """{(block..., t_start): field dict} of the detected rows."""
    det = np.asarray(res.detected)
    rows = {}
    for idx in zip(*np.nonzero(det)):
        key = tuple(int(i) for i in idx[:-1]) + (int(res.t_start[idx]),)
        rows[key] = {f: np.asarray(getattr(res, f)[idx])
                     for f in res._fields}
    return rows


def _compare(tres, jres):
    tres = type(jres)(*(v.numpy() for v in tres))
    for f in ("detected", "header_valid", "payload_valid"):
        np.testing.assert_array_equal(
            np.sort(getattr(tres, f), axis=-1),
            np.sort(getattr(jres, f), axis=-1), err_msg=f)
    trows, jrows = _rows(tres), _rows(jres)
    assert trows.keys() == jrows.keys()
    for key in trows:
        t, j = trows[key], jrows[key]
        for f in ("header_valid", "payload_valid", "header", "payload",
                  "payload_len", "mod", "fec0", "fec1", "check", "t_start"):
            np.testing.assert_array_equal(t[f], j[f], err_msg=f)
        np.testing.assert_allclose(t["rssi"], j["rssi"], atol=1e-3)
        np.testing.assert_allclose(t["evm"], j["evm"], atol=0.05)
        np.testing.assert_allclose(t["cfo"], j["cfo"], atol=1e-5)
    return trows


def _check_sent(rows, sent, channel_key):
    got = {(k[0] if channel_key else 0, k[-1]): r for k, r in rows.items()
           if r["payload_valid"]}
    for ch, pos, hdr, pay in sent:
        r = got[(ch, pos)]
        np.testing.assert_array_equal(r["header"], hdr)
        np.testing.assert_array_equal(r["payload"][:len(pay)], pay)
        np.testing.assert_allclose(r["cfo"], CFOS[ch], atol=1.5e-3)


def _syncs(level):
    kw = dict(block_size=BS, max_payload=128, max_frames=8,
              use_pallas=level)
    return (jsync.make_sync(jofdm.make_ofdm_params(48, 6, 4), **kw),
            tsync.make_sync(tofdm.make_ofdm_params(48, 6, 4), **kw))


@pytest.fixture(scope="module", params=[0, 1, 2])
def jax_ref(request, streams):
    """(level, JAX sync_channels_batched results of each 2-block call over
    both channels, final JAX states).  JAX's per-channel ``sync_block``
    gives the same detected/valid-masked fields (its own suite holds the
    two equal), so these results are the reference for both port steps."""
    stream, _ = streams
    jsy, _ = _syncs(request.param)
    one = jsync.sync_init(jsy)
    js = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), one)
    jstep = jax.jit(lambda s, c: jsync.sync_channels_batched(jsy, s, c))
    out = []
    for call in range(N_BLOCKS // 2):
        chunk = stream[:, call * 2 * BS:(call + 1) * 2 * BS]
        js, jr = jstep(js, jnp.asarray(chunk.reshape(2, 2, BS)))
        out.append(jax.device_get(jr))
    return request.param, out, jax.device_get(js)


def test_sync_block_levels(streams, jax_ref):
    stream, sent = streams
    level, ref, jfinal = jax_ref
    _, tsy = _syncs(level)
    ts = tsync.sync_init(tsy, "cpu")
    found = {}
    for b in range(N_BLOCKS):
        ts, tr = tsync.sync_block(tsy, ts, _t(stream[0, b * BS:(b + 1) * BS]))
        jr = type(ref[0])(*(v[0, b % 2] for v in ref[b // 2]))
        for key, row in _compare(tr, jr).items():
            found[(0, key[-1])] = row
    assert int(ts.base) == int(jfinal.base[0])
    np.testing.assert_array_equal(ts.tail.numpy(), jfinal.tail[0])
    _check_sent(found, [s for s in sent if s[0] == 0], True)


def test_sync_channels_batched_levels(streams, jax_ref):
    stream, sent = streams
    level, ref, jfinal = jax_ref
    _, tsy = _syncs(level)
    t1 = tsync.sync_init(tsy, "cpu")
    ts = tsync.OfdmSyncState(tail=t1.tail.expand(2, -1).clone(),
                             base=t1.base.expand(2).clone())
    found = {}
    for call in range(N_BLOCKS // 2):
        chunk = stream[:, call * 2 * BS:(call + 1) * 2 * BS]
        ts, tr = tsync.sync_channels_batched(tsy, ts,
                                             _t(chunk.reshape(2, 2, BS)))
        for key, row in _compare(tr, ref[call]).items():
            found[(key[0], key[-1])] = row
    np.testing.assert_array_equal(ts.base.numpy(), jfinal.base)
    np.testing.assert_array_equal(ts.tail.numpy(), jfinal.tail)
    _check_sent(found, sent, True)
    assert len(found) == 3
