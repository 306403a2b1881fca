"""The soft-decision synchronizers against the JAX package: OFDM
(``make_sync(soft=True)``), flexframe (``make_flex_sync``) and GMSK
(``make_gmsk_sync``), each with ``enable_conv=True`` on the same NumPy
stream (frames from JAX's TX, AWGN from ``default_rng``), through the
batched dispatch of each family; the ``--soft`` CLI pairs; and the
``MultichannelRx`` keywords ``enable_conv`` and ``soft`` (fault C3).

Tolerances: rows masked by ``detected``: flags, header, ``payload_len``,
``t_start``, mod, FEC and check exact, the payload exact on header-valid
rows (the port decodes the conv/RS schemes only there), ``cfo`` within 1e-5
rad/sample, ``evm`` and ``rssi`` within 1e-3 dB.  The soft header's Golay
decode scores in float64 where JAX scores in float32
(``tests/test_torch_soft.py``); no near-tie arises on these streams.
"""
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import flexframe as jff
from liquid_usrp_tpu.framing import flexframe_sync as jfs
from liquid_usrp_tpu.framing import gmskframe as jg
from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jos
from liquid_usrp_tpu.framing import payload as jpc
from liquid_usrp_tpu.models import multichannel as jmc
from liquid_usrp_tpu.ops import crc, fec, modem
from liquid_usrp_tpu_torch.apps import (flexframe_rx, flexframe_tx,
                                        gmskframe_rx, gmskframe_tx,
                                        ofdmflexframe_rx, ofdmflexframe_tx)
from liquid_usrp_tpu_torch.framing import flexframe as tff
from liquid_usrp_tpu_torch.framing import flexframe_sync as tfs
from liquid_usrp_tpu_torch.framing import gmskframe as tg
from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.framing import ofdm_sync as tos
from liquid_usrp_tpu_torch.models import multichannel as tmc
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

FLOATS = {"cfo": 1e-5, "evm": 1e-3, "rssi": 1e-3}
BS = 4096


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _awgn(x, snr_db, power, rng):
    std = np.sqrt(power / 10.0 ** (snr_db / 10.0) / 2.0)
    return (x + std * (rng.normal(size=x.shape) +
                       1j * rng.normal(size=x.shape))).astype(np.complex64)


def _blocks(x, overlap):
    n = -(-len(x) // BS) + -(-overlap // BS) + 1
    full = np.zeros(n * BS, np.complex64)
    full[:len(x)] = x
    return full.reshape(n, BS)


def _rows_equal(got, want):
    """Two results (NamedTuples of arrays) equal on the detected rows;
    returns the number of payload-valid rows."""
    want = type(want)(*(np.asarray(v) for v in want))
    got = type(got)(*(v.numpy() for v in got))
    det = want.detected
    np.testing.assert_array_equal(got.detected, det)
    hv = want.header_valid
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f in FLOATS:
            np.testing.assert_allclose(a[det], b[det], atol=FLOATS[f],
                                       rtol=0, err_msg=f)
        elif f == "payload":
            np.testing.assert_array_equal(a[hv], b[hv], err_msg=f)
        else:
            np.testing.assert_array_equal(a[det], b[det], err_msg=f)
    return int(want.payload_valid.sum())


def _assert_sent(res, sent):
    """Every sent (header, payload) is among the payload-valid rows."""
    res = type(res)(*(np.asarray(v) for v in res))
    ok = np.nonzero(res.payload_valid)
    got = [(res.header[i].tobytes(),
            res.payload[i][:int(res.payload_len[i])].tobytes())
           for i in zip(*ok)]
    for h, p in sent:
        assert (h.tobytes(), p.tobytes()) in got


def test_ofdm_soft_sync_matches_jax():
    """v27 (fec1 none: channel LLRs into the Viterbi), v27 under
    Hamming(12,8) (pseudo-LLRs) and a Golay-only frame, QPSK, CRC32, at
    10 dB (``tests/test_ofdm_loopback.py``)."""
    rng = _rng("ofdm soft")
    params = jofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    kinds = ((fec.FEC_CONV_V27, fec.FEC_NONE),
             (fec.FEC_CONV_V27, fec.FEC_HAMMING128),
             (fec.FEC_NONE, fec.FEC_GOLAY2412))
    pieces, sent = [np.zeros(700, np.complex64)], []
    for f0, f1 in kinds:
        props = jofdm.FrameProps(check=crc.CRC_32, fec0=f0, fec1=f1,
                                 mod=modem.MOD_QPSK)
        h = rng.integers(0, 256, 8, dtype=np.uint8)
        p = rng.integers(0, 256, 48, dtype=np.uint8)
        pieces += [np.asarray(jofdm.assemble_frame(
            params, props, jnp.asarray(h), jnp.asarray(p),
            rx_max_payload=64)),
            np.zeros(1300, np.complex64)]
        sent.append((h, p))
    x = np.concatenate(pieces)
    x = _awgn(x, 10.0, 0.8, rng)
    kw = dict(block_size=BS, max_payload=64, max_frames=2,
              enable_conv=True, soft=True, use_pallas=0)
    jsync = jos.make_sync(params, **kw)
    tsync = tos.make_sync(tofdm.make_ofdm_params(48, 6, 4), **kw)
    assert tsync._replace(params=None) == jsync._replace(params=None)
    blocks = _blocks(x, jsync.overlap)
    _, want = jax.jit(lambda st, b: jos.sync_blocks_batched(jsync, st, b))(
        jos.sync_init(jsync), jnp.asarray(blocks))
    _, got = tos.sync_blocks_batched(tsync, tos.sync_init(tsync, "cpu"),
                                     torch.as_tensor(blocks))
    assert _rows_equal(got, want) == 3
    _assert_sent(want, sent)


def test_flexframe_soft_sync_matches_jax():
    """v27, v27 under Hamming(12,8) and the default props, QPSK, at
    0.1-rms AWGN on 0.5-amplitude frames."""
    rng = _rng("flexframe soft")
    fp = jff.make_flex_params()
    kinds = ((fec.FEC_CONV_V27, fec.FEC_NONE),
             (fec.FEC_CONV_V27, fec.FEC_HAMMING128),
             (fec.FEC_NONE, fec.FEC_HAMMING128))
    pieces, sent = [np.zeros(1500, np.complex64)], []
    for f0, f1 in kinds:
        props = jff.FrameProps(check=crc.CRC_32, fec0=f0, fec1=f1,
                               mod=modem.MOD_QPSK)
        h = rng.integers(0, 256, jff.FLEX_HEADER_USER, dtype=np.uint8)
        p = rng.integers(0, 256, 48, dtype=np.uint8)
        pieces += [0.5 * np.asarray(jff.flex_assemble(
            fp, props, jnp.asarray(h), jnp.asarray(p), rx_max_payload=64)),
            np.zeros(1500, np.complex64)]
        sent.append((h, p))
    x = np.concatenate(pieces).astype(np.complex64)
    x = _awgn(x, 12.0, 0.25, rng)
    kw = dict(block_size=BS, max_payload=64, max_frames=2,
              enable_conv=True, soft=True)
    jsync = jfs.make_flex_sync(fp, **kw)
    tsync = tfs.make_flex_sync(tff.make_flex_params(), **kw)
    assert tsync._replace(params=None) == jsync._replace(params=None)
    blocks = _blocks(x, jsync.overlap)
    _, want = jax.jit(lambda st, b: jfs.flex_sync_blocks_batched(
        jsync, st, b))(jfs.flex_sync_init(jsync), jnp.asarray(blocks))
    _, got = tfs.flex_sync_blocks_batched(
        tsync, tfs.flex_sync_init(tsync, "cpu"), torch.as_tensor(blocks))
    assert _rows_equal(got, want) == 3
    _assert_sent(want, sent)


def test_gmsk_soft_sync_at_0_db_matches_jax():
    """v27 payloads at 0 dB with a 0.001 rad/sample offset, two trials
    (``tests/test_gmsk.py::test_zero_db_header_decode`` runs six)."""
    params = jg.make_gmsk_params(k=2, m=3, bt=0.5)
    props = jg.gmsk_default_props()._replace(fec0=fec.FEC_CONV_V27,
                                             fec1=fec.FEC_NONE)
    expansion = jpc.required_expansion(props, 200)
    kw = dict(block_size=BS, max_payload=512, max_frames=4,
              enable_conv=True, soft=True, expansion=expansion)
    jsync = jg.make_gmsk_sync(params, **kw)
    tsync = tg.make_gmsk_sync(tg.make_gmsk_params(k=2, m=3, bt=0.5), **kw)
    assert tsync._replace(params=None) == jsync._replace(params=None)
    rng = _rng("gmsk soft 0 dB")
    header = rng.integers(0, 256, 8, dtype=np.uint8)
    payload = rng.integers(0, 256, 200, dtype=np.uint8)
    frame = np.asarray(jg.gmsk_assemble(params, props, jnp.asarray(header),
                                        jnp.asarray(payload),
                                        expansion=expansion))
    sig = float(np.mean(np.abs(frame) ** 2))
    dispatch = jax.jit(lambda st, b: jg.gmsk_sync_blocks_batched(jsync, st,
                                                                 b))
    valid = 0
    for trial in range(2):
        stream = np.zeros(2500 + len(frame), np.complex64)
        pos = 600 + 290 * trial
        stream[pos:pos + len(frame)] = frame
        stream = stream * np.exp(1j * 0.001 * np.arange(len(stream)))
        stream = _awgn(stream, 0.0, sig, rng)
        blocks = _blocks(stream, jsync.overlap)
        _, want = dispatch(jg.gmsk_sync_init(jsync), jnp.asarray(blocks))
        _, got = tg.gmsk_sync_blocks_batched(
            tsync, tg.gmsk_sync_init(tsync, "cpu"), torch.as_tensor(blocks))
        valid += _rows_equal(got, want) > 0
        _assert_sent(want, [(header, payload)])
    assert valid == 2


# --- the --soft CLI pairs ---------------------------------------------------

@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


def _count(out: str, what: str) -> int:
    return int(re.search(what + r"\s+:\s+(\d+)", out).group(1))


@pytest.mark.parametrize("name,tx,rx,tx_argv,rx_argv", [
    ("ofdmflexframe", ofdmflexframe_tx, ofdmflexframe_rx,
     ["-N", "2", "-P", "48"], ["-p", "64"]),
    ("flexframe", flexframe_tx, flexframe_rx,
     ["-N", "2", "-P", "48"], ["-p", "64"]),
    ("gmskframe", gmskframe_tx, gmskframe_rx,
     ["-N", "2", "-P", "60"], ["-p", "128", "--snr", "8"]),
])
def test_soft_cli_pairs(cpu_env, tmp_path, capsys, name, tx, rx, tx_argv,
                        rx_argv):
    """Each TX writes v27 payloads; its RX decodes every frame with
    ``--conv --soft``, as many as without ``--soft``."""
    iq = str(tmp_path / f"{name}.iq")
    assert tx.main(["-o", iq, *tx_argv, "-c", "v27", "-k", "none"]) == 0
    capsys.readouterr()
    assert rx.main(["-i", iq, "-q", "--conv", "--soft", *rx_argv]) == 0
    out = capsys.readouterr().out
    assert _count(out, "valid packets") == 2, out
    assert rx.main(["-i", iq, "-q", "--conv", *rx_argv]) == 0
    assert _count(capsys.readouterr().out, "valid packets") == 2
    assert rx.main(["-h"]) == 0
    assert "--soft : soft-decision" in capsys.readouterr().out


def test_multichannel_rx_takes_conv_and_soft():
    """Fault C3: ``MultichannelRx`` takes JAX's ``enable_conv`` and
    ``soft``, and its synchronizer has JAX's FEC set, flag and budgets."""
    rx = tmc.MultichannelRx(4, enable_conv=True, soft=True, device="cpu")
    ref = jmc.MultichannelRx(4, enable_conv=True, soft=True)
    for f in ("fecs", "soft", "enc_max", "dec_max", "max_psym", "overlap"):
        assert getattr(rx.sync, f) == getattr(ref.sync, f), f
    assert rx.sync.soft is True and fec.FEC_CONV_V27 in rx.sync.fecs
    hard = tmc.MultichannelRx(4, device="cpu")
    assert hard.sync.soft is False and fec.FEC_CONV_V27 not in hard.sync.fecs
