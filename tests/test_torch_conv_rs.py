"""The convolutional FEC layer against the JAX package: ``ops/conv.py``
(every conv scheme: tables, ``encoded_length``, ``conv_encode``,
``conv_decode``, ``conv_decode_soft``), the scheme ids and names of
``ops/fec.py``, and OFDM and flexframe loopbacks with ``enable_conv=True``
(v27 and RS8 payloads).  ``tests/test_torch_rs.py`` holds Reed-Solomon
and the conv/RS branch of ``payload._fec_batch``.

Tolerances: none.  Tables, code lengths, encoded bytes and decoded bytes
equal JAX's exactly, also where the decode fails; the loopbacks decode
payload-exact.  Inputs come from ``numpy.random.default_rng`` seeded per
case with ``zlib.crc32`` of its name.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import payload as jpay
from liquid_usrp_tpu.ops import conv as jconv
from liquid_usrp_tpu.ops import fec as jfec
from liquid_usrp_tpu_torch.apps.common import iter_sync_results
from liquid_usrp_tpu_torch.framing import flexframe as tff
from liquid_usrp_tpu_torch.framing import flexframe_sync as tfs
from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.framing import ofdm_sync as tos
from liquid_usrp_tpu_torch.framing import payload as tpay
from liquid_usrp_tpu_torch.ops import conv as tconv
from liquid_usrp_tpu_torch.ops import crc, modem
from liquid_usrp_tpu_torch.ops import fec as tfec

CONV = [s for s in range(tfec.FEC_CONV_V27, tfec.FEC_CONV_V29P78 + 1)
        if s != tfec.FEC_RS8]


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _flip(words: np.ndarray, p: float, rng) -> np.ndarray:
    """``words`` (uint8 rows) with each bit flipped with probability p."""
    bits = np.unpackbits(words, axis=-1)
    return np.packbits(bits ^ (rng.random(bits.shape) < p), axis=-1)


def test_scheme_ids_and_names_equal_jax():
    assert tfec.fec_names() == jfec.fec_names()
    for s in range(len(jfec.fec_names())):
        assert tfec.fec_name(s) == jfec.fec_name(s)
        assert tfec.fec_from_name(tfec.fec_name(s)) == s
        assert tfec._is_conv(s) == jfec._is_conv(s)
    for name in ("FEC_CONV_V27", "FEC_CONV_V29", "FEC_RS8", "FEC_CONV_V615",
                 "FEC_CONV_V27P23", "FEC_CONV_V29P78"):
        assert getattr(tfec, name) == getattr(jfec, name)
    assert tpay.PAYLOAD_FECS_FULL == jpay.PAYLOAD_FECS_FULL
    with pytest.raises(ValueError):
        tfec._block_code(tfec.FEC_CONV_V27)


@pytest.mark.parametrize("name", [jfec.fec_name(s) for s in CONV])
def test_conv_matches_jax(name):
    """Trellis tables, code lengths, encoded bytes, and the hard and soft
    Viterbi outputs on the same noisy words and LLRs, per scheme."""
    s = tfec.fec_from_name(name)
    rng = _rng(name)
    for a, b in zip(tconv._tables(s), jconv._tables(s)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for m in (1, 7, 64, 223, 1000):
        assert tfec.encoded_length(s, m) == jfec.encoded_length(s, m)
    n = 6 if s == tfec.FEC_CONV_V615 else 20
    data = rng.integers(0, 256, (2, n), dtype=np.uint8)
    enc = tfec.fec_encode(s, torch.as_tensor(data)).numpy()
    want = np.stack([np.asarray(jfec.fec_encode(s, jnp.asarray(d)))
                     for d in data])
    np.testing.assert_array_equal(enc, want)
    np.testing.assert_array_equal(
        tfec.fec_decode(s, torch.as_tensor(enc), n).numpy(), data)
    # hard decisions: 2 % and 12 % bit errors (the second beyond the code)
    noisy = np.stack([_flip(want[0], 0.02, rng), _flip(want[1], 0.12, rng)])
    got = tfec.fec_decode(s, torch.as_tensor(noisy), n).numpy()
    ref = np.stack([np.asarray(jfec.fec_decode(s, jnp.asarray(w), n))
                    for w in noisy])
    np.testing.assert_array_equal(got, ref)
    # soft: +-1 per coded bit in noise, a few exact erasures
    sym = 2.0 * np.unpackbits(want, axis=-1).astype(np.float32) - 1.0
    llr = (sym + rng.normal(scale=0.9, size=sym.shape)).astype(np.float32)
    llr[:, 5::37] = 0.0
    got = tconv.conv_decode_soft(s, torch.as_tensor(llr), n).numpy()
    ref = np.stack([np.asarray(jconv.conv_decode_soft(s, jnp.asarray(v), n))
                    for v in llr])
    np.testing.assert_array_equal(got, ref)


def test_conv_decode_at_the_payload_budget_matches_jax():
    """v27 hard decode over the receiver's whole 2,052-byte budget (16,422
    trellis steps) at 2 % bit errors: JAX's bytes, and every row decoded
    (about 0.1 error events a row are expected at K=7)."""
    s = tfec.FEC_CONV_V27
    n = 2052
    rng = _rng("v27 budget")
    data = rng.integers(0, 256, (2, n), dtype=np.uint8)
    enc = tfec.fec_encode(s, torch.as_tensor(data)).numpy()
    noisy = _flip(enc, 0.02, rng)
    got = tfec.fec_decode(s, torch.as_tensor(noisy), n).numpy()
    ref = np.stack([np.asarray(jfec.fec_decode(s, jnp.asarray(w), n))
                    for w in noisy])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, data)


def _loopback(sync, step, init, frames, rng):
    """The frames (at amplitude 0.5, 1500-sample gaps) in 0.02-rms noise
    through ``iter_sync_results``: the payload-valid (header, payload)
    pairs in stream order."""
    pieces = [np.zeros(1500, np.complex64)]
    for w in frames:
        pieces += [0.5 * w, np.zeros(1500, np.complex64)]
    x = np.concatenate(pieces)
    x += (0.02 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
          ).astype(np.complex64)
    out = []
    for r in iter_sync_results(step, init, x, sync.block_size,
                               sync.overlap):
        for i in np.nonzero(r.payload_valid)[0]:
            out.append((int(r.t_start[i]), r.header[i],
                        r.payload[i][:int(r.payload_len[i])]))
    return [o[1:] for o in sorted(out, key=lambda o: o[0])]


@pytest.mark.parametrize("fec0,fec1,n", [("v27", "none", 48),
                                          ("none", "rs8", 219)])
def test_ofdm_and_flexframe_conv_loopbacks(fec0, fec1, n):
    """``enable_conv=True`` in the OFDM and flexframe synchronizers: v27
    and RS8 payloads decode payload-exact (two frames each).  The RS8
    payload with its CRC fills one whole 223-byte block: the synchronizers
    decode RS at their static maximum size, which aligns with a frame's
    whole blocks but not with a shortened last block (that block's parity
    is read from the wrong bytes, and JAX decodes such a frame only when
    the spurious correction misses its data; ROADMAP Queue C)."""
    rng = _rng(f"loopback {fec0} {fec1}")
    f0, f1 = tfec.fec_from_name(fec0), tfec.fec_from_name(fec1)
    max_payload = 64 if n <= 64 else 256
    sent = [(rng.integers(0, 256, 8, dtype=np.uint8),
             rng.integers(0, 256, n, dtype=np.uint8)) for _ in range(2)]
    params = tofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
    props = tofdm.FrameProps(check=crc.CRC_32, fec0=f0, fec1=f1,
                             mod=modem.MOD_QPSK)
    frames = tofdm.assemble_frames(
        params, props, torch.as_tensor(np.stack([h for h, _ in sent])),
        torch.as_tensor(np.stack([p for _, p in sent]))).numpy()
    sync = tos.make_sync(params, block_size=4096, max_payload=max_payload,
                         max_frames=2, enable_conv=True)
    got = _loopback(sync, tos.make_sync_step(sync),
                    tos.sync_init(sync, "cpu"), frames, rng)
    assert len(got) == 2
    for (h, p), (h0, p0) in zip(got, sent):
        np.testing.assert_array_equal(h, h0)
        np.testing.assert_array_equal(p, p0)

    fp = tff.make_flex_params()
    fprops = tff.FrameProps(check=crc.CRC_32, fec0=f0, fec1=f1,
                            mod=modem.MOD_QPSK)
    sent = [(rng.integers(0, 256, tff.FLEX_HEADER_USER, dtype=np.uint8),
             p) for _, p in sent]
    frames = [tff.flex_assemble(fp, fprops, torch.as_tensor(h),
                                torch.as_tensor(p)).numpy()
              for h, p in sent]
    fsync = tfs.make_flex_sync(fp, block_size=4096, max_payload=max_payload,
                               max_frames=2, enable_conv=True)
    got = _loopback(fsync, tfs.make_flex_sync_step(fsync),
                    tfs.flex_sync_init(fsync, "cpu"), frames, rng)
    assert len(got) == 2
    for (h, p), (h0, p0) in zip(got, sent):
        np.testing.assert_array_equal(h, h0)
        np.testing.assert_array_equal(p, p0)
