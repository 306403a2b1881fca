"""Reed-Solomon RS(255,223) and the conv/RS branch of the payload codec
against the JAX package: ``ops/rs.py`` (tables, ``rs_encode``,
``rs_decode`` up to and beyond 16 byte errors a block, the NumPy oracle)
and ``payload._fec_batch`` over ``PAYLOAD_FECS_FULL`` with a different
scheme on every row, and ``fec_decode_switch``.

Tolerances: none.  Tables and bytes equal JAX's exactly, also where the
decode fails.  Inputs come from ``numpy.random.default_rng`` seeded per
case with ``zlib.crc32`` of its name.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import torch

from liquid_usrp_tpu.framing import payload as jpay
from liquid_usrp_tpu.ops import fec as jfec
from liquid_usrp_tpu.ops import rs as jrs
from liquid_usrp_tpu_torch.framing import payload as tpay
from liquid_usrp_tpu_torch.ops import fec as tfec
from liquid_usrp_tpu_torch.ops import rs as trs
from liquid_usrp_tpu_torch.utils.bits import unpack_bits


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _flip(words: np.ndarray, p: float, rng) -> np.ndarray:
    """``words`` (uint8 rows) with each bit flipped with probability p."""
    bits = np.unpackbits(words, axis=-1)
    return np.packbits(bits ^ (rng.random(bits.shape) < p), axis=-1)


def test_rs_tables_and_oracle_equal_jax():
    for a, b in zip(trs._codec_matrices(), jrs._codec_matrices()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(trs._position_tables(), jrs._position_tables()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(trs._gf_tables(), jrs._gf_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trs._gen_poly(), jrs._gen_poly())
    rng = _rng("rs oracle")
    for _ in range(3):
        msg = rng.integers(0, 256, trs.RS_K, dtype=np.uint8)
        assert trs.np_rs_roundtrip_check(msg)
        assert jrs.np_rs_roundtrip_check(msg)
        np.testing.assert_array_equal(trs._np_parity(msg),
                                      jrs._np_parity(msg))


def test_rs_matches_jax():
    """``rs_encode`` bytes, and ``rs_decode`` on rows with 0-16 byte errors
    in the first block (corrected) and 17-40 (beyond the code, where the
    output is whatever JAX's is); 300 bytes: a whole block and a
    shortened one."""
    n = 300
    rng = _rng(f"rs {n}")
    n_err = (0, 1, 5, 11, 16, 17, 24, 40)
    data = rng.integers(0, 256, (len(n_err), n), dtype=np.uint8)
    for m in (1, 10, 223, 224, 300, 1000):
        assert tfec.encoded_length(tfec.FEC_RS8, m) == \
            jfec.encoded_length(jfec.FEC_RS8, m)
    enc = tfec.fec_encode(tfec.FEC_RS8, torch.as_tensor(data)).numpy()
    want = np.stack([np.asarray(jrs.rs_encode(jnp.asarray(d)))
                     for d in data])
    np.testing.assert_array_equal(enc, want)
    bad = want.copy()
    first = min(n, trs.RS_K) + 32
    for row, e in enumerate(n_err):
        for p in rng.choice(first, size=min(e, first), replace=False):
            bad[row, p] ^= int(rng.integers(1, 256))
    got = tfec.fec_decode(tfec.FEC_RS8, torch.as_tensor(bad), n).numpy()
    ref = np.stack([np.asarray(jrs.rs_decode(jnp.asarray(w), n))
                    for w in bad])
    np.testing.assert_array_equal(got, ref)
    ok = [e <= 16 for e in n_err]
    np.testing.assert_array_equal(got[ok], data[ok])


def test_fec_batch_full_set_matches_jax():
    """``_fec_batch`` over ``PAYLOAD_FECS_FULL`` with a different scheme
    on every row equals JAX's; with ``rows`` the marked rows keep it and
    the unmarked conv/RS rows are zeros."""
    rng = _rng("fec batch")
    fecs = tpay.PAYLOAD_FECS_FULL
    out_bytes, in_bytes = 40, 3 * 44
    ids = np.arange(len(fecs), dtype=np.int32)
    bufs = rng.integers(0, 256, (len(fecs), in_bytes), dtype=np.uint8)
    for i, s in enumerate(fecs):
        n = tpay._fit_bytes(s, out_bytes, in_bytes)
        enc = tfec.fec_encode(s, torch.as_tensor(rng.integers(
            0, 256, n, dtype=np.uint8))).numpy()
        bufs[i, :len(enc)] = _flip(enc, 0.01, rng)
    got = tpay._fec_batch(torch.as_tensor(ids), torch.as_tensor(bufs),
                          out_bytes, fecs).numpy()
    want = np.asarray(jpay._fec_batch(jnp.asarray(ids), jnp.asarray(bufs),
                                      out_bytes, fecs))
    np.testing.assert_array_equal(got, want)
    rows = torch.as_tensor(ids % 2 == 0)
    part = tpay._fec_batch(torch.as_tensor(ids), torch.as_tensor(bufs),
                           out_bytes, fecs, rows=rows).numpy()
    heavy = np.array([tpay._is_heavy(s) for s in fecs])
    keep = rows.numpy() | ~heavy
    np.testing.assert_array_equal(part[keep], want[keep])
    assert not part[~keep].any()
    # the single-frame switch takes one branch
    for i in (3, 10, 12):
        np.testing.assert_array_equal(
            tpay.fec_decode_switch(i, torch.as_tensor(bufs[i]), out_bytes,
                                   fecs).numpy(), want[i])


def test_decode_payload_single_frame_matches_batch():
    """``decode_payload`` (one frame, ``fec_decode_switch`` per stage) on
    the BPSK points of a v27 and an RS8 payload: the payload byte for byte
    and valid, as the batched decode's row."""
    from liquid_usrp_tpu_torch.framing.ofdm import FrameProps
    from liquid_usrp_tpu_torch.ops import crc, modem
    rng = _rng("decode payload")
    fecs = tpay.PAYLOAD_FECS_FULL
    max_payload = 64
    dec_max, enc_max = max_payload + 4, 3 * (max_payload + 4)
    for f0, f1 in ((tfec.FEC_CONV_V27, tfec.FEC_NONE),
                   (tfec.FEC_NONE, tfec.FEC_RS8)):
        props = FrameProps(check=crc.CRC_32, fec0=f0, fec1=f1,
                           mod=modem.MOD_BPSK)
        payload = rng.integers(0, 256, 50, dtype=np.uint8)
        bits = unpack_bits(tpay.encode_payload(
            props, torch.as_tensor(payload))).to(torch.float32)
        pts = torch.zeros(enc_max * 8, dtype=torch.complex64)
        pts[:bits.shape[0]] = 1.0 - 2.0 * bits
        args = [torch.tensor(v, dtype=torch.int32) for v in (
            modem.MOD_BPSK, fecs.index(f0), fecs.index(f1), crc.CRC_32,
            50)]
        got, ok = tpay.decode_payload(enc_max, dec_max, max_payload, pts,
                                      *args, torch.tensor(True), fecs)
        assert bool(ok)
        np.testing.assert_array_equal(got.numpy()[:50], payload)
        assert not got[50:].any()
        bat, bok = tpay.decode_payload_batch(
            enc_max, dec_max, max_payload, pts[None],
            *(a.reshape(1) for a in args), torch.tensor([True]), fecs)
        np.testing.assert_array_equal(bat[0].numpy(), got.numpy())
        assert bool(bok[0])
