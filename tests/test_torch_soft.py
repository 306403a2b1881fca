"""The soft-decision decode ops against the JAX package: ``demodulate_soft``,
``generic_demod_soft`` (tables of 64 and 256 entries, with DPSK rows),
``golay_decode_soft``, ``decode_header_soft`` (and the synchronizers'
``decode_header_points_soft``) and ``decode_payload_batch_soft`` over the
full FEC matrix.

Tolerances: LLRs within 1e-6 of the largest |LLR| of the call (JAX squares
``abs()`` of a complex difference where the port sums the squared real and
imaginary parts, as its hard demappers do; measured 2.4e-7 for
``demodulate_soft`` and 1.2e-7 for ``generic_demod_soft``), with equal
signs wherever |LLR| exceeds that.  ``golay_decode_soft`` scores in float64
where JAX scores in float32: the messages are equal except on blocks whose
two best scores lie within 1e-5 of the best (near-ties, counted).  Header
fields and payload bytes exact, on every row, header-valid or not.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import payload as jpc
from liquid_usrp_tpu.ops import crc as jcrc
from liquid_usrp_tpu.ops import fec as jfec
from liquid_usrp_tpu.ops import modem as jmodem
from liquid_usrp_tpu.utils.bits import unpack_bits as junpack
from liquid_usrp_tpu_torch.framing import payload as tpc
from liquid_usrp_tpu_torch.ops import fec as tfec
from liquid_usrp_tpu_torch.ops import modem as tmodem

LLR_RTOL = 1e-6        # of the largest |LLR| in the call
NEAR_TIE = 1e-5        # Golay: best-two score gap, relative to the best


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _llr_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = LLR_RTOL * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    sure = np.abs(want) > tol
    np.testing.assert_array_equal(np.sign(got[sure]), np.sign(want[sure]))


def _noisy(rng, shape, scale):
    return (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
            ).astype(np.complex64)


@pytest.mark.parametrize("name", ["bpsk", "qpsk", "psk8", "ask4", "qam16",
                                  "qam64", "apsk32", "qam256", "psk256",
                                  "v29", "arb64opt", "dpsk4"])
def test_demodulate_soft_matches_jax(name):
    scheme = tmodem.mod_from_name(name)
    x = _noisy(_rng(name), 400, 0.6)
    for nv in (0.1, 0.5):
        _llr_close(tmodem.demodulate_soft(scheme, torch.as_tensor(x), nv),
                   jmodem.demodulate_soft(scheme, jnp.asarray(x), nv))
    got = tmodem.demodulate_soft(scheme, torch.as_tensor(x))
    assert got.shape == (400, tmodem.bits_per_symbol(scheme))


# per-row schemes of one batch: every family at tables of 64 and 256
# entries (the batch gate of decode_payload_batch_soft), DPSK included
TABLE_MODS = {
    64: ["bpsk", "qpsk", "psk8", "qam16", "qam64", "dpsk4", "apsk32",
         "ask8", "v29"],
    256: ["qam256", "psk256", "apsk128", "dpsk256", "qpsk", "arb256opt",
          "sqam128", "ask256"],
}


@pytest.mark.parametrize("n_table", [64, 256])
def test_generic_demod_soft_matches_jax(n_table):
    names = TABLE_MODS[n_table]
    mods = np.array([tmodem.mod_from_name(m) for m in names], np.int32)
    rng = _rng(f"generic_demod_soft {n_table}")
    n = 257
    # constellation points with noise, so every bit has a clear sign
    x = np.stack([np.asarray(jmodem.modulate(int(m), jnp.asarray(
        rng.integers(0, 1 << jmodem.bits_per_symbol(int(m)), n))))
        for m in mods]).astype(np.complex64) + _noisy(rng, (len(mods), n),
                                                       0.03)
    for max_bits in (n * 3, n * 8 + 40):     # within and past the stream
        want = jax.jit(jax.vmap(lambda xx, mm: jpc.generic_demod_soft(
            xx, mm, max_bits, n_table=n_table)))(jnp.asarray(x),
                                                 jnp.asarray(mods))
        got = tpc.generic_demod_soft(torch.as_tensor(x),
                                     torch.as_tensor(mods), max_bits,
                                     n_table)
        _llr_close(got, want)
    # the soft decisions are the hard demapper's bits
    bits, _ = tpc.generic_demod_bits(torch.as_tensor(x),
                                     torch.as_tensor(mods), n * 3, n_table)
    np.testing.assert_array_equal((got[:, :n * 3] > 0).numpy(),
                                  bits.numpy().astype(bool))


def _golay_words(rng, n, sigma):
    c = jfec._block_code(jfec.FEC_GOLAY2412)
    msg = rng.integers(0, 2, (n, 12)).astype(np.uint8)
    cw = (msg @ c.G) % 2
    clean = (2.0 * cw - 1.0).astype(np.float32)
    return c, msg, clean, (clean + sigma * rng.standard_normal(cw.shape)
                           ).astype(np.float32)


def test_golay_decode_soft_matches_jax_and_beats_hard():
    """Clean LLRs decode to the message, equal to JAX; noisy ones equal
    JAX's except near-ties; ML beats the hard syndrome decoder by at least
    5 word errors in 60 (``tests/test_fec.py``)."""
    rng = _rng("golay soft")
    c, msg, clean, L = _golay_words(rng, 60, 0.9)
    got = tfec.golay_decode_soft(torch.as_tensor(clean)).numpy()
    np.testing.assert_array_equal(got, msg)
    np.testing.assert_array_equal(
        got, np.asarray(jfec.golay_decode_soft(jnp.asarray(clean))))
    soft = tfec.golay_decode_soft(torch.as_tensor(L)).numpy()
    np.testing.assert_array_equal(
        soft, np.asarray(jfec.golay_decode_soft(jnp.asarray(L))))
    hard_bits = (L > 0).astype(np.uint8)
    syn = (hard_bits @ c.H.T) % 2
    s_idx = (syn * (1 << np.arange(11, -1, -1))).sum(1)
    hard = (hard_bits ^ c.syn_table[s_idx])[:, :12]
    errs_soft = int((soft != msg).any(1).sum())
    errs_hard = int((hard != msg).any(1).sum())
    assert errs_soft <= errs_hard - 5, (errs_soft, errs_hard)


def test_golay_decode_soft_near_ties_only_differ():
    """4,096 noisy blocks with a leading batch axis: equal to JAX except
    near-ties, whose count stays small."""
    rng = _rng("golay near ties")
    _, _, _, L = _golay_words(rng, 4096, 1.2)
    L = L.reshape(64, 64, 24)
    got = tfec.golay_decode_soft(torch.as_tensor(L)).numpy()
    want = np.asarray(jfec.golay_decode_soft(jnp.asarray(L)))
    assert got.shape == (64, 64, 12)
    top2 = torch.topk(tfec._golay_scores(torch.as_tensor(L)), 2).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    tie = gap <= NEAR_TIE * np.maximum(np.abs(top2[..., 0].numpy()), 1.0)
    differ = (got != want).any(-1)
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert int(tie.sum()) <= 8, int(tie.sum())


class _Props:
    mod, fec0, fec1, check = 3, 1, 2, jcrc.CRC_32


def test_decode_header_soft_matches_hard_and_jax():
    """Clean: every field equals the hard decoder's.  25 noisy trials: the
    fields equal JAX's, and soft decodes at least 5 more headers than hard
    (``tests/test_payload_codec.py``)."""
    rng = _rng("header soft")
    hdr = rng.integers(0, 256, 8, dtype=np.uint8)
    henc = np.asarray(jpc.encode_header(jnp.asarray(hdr), 77, _Props))
    bits = np.unpackbits(henc)
    pts = np.asarray(jmodem.modulate(
        jmodem.MOD_BPSK, jnp.asarray(bits.astype(np.int32))))
    bpsk = torch.tensor([tmodem.MOD_BPSK], dtype=torch.int32)
    nb = tpc.HEADER_ENC_BYTES * 8
    llr = tpc.generic_demod_soft(torch.as_tensor(pts[None].copy()), bpsk, nb)
    got = tpc.decode_header_soft(llr[0], 100)
    want = tpc.decode_header(tpc.header_bits_to_bytes(
        torch.as_tensor(bits)), 100)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert bool(got[-1]) and int(got[1]) == 77 and int(got[2]) == 3

    noisy = np.stack([
        (pts + 0.85 * (np.random.default_rng(t).standard_normal(len(pts)) +
                       1j * np.random.default_rng(t + 100)
                       .standard_normal(len(pts)))).astype(np.complex64)
        for t in range(25)])
    llrs = tpc.generic_demod_soft(torch.as_tensor(noisy),
                                  bpsk.expand(25), nb)
    got = tpc.decode_header_soft(llrs, 100)
    # the synchronizers' form: a 16-entry table, the same fields
    for g, w in zip(tpc.decode_header_points_soft(torch.as_tensor(noisy),
                                                  100), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    want = jax.jit(jax.vmap(lambda x: jpc.decode_header_soft(
        jpc.generic_demod_soft(x, jnp.int32(jmodem.MOD_BPSK), nb), 100)))(
        jnp.asarray(noisy))
    for f, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"field {f}")
    hs = tmodem.demodulate(tmodem.MOD_BPSK, torch.as_tensor(noisy))
    ok_h = int(tpc.decode_header(tpc.header_bits_to_bytes(
        hs.to(torch.uint8)), 100)[-1].sum())
    ok_s = int(got[-1].sum())
    assert ok_s >= ok_h + 5, (ok_h, ok_s)


# --- the full FEC matrix (tests/test_payload_codec.py) ----------------------

PLEN = 32
EXPANSION = 12         # rep5 inner x golay outer = 10x
ENC_MAX = EXPANSION * (PLEN + 4)
N_PTS = ENC_MAX * 8 + 1
INVALID_ROWS = (3, 8)  # header-invalid rows: payload not compared


def _matrix():
    mods = [jmodem.MOD_BPSK, jmodem.MOD_QPSK, jmodem.MOD_QAM16]
    combos = []
    for i, f0 in enumerate(jpc.PAYLOAD_FECS_FULL):
        for f1 in (jfec.FEC_NONE, jfec.FEC_HAMMING128):
            combos.append(jofdm.FrameProps(
                check=(jcrc.CRC_16, jcrc.CRC_32)[i % 2], fec0=f0, fec1=f1,
                mod=mods[i % len(mods)]))
    return combos


def _points(props, payload):
    enc = jpc.encode_payload(props, jnp.asarray(payload))
    bps = jmodem.bits_per_symbol(props.mod)
    pbits = junpack(enc)
    pad = -(-pbits.shape[-1] // bps) * bps - pbits.shape[-1]
    if pad:
        pbits = jnp.concatenate([pbits, jnp.zeros(pad, dtype=pbits.dtype)])
    return np.asarray(jmodem.modulate(props.mod,
                                      jmodem.bits_to_symbols(pbits, bps)))


@pytest.fixture(scope="module")
def fec_matrix():
    """The matrix's points (mild noise, so the conv rows take their true
    LLR path), its per-row fields, the payloads and JAX's decode."""
    combos = _matrix()
    rng = _rng("soft fec matrix")
    pays = [rng.integers(0, 256, PLEN, dtype=np.uint8) for _ in combos]
    K = len(combos)
    P = np.zeros((K, N_PTS), np.complex64)
    for r, (props, pay) in enumerate(zip(combos, pays)):
        x = _points(props, pay)
        P[r, :len(x)] = x + _noisy(rng, x.shape, 0.02)
    hv = np.ones(K, bool)
    hv[list(INVALID_ROWS)] = False
    fields = [np.asarray([getattr(p, f) for p in combos], np.int32)
              for f in ("mod", "fec0", "fec1", "check")]
    fields.append(np.full(K, PLEN, np.int32))
    decode = jax.jit(jpc.decode_payload_batch_soft, static_argnums=(0, 1, 2),
                     static_argnames=("fecs",))
    pay, valid = decode(
        ENC_MAX, PLEN + 4, PLEN, jnp.asarray(P),
        *[jnp.asarray(v) for v in fields], jnp.asarray(hv),
        fecs=jpc.PAYLOAD_FECS_FULL)
    return combos, pays, P, fields, hv, (np.asarray(pay), np.asarray(valid))


def test_decode_payload_batch_soft_full_matrix(fec_matrix):
    """Every FEC pair (fec1 none and Hamming(12,8), so the inner conv rows
    decode both channel LLRs and pseudo-LLRs) decodes its payload, equal
    to JAX on every row; header-invalid rows are invalid in both."""
    combos, pays, P, fields, hv, (jpay, jvalid) = fec_matrix
    pay, valid = tpc.decode_payload_batch_soft(
        ENC_MAX, PLEN + 4, PLEN, torch.as_tensor(P),
        *[torch.as_tensor(v) for v in fields], torch.as_tensor(hv),
        fecs=tpc.PAYLOAD_FECS_FULL)
    pay, valid = pay.numpy(), valid.numpy()
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(pay, jpay)
    for r, (props, sent) in enumerate(zip(combos, pays)):
        name = (f"{jfec.fec_name(props.fec0)}+"
                f"{jfec.fec_name(props.fec1)}")
        assert bool(valid[r]) == bool(hv[r]), name
        if hv[r]:
            np.testing.assert_array_equal(pay[r], sent, err_msg=name)


def test_fec_batch_soft_rows_take_llrs_or_pseudo_llrs(fec_matrix):
    """The conv rows of ``_fec_batch`` with channel LLRs: a row whose
    ``llr_ok`` is False decodes its hard bytes exactly as the hard
    Viterbi does, and the v27 rows' soft decode of their channel LLRs
    gives their payloads (past a frame's own bytes its LLRs are zeros,
    erasures, where the hard bytes are zeros)."""
    combos, pays, P, fields, hv, _ = fec_matrix
    mod = torch.as_tensor(fields[0])
    llrs = tpc.generic_demod_soft(torch.as_tensor(P), mod, ENC_MAX * 8, 64)
    enc = tpc.scramble(tpc.pack_bits((llrs > 0).to(torch.uint8)), salt=2)
    desc = llrs * torch.as_tensor(tpc._pn_signs(ENC_MAX, 2))
    f1 = torch.as_tensor(fields[2])
    v27 = list(tpc.PAYLOAD_FECS_FULL).index(tfec.FEC_CONV_V27)
    ids = torch.full_like(f1, v27)
    hard = tpc._fec_batch(ids, enc, PLEN + 4, tpc.PAYLOAD_FECS_FULL)
    pseudo = tpc._fec_batch(ids, enc, PLEN + 4, tpc.PAYLOAD_FECS_FULL,
                            llrs=desc, llr_ok=torch.zeros_like(f1,
                                                               dtype=bool))
    np.testing.assert_array_equal(pseudo.numpy(), hard.numpy())
    soft = tpc._fec_batch(ids, enc, PLEN + 4, tpc.PAYLOAD_FECS_FULL,
                          llrs=desc)
    rows = [r for r, p in enumerate(combos)
            if p.fec0 == tfec.FEC_CONV_V27 and p.fec1 == tfec.FEC_NONE]
    assert rows
    for r in rows:
        np.testing.assert_array_equal(soft[r, :PLEN].numpy(), pays[r])
