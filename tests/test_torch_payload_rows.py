"""Payload bytes of header-invalid rows against the JAX package.

JAX's ``_fec_batch`` decodes every candidate row with every scheme and
picks by the row's (clipped) scheme id, whether the row's header is valid
or not; a failed header's garbage id clips onto a real scheme, often the
last one (RS8).  The port decodes the convolutional and RS schemes only for
the rows that carry them, and must give those rows JAX's bytes too:

* ``decode_payload_batch`` and ``decode_payload_batch_soft`` on candidates
  whose headers failed, with fec0 ids of v27, v29 and RS8 (fec1 none and
  Hamming(12,8), so the soft path's inner stage takes both its channel
  LLRs and its pseudo-LLRs), beside header-valid rows: every row's payload
  bytes and flags equal JAX's;
* the sweep's score (``apps/ber_sweep.py::score``) on JAX's own noisy GMSK
  v27 stream at -2 dB, where some matched detections fail their header:
  its bit-error count equals the JAX script's receive loop's;
* a receiver decodes the conv/RS schemes only for its detected candidates
  (``rows``): on a clean GMSK v27 stream the empty slots, whose noise ids
  clip mostly to RS8, start no RS8 decode, and v27 decodes one row a
  detection.

Tolerances: none, bytes and counts exact.  Inputs come from numpy seeded
with ``zlib.crc32`` of the case's name.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ber_ref as ref
from liquid_usrp_tpu.framing import payload as jpc
from liquid_usrp_tpu.ops import fec as jfec
from liquid_usrp_tpu.ops import modem as jmodem
from liquid_usrp_tpu_torch.apps import ber_sweep as bs
from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.framing import payload as tpc

PLEN = 32
ENC_MAX = 6 * (PLEN + 4)
N_PTS = ENC_MAX * 8 + 1
FECS = tpc.PAYLOAD_FECS_FULL
HEAVY = [list(FECS).index(s) for s in
         (jfec.FEC_CONV_V27, jfec.FEC_CONV_V29, jfec.FEC_RS8)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _candidates():
    """Rows of (mod, fec0, fec1, check, plen, hvalid) and their noisy
    points: each heavy fec0 with fec1 none and Hamming(12,8), a header-
    valid and a header-invalid row of each, the invalid rows' points from
    a payload of another length (what a failed header leaves: the frame's
    own points under wrong fields)."""
    rng = _rng("payload rows")
    mods = (jmodem.MOD_BPSK, jmodem.MOD_QPSK)
    rows, pts = [], []
    for i, f0 in enumerate(HEAVY):
        for f1 in (jfec.FEC_NONE, jfec.FEC_HAMMING128):
            for hv in (True, False):
                props = tofdm.FrameProps(check=1 + i % 2, fec0=FECS[f0],
                                         fec1=f1, mod=mods[len(rows) % 2])
                n = PLEN if hv else PLEN - 5
                enc = tpc.encode_payload(props, torch.as_tensor(
                    rng.integers(0, 256, n, dtype=np.uint8))).numpy()
                bps = jmodem.bits_per_symbol(props.mod)
                bits = np.unpackbits(enc)
                bits = np.concatenate([bits,
                                       np.zeros(-len(bits) % bps, np.uint8)])
                sy = bits.reshape(-1, bps) @ (1 << np.arange(bps)[::-1])
                x = np.zeros(N_PTS, np.complex64)
                x[:len(sy)] = np.asarray(jmodem.modulate(
                    props.mod, jnp.asarray(sy, jnp.int32)))
                x += (0.35 * (rng.normal(size=N_PTS) + 1j *
                              rng.normal(size=N_PTS))).astype(np.complex64)
                pts.append(x)
                rows.append((props.mod, f0, f1, props.check, PLEN, hv))
    cols = [np.asarray(c) for c in zip(*rows)]
    return np.stack(pts), [c.astype(np.int32) for c in cols[:5]], \
        cols[5].astype(bool)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_header_invalid_conv_rs_rows_match_jax(soft):
    P, fields, hv = _candidates()
    assert not hv.all() and hv.any()
    jfn = jpc.decode_payload_batch_soft if soft else jpc.decode_payload_batch
    decode = jax.jit(jfn, static_argnums=(0, 1, 2), static_argnames=("fecs",))
    jpay, jvalid = decode(ENC_MAX, PLEN + 4, PLEN, jnp.asarray(P),
                          *[jnp.asarray(v) for v in fields], jnp.asarray(hv),
                          fecs=FECS)
    tfn = tpc.decode_payload_batch_soft if soft else \
        tpc.decode_payload_batch
    pay, valid = tfn(ENC_MAX, PLEN + 4, PLEN, torch.as_tensor(P),
                     *[torch.as_tensor(v) for v in fields],
                     torch.as_tensor(hv), fecs=FECS)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    # the invalid rows carry decoded bytes, not zeros
    assert pay.numpy()[~hv].any(axis=-1).all()


def test_sweep_bit_errors_equal_jax_where_headers_fail():
    """GMSK, fec0 v27, fec1 none, hard decisions, 12 frames of JAX's
    stream with JAX's channel at -2 dB (``docs/ber_gmsk_v27_hard.json``:
    85 header errors in 200 frames there)."""
    frames, payload_len, snr = 12, 200, -2.0
    sync, step, init, assemble = ref.config("gmsk", payload_len, "v27",
                                            "none")
    x, positions, payloads, _, sig_pwr = ref.stream(
        sync, assemble, frames, payload_len,
        zlib.crc32(b"gmsk v27 header-invalid rows"))
    y = ref.noisy(x, sig_pwr, snr)
    row_j, _, errs_j = ref.point(sync, step, init, y, positions, payloads,
                                 payload_len, snr)
    cfg = bs.make_config("gmsk", payload_len, "v27", "none")
    sc = bs.score(bs.receive(cfg, torch.as_tensor(y)), positions, payloads,
                  payload_len)
    got = bs.row(sc, snr)
    assert row_j["header_errors"] > 0
    assert got["frames_detected"] == row_j["frames_detected"]
    assert got["header_errors"] == row_j["header_errors"]
    np.testing.assert_array_equal(sc.frame_errs, errs_j)
    assert sc.bit_errs == int(errs_j[errs_j >= 0].sum())


def test_receiver_decodes_conv_rs_rows_of_its_detections_only(monkeypatch):
    """GMSK, fec0 v27, fec1 none, 6 frames of JAX's stream at 10 dB: every
    frame payload-valid and every detection's header valid, no RS8 row
    decoded, and v27 decoded for as many rows as there were detections."""
    frames, payload_len = 6, 200
    sync, _, _, assemble = ref.config("gmsk", payload_len, "v27", "none")
    x, positions, payloads, _, sig_pwr = ref.stream(
        sync, assemble, frames, payload_len,
        zlib.crc32(b"gmsk v27 detected rows"))
    y = ref.noisy(x, sig_pwr, 10.0)
    decoded = {}
    fit = tpc._decode_fit

    def counted(s, bufs, out_bytes):
        if tpc._is_heavy(s):
            decoded[s] = decoded.get(s, 0) + bufs.shape[0]
        return fit(s, bufs, out_bytes)
    monkeypatch.setattr(tpc, "_decode_fit", counted)
    cfg = bs.make_config("gmsk", payload_len, "v27", "none")
    sc = bs.score(bs.receive(cfg, torch.as_tensor(y)), positions, payloads,
                  payload_len)
    assert sc.packets_ok == frames and sc.header_ok == sc.detected
    assert decoded == {jfec.FEC_CONV_V27: sc.detected}
