"""The benchmark's generator: golden outputs at each seed, the same frame
plan for every seed, and the frame format's arithmetic."""
import hashlib

import numpy as np
import pytest

from rxbench import txgen
from rxbench.tests.conftest import tiny_cell

# (cell, seed): (sha256 of the truth's bytes and the carrier offsets, IQ
# samples a loop, sum of the real parts, total energy) on the CPU
GOLDEN = {
    ("mcrx4.loaded", 5): ("299940c3a07148b8", 196608, 84.87033522184834,
                          430722.4312274133),
    ("mcrx4.loaded", 2147483655): ("03b7b7d525efae6d", 196608,
                                   69.97659581199787, 431370.96495727723),
    ("mcrx4.burst", 5): ("c4a21be1e0d87fbf", 294912, 106.38578074164025,
                         209593.2862932991),
    ("mcrx4.burst", 2147483655): ("bce7eaae36857772", 294912,
                                  55.72125958656329, 209810.04540128406),
    ("ofdm1_conv.v27", 5): ("fbdbc5903f49ffbc", 32768, -9.998191311936125,
                            1099.412451927384),
    ("ofdm1_conv.v27", 2147483655): ("e8b3a165c3b143bc", 32768,
                                     13.21904119840849, 1098.463982907801),
    ("ofdm1_conv.golay", 5): ("fbdbc5903f49ffbc", 32768, 5.466324030030137,
                              1090.2485355574245),
    ("ofdm1_conv.golay", 2147483655): ("e8b3a165c3b143bc", 32768,
                                       11.40029441013732,
                                       1092.1029167329132),
}


@pytest.mark.parametrize("name,seed", sorted(GOLDEN))
def test_generator_matches_its_golden_output(name, seed):
    cell = tiny_cell(name)
    s = txgen.make_stream(cell["config"], cell["traffic"], seed, "cpu")
    h = hashlib.sha256()
    for k in ("channel", "start", "header", "payload"):
        h.update(np.ascontiguousarray(s.frames[k]).tobytes())
    h.update(np.asarray(s.cfo).tobytes())
    x = np.concatenate(s.chunks)
    digest, n, re_sum, energy = GOLDEN[(name, seed)]
    assert h.hexdigest()[:16] == digest
    assert len(x) == n
    assert float(np.sum(x.real.astype(np.float64))) == pytest.approx(
        re_sum, rel=1e-5, abs=1e-3)
    assert float(np.sum(np.abs(x.astype(np.complex128)) ** 2)) == \
        pytest.approx(energy, rel=1e-6)


@pytest.mark.parametrize("name", ["mcrx4.loaded", "ofdm1_conv.v27"])
def test_every_seed_gets_the_same_frame_plan(name):
    cell = tiny_cell(name)
    a = txgen.make_stream(cell["config"], cell["traffic"], 1, "cpu")
    b = txgen.make_stream(cell["config"], cell["traffic"], 2, "cpu")
    assert np.array_equal(a.frames["start"], b.frames["start"])
    assert np.array_equal(a.frames["channel"], b.frames["channel"])
    assert not np.array_equal(a.frames["payload"], b.frames["payload"])
    assert [len(c) for c in a.chunks] == [len(c) for c in b.chunks]


def test_the_loop_ends_in_silence_longer_than_the_receivers_overlap():
    cell = tiny_cell("mcrx4.loaded")
    c, t = cell["config"], cell["traffic"]
    p = txgen.ofdm_params(c["M"], c["cp_len"], c["taper_len"])
    props = txgen.Props(txgen.CRC_32, txgen.FEC_NONE, txgen.FEC_HAMMING128,
                        txgen.MOD_QPSK)
    flen = txgen.frame_length(p, props, t["payload_len"])
    starts = txgen.frame_start_plan(c, t)
    loop = c["chunk_samples"] // (2 * c["num_channels"]) * t["loop_chunks"]
    assert loop - (starts[-1] + flen) > txgen.receiver_overlap(c)


def test_codes_and_crcs():
    # CRC-16/ARC and CRC-32 check values of "123456789"
    msg = np.frombuffer(b"123456789", np.uint8)[None]
    assert txgen._crc16_arc(msg.tobytes()) == 0xBB3D
    assert list(txgen.crc_append(txgen.CRC_32, msg)[0, -4:]) == \
        [0xCB, 0xF4, 0x39, 0x26]
    # the receiver's (24,12) header and payload code, as its tables build
    # it: its least codeword weight is 7 (the extended Golay code's is 8),
    # so it still corrects every pattern of 3 errors
    G = txgen._generator(txgen.FEC_GOLAY2412)
    msgs = (np.arange(1, 4096)[:, None] >> np.arange(11, -1, -1)) & 1
    assert ((msgs @ G) % 2).sum(-1).min() == 7
    # v27 of a single 1 bit: the two polynomials' impulse responses
    bits = np.unpackbits(txgen.fec_encode(
        txgen.FEC_CONV_V27, np.array([[0x80]], np.uint8))[0])
    for r, g in enumerate((0o171, 0o133)):
        assert list(bits[r:14:2]) == [(g >> (6 - t)) & 1 for t in range(7)]
    assert txgen.encoded_length(txgen.FEC_CONV_V27, 1204) == 2410
    assert txgen.encoded_length(txgen.FEC_HAMMING128, 404) == 606


def test_filterbank_delay():
    assert txgen.pfb_delay(8, 13, 7) == 19
