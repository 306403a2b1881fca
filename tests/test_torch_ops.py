"""Parity of the PyTorch port's ops layer with the JAX package.

Inputs come from seeded NumPy generators and run through the JAX function
and its port counterpart on the CPU.  Tolerances, stated per test: bits,
CRC, FEC, modem tables and hard decisions, filter-design tables and NCO
phase state are exact; NCO output atol 1e-6; PFB max abs error <= 1e-5 of
the peak.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.ops import corr as jcorr
from liquid_usrp_tpu.ops import crc as jcrc
from liquid_usrp_tpu.ops import fec as jfec
from liquid_usrp_tpu.ops import filter_design as jfd
from liquid_usrp_tpu.ops import iqfmt as jiq
from liquid_usrp_tpu.ops import modem as jmodem
from liquid_usrp_tpu.ops import nco as jnco
from liquid_usrp_tpu.ops import pfb as jpfb
from liquid_usrp_tpu.utils import bits as jbits
from liquid_usrp_tpu_torch.ops import corr as tcorr
from liquid_usrp_tpu_torch.ops import crc as tcrc
from liquid_usrp_tpu_torch.ops import fec as tfec
from liquid_usrp_tpu_torch.ops import filter_design as tfd
from liquid_usrp_tpu_torch.ops import iqfmt as tiq
from liquid_usrp_tpu_torch.ops import modem as tmodem
from liquid_usrp_tpu_torch.ops import nco as tnco
from liquid_usrp_tpu_torch.ops import pfb as tpfb
from liquid_usrp_tpu_torch.utils import bits as tbits

BLOCK_FECS = [tfec.FEC_NONE, tfec.FEC_REP3, tfec.FEC_REP5,
              tfec.FEC_HAMMING74, tfec.FEC_HAMMING84, tfec.FEC_HAMMING128,
              tfec.FEC_GOLAY2412, tfec.FEC_SECDED2216, tfec.FEC_SECDED3932,
              tfec.FEC_SECDED7264]


def _t(a):
    return torch.as_tensor(np.array(a))


def test_bits_exact():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (3, 17), dtype=np.uint8)
    bits = np.asarray(jbits.unpack_bits(jnp.asarray(data)))
    np.testing.assert_array_equal(tbits.unpack_bits(_t(data)).numpy(), bits)
    np.testing.assert_array_equal(tbits.pack_bits(_t(bits)).numpy(), data)
    a = rng.integers(0, 2, (5, 40), dtype=np.uint8)
    b = rng.integers(0, 2, (40, 9), dtype=np.uint8)
    np.testing.assert_array_equal(
        tbits.gf2_matmul(_t(a), _t(b)).numpy(),
        np.asarray(jbits.gf2_matmul(jnp.asarray(a), jnp.asarray(b))))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("scheme", [tcrc.CRC_16, tcrc.CRC_32])
def test_crc_exact(scheme):
    for a, b in zip(tcrc._build_tables(scheme), jcrc._build_tables(scheme)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(scheme)
    for n in (1, 7, 64):
        data = rng.integers(0, 256, (4, n), dtype=np.uint8)
        got = tcrc.crc_compute(scheme, _t(data)).numpy()
        want = np.asarray(jcrc.crc_compute(scheme, jnp.asarray(data)))
        np.testing.assert_array_equal(got, want.astype(np.int64))
        assert int(got[0]) == tcrc.np_crc(scheme, bytes(data[0]))
        framed = tcrc.crc_append(scheme, _t(data))
        np.testing.assert_array_equal(
            framed.numpy(),
            np.asarray(jcrc.crc_append(scheme, jnp.asarray(data))))
        assert bool(tcrc.crc_check(scheme, framed).all())
    buf = rng.integers(0, 256, (6, 40), dtype=np.uint8)
    lens = np.array([0, 1, 5, 17, 39, 40])
    got = tcrc.crc_compute_masked(scheme, _t(buf), _t(lens)).numpy()
    for i, n in enumerate(lens):
        want = jcrc.crc_compute_masked(scheme, jnp.asarray(buf[i]),
                                       jnp.int32(n))
        assert int(got[i]) == int(want)


@pytest.mark.parametrize("scheme", BLOCK_FECS)
def test_fec_exact(scheme):
    if scheme not in (tfec.FEC_NONE, tfec.FEC_REP3, tfec.FEC_REP5):
        tc, jc = tfec._block_code(scheme), jfec._block_code(scheme)
        for name in ("G", "H", "syn_table"):
            np.testing.assert_array_equal(getattr(tc, name),
                                          getattr(jc, name))
    rng = np.random.default_rng(scheme + 10)
    n = 23
    assert tfec.encoded_length(scheme, n) == jfec.encoded_length(scheme, n)
    data = rng.integers(0, 256, (3, n), dtype=np.uint8)
    enc = tfec.fec_encode(scheme, _t(data)).numpy()
    np.testing.assert_array_equal(
        enc, np.asarray(jfec.fec_encode(scheme, jnp.asarray(data))))
    # a few flipped bits per row: decodes must agree bit for bit
    flips = np.zeros_like(enc)
    for r in range(3):
        for _ in range(r + 1):
            flips[r, rng.integers(enc.shape[1])] ^= np.uint8(
                1 << int(rng.integers(8)))
    noisy = enc ^ flips
    got = tfec.fec_decode(scheme, _t(noisy), n).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfec.fec_decode(scheme, jnp.asarray(noisy), n)))
    np.testing.assert_array_equal(
        tfec.fec_decode(scheme, _t(enc), n).numpy(), data)


def test_modem_tables_and_decisions_exact():
    rng = np.random.default_rng(3)
    for s in range(50):
        np.testing.assert_array_equal(tmodem._table_np(s),
                                      jmodem._table_np(s))
        assert tmodem.bits_per_symbol(s) == jmodem.bits_per_symbol(s)
        assert tmodem.mod_name(s) == jmodem.mod_name(s)
        assert tmodem.is_differential(s) == jmodem.is_differential(s)
    for s in (tmodem.MOD_BPSK, tmodem.MOD_QPSK, tmodem.MOD_QAM16,
              tmodem.MOD_APSK32, tmodem.MOD_QAM256):
        bps = tmodem.bits_per_symbol(s)
        sym = rng.integers(0, 1 << bps, 300)
        pts = tmodem.modulate(s, _t(sym))
        np.testing.assert_array_equal(
            pts.numpy(), np.asarray(jmodem.modulate(s, jnp.asarray(sym))))
        x = (pts.numpy() + 0.08 * (rng.normal(size=300) +
                                   1j * rng.normal(size=300))
             ).astype(np.complex64)
        dec = tmodem.demodulate(s, _t(x)).numpy()
        np.testing.assert_array_equal(
            dec, np.asarray(jmodem.demodulate(s, jnp.asarray(x))))
        np.testing.assert_array_equal(
            tmodem.symbols_to_bits(_t(dec), bps).numpy(),
            np.asarray(jmodem.symbols_to_bits(jnp.asarray(dec), bps)))
        np.testing.assert_allclose(
            float(tmodem.evm(s, _t(x), _t(dec))),
            float(jmodem.evm(s, jnp.asarray(x), jnp.asarray(dec))),
            atol=1e-4)


def test_filter_design_exact():
    for M, m in ((8, 7), (8, 13), (16, 7)):
        np.testing.assert_array_equal(
            tfd.pfb_channelizer_prototype(M, m, 60.0),
            jfd.pfb_channelizer_prototype(M, m, 60.0))
    np.testing.assert_array_equal(tpfb.pfbch_create(8, 7).h_pol,
                                  jpfb.pfbch_create(8, 7).h_pol)


def test_nco_phase_exact_output_close():
    """Phase state exact over three blocks; output atol 1e-6."""
    rng = np.random.default_rng(4)
    f = -0.5 * 3 / 4 * np.pi
    assert tnco.freq_to_u32(f) == int(jnco.freq_to_u32(f))
    ts, js = tnco.nco_init(f, 0.3, device="cpu"), jnco.nco_init(f, 0.3)
    for n in (1000, 4096, 777):
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
            np.complex64)
        ts, ty = tnco.nco_mix_block(ts, _t(x), up=True)
        js, jy = jnco.nco_mix_block(js, jnp.asarray(x), up=True)
        assert int(ts.phase) == int(js.phase)
        assert int(ts.freq) == int(js.freq)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    ph_t, _ = tnco.nco_phase_ramp(ts, 5000)
    ph_j, _ = jnco.nco_phase_ramp(js, 5000)
    np.testing.assert_array_equal(ph_t.numpy(), np.asarray(ph_j))


@pytest.mark.parametrize("direction", ["analyze", "synthesize"])
def test_pfb_block_chopping(direction):
    """Three differently-chopped blocks (mirrors tests/test_pfb.py):
    max abs error <= 1e-5 of the peak."""
    M = 8
    m = 7 if direction == "analyze" else 13
    tch, jch = tpfb.pfbch_create(M, m), jpfb.pfbch_create(M, m)
    rng = np.random.default_rng(5)
    ts, js = tpfb.pfbch_state(tch, "cpu"), jpfb.pfbch_state(jch)
    for n_frames in (40, 8, 23):
        if direction == "analyze":
            x = (rng.normal(size=n_frames * M) +
                 1j * rng.normal(size=n_frames * M)).astype(np.complex64)
            ts, ty = tpfb.pfb_analyze_block(tch, ts, _t(x))
            js, jy = jpfb.pfb_analyze_block(jch, js, jnp.asarray(x))
        else:
            x = (rng.normal(size=(n_frames, M)) +
                 1j * rng.normal(size=(n_frames, M))).astype(np.complex64)
            ts, ty = tpfb.pfb_synthesize_block(tch, ts, _t(x))
            js, jy = jpfb.pfb_synthesize_block(jch, js, jnp.asarray(x))
        jy = np.asarray(jy)
        assert np.abs(ty.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
        np.testing.assert_allclose(ts.frames.numpy(), np.asarray(js.frames),
                                   atol=1e-5 * np.abs(jy).max())


def test_iq_from_any_exact():
    rng = np.random.default_rng(6)
    x = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    sc8 = np.clip(np.round(planes * 40), -127, 127).astype(np.int8)
    sc16 = np.clip(np.round(planes * 9000), -32767, 32767).astype(np.int16)
    for a in (x, planes, sc8, sc16):
        np.testing.assert_array_equal(
            tiq.iq_from_any(_t(a)).numpy(),
            np.asarray(jiq.iq_from_any(jnp.asarray(a))))
    bf = _t(planes).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tiq.iq_from_any(bf).numpy(),
        np.asarray(jiq.iq_from_any(jnp.asarray(planes).astype(
            jnp.bfloat16))))
    with pytest.raises(ValueError):
        tiq.iq_from_any(_t(planes.astype(np.int32)))


@pytest.mark.parametrize("n,radius", [(300, 5), (1000, 48)])
def test_sliding_max_and_topk_exact(n, radius):
    rng = np.random.default_rng(n)
    x = rng.random(n).astype(np.float32)
    np.testing.assert_array_equal(
        tcorr.sliding_max(_t(x), radius).numpy(),
        np.asarray(jcorr.sliding_max(jnp.asarray(x), radius)))
    from liquid_usrp_tpu.framing.ofdm_sync import topk_peaks
    score = np.where(rng.random(n) < 0.05, x, -1.0).astype(np.float32)
    tv, tl = tcorr.topk_peaks(_t(score), 4, 2 * radius + 1)
    jv, jl = topk_peaks(jnp.asarray(score), 4, 2 * radius + 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy()[tv.numpy() > 0],
                                  np.asarray(jl)[np.asarray(jv) > 0])
    np.testing.assert_array_equal(
        tcorr.comb_rev_freq_np(x[:24].astype(np.complex64), 1, 256),
        jcorr.comb_rev_freq_np(x[:24].astype(np.complex64), 1, 256))


def test_port_imports_no_jax():
    """The port and every submodule import with jax made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import liquid_usrp_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'liquid_usrp_tpu' or "
        "k.startswith('liquid_usrp_tpu.') for k in sys.modules)\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
