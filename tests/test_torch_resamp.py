"""The port's FIR/resampler layer, phase tracker, comb moving sum and
channel sample-rate offset against the JAX package.

Tolerances: filter designs exact; ``fir_block``, ``firinterp_block``,
``firdecim_block``, ``resamp_block`` and ``msresamp_block`` within 1e-5 of
max |y| (float32 rounding: the port filters with ``conv1d`` and a float32
matmul, JAX with ``jnp.convolve`` and a complex matmul), with ``count``
and the carried timing (``i0``, ``num0``) equal and the carried delay lines
exact (to 1e-5 where they hold a half-band stage's output); block-size invariance of the port to 1e-6 of max |y|;
``track_phase_bpsk`` within 1e-5 rad; ``comb_moving_sum`` within 1e-5 of
its max (both sum in float32, in different orders); ``channel_apply`` with
a sample-rate offset (noise off) within 1e-5 of max |y|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.apps import common as japps
from liquid_usrp_tpu.framing import phase_track as jpt
from liquid_usrp_tpu.io import channel_model as jchan
from liquid_usrp_tpu.ops import corr as jcorr
from liquid_usrp_tpu.ops import filter_design as jfd
from liquid_usrp_tpu.ops import fir as jfir
from liquid_usrp_tpu.ops import resamp as jrs
from liquid_usrp_tpu_torch.apps import common as tapps
from liquid_usrp_tpu_torch.framing import phase_track as tpt
from liquid_usrp_tpu_torch.io import channel_model as tchan
from liquid_usrp_tpu_torch.ops import corr as tcorr
from liquid_usrp_tpu_torch.ops import filter_design as tfd
from liquid_usrp_tpu_torch.ops import fir as tfir
from liquid_usrp_tpu_torch.ops import resamp as trs
from liquid_usrp_tpu_torch.utils.checkpoint import load_state, save_state
from liquid_usrp_tpu_torch.utils.convert import from_jax_tree, to_numpy_tree

RATES = (0.5003, 0.5, 1.33, 2.0, 3.7)


def _iq(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64)


def _close(got, want, tol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("k,m,beta", [(2, 7, 0.3), (4, 3, 0.5), (2, 4, 0.25),
                                      (3, 5, 0.0)])
def test_filter_designs_equal_jax(k, m, beta):
    np.testing.assert_array_equal(tfd.rrcos(k, m, beta),
                                  jfd.rrcos(k, m, beta))
    np.testing.assert_array_equal(tfd.halfband_kaiser(m, 40.0 + 5 * k),
                                  jfd.halfband_kaiser(m, 40.0 + 5 * k))


def test_fir_blocks_match_jax_and_are_block_invariant():
    x = _iq(3000, 1)
    taps = (jfd.firdes_kaiser(31, 0.2, 60.0)).astype(np.float32)
    # plain, interpolating (k = 2, 3), decimating (k = 2, 4)
    cases = [
        ("fir", lambda m, st, b: m.fir_block(taps, st, b),
         lambda m, d: m.fir_init(31, **d)),
        ("interp2", lambda m, st, b: m.firinterp_block(taps, 2, st, b),
         lambda m, d: m.firinterp_init(31, 2, **d)),
        ("interp3", lambda m, st, b: m.firinterp_block(taps, 3, st, b),
         lambda m, d: m.firinterp_init(31, 3, **d)),
        ("decim2", lambda m, st, b: m.firdecim_block(taps, 2, st, b),
         lambda m, d: m.fir_init(31, **d)),
        ("decim4", lambda m, st, b: m.firdecim_block(taps, 4, st, b),
         lambda m, d: m.fir_init(31, **d)),
    ]
    for name, blk, init in cases:
        sj, st = init(jfir, {}), init(tfir, {"device": "cpu"})
        outs = []
        for lo, hi in ((0, 1200), (1200, 3000)):
            sj, yj = blk(jfir, sj, jnp.asarray(x[lo:hi]))
            st, yt = blk(tfir, st, torch.as_tensor(x[lo:hi]))
            _close(yt, yj)
            np.testing.assert_array_equal(st.tail.numpy(),
                                          np.asarray(sj.tail))
            outs.append(yt)
        # other block sizes give the same stream
        st = init(tfir, {"device": "cpu"})
        again = []
        for lo, hi in ((0, 400), (400, 2000), (2000, 3000)):
            st, y = blk(tfir, st, torch.as_tensor(x[lo:hi]))
            again.append(y)
        _close(torch.cat(again), torch.cat(outs).numpy(), 1e-6)


@pytest.mark.parametrize("rate", RATES)
def test_resamplers_match_jax(rate):
    """``msresamp_block`` and a single ``resamp_block`` at ``rate`` over
    two blocks: counts, carried timing and delay lines equal, outputs
    within 1e-5 of max; the port's valid stream does not depend on the
    block size."""
    x = _iq(4608, 2)
    mj, mt = jrs.msresamp_create(rate), trs.msresamp_create(rate)
    assert (mt.num_halfband, mt.is_interp) == (mj.num_halfband,
                                               mj.is_interp)
    assert mt.arb._replace(pfb=None) == mj.arb._replace(pfb=None)
    np.testing.assert_array_equal(mt.arb.pfb, mj.arb.pfb)
    rj, rt = jrs.resamp_create(rate), trs.resamp_create(rate)
    assert trs.resamp_max_out(rt, 999) == jrs.resamp_max_out(rj, 999)
    assert trs.msresamp_max_out(mt, 4096) == jrs.msresamp_max_out(mj, 4096)
    runs = ((jax.jit(functools.partial(jrs.msresamp_block, mj)),
             trs.msresamp_block, jrs.msresamp_state(mj),
             trs.msresamp_state(mt, "cpu"), mt),
            (jax.jit(functools.partial(jrs.resamp_block, rj)),
             trs.resamp_block, jrs.resamp_state(rj),
             trs.resamp_state(rt, "cpu"), rt))
    for fj, ft, sj, st, ot in runs:
        whole = []
        for lo, hi in ((0, 4096), (4096, 4608)):
            sj, yj, vj, cj = fj(sj, jnp.asarray(x[lo:hi]))
            st, yt, vt, ct = ft(ot, st, torch.as_tensor(x[lo:hi]))
            assert int(ct) == int(cj) and ct.dtype == torch.int32
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
            _close(yt, yj)
            arb_j = sj.arb_state if hasattr(sj, "arb_state") else sj
            arb_t = st.arb_state if hasattr(st, "arb_state") else st
            assert int(arb_t.i0) == int(arb_j.i0)
            assert int(arb_t.num0) == int(arb_j.num0)
            assert arb_t.i0.dtype == arb_t.num0.dtype == torch.int32
            # the arbitrary stage's delay line holds the half-band
            # stages' outputs (float32 rounding), else the input (exact)
            _close(arb_t.tail, arb_j.tail, 1e-5 if mt.num_halfband else 0)
            whole.append(yt[:int(ct)])
        st = (trs.msresamp_state(mt, "cpu") if ft is trs.msresamp_block
              else trs.resamp_state(rt, "cpu"))
        parts = []
        for lo, hi in ((0, 1024), (1024, 3072), (3072, 4608)):
            st, y, _, c = ft(ot, st, torch.as_tensor(x[lo:hi]))
            parts.append(y[:int(c)])
        _close(torch.cat(parts), torch.cat(whole).numpy(), 1e-6)


def test_resamp_set_rate_rescale_and_int32_guard():
    x = _iq(2000, 3)
    rj, rt = jrs.resamp_create(0.73), trs.resamp_create(0.73)
    sj, st = jrs.resamp_state(rj), trs.resamp_state(rt, "cpu")
    sj, *_ = jrs.resamp_block(rj, sj, jnp.asarray(x[:777]))
    st, *_ = trs.resamp_block(rt, st, torch.as_tensor(x[:777]))
    rj2, rt2 = jrs.resamp_set_rate(rj, 1.21), trs.resamp_set_rate(rt, 1.21)
    assert rt2._replace(pfb=None) == rj2._replace(pfb=None)
    sj = jrs.resamp_rescale_state(rj, rj2, sj)
    st = trs.resamp_rescale_state(rt, rt2, st)
    assert int(st.num0) == int(sj.num0)
    _, yj, _, cj = jrs.resamp_block(rj2, sj, jnp.asarray(x[777:]))
    _, yt, _, ct = trs.resamp_block(rt2, st, torch.as_tensor(x[777:]))
    assert int(ct) == int(cj)
    _close(yt, yj)
    # the int32 timing guard trips where JAX's does (the channel model's
    # max_den = 2^15: past about 65k samples)
    rs = trs.resamp_create(1.0 + 37e-6, max_den=1 << 15)
    rsj = jrs.resamp_create(1.0 + 37e-6, max_den=1 << 15)
    raised = []
    for n in (1000, 90000):
        blk = np.zeros(n, np.complex64)
        try:
            jrs.resamp_block(rsj, jrs.resamp_state(rsj), jnp.asarray(blk))
            trs.resamp_block(rs, trs.resamp_state(rs, "cpu"),
                             torch.as_tensor(blk))
            raised.append(False)
        except ValueError:
            with pytest.raises(ValueError, match="int32 timing overflow"):
                trs.resamp_block(rs, trs.resamp_state(rs, "cpu"),
                                 torch.as_tensor(blk))
            raised.append(True)
    assert raised == [False, True]


def test_compact_masked_and_apply_msresamp_match_jax():
    x = _iq(64, 4)
    valid = np.random.default_rng(4).random(64) < 0.6
    got = trs.compact_masked(torch.as_tensor(x), torch.as_tensor(valid))
    want = jrs.compact_masked(jnp.asarray(x), jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    s = _iq(40000, 5)
    for rate in (0.5, 2.0, 1.0):
        _close(tapps.apply_msresamp(s, rate, "cpu"),
               japps.apply_msresamp(s, rate))


def test_comb_moving_sum_matches_jax():
    rng = np.random.default_rng(6)
    x = (rng.random((3, 3001)) ** 2).astype(np.float32)
    # the flexframe front end's shapes (D = 32 preamble-half symbols, k
    # samples a symbol): the float32 cumsums' rounding stays within 1e-5
    # of the window sums' max
    for D, k, n_out in ((32, 2, 2500), (32, 4, 2800), (64, 2, 2800)):
        got = tcorr.comb_moving_sum(torch.as_tensor(x), D, k, n_out)
        assert got.shape == (3, n_out)
        for row in range(3):
            want = np.asarray(jcorr.comb_moving_sum(jnp.asarray(x[row]), D,
                                                    k, n_out))
            _close(got[row], want)


def test_track_phase_bpsk_matches_jax():
    """A batch of drifting pseudo-BPSK streams (one with a pi slip on
    unknown data) and a single-segment stream: the port's batched call
    gives JAX's per-stream trajectories within 1e-5 rad."""
    rng = np.random.default_rng(7)
    jtrack = jax.jit(jpt.track_phase_bpsk, static_argnums=(2, 3))
    for n, seg, n_iter in ((320, 32, 2), (517, 32, 2), (20, 32, 1),
                           (200, 16, 0)):
        ys, ks = [], []
        for b, drift in enumerate((0.003, -0.004, 0.0005)):
            s = rng.choice([-1.0, 1.0], n)
            s[:min(64, n)] = 1.0
            phi = drift * np.arange(n) + 0.7 * b + np.pi * (
                np.arange(n) >= n // 2) * (b == 2)
            y = s * np.exp(1j * phi) + 0.2 * (rng.normal(size=n) +
                                              1j * rng.normal(size=n))
            ys.append(y.astype(np.complex64))
            k = np.zeros(n, np.float32)
            k[:min(64, n)] = 1.0
            ks.append(k)
        got = tpt.track_phase_bpsk(torch.as_tensor(np.stack(ys)),
                                   torch.as_tensor(np.stack(ks)), seg,
                                   n_iter)
        assert got.shape == (3, n) and got.dtype == torch.float32
        for b in range(3):
            want = np.asarray(jtrack(jnp.asarray(ys[b]), jnp.asarray(ks[b]),
                                     seg, n_iter))
            np.testing.assert_allclose(got[b].numpy(), want, atol=1e-5)


def test_channel_sro_matches_jax():
    """``channel_apply`` with a sample-rate offset (and gain, multipath,
    delay, offset; noise off) gives JAX's samples; JAX applies the gain
    before the resampler, and so does the port."""
    x = _iq(3000, 8)
    gen = torch.Generator().manual_seed(0)
    for ch in (dict(sro_ppm=50.0), dict(sro_ppm=-120.0, gain=0.7,
                                       multipath=(1.0, 0.2j), delay=5,
                                       cfo=0.01, phase=0.3)):
        got = tchan.channel_apply(tchan.Channel(**ch), gen,
                                  torch.as_tensor(x))
        want = jchan.channel_apply(jchan.Channel(**ch),
                                   jax.random.PRNGKey(0), jnp.asarray(x))
        assert got.dtype == torch.complex64
        _close(got, want)


def test_msresamp_state_carries_over_from_jax_and_checkpoints(tmp_path):
    """A mid-stream JAX ``MsresampState`` (a tuple of ``FirState`` and a
    ``ResampState``) moves to the port with ``from_jax_tree``, back with
    ``to_numpy_tree``, and through the port's checkpoint; each copy
    continues to JAX's output."""
    x = _iq(6144, 9)
    for rate in (0.5003, 2.0):
        mj, mt = jrs.msresamp_create(rate), trs.msresamp_create(rate)
        sj = jrs.msresamp_state(mj)
        sj, *_ = jrs.msresamp_block(mj, sj, jnp.asarray(x[:4096]))
        host = jax.device_get(sj)
        _, yj, _, cj = jrs.msresamp_block(mj, sj, jnp.asarray(x[4096:]))
        st = from_jax_tree(host, "cpu")
        assert type(st) is trs.MsresampState
        assert isinstance(st.hb_states, tuple) and all(
            type(h) is tfir.FirState for h in st.hb_states)
        back = to_numpy_tree(st)
        assert type(back.hb_states) is tuple
        np.testing.assert_array_equal(back.arb_state.num0,
                                      np.asarray(host.arb_state.num0))
        path = str(tmp_path / f"ms{rate}")
        save_state(path, st)
        loaded = load_state(path, trs.msresamp_state(mt, "cpu"))
        for s in (st, loaded):
            _, yt, _, ct = trs.msresamp_block(mt, s, torch.as_tensor(
                x[4096:]))
            assert int(ct) == int(cj)
            _close(yt, yj)
