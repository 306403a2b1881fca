"""The yardstick the card's kernels are held to, at the OFDM sizes where
B1-B3 leave their one-block tilings (M = 476 and up for B2, 1,028 for B1,
1,152 for B3): the plain versions against float64 and against the JAX
package, and ``sync_block`` on the CPU against JAX's jitted level 0.

No JAX Pallas kernel runs here: interpret mode takes minutes at these
sizes.  Tolerances:

* the plain B1 on complex64 input within 1e-6 of the same function on
  complex128 input (its float64 value);
* the plain B1 against JAX's FFT path (``_detect_metric_xcorr``, level
  0): equal argmax and a max abs difference within
  5e-3 * sqrt(len / 15,916), ``len`` the window's length: the FFT's
  float32 rounding grows with the square root of its length, and gated
  segments just above the silence floor magnify it (5e-3 at M = 1,028,
  whose window is 15,916 samples);
* the plain B2 against JAX's ``_detect_metric`` plus ``topk_peaks``
  (level 0, the legacy detector): equal ``detected`` and offsets;
* the plain B3 against JAX's ``_detect_metric``: metric within 2e-4 (JAX
  takes its windows as differences of a float32 cumsum along the whole
  window, the port's plain version of a float64 one) and ``c`` within
  1e-5 of max ``|c|``;
* ``sync_block`` at M = 512 (level 2) and 1,028 (level 1) decodes every
  frame payload-exact, with JAX's level-0 rows (``t_start`` and flags
  exact, payloads exact where valid, ``cfo`` within 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jsync
from liquid_usrp_tpu_torch.framing import ofdm_sync as tsync
from liquid_usrp_tpu_torch.ops import kernels
import torch_sync_streams as tss

BS = 4096


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _window(M, xcorr=True):
    """(JAX sync at level 0, the port's sync, one extended window holding
    a frame at M)."""
    kw = dict(block_size=BS, max_payload=64, max_frames=4, use_pallas=0,
              xcorr_detect=xcorr)
    js = jsync.make_sync(jofdm.make_ofdm_params(M, M // 8, 4), **kw)
    ts = tsync.make_sync(tss.params_at(M), **kw)
    stream, _ = tss.frame_stream(M, 1, M)
    ext = np.zeros(ts.overlap + BS, np.complex64)
    n = min(len(ext), len(stream))
    ext[:n] = stream[:n]
    return js, ts, ext


@pytest.mark.parametrize("M", [1028, 2052])
def test_plain_b1_against_float64_and_jax(M):
    js, ts, ext = _window(M)
    tmpl = np.tile(ts.params.s0_time, 2)
    span, n_metric = tsync._xc_span(2 * M), BS + 2 * M + 1
    x = torch.as_tensor(ext)[None]
    got = kernels.detect_metric_xcorr_plain(x, tmpl, span, n_metric)[0]
    wide = kernels.detect_metric_xcorr_plain(x.to(torch.complex128), tmpl,
                                             span, n_metric)[0]
    assert float((got - wide).abs().max()) <= 1e-6
    ref = np.asarray(jsync._detect_metric_xcorr(js, jnp.asarray(ext)))
    assert ref.shape == tuple(got.shape)
    assert int(np.argmax(ref)) == int(got.argmax())
    assert float(got.max()) > 0.9                   # the frame is there
    tol = 5e-3 * np.sqrt(len(ext) / 15916)
    assert float(np.abs(ref - got.numpy()).max()) <= tol


@pytest.mark.parametrize("M", [512, 1024])
def test_plain_b2_against_jax(M):
    js, ts, ext = _window(M, xcorr=False)
    jd, jl, _ = (np.asarray(a) for a in jsync._detect_candidates(
        js, jnp.asarray(ext)))
    v, loc, _ = kernels.detect_candidates_plain(
        torch.as_tensor(ext)[None], M // 4, 2 * M - M // 4, M, BS,
        ts.threshold, ts.max_frames)
    det = (v[0] > 0).numpy()
    np.testing.assert_array_equal(det, jd)
    assert det.any()
    np.testing.assert_array_equal(loc[0].numpy()[det], jl[jd])


def test_plain_b3_against_jax():
    M = 1152
    js, _, ext = _window(M, xcorr=False)
    jm, jc = (np.asarray(a) for a in jsync._detect_metric(
        js, jnp.asarray(ext)))
    m, c = kernels.autocorr_metric(torch.as_tensor(ext)[None], M // 4,
                                   2 * M - M // 4)
    assert m.shape[-1] == jm.shape[0]
    assert float(m.max()) > 0.9
    assert float(np.abs(jm - m[0].numpy()).max()) <= 2e-4
    assert float(np.abs(jc - c[0].numpy()).max()) <= \
        1e-5 * float(c.abs().max())


@pytest.mark.parametrize("M,level", [(512, 2), (1028, 1)])
def test_sync_block_large_m_matches_jax_level0(M, level):
    stream, sent = tss.frame_stream(M, 2, M)
    kw = dict(block_size=8192, max_payload=64, max_frames=4)
    ts = tsync.make_sync(tss.params_at(M), use_pallas=level, **kw)
    kernels.reset_launch_counts()
    got = tss.sync_rows(ts, stream, "cpu")
    assert not any(kernels.launches.values())    # the CPU runs plain code
    tss.assert_decodes_sent(got, sent)

    js = jsync.make_sync(jofdm.make_ofdm_params(M, M // 8, 4), use_pallas=0,
                         **kw)
    step = jsync.make_sync_step(js)
    st = jsync.sync_init(js)
    want = []
    for blk in tss.padded_blocks(ts, stream):
        st, res = step(st, jnp.asarray(blk))
        res = jax.device_get(res)._asdict()
        for k in np.nonzero(res["detected"])[0]:
            want.append(dict(
                t_start=int(res["t_start"][k]),
                header_valid=bool(res["header_valid"][k]),
                payload_valid=bool(res["payload_valid"][k]),
                header=np.asarray(res["header"][k]),
                payload=np.asarray(res["payload"][k])[
                    :int(res["payload_len"][k])],
                cfo=float(res["cfo"][k])))
    tss.assert_same_rows(got, sorted(want, key=lambda r: r["t_start"]))
