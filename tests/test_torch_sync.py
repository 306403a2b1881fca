"""The port's single-channel synchronizer entry points against the JAX
package: the legacy (Schmidl-Cox) detector with kernel B3,
``make_sync_step``, ``sync_blocks_batched`` and ``debug_capture``.

Tolerances, as in ``tests/test_torch_framing.py``: ``detected``,
``header_valid``, ``payload_valid`` exact, and where detected
``header``/``payload``/``payload_len``/``mod``/``fec0``/``fec1``/``check``/
``t_start`` exact, ``rssi`` atol 1e-3 dB, ``evm`` atol 0.05 dB, ``cfo``
atol 1e-5 rad/sample; every injected frame decodes with its offset (0.045
rad/sample, above pi / (2 M), so a wrong lag correlation fails the decode)
estimated within 1.5e-3.  Candidate offsets are exact.  ``debug_capture``:
``detected``, ``n0`` and ``header_valid`` exact; ``metric`` atol 5e-4
(``tests/test_pallas_kernels.py``'s tolerance for B3), ``H`` and
``hsyms_eq`` atol 1e-4, ``psyms_eq`` atol 1e-3, ``cfo`` atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jsync
from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.framing import ofdm_sync as tsync
from liquid_usrp_tpu_torch.ops import kernels
from test_torch_framing import PROPS_QAM, _check_sent, _compare, _t

BS = 4096
NB = 3                          # blocks per batched call
N_BLOCKS = 6
CFO = 0.045                     # rad/sample (= test_torch_framing.CFOS[0])
CONFIGS = [(True, 0), (True, 1), (False, 0), (False, 1)]  # (xcorr, level)


def test_legacy_detector_runs_b3_where_jax_does(monkeypatch):
    """``use_pallas=2`` below M=32 and ``use_pallas=1`` with the legacy
    detector take their metric from B3, as JAX does (the port used to
    raise there).  Mirrors ``tests/test_topk_peaks.py::
    test_pallas_m_below_32_routes_around_fused_kernel``: at M=16 level 2
    never calls the fused kernel and finds level 0's candidates; level 1
    legacy matches JAX's ``_detect_candidates`` (its B3 in interpret
    mode)."""
    def _boom(*a, **k):
        raise AssertionError("detect_candidates_onepass called for M<32")
    monkeypatch.setattr(kernels, "detect_candidates_onepass", _boom)
    params = tofdm.make_ofdm_params(M=16, cp_len=4, taper_len=2)
    rng = np.random.default_rng(11)
    frame = tofdm.assemble_frame(
        params, tofdm.default_props(), torch.arange(8, dtype=torch.uint8),
        _t(rng.integers(0, 256, 20, dtype=np.uint8))).numpy()

    def mk(mod, p, **kw):
        return mod.make_sync(p, block_size=4096, max_payload=32,
                             max_frames=4, **kw)
    s0 = mk(tsync, params, use_pallas=0)
    ext = np.zeros(4096 + s0.overlap, np.complex64)
    ext[700:700 + len(frame)] = frame
    ext += 0.01 * (rng.standard_normal(len(ext)) +
                   1j * rng.standard_normal(len(ext))).astype(np.complex64)
    x = _t(ext)[None]
    det0, locs0, c0 = tsync._detect_candidates(
        s0, x, tsync.sync_tables(s0, "cpu"))
    det2, locs2, c2 = tsync._detect_candidates(
        mk(tsync, params, use_pallas=2), x, None)
    # offsets of undetected slots are not part of the contract (ROADMAP
    # Queue C: torch.topk orders the -1 scores differently)
    np.testing.assert_array_equal(det0.numpy(), det2.numpy())
    np.testing.assert_array_equal(locs0[det0].numpy(), locs2[det0].numpy())
    np.testing.assert_allclose(c0[det0].numpy(), c2[det0].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert int(det0.sum()) >= 1

    jparams = jofdm.make_ofdm_params(M=16, cp_len=4, taper_len=2)
    det1, locs1, c1 = tsync._detect_candidates(
        mk(tsync, params, use_pallas=1, xcorr_detect=False), x, None)
    jd, jl, jc = (np.asarray(a) for a in jsync._detect_candidates(
        mk(jsync, jparams, use_pallas=1, xcorr_detect=False),
        jnp.asarray(ext)))
    np.testing.assert_array_equal(det1[0].numpy(), jd)
    np.testing.assert_array_equal(locs1[0].numpy()[jd], jl[jd])
    np.testing.assert_allclose(c1[0].numpy()[jd], jc[jd], atol=2e-3)
    assert jd.sum() >= 1


@pytest.fixture(scope="module")
def stream():
    """One stream of 3 loaded blocks + 3 flush blocks with a frequency
    offset ``CFO``: frames (from the port's TX) straddling the first and
    second block edges and one QAM16/CRC16/Hamming(8,4) frame in block 2."""
    rng = np.random.default_rng(21)
    params = tofdm.make_ofdm_params(48, 6, 4)
    out = np.zeros(N_BLOCKS * BS, np.complex64)
    sent = []
    for pos, pr in ((3000, {}), (7200, {}), (9800, PROPS_QAM)):
        hdr = rng.integers(0, 256, 8, dtype=np.uint8)
        pay = rng.integers(0, 256, 90, dtype=np.uint8)
        f = tofdm.assemble_frame(params, tofdm.FrameProps(**pr), _t(hdr),
                                 _t(pay)).numpy()
        out[pos:pos + len(f)] = f
        sent.append((0, pos, hdr, pay))
    out *= np.exp(1j * CFO * np.arange(len(out))).astype(np.complex64)
    out[:3 * BS] += (0.01 * (rng.normal(size=3 * BS) + 1j *
                             rng.normal(size=3 * BS))).astype(np.complex64)
    return out, sent


def _syncs(xcorr, level):
    kw = dict(block_size=BS, max_payload=128, max_frames=8,
              use_pallas=level, xcorr_detect=xcorr)
    return (jsync.make_sync(jofdm.make_ofdm_params(48, 6, 4), **kw),
            tsync.make_sync(tofdm.make_ofdm_params(48, 6, 4), **kw))


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"{'xcorr' if x else 'legacy'}{lv}" for x, lv in CONFIGS])
def jax_batched(request, stream):
    """(config, JAX ``sync_blocks_batched`` results of each 3-block call,
    final JAX state)."""
    x, _ = stream
    jsy, _ = _syncs(*request.param)
    js = jsync.sync_init(jsy)
    jstep = jax.jit(lambda s, b: jsync.sync_blocks_batched(jsy, s, b))
    out = []
    for call in range(N_BLOCKS // NB):
        chunk = x[call * NB * BS:(call + 1) * NB * BS].reshape(NB, BS)
        js, jr = jstep(js, jnp.asarray(chunk))
        out.append(jax.device_get(jr))
    return request.param, out, jax.device_get(js)


def test_sync_step_and_batched_match_jax(stream, jax_batched):
    """``sync_blocks_batched`` (3-block calls) and ``make_sync_step`` (one
    block per call) give JAX's rows, and the batched calls JAX's state;
    at level 1 the legacy detector launches no kernel on the CPU."""
    x, sent = stream
    config, ref, jfinal = jax_batched
    _, tsy = _syncs(*config)
    ts = tsync.sync_init(tsy, "cpu")
    found = {}
    for call in range(N_BLOCKS // NB):
        chunk = x[call * NB * BS:(call + 1) * NB * BS].reshape(NB, BS)
        ts, tr = tsync.sync_blocks_batched(tsy, ts, _t(chunk))
        assert tr.detected.shape == (NB, 8)
        found.update(_compare(tr, ref[call]))
    assert int(ts.base) == int(jfinal.base)
    np.testing.assert_array_equal(ts.tail.numpy(), jfinal.tail)
    _check_sent(found, sent, False)
    assert len(found) == len(sent)

    step = tsync.make_sync_step(tsy)
    ts = tsync.sync_init(tsy, "cpu")
    for b in range(N_BLOCKS):
        ts, tr = step(ts, _t(x[b * BS:(b + 1) * BS]))
        jr = type(ref[0])(*(v[b % NB] for v in ref[b // NB]))
        _compare(tr, jr)
    np.testing.assert_array_equal(ts.tail.numpy(), jfinal.tail)


def test_batched_blocks_equal_sequential(stream):
    """``sync_blocks_batched`` over all 6 blocks at once equals six
    single-block steps (mirrors ``tests/test_ofdm_loopback.py::
    test_batched_blocks_equal_sequential``): the same rows, stats
    included, and the same carried state; planes ingest decodes alike."""
    x, sent = stream
    _, tsy = _syncs(False, 1)
    st, res = tsync.sync_blocks_batched(tsy, tsync.sync_init(tsy, "cpu"),
                                        _t(x.reshape(N_BLOCKS, BS)))
    step = tsync.make_sync_step(tsy)
    seq = tsync.sync_init(tsy, "cpu")
    for b in range(N_BLOCKS):
        seq, r = step(seq, _t(x[b * BS:(b + 1) * BS]))
        rb = tsync.FrameResults(*(v[b] for v in res))
        for f in r._fields:
            got, want = getattr(rb, f), getattr(r, f)
            det = r.detected
            if f in ("rssi", "evm", "cfo", "header", "payload", "mod",
                     "fec0", "fec1", "check"):
                got, want = got[det], want[det]
            np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                          err_msg=f)
    np.testing.assert_array_equal(st.tail.numpy(), seq.tail.numpy())
    assert int(st.base) == int(seq.base)
    assert int(res.payload_valid.sum()) == len(sent)
    planes = _t(np.stack([x.real, x.imag]).reshape(2, N_BLOCKS, BS))
    _, rp = tsync.sync_blocks_batched(tsy, tsync.sync_init(tsy, "cpu"), planes)
    np.testing.assert_array_equal(rp.payload.numpy(), res.payload.numpy())


def test_debug_capture_matches_jax(stream, monkeypatch):
    """At the legacy detector's level 1: the metric is kernel B3's (its
    plain version here, JAX's in interpret mode).  JAX's candidate decode
    runs jitted, the same computation as its eager call, whose first
    dispatch of several hundred primitives compiles each one."""
    x, _ = stream
    jsy, tsy = _syncs(False, 1)
    decode = jax.jit(lambda e, n0, c, f=jsync._decode_candidate: f(
        jsy, e, n0, c, debug=True))
    monkeypatch.setattr(jsync, "_decode_candidate",
                        lambda sync, e, n0, c, debug: decode(e, n0, c))
    seg = x[2 * BS:4 * BS]                 # the QAM16 frame at 9800
    got = tsync.debug_capture(tsy, seg, "cpu")
    want = jsync.debug_capture(jsy, seg)
    for k in ("detected", "n0", "header_valid"):
        assert got[k] == want[k], k
    assert got["detected"] and got["header_valid"]
    assert abs(got["n0"] - (9800 - 2 * BS)) <= 3
    np.testing.assert_allclose(got["metric"], want["metric"], atol=5e-4)
    assert int(got["metric"].argmax()) == int(want["metric"].argmax())
    np.testing.assert_allclose(got["H"], want["H"], atol=1e-4)
    np.testing.assert_allclose(got["hsyms_eq"], want["hsyms_eq"], atol=1e-4)
    np.testing.assert_allclose(got["cfo"], want["cfo"], atol=1e-5)
    assert got["psyms_eq"].shape == want["psyms_eq"].shape
    np.testing.assert_allclose(got["psyms_eq"], want["psyms_eq"], atol=1e-3)
