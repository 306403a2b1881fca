"""The port's detect kernels B1-B5: plain versions vs the JAX kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that plain version against the JAX Pallas kernel run in
interpret mode (as the JAX suite runs it on CPU) and against the JAX XLA
path.  The CUDA kernels themselves are compared with the plain versions on
the card by ``tests/test_torch_gpu.py``.

Tolerances: B1 plain vs JAX interpret atol 1e-5 (at M=48, and on a short
zero-padded row); B1 plain vs the JAX FFT
path atol 1e-3 (JAX documents ~3e-4 between those two).  B2 plain vs JAX
interpret: ``detected`` equal, ``locs`` equal where detected (plateau-free
input), ``vals`` atol 1e-5, ``c_at`` rtol 1e-4.  B3/B4/B5 plain vs JAX
interpret on ``tests/test_pallas_kernels.py``'s loaded window: metric atol
5e-4, ``c`` atol 2e-3 (that file's tolerances: float32 sums in another
order); B4 raises where JAX raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jsync
from liquid_usrp_tpu.ops import pallas_kernels as jpk
from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.framing import ofdm_sync as tsync
from liquid_usrp_tpu_torch.ops import kernels

BS = 4096
METRIC_KERNELS = (kernels.detect_metric_onepass,
                  kernels.detect_metric_fused_2d,
                  kernels.detect_metric_fused)


@pytest.fixture(scope="module", params=[48, 64])
def loaded(request):
    """Two extended windows (rows) with frames (from the port's TX) at
    distinct offsets in 0.02-rms noise, and the matching JAX sync config."""
    M = request.param
    params = jofdm.make_ofdm_params(M, M // 8, 4)
    sync = jsync.make_sync(params, block_size=BS, max_payload=128,
                           max_frames=8)
    rng = np.random.default_rng(M)
    ext = np.zeros((2, sync.overlap + BS), np.complex64)
    for row, pos in ((0, 2000), (1, 700)):
        frame = tofdm.assemble_frame(
            tofdm.make_ofdm_params(M, M // 8, 4), tofdm.default_props(),
            torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, 256, 64, dtype=np.uint8))
        ).numpy()
        ext[row, pos:pos + len(frame)] = frame
    ext += (0.02 * (rng.normal(size=ext.shape) +
                    1j * rng.normal(size=ext.shape))).astype(np.complex64)
    return params, sync, ext


def test_b1_plain_matches_jax_kernel_and_fft_path(loaded):
    params, sync, ext = loaded
    M = params.M
    tmpl = np.tile(params.s0_time, jofdm.NUM_S0)
    span = jsync._xc_span(len(tmpl))
    n_metric = BS + 2 * M + 1
    got = kernels.detect_metric_xcorr_onepass(torch.as_tensor(ext), tmpl,
                                              span, n_metric).numpy()
    assert got.shape == (2, n_metric)
    if M == 48:         # the JAX suite runs the kernel itself at M=48
        want = np.asarray(jpk.detect_metric_xcorr_onepass(
            jnp.asarray(ext[0]), tmpl, span, n_metric, interpret=True))
        np.testing.assert_allclose(got[0], want, atol=1e-5)
        assert got[0].argmax() == want.argmax()
    for row in range(2):
        fft = np.asarray(jsync._detect_metric_xcorr(sync,
                                                    jnp.asarray(ext[row])))
        np.testing.assert_allclose(got[row], fft, atol=1e-3)
        assert got[row].argmax() == fft.argmax()
    # the port's own FFT path (detect level 0) agrees with both
    tables = tsync.sync_tables(tsync.make_sync(
        params, block_size=BS, max_payload=128, max_frames=8), "cpu")
    lvl0 = tsync._detect_metric_xcorr(
        tsync.make_sync(params, block_size=BS, max_payload=128,
                        max_frames=8), torch.as_tensor(ext), tables)
    np.testing.assert_allclose(lvl0.numpy(), got, atol=1e-3)
    assert kernels.launches["detect_metric_xcorr_onepass"] == 0


def test_b1_short_row_zero_padding():
    """A row shorter than the JAX kernel's raster is zero-padded, and the
    padding enters the floor's mean, as in JAX."""
    params = jofdm.make_ofdm_params(48, 6, 4)
    tmpl = np.tile(params.s0_time, jofdm.NUM_S0)
    rng = np.random.default_rng(1)
    x = (0.01 * (rng.normal(size=1300) + 1j * rng.normal(size=1300))
         ).astype(np.complex64)
    x[200:296] += tmpl
    got = kernels.detect_metric_xcorr_onepass(torch.as_tensor(x), tmpl, 24,
                                              1200).numpy()
    want = np.asarray(jpk.detect_metric_xcorr_onepass(
        jnp.asarray(x), tmpl, 24, 1200, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got.argmax() == 200


def test_b2_plain_matches_jax_kernel(loaded):
    params, sync, ext = loaded
    M = params.M
    d = M // 4
    L = jofdm.NUM_S0 * M - d
    vals, locs, c_at = kernels.detect_candidates_onepass(
        torch.as_tensor(ext), d, L, M, BS, sync.threshold, sync.max_frames)
    assert vals.shape == locs.shape == c_at.shape == (2, sync.max_frames)
    for row in range(2):
        jv, jl, jc = (np.asarray(a) for a in jpk.detect_candidates_onepass(
            jnp.asarray(ext[row]), d, L, M, BS, sync.threshold,
            sync.max_frames, interpret=True))
        det = vals[row].numpy() > 0
        np.testing.assert_array_equal(det, jv > 0)
        assert det.any()
        np.testing.assert_array_equal(locs[row].numpy()[det], jl[det])
        np.testing.assert_allclose(vals[row].numpy()[det], jv[det],
                                   atol=1e-5)
        np.testing.assert_allclose(c_at[row].numpy()[det], jc[det],
                                   rtol=1e-4)
    # the autocorrelation metric itself vs the JAX XLA formulation
    metric, c = kernels.autocorr_metric(torch.as_tensor(ext[0]), d, L)
    jm, jc = jsync._detect_metric(sync, jnp.asarray(ext[0]))
    np.testing.assert_allclose(metric.numpy(), np.asarray(jm), atol=5e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-3)
    assert kernels.launches["detect_candidates_onepass"] == 0


def test_wrappers_dispatch_by_device():
    """A CPU tensor takes the plain version (no launch is counted); a
    tensor on a device without a kernel raises instead of falling back."""
    x = torch.zeros(4096 + 2000, dtype=torch.complex64)
    tmpl = np.ones(96, np.complex64)
    kernels.reset_launch_counts()
    kernels.detect_metric_xcorr_onepass(x, tmpl, 24, 4193)
    kernels.detect_candidates_onepass(x, 12, 84, 48, 4096, 0.5, 4)
    for fn in METRIC_KERNELS:
        fn(x, 12, 84)
    assert kernels.launches == dict.fromkeys(
        ["detect_metric_xcorr_onepass", "detect_candidates_onepass",
         "detect_metric_onepass", "detect_metric_fused_2d",
         "detect_metric_fused", "viterbi", "nearest"], 0)
    meta = x.to("meta")
    with pytest.raises(RuntimeError):
        kernels.detect_metric_xcorr_onepass(meta, tmpl, 24, 4193)
    with pytest.raises(RuntimeError):
        kernels.detect_candidates_onepass(meta, 12, 84, 48, 4096, 0.5, 4)
    for fn in METRIC_KERNELS:
        with pytest.raises(RuntimeError):
            fn(meta, 12, 84)
        with pytest.raises(ValueError):         # no output offset
            fn(x[:90], 12, 84)
    with pytest.raises(ValueError):
        kernels.detect_metric_xcorr_onepass(x, tmpl[:95], 24, 4193)


@pytest.fixture(scope="module")
def pallas_ext():
    """The window of ``tests/test_pallas_kernels.py::_loaded_ext`` (one
    frame at 2000 in 0.02-rms noise, the same generator draws), with the
    frame from the port's TX, at M = 48, 64 and 128, keyed by M."""
    out = {}
    for M in (48, 64, 128):
        params = tofdm.make_ofdm_params(M, M // 8, 4)
        sync = tsync.make_sync(params, block_size=4096, max_payload=128,
                               max_frames=4)
        rng = np.random.default_rng(0)
        frame = tofdm.assemble_frame(
            params, tofdm.default_props(),
            torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, 256, 64, dtype=np.uint8))
        ).numpy()
        ext = np.zeros(sync.overlap + 4096, np.complex64)
        ext[2000:2000 + len(frame)] = frame
        ext += 0.02 * (rng.normal(size=len(ext)) +
                       1j * rng.normal(size=len(ext)))
        out[M] = ext.astype(np.complex64)
    return out


@pytest.mark.parametrize("name,M", [
    ("detect_metric_onepass", 48), ("detect_metric_onepass", 64),
    ("detect_metric_onepass", 128), ("detect_metric_fused_2d", 48),
    ("detect_metric_fused", 48)])
def test_b3_b4_b5_plain_match_jax_kernels(pallas_ext, name, M):
    ext = pallas_ext[M]
    lag = M // 4
    span = jofdm.NUM_S0 * M - lag
    kernels.reset_launch_counts()
    metric, c = getattr(kernels, name)(torch.as_tensor(ext), lag, span)
    jm, jc = getattr(jpk, name)(jnp.asarray(ext), lag, span, interpret=True)
    assert metric.shape == c.shape == (len(ext) - span - lag + 1,)
    assert metric.dtype == torch.float32 and c.dtype == torch.complex64
    np.testing.assert_allclose(metric.numpy(), np.asarray(jm), atol=5e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-3)
    assert int(metric.argmax()) == int(np.argmax(np.asarray(jm)))
    # batched rows give each row's own result
    two = torch.as_tensor(np.stack([ext, ext[::-1].copy()]))
    bm, bc = getattr(kernels, name)(two, lag, span)
    np.testing.assert_array_equal(bm[0].numpy(), metric.numpy())
    np.testing.assert_array_equal(bc[0].numpy(), c.numpy())
    assert kernels.launches[name] == 0


def test_b4_span_limit_raises_as_jax(pallas_ext):
    ext = pallas_ext[64]                      # span + lag = 128: allowed
    kernels.detect_metric_fused_2d(torch.as_tensor(ext), 16, 112)
    ext = pallas_ext[128]                     # span + lag = 256
    with pytest.raises(ValueError):
        jpk.detect_metric_fused_2d(jnp.asarray(ext), 32, 224, interpret=True)
    with pytest.raises(ValueError):
        kernels.detect_metric_fused_2d(torch.as_tensor(ext), 32, 224)


# --- the arithmetic of kernels B2's and B3's tiles, in float32 NumPy --------

B2_R, B2_THREADS, B2_SEG = 9, 256, 64        # csrc/detect_candidates.cu
B3_R, B3_THREADS = 9, 256                    # csrc/autocorr_metric.cu


def _lag_planes(X, lag, n):
    """Re and Im of ``X[i] * conj(X[i + lag])`` and ``|X[i]|^2`` for
    ``i < n``, in float32, as the kernels form them."""
    a, b = X[:n], X[lag:n + lag]
    return [(a.real * b.real + a.imag * b.imag).astype(np.float32),
            (a.imag * b.real - a.real * b.imag).astype(np.float32),
            (a.real * a.real + a.imag * a.imag).astype(np.float32)]


def _chunked_window_sums(planes, span, R, threads):
    """The span-window sums of kernels B2 and B3 over ``R * threads``
    offsets in float32, in the kernels' order: thread t owns the chunk of
    offsets ``q = t * R + r``; each window is the in-chunk suffix sum from
    r, plus the totals of chunks t+1 .. t+K-1 (and t+K from r = rs on),
    plus the in-chunk prefix sum at the window end.  Offsets whose windows
    pass the last chunk read zeros (the kernels read their pads there, and
    no output reads those offsets)."""
    f32 = np.float32
    K = (span - 1) // R
    rs = R * (K + 1) - span + 1
    t = np.arange(threads)
    r = np.arange(R)
    q = t[:, None] * R + r[None, :]                       # [threads, R]
    sums = []
    for p in planes:
        p = p.astype(f32).reshape(threads, R)
        pre = np.cumsum(p, axis=1, dtype=f32)
        suf = np.cumsum(p[:, ::-1], axis=1, dtype=f32)[:, ::-1]
        tot = np.concatenate([pre[:, -1], np.zeros(K + 1, f32)])
        mid = np.zeros(threads, f32)
        for kk in range(1, K):
            mid = mid + tot[t + kk]
        mid1 = mid + tot[t + K]
        pre = np.concatenate([pre.reshape(-1), np.zeros(span, f32)])
        m = np.where(r[None, :] < rs, mid[:, None], mid1[:, None])
        sums.append(((suf + m) + pre[q + span - 1]).reshape(-1))
    return sums


def _b2_tile_model(x, lag, span, win, T, thr, k, floor):
    """Kernel B2's schedule on one row ``x`` in float32: per tile of TO
    outputs, lag products in chunks of B2_R offsets and their window sums
    by :func:`_chunked_window_sums`; the NMS max takes the same chunked
    (van Herk) form with max.  Returns (vals, locs, e1 at stream offsets
    -win, -win + 1, ...)."""
    f32 = np.float32
    cap = B2_R * B2_THREADS
    TO = (cap - 2 * win - lag - span + 1) // B2_SEG * B2_SEG
    n_out = len(x) - span - lag + 1
    n_seg = -(-n_out // B2_SEG)
    segval = np.full(n_seg, -1.0, f32)
    segarg = np.zeros(n_seg, np.int64)
    e1_all = []
    K2 = 2 * win // B2_R
    rs2 = B2_R * (K2 + 1) - 2 * win
    t = np.arange(B2_THREADS)
    r = np.arange(B2_R)
    q = (t[:, None] * B2_R + r[None, :])                  # [threads, R]
    for n0 in range(0, n_seg * B2_SEG, TO):
        g = n0 - win + np.arange(cap + lag + span)
        X = np.where(g < 0, 0, x[np.clip(g, 0, len(x) - 1)]).astype(
            np.complex64)
        cr, ci, e1 = _chunked_window_sums(_lag_planes(X, lag, cap), span,
                                          B2_R, B2_THREADS)
        e1_all.append(e1[:TO])
        e2 = np.concatenate([e1, np.zeros(lag, f32)])[lag:]
        c2 = cr * cr + ci * ci
        met = np.where(np.minimum(e1, e2) > f32(floor),
                       c2 / np.maximum(e1 * e2, f32(1e-12)), 0).astype(f32)
        mc = met.reshape(B2_THREADS, B2_R)
        pmax = np.concatenate([np.maximum.accumulate(mc, axis=1).reshape(-1),
                               np.full(2 * win, -np.inf, f32)])
        smax = np.maximum.accumulate(mc[:, ::-1], axis=1)[:, ::-1]
        cmax = np.concatenate([mc.max(axis=1), np.full(K2 + 1, -np.inf)])
        mm = np.full(B2_THREADS, -np.inf, f32)
        for kk in range(1, K2):
            mm = np.maximum(mm, cmax[t + kk])
        mm1 = np.maximum(mm, cmax[t + K2])
        mmr = np.where(r[None, :] < rs2, mm[:, None], mm1[:, None])
        lmax = np.maximum(np.maximum(smax, mmr), pmax[q + 2 * win])
        j = np.arange(TO)
        mv = met[j + win]
        n = n0 + j
        ok = (mv >= lmax.reshape(-1)[:TO]) & (mv > thr) & (n >= win) & \
            (n < T + win) & (n < n_out)
        score = np.where(ok, mv, -1.0).astype(f32).reshape(-1, B2_SEG)
        s0 = n0 // B2_SEG
        ns = min(len(score), n_seg - s0)
        segval[s0:s0 + ns] = score.max(axis=1)[:ns]
        segarg[s0:s0 + ns] = n0 + np.arange(ns) * B2_SEG + \
            score.argmax(axis=1)[:ns]
    top = np.argsort(-segval, kind="stable")[:k]
    return segval[top], segarg[top], np.concatenate(e1_all)


def _b3_tile_model(x, lag, span, floor):
    """Kernel B3's schedule on one row ``x`` in float32: per tile of TO
    outputs, the lag products and powers of the block's B3_R * B3_THREADS
    offsets (samples past the row end repeat the last), their window sums
    by :func:`_chunked_window_sums`, e2 read from the e1 plane at +lag and
    the floor-gated metric.  Returns (metric, c, e1), each ``[n_out]``."""
    f32 = np.float32
    cap = B3_R * B3_THREADS
    TO = (cap - lag - span + 1) & ~3
    n_out = len(x) - span - lag + 1
    out = []
    for n0 in range(0, n_out, TO):
        X = x[np.minimum(n0 + np.arange(cap + lag), len(x) - 1)]
        cr, ci, e1 = _chunked_window_sums(_lag_planes(X, lag, cap), span,
                                          B3_R, B3_THREADS)
        e2 = np.concatenate([e1, np.zeros(lag, f32)])[lag:]
        met = np.where(np.minimum(e1, e2) > f32(floor),
                       (cr * cr + ci * ci) / np.maximum(e1 * e2, f32(1e-12)),
                       0).astype(f32)
        nv = min(TO, n_out - n0)
        out.append((met[:nv], (cr + 1j * ci)[:nv].astype(np.complex64),
                    e1[:nv]))
    return tuple(np.concatenate(v) for v in zip(*out))


def _loud_burst_row(M):
    """One row of 12,288 samples: a frame at 100x amplitude (+40 dB over a
    unit frame) from 300, then 0.01-rms noise and, 2,000 samples after the
    burst, a unit frame.  Returns (row, burst end, unit frame start)."""
    params = tofdm.make_ofdm_params(M, {16: 4}.get(M, M // 8),
                                    {16: 2}.get(M, 4))
    rng = np.random.default_rng(40)
    frame = [tofdm.assemble_frame(
        params, tofdm.default_props(),
        torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
        torch.as_tensor(rng.integers(0, 256, 32, dtype=np.uint8))).numpy()
        for _ in range(2)]
    x = (0.01 * (rng.normal(size=3 * 4096) + 1j * rng.normal(size=3 * 4096))
         ).astype(np.complex64)
    end = 300 + len(frame[0])
    x[300:end] += 100.0 * frame[0]
    pos = end + 2000
    x[pos:pos + len(frame[1])] += frame[1]
    return x, end, pos


def _sliding_sums(v, span):
    """Window sums of ``v`` by a float32 (complex64) running add and
    subtract, for contrast with the kernels' chunked sums."""
    run = np.zeros(len(v) - span, v.dtype)
    acc = v[:span].sum(dtype=v.dtype)
    for m in range(len(v) - span):
        run[m] = acc
        acc = (acc + v[m + span]) - v[m]
    return run


def _row_floor64(x, span):
    return 1e-4 * span * (float(np.sum(np.abs(x.astype(np.complex128)) ** 2))
                          / len(x) + 1e-12)


def test_b2_tile_arithmetic_after_a_loud_burst():
    """A frame at 100x amplitude (+40 dB over a unit frame) ends mid-row,
    then 0.01-rms noise and a unit frame follow.  The float32 model of
    kernel B2's chunked window sums and van Herk NMS detects exactly what
    the plain version detects, at the same offsets, and its window sums of
    |x|^2 in the quiet part stay within 1e-5 (relative) of float64.  A
    sliding add-and-subtract float32 sum over the same row keeps a residue
    of the burst there, orders of magnitude larger: why the kernel sums
    each window from its own terms."""
    M = 48
    lag, win = M // 4, M
    span = jofdm.NUM_S0 * M - lag
    x, end, pos = _loud_burst_row(M)
    T = len(x) - span - lag + 1 - 2 * win
    k = 8
    vals, locs, e1 = _b2_tile_model(x, lag, span, win, T, 0.5, k,
                                    _row_floor64(x, span))
    pv, pl, _ = kernels.detect_candidates_plain(torch.as_tensor(x), lag, span,
                                                win, T, 0.5, k)
    det = vals > 0
    np.testing.assert_array_equal(np.sort(det), np.sort(pv.numpy() > 0))
    assert det.sum() == 2
    np.testing.assert_array_equal(np.sort(locs[det]),
                                  np.sort(pl.numpy()[pv.numpy() > 0]))
    np.testing.assert_allclose(np.sort(vals[det]),
                               np.sort(pv.numpy()[pv.numpy() > 0]),
                               atol=1e-5)
    # window sums of |x|^2 after the burst, across tile edges
    p64 = np.abs(x.astype(np.complex128)) ** 2
    quiet = np.arange(end + 10, pos - span - 10)
    want = np.array([p64[m:m + span].sum() for m in quiet])
    got = e1[quiet + win]
    assert np.abs(got - want).max() <= 1e-5 * want.max()
    # the sliding float32 sum of the same row, for contrast
    run = _sliding_sums(p64.astype(np.float32), span)
    slide_err = np.abs(run[quiet] - want).max()
    assert slide_err > 100 * np.abs(got - want).max()


@pytest.mark.parametrize("M", [16, 48])
def test_b3_tile_arithmetic_after_a_loud_burst(M):
    """The loud-burst row of the B2 test through a float32 model of kernel
    B3's tiles (M = 16: the generic instance's geometry, and the tiles
    are longer; M = 48: the path's).  Its e1 and c over the quiet part stay
    within 1e-5 (relative to the largest there) of float64 sums, across
    tile edges; a sliding float32 sum keeps a residue of the burst there
    over 100x larger; and its metric passes the same floor gate as
    :func:`kernels.autocorr_metric`'s, within 1e-5 of it everywhere."""
    lag = M // 4
    span = jofdm.NUM_S0 * M - lag
    x, end, pos = _loud_burst_row(M)
    metric, c, e1 = _b3_tile_model(x, lag, span, _row_floor64(x, span))
    n_out = len(x) - span - lag + 1
    assert metric.shape == c.shape == e1.shape == (n_out,)
    assert n_out > (B3_R * B3_THREADS - lag - span + 1) // 4 * 4 * 4
    pm, pc = kernels.autocorr_metric(torch.as_tensor(x), lag, span)
    np.testing.assert_array_equal(metric > 0, pm.numpy() > 0)
    assert np.abs(metric - pm.numpy()).max() <= 1e-5
    # e1 and c of the windows between the burst and the unit frame
    x64 = x.astype(np.complex128)
    p64 = np.abs(x64) ** 2
    prod64 = x64[:-lag] * np.conj(x64[lag:])
    quiet = np.arange(end + 10, pos - span - lag - 10)
    e1_64 = np.array([p64[m:m + span].sum() for m in quiet])
    c64 = np.array([prod64[m:m + span].sum() for m in quiet])
    e1_err = np.abs(e1[quiet] - e1_64).max()
    c_err = np.abs(c[quiet] - c64).max()
    assert e1_err <= 1e-5 * e1_64.max()
    assert c_err <= 1e-5 * np.abs(c64).max()
    # sliding float32 sums of the same row, for contrast
    e1_slide = _sliding_sums(p64.astype(np.float32), span)[quiet]
    c_slide = _sliding_sums(prod64.astype(np.complex64), span)[quiet]
    assert np.abs(e1_slide - e1_64).max() > 100 * e1_err
    assert np.abs(c_slide - c64).max() > 100 * c_err
