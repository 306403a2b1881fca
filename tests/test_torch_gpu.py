"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py \
        tests/test_torch_robustness.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Tolerances: B1 max abs difference <= 1e-4; B2 ``detected`` equal, ``vals``
atol 1e-4, the same set of detected offsets per row, and ``c_at`` within
1e-4 of ``|c|`` of the plain lag correlation at the kernel's offsets.  The
tiling tests (short rows, ragged lengths, M = 16-128 for B1 and 32-128
for B2, every M but 48 reaching the kernels' generic instances, an exact
metric plateau, a loud burst followed by quiet noise) hold
B2's detected offsets within 3 samples of the plain version's (equal on
the plateau, whose ties are exact) and its other outputs as above.  B3
vs :func:`kernels.autocorr_metric` (float64 window sums): metric max abs
difference <= 1e-4, ``c`` within 1e-4 of max ``|c|``, on the loaded
windows and in B3's tiling tests (M = 16-64, M = 48 through its template
instance and the others through the generic one; rows shorter than a
tile, ending mid-tile, with odd and even ``n_out``, more tiles than the
persistent grid has blocks, and a loud burst followed by quiet noise,
whose metric would carry a residue of a running sum).  B4/B5 vs
:func:`kernels.autocorr_metric_prefix` (the same float32 prefix sums):
metric <= 1e-5, ``c`` within 1e-5 of max ``|c|``.

Every OFDM size the JAX package takes: B2 at M = 400 and 472 (the last
its one-pass kernel takes) and 476-8,192 (its window-sum path; a +40 dB
burst at 512 and 4,096, an exact plateau across a tile edge at 512, and
70,000 rows at 512, and at geometries with a span or an NMS window
shorter than a segment, against the segment reduction of the plain
metric), B1 at 1,028-4,096, B3 at 1,148 (the
last its persistent kernel takes), 1,152-4,096 and at a span inside one
chunk, B1 and B2 on 70,000 rows, all under the limits above; a
launch-only sweep over every
M that is a multiple of 4 from 8 to 4,096 (and 6,144, 8,192), each
output finite and of its shape; ``sync_block`` at M = 512 (B2), 1,028
(B1) and 1,152 (B3) decoding every frame with the CPU path's rows
(t_start and flags exact, valid payloads exact, ``cfo`` within 1e-5).

B1's period fold (``csrc/xcorr_fold.cu``) at M = 64, 256, 1,024, 1,028,
2,052 and 4,096 (rows holding a frame, rows shorter than the template's
reach, a +40 dB frame before quiet samples) and on 70,000 rows beside the
direct form: max abs difference <= 1e-4 as above (its segment sums run in
another order than the plain version's taps; the fold's model on the CPU
is within 2.4e-7, ``tests/test_torch_kernel_paths.py``), outputs at 0
(every segment gated) equal, and equal candidates (NMS radius M,
threshold 0.3).  B3's window sums at M = 1,152, 2,048 and 4,096 (1,148,
its persistent kernel, beside them), with and without the burst, under
B3's limits above with equal zeros and candidates, and at spans of at
most 9, also on 70,000 rows.

The flexframe path runs no kernel; its tests hold the card against the CPU:
the front end (``_mf_and_detect``) with identical detections and detected
offsets, ``mf`` within 1e-5 of max |mf| and the metric within 1e-4 where
the window energy is at least 100x the silence floor; ``msresamp_block`` with equal counts and
outputs within 1e-5 of max |y|; the batched sync decoding every frame, and
candidates past a window's end reading clamped indices.

The parallel layer: a 2-rank gloo world that shares the card runs
``sharded_mcrx`` at detect level 1; its rows equal the single-process
batched receiver's on the card in the detected/valid-masked fields
(``rssi`` atol 1e-3 dB, ``evm`` 0.05 dB, ``cfo`` 1e-5), and both ranks
launch B1, no other detect kernel, and the nearest-point kernel
(``csrc/nearest.cu``; the rank functions are in
``tests/torch_parallel_ranks.py``).

The payload codec's Viterbi kernel (``csrc/viterbi.cu``) equals its plain
version bit for bit on every trellis step: v27, v29, v39, v615, v27p34 and
v29p78, hard and soft costs, rows at 3 % and 30 % bit errors (exact ties)
and with erased runs, 1-70 rows of 6 to 16,422+ steps, the ``v27`` cell's
10 x 16,422, decisions on chip and in the global scratch; every conv
scheme's ``conv_decode``/``conv_decode_soft`` on the card equals the CPU's
without the plain loop running.

The soft decode path and the measurement ops run no kernel either: soft
LLRs within 1e-6 of max |LLR| of the CPU's with equal signs beyond, Golay
ML equal to the CPU except near-ties and unchanged at any float32 matmul
precision, the soft payload decode equal on header-valid rows, AGC within
a relative 1e-5, the spectrogram within 1e-3 dB, ring logs equal.
"""
import zlib

import numpy as np
import pytest
import torch

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.ops import kernels
from test_torch_kernel_paths import B2_ANY, b2_any_case, b2_segment_plain


@pytest.fixture(scope="module")
def loaded_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = ofdm.make_ofdm_params(48, 6, 4)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=128,
                               max_frames=8)
    rng = np.random.default_rng(0)
    ext = np.zeros((3, sync.overlap + sync.block_size), np.complex64)
    for row, pos in ((0, 2000), (1, 700), (2, 3900)):
        frame = ofdm.assemble_frame(
            params, ofdm.default_props(),
            torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, 256, 64, dtype=np.uint8)))
        ext[row, pos:pos + len(frame)] = frame.numpy()
    ext += (0.02 * (rng.normal(size=ext.shape) +
                    1j * rng.normal(size=ext.shape))).astype(np.complex64)
    return params, sync, torch.as_tensor(ext).cuda()


@pytest.mark.gpu
def test_b1_kernel_matches_plain(loaded_cuda):
    params, sync, x = loaded_cuda
    tmpl = np.tile(params.s0_time, ofdm.NUM_S0)
    n = sync.block_size + 2 * params.M + 1
    kernels.reset_launch_counts()
    got = kernels.detect_metric_xcorr_onepass(x, tmpl, 24, n)
    torch.cuda.synchronize()
    ref = kernels.detect_metric_xcorr_plain(x, tmpl, 24, n)
    assert float((got - ref).abs().max()) <= 1e-4
    assert kernels.launches["detect_metric_xcorr_onepass"] == 1


@pytest.mark.gpu
def test_b2_kernel_matches_plain(loaded_cuda):
    params, sync, x = loaded_cuda
    M = params.M
    kernels.reset_launch_counts()
    v, loc, c = kernels.detect_candidates_onepass(
        x, M // 4, 2 * M - M // 4, M, sync.block_size, 0.5, 8)
    torch.cuda.synchronize()
    vr, lr, _ = kernels.detect_candidates_plain(
        x, M // 4, 2 * M - M // 4, M, sync.block_size, 0.5, 8)
    _, c_full = kernels.autocorr_metric(x, M // 4, 2 * M - M // 4)
    assert torch.equal(v > 0, vr > 0)
    assert bool((v > 0).any())
    assert float((v - vr).abs().max()) <= 1e-4
    for row in range(x.shape[0]):
        assert sorted(loc[row][v[row] > 0].tolist()) == \
            sorted(lr[row][vr[row] > 0].tolist())
    det = v > 0
    c_ref = torch.gather(c_full, -1, loc.to(torch.int64))[det]
    assert float(((c[det] - c_ref).abs() / c_ref.abs()).max()) <= 1e-4
    assert kernels.launches["detect_candidates_onepass"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name,plain,limit", [
    ("detect_metric_onepass", "autocorr_metric", 1e-4),
    ("detect_metric_fused_2d", "autocorr_metric_prefix", 1e-5),
    ("detect_metric_fused", "autocorr_metric_prefix", 1e-5)])
def test_autocorr_kernels_match_plain(loaded_cuda, name, plain, limit):
    params, _, x = loaded_cuda
    lag = params.M // 4
    span = ofdm.NUM_S0 * params.M - lag
    kernels.reset_launch_counts()
    m, c = getattr(kernels, name)(x, lag, span)
    torch.cuda.synchronize()
    mr, cr = getattr(kernels, plain)(x, lag, span)
    assert m.shape == c.shape == mr.shape == (x.shape[0], x.shape[1] - span
                                              - lag + 1)
    assert float(mr.max()) > 0.5                  # the frames are there
    assert float((m - mr).abs().max()) <= limit
    assert float((c - cr).abs().max()) <= limit * float(cr.abs().max())
    assert kernels.launches[name] == 1


# --- the redesigned tilings of B1, B2 and B3 -------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _params(M):
    return ofdm.make_ofdm_params(M, {16: 4}.get(M, M // 8), {16: 2}.get(M, 4))


def _rows(M, length, rows, rng, loud=False):
    """``rows`` windows of ``length`` samples: frames at seeded offsets in
    0.02-rms noise; ``loud``: a frame at 100x amplitude (+40 dB in power
    over a unit frame) ending mid-window, then 0.01-rms noise and a unit
    frame after it."""
    params = _params(M)
    x = (0.02 * (rng.normal(size=(rows, length)) +
                 1j * rng.normal(size=(rows, length)))).astype(np.complex64)
    for r in range(rows):
        f = ofdm.assemble_frame(
            params, ofdm.default_props(),
            torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8))
        ).numpy()
        if loud:
            pos = int(rng.integers(0, max(1, length // 4)))
            n = min(len(f), length - pos)
            x[r, pos:pos + n] = 100.0 * f[:n]
            x[r, pos + n:] *= 0.5                    # 0.01-rms after it
            pos2 = pos + n + 3 * M
        else:
            pos2 = int(rng.integers(0, max(1, length - len(f) // 2)))
        n2 = max(0, min(len(f), length - pos2))
        x[r, pos2:pos2 + n2] += f[:n2]
    return x


def _check_b1(x, M):
    params = _params(M)
    tmpl = np.tile(params.s0_time, ofdm.NUM_S0)
    span = ofdm_sync._xc_span(len(tmpl))
    for n_metric in (x.shape[-1] - len(tmpl) + 1, x.shape[-1] // 3 + 7):
        kernels.reset_launch_counts()
        got = kernels.detect_metric_xcorr_onepass(x, tmpl, span, n_metric)
        torch.cuda.synchronize()
        ref = kernels.detect_metric_xcorr_plain(x, tmpl, span, n_metric)
        assert got.shape == ref.shape == (x.shape[0], n_metric)
        assert float((got - ref).abs().max()) <= 1e-4
        assert kernels.launches["detect_metric_xcorr_onepass"] == 1


def _check_b2(x, M, T, k=8, exact_locs=False):
    lag, win = M // 4, M
    span = ofdm.NUM_S0 * M - lag
    args = (x, lag, span, win, T, 0.5, k)
    kernels.reset_launch_counts()
    v, loc, c = kernels.detect_candidates_onepass(*args)
    torch.cuda.synchronize()
    vr, lr, _ = kernels.detect_candidates_plain(*args)
    _, c_full = kernels.autocorr_metric(x, lag, span)
    det = v > 0
    assert torch.equal(det, vr > 0)
    assert bool(det.any())
    assert float((v - vr).abs().max()) <= 1e-4
    det_h, loc_h, lr_h = det.cpu().numpy(), loc.cpu().numpy(), \
        lr.cpu().numpy()
    for row in range(x.shape[0]):
        a = np.sort(loc_h[row][det_h[row]])
        b = np.sort(lr_h[row][det_h[row]])
        limit = 0 if exact_locs else 3
        assert np.abs(a.astype(np.int64) - b).max(initial=0) <= limit
    c_ref = torch.gather(c_full, -1, loc.to(torch.int64))[det]
    assert float(((c[det] - c_ref).abs() / c_ref.abs()).max()) <= 1e-4
    assert kernels.launches["detect_candidates_onepass"] == 1


def _check_b3(x, M):
    lag = M // 4
    span = ofdm.NUM_S0 * M - lag
    kernels.reset_launch_counts()
    m, c = kernels.detect_metric_onepass(x, lag, span)
    torch.cuda.synchronize()
    mr, cr = kernels.autocorr_metric(x, lag, span)
    assert m.shape == c.shape == mr.shape == (x.shape[0], x.shape[1] - span
                                              - lag + 1)
    assert float((m - mr).abs().max()) <= 1e-4
    assert float((c - cr).abs().max()) <= 1e-4 * float(cr.abs().max())
    assert kernels.launches["detect_metric_onepass"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("M", [16, 48, 64, 128])
@pytest.mark.parametrize("length", [1500, 2048 + 95, 4096 + 2 * 2048 + 777])
def test_b1_tiling_matches_plain(cuda, M, length):
    """Rows shorter than one 2,048-output tile, and ragged lengths and
    ``n_metric`` (not multiples of the tile or of 8 outputs a thread)."""
    rng = np.random.default_rng(M * 7 + length)
    x = torch.as_tensor(_rows(M, length, 3, rng)).to(cuda)
    _check_b1(x, M)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [32, 48, 64, 128])
@pytest.mark.parametrize("length", [1700, 2112 + 500, 4096 + 3 * 2112 + 333])
def test_b2_tiling_matches_plain(cuda, M, length):
    """Rows shorter than one tile and ragged ``n_out`` (not a multiple of
    64 or of the tile), at each M that reaches B2."""
    rng = np.random.default_rng(M * 11 + length)
    x = torch.as_tensor(_rows(M, length, 3, rng)).to(cuda)
    n_out = length - (ofdm.NUM_S0 * M - M // 4) - M // 4 + 1
    _check_b2(x, M, T=n_out - 2 * M)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [16, 32, 48, 64])
@pytest.mark.parametrize("length,rows,loud", [
    (1700, 3, False),              # shorter than one tile, n_out odd
    (2209 + 500, 3, False),        # ends mid-tile, n_out even
    (3 * 2208 + 751, 5, False),    # several tiles, n_out even
    (100366, 24, False),           # the path's rows; 2-3 tiles a block
    (3 * 4096 + 123, 4, True)])    # a +40 dB burst, then quiet noise
def test_b3_tiling_matches_plain(cuda, M, length, rows, loud):
    """B3's tiles, the persistent loop over them and the scalar heads and
    tails of its 16-byte stores, against the plain version."""
    rng = np.random.default_rng(M * 13 + length)
    x = torch.as_tensor(_rows(M, length, rows, rng, loud=loud)).to(cuda)
    _check_b3(x, M)


@pytest.mark.gpu
def test_b3_takes_windows_up_to_its_tile(cuda):
    """span + lag = 2301 leaves the persistent kernel's tile 4 outputs;
    one more, and a span inside one of its chunks, take the window sums of
    any length: all three match the plain version."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor((0.1 * (rng.normal(size=(3, 3000)) + 1j *
                                rng.normal(size=(3, 3000)))
                         ).astype(np.complex64)).to(cuda)
    for lag, span in ((300, 2001), (300, 2002), (2, 9)):
        m, c = kernels.detect_metric_onepass(x, lag, span)
        torch.cuda.synchronize()
        mr, cr = kernels.autocorr_metric(x, lag, span)
        assert m.shape == mr.shape == (3, 3000 - span - lag + 1)
        assert float((m - mr).abs().max()) <= 1e-4
        assert float((c - cr).abs().max()) <= 1e-4 * float(cr.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("M", [32, 48, 64])
def test_b1_b2_loud_burst_then_quiet(cuda, M):
    """A +40 dB frame, then 0.01-rms noise and a unit frame: the window
    sums of the quiet samples must carry no residue of the burst."""
    rng = np.random.default_rng(M)
    length = 3 * 4096 + 123
    x = torch.as_tensor(_rows(M, length, 4, rng, loud=True)).to(cuda)
    n_out = length - (ofdm.NUM_S0 * M - M // 4) - M // 4 + 1
    _check_b2(x, M, T=n_out - 2 * M)
    _check_b1(x, M)


@pytest.mark.gpu
def test_b2_plateau_keeps_the_lowest_offset(cuda):
    """Runs of the constant sample 1: every window sum is an exact integer,
    so the metric is exactly 1 over each run; every segment there must
    pick its lowest offset, as the plain version does."""
    M = 48
    x = np.zeros((2, 3 * 4096), np.complex64)
    x[0, 1000:1700] = 1.0
    x[0, 5000:9000] = 1.0
    x[1, 2113:2113 + 2500] = 1.0             # across a tile edge
    x = torch.as_tensor(x).to(cuda)
    _check_b2(x, M, T=x.shape[-1] - 4 * M, k=80, exact_locs=True)


@pytest.mark.gpu
def test_b2_window_sums_plateau_keeps_the_lowest_offset(cuda):
    """The window-sum path (M = 512: tiles of 896 outputs) on runs of the
    constant sample 1, one across a tile edge: every segment of a run must
    pick its lowest offset, as the plain version does, also where the
    segment's two parts lie in two tiles."""
    M = 512
    x = np.zeros((2, 16 * 896), np.complex64)
    x[0, 3000:6000] = 1.0
    x[1, 5 * 896 - 300:5 * 896 + 2700] = 1.0   # across a tile edge
    x[1, 10000:12500] = 1.0
    x = torch.as_tensor(x).to(cuda)
    _check_b2(x, M, T=x.shape[-1] - 4 * M, k=80, exact_locs=True)


@pytest.mark.gpu
def test_b2_window_sums_take_70000_rows(cuda):
    """70,000 rows at M = 512 (more than a grid's y dimension holds) on the
    window-sum path, every seventh with a frame's S0 in its detect
    region."""
    M, n = 512, 2600
    rng = np.random.default_rng(70512)
    x = (0.02 * (rng.normal(size=(70000, n)) + 1j *
                 rng.normal(size=(70000, n)))).astype(np.complex64)
    f = ofdm.assemble_frame(
        _params(M), ofdm.default_props(),
        torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
        torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8))).numpy()
    for r in range(0, 70000, 7):
        pos = 600 + r % 90
        x[r, pos:] += f[:n - pos]
    x = torch.as_tensor(x).to(cuda)
    n_out = n - (ofdm.NUM_S0 * M - M // 4) - M // 4 + 1
    _check_b2(x, M, T=n_out - 2 * M, k=4)     # 25 segments a row


@pytest.mark.gpu
@pytest.mark.parametrize("lag,span,win", B2_ANY)
def test_b2_window_sums_take_any_geometry(cuda, lag, span, win):
    """B2's window-sum path at the geometries that its one-pass kernel
    refuses with a span or an NMS window shorter than a segment
    (``tests/test_torch_kernel_paths.py``'s ``B2_ANY`` and its rows:
    segments across up to 22 tiles, win from 0 to 40): against
    ``b2_segment_plain`` (the plain version itself where win >= 64) at
    ``_check_b2``'s limits, offsets equal on the constant row."""
    x, args = b2_any_case(lag, span, win)
    x = torch.as_tensor(x)
    kernels.reset_launch_counts()
    v, loc, c = (t.cpu() for t in kernels.detect_candidates_onepass(
        x.to(cuda), *args))
    vr, lr = b2_segment_plain(x.numpy(), *args)
    _, c_full = kernels.autocorr_metric(x, lag, span)
    det = v > 0
    assert torch.equal(det, vr > 0) and bool(det.any())
    assert float((v - vr).abs().max()) <= 1e-4
    for row in range(x.shape[0]):
        a, b = np.sort(loc[row][det[row]]), np.sort(lr[row][det[row]])
        assert np.abs(a.astype(np.int64) - b).max(initial=0) <= (
            0 if row == 2 else 3)
    c_ref = torch.gather(c_full, -1, loc.to(torch.int64))[det]
    assert float(((c[det] - c_ref).abs() / c_ref.abs()).max()) <= 1e-4
    assert kernels.cand_paths == {"m48": 0, "one_pass": 0, "window_sums": 1}


# --- every OFDM size the JAX package takes (B1-B3 at large M) -------------

def _large_rows(M, rows, seed, loud=False):
    """``rows`` windows holding a frame at M (16-byte payload) with room
    for its detect region: the frame's length plus 6 M samples."""
    params = _params(M)
    n = ofdm.frame_length(params, ofdm.default_props(), 16) + 6 * M
    return torch.as_tensor(_rows(M, n, rows, np.random.default_rng(seed),
                                 loud=loud))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [400, 472, 476, 512, 560, 1024, 2048, 4096,
                               8192])
def test_b2_large_m_matches_plain(cuda, M):
    """B2 past its one-block halo (M >= 476), where its window-sum path
    takes windows of any length (one chunk a block up to 512, balanced
    chunks from 516: two of 455 at 560); M = 512 and 4,096 also with a
    +40 dB burst; beside them its one-pass kernel at 472, the largest M it
    takes, and 400, where the last thread's window sums read chunk totals
    past the third plane."""
    assert kernels.candidates_path(M // 4, 7 * M // 4, M) == (
        "window_sums" if M >= 476 else "one_pass")
    for loud in ((False, True) if M in (512, 4096) else (False,)):
        x = _large_rows(M, 3, M, loud).to(cuda)
        n_out = x.shape[-1] - (ofdm.NUM_S0 * M - M // 4) - M // 4 + 1
        _check_b2(x, M, T=n_out - 2 * M)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1028, 2048, 2052, 4096])
def test_b1_large_m_matches_plain(cuda, M):
    """B1 with more than 256 segments or 4,096 padded taps (1,028: 257
    segments of 8; 2,052: 513 of 8; 4,096: 512 of 16), in passes over its
    segments; 2,048 (256 of 16) is the control."""
    _check_b1(_large_rows(M, 3, M).to(cuda), M)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1148, 1152, 2048, 4096])
def test_b3_large_m_matches_plain(cuda, M):
    """B3 past its persistent kernel's tile (span + lag > 2,301), and at
    1,148, the largest M that kernel takes."""
    _check_b3(_large_rows(M, 3, M).to(cuda), M)


def _same_candidates(got, ref, M):
    """The detect front end's candidates (NMS radius M, threshold 0.3, 4 a
    row) of two metrics: equal flags and equal offsets where detected."""
    from liquid_usrp_tpu_torch.ops import corr
    T = got.shape[-1] - 2 * M
    vg, lg = corr.find_candidates(got, M, T, 0.3, 4)
    vr, lr = corr.find_candidates(ref, M, T, 0.3, 4)
    assert torch.equal(vg > 0, vr > 0)
    assert torch.equal(lg[vg > 0], lr[vr > 0])


@pytest.mark.gpu
@pytest.mark.parametrize("M", [64, 256, 1024, 1028, 2052, 4096])
@pytest.mark.parametrize("kind", ["frames", "short", "loud"])
def test_b1_fold_matches_plain(cuda, M, kind):
    """B1's period-fold path (``csrc/xcorr_fold.cu``) against the plain
    version: rows holding a frame, rows shorter than the template's reach
    (zero padding), and a +40 dB frame before quiet samples.  Max abs
    difference <= 1e-4 (as every B1 test; the fold sums each segment's
    taps in another order), outputs under the floor (every segment gated)
    equal 0 in both, equal candidates."""
    params = _params(M)
    tmpl = np.tile(params.s0_time, ofdm.NUM_S0)
    span = ofdm_sync._xc_span(len(tmpl))
    assert kernels.xcorr_path(tmpl, span) == "fold"
    if kind == "short":
        x = _large_rows(M, 3, M)[:, :len(tmpl) + 3 * M].to(cuda)
        n_metric = x.shape[-1] + 2 * M
    else:
        x = _large_rows(M, 3, M, loud=kind == "loud").to(cuda)
        n_metric = x.shape[-1] - len(tmpl) + 1
    kernels.reset_launch_counts()
    got = kernels.detect_metric_xcorr_onepass(x, tmpl, span, n_metric)
    torch.cuda.synchronize()
    ref = kernels.detect_metric_xcorr_plain(x, tmpl, span, n_metric)
    assert got.shape == ref.shape == (3, n_metric)
    assert float((got - ref).abs().max()) <= 1e-4
    assert torch.equal(got == 0, ref == 0)
    if kind != "short":
        _same_candidates(got, ref, M)
    assert kernels.launches["detect_metric_xcorr_onepass"] == 1
    assert kernels.xcorr_paths == {"const": 0, "fold": 1, "direct": 0}


@pytest.mark.gpu
def test_b1_fold_and_direct_take_70000_rows(cuda):
    """More rows than a grid's y dimension holds, through the fold (M = 64,
    an S0 template) and the direct form (a template with no period)."""
    M, n = 64, 520
    rng = np.random.default_rng(70001)
    x = (0.02 * (rng.normal(size=(70000, n)) + 1j *
                 rng.normal(size=(70000, n)))).astype(np.complex64)
    tmpl = np.tile(_params(M).s0_time, ofdm.NUM_S0)
    for r in range(0, 70000, 7):
        pos = 40 + r % 200
        x[r, pos:pos + len(tmpl)] += tmpl
    x = torch.as_tensor(x).to(cuda)
    noise = (rng.normal(size=len(tmpl)) + 1j * rng.normal(size=len(tmpl))
             ).astype(np.complex64)
    n_metric = n - len(tmpl) + 1
    for t, path in ((tmpl, "fold"), (noise, "direct")):
        kernels.reset_launch_counts()
        got = kernels.detect_metric_xcorr_onepass(x, t, 16, n_metric)
        torch.cuda.synchronize()
        ref = kernels.detect_metric_xcorr_plain(x, t, 16, n_metric)
        assert float((got - ref).abs().max()) <= 1e-4
        assert kernels.xcorr_paths[path] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1148, 1152, 2048, 4096])
@pytest.mark.parametrize("loud", [False, True])
def test_b3_window_path_matches_plain(cuda, M, loud):
    """B3 past its persistent kernel's tile (chunked window sums, metric
    and c written once), and at 1,148, the largest M that kernel takes:
    rows holding a frame, with and without a +40 dB frame before quiet
    samples, against the plain version (metric <= 1e-4, c within 1e-4 of
    max |c|), equal gates (outputs at 0) and equal candidates."""
    x = _large_rows(M, 3, M + 1, loud=loud).to(cuda)
    _check_b3(x, M)
    lag, span = M // 4, ofdm.NUM_S0 * M - M // 4
    m, _ = kernels.detect_metric_onepass(x, lag, span)
    mr, _ = kernels.autocorr_metric(x, lag, span)
    assert torch.equal(m == 0, mr == 0)
    _same_candidates(m, mr, M)


@pytest.mark.gpu
@pytest.mark.parametrize("lag,span,rows,length", [
    (2, 9, 3, 3000), (5, 3, 3, 2000), (300, 1, 2, 5000), (7, 8, 70000, 90)])
def test_b3_short_spans_match_plain(cuda, lag, span, rows, length):
    """Spans of at most 9 (term-by-term window sums), also on 70,000 rows."""
    rng = np.random.default_rng(lag * 100 + span)
    x = torch.as_tensor((0.1 * (rng.normal(size=(rows, length)) + 1j *
                                rng.normal(size=(rows, length)))
                         ).astype(np.complex64)).to(cuda)
    m, c = kernels.detect_metric_onepass(x, lag, span)
    torch.cuda.synchronize()
    mr, cr = kernels.autocorr_metric(x, lag, span)
    assert m.shape == mr.shape == (rows, length - span - lag + 1)
    assert float((m - mr).abs().max()) <= 1e-4
    assert float((c - cr).abs().max()) <= 1e-4 * float(cr.abs().max())


@pytest.mark.gpu
def test_b1_b2_take_70000_rows(cuda):
    """More rows than a grid's y dimension holds (65,535): 70,000 short
    rows at M=48, every seventh with a frame's S0 in its detect region."""
    M, n = 48, 400
    rng = np.random.default_rng(70000)
    x = (0.02 * (rng.normal(size=(70000, n)) + 1j *
                 rng.normal(size=(70000, n)))).astype(np.complex64)
    f = ofdm.assemble_frame(
        _params(M), ofdm.default_props(),
        torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
        torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8))).numpy()
    for r in range(0, 70000, 7):
        pos = 60 + r % 90
        x[r, pos:] += f[:n - pos]
    x = torch.as_tensor(x).to(cuda)
    n_out = n - (ofdm.NUM_S0 * M - M // 4) - M // 4 + 1
    _check_b2(x, M, T=n_out - 2 * M, k=4)     # 5 segments a row
    _check_b1(x, M)


def _sweep_sizes():
    return list(range(8, 4097, 4)) + [6144, 8192]


@pytest.mark.gpu
def test_every_ofdm_size_launches(cuda):
    """Launch-only sweep over every M that is a multiple of 4 from 8 to
    4,096, and 6,144 and 8,192: the kernel of each detect level that M
    reaches (B1 at level 1, B2 at level 2 from M = 32, B3 at level 2 below
    and on the legacy detector) returns finite output of its shape, on 2
    rows of seeded noise of 4 M + 1,024 samples (a 1,024-sample block)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    for M in _sweep_sizes():
        n = 4 * M + 1024
        x = torch.randn((2, n), dtype=torch.complex64, device=cuda,
                        generator=gen)
        lag, span = M // 4, ofdm.NUM_S0 * M - M // 4
        tmpl = np.exp(2j * np.pi * np.arange(2 * M) / 4).astype(np.complex64)
        n_metric = 1024 + 2 * M + 1
        b1 = kernels.detect_metric_xcorr_onepass(
            x, tmpl, ofdm_sync._xc_span(2 * M), n_metric)
        m, c = kernels.detect_metric_onepass(x, lag, span)
        outs = [(b1, (2, n_metric)), (m, (2, n - span - lag + 1)),
                (c, (2, n - span - lag + 1))]
        if M >= 32:
            v, loc, ca = kernels.detect_candidates_onepass(
                x, lag, span, M, 1024, 0.5, 8)
            outs += [(v, (2, 8)), (loc, (2, 8)), (ca, (2, 8))]
        torch.cuda.synchronize()
        for out, shape in outs:
            assert tuple(out.shape) == shape, (M, out.shape)
            assert bool(torch.isfinite(out).all()), M


@pytest.mark.gpu
@pytest.mark.parametrize("M,level,xcorr", [(512, 2, True), (1028, 1, True),
                                           (1152, 1, False)])
def test_sync_block_large_m_on_the_card(cuda, M, level, xcorr):
    """``sync_block`` on the card at M = 512 (level 2: B2), 1,028 (level 1:
    B1) and 1,152 (the legacy detector at level 1: B3) decodes every frame
    payload-exact, with the rows of the port's CPU path on the same
    samples."""
    import torch_sync_streams as tss
    stream, sent = tss.frame_stream(M, 2, M)
    sync = ofdm_sync.make_sync(tss.params_at(M), block_size=8192,
                               max_payload=64, max_frames=4,
                               use_pallas=level, xcorr_detect=xcorr)
    kernels.reset_launch_counts()
    got = tss.sync_rows(sync, stream, cuda)
    name = {2: "detect_candidates_onepass", 1: "detect_metric_xcorr_onepass"
            if xcorr else "detect_metric_onepass"}[level]
    assert kernels.launches[name] > 0
    tss.assert_decodes_sent(got, sent)
    tss.assert_same_rows(got, tss.sync_rows(sync, stream, "cpu"))


# ---------------------------------------------------------------------------
# the single-carrier flexframe path (no kernel): the card against the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flex_stream():
    """Six 1024-byte QPSK flexframes (the ``flexframe_tx`` defaults) at
    -12 dB with 150-sample zero gaps, at 2 samples a symbol, and the sync
    of ``flexframe_rx`` (``block_size=8192``, ``max_payload=2048``,
    ``max_frames=4``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liquid_usrp_tpu_torch.framing import flexframe as ff
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    rng = np.random.default_rng(11)
    params = ff.make_flex_params()
    pieces = [np.zeros(150, np.complex64)]
    for _ in range(6):
        h = torch.as_tensor(rng.integers(0, 256, 14, dtype=np.uint8))
        p = torch.as_tensor(rng.integers(0, 256, 1024, dtype=np.uint8))
        w = ff.flex_assemble(params, ff.default_props(), h, p).numpy()
        pieces += [w * 10 ** (-12 / 20), np.zeros(150, np.complex64)]
    sync = fs.make_flex_sync(params, block_size=8192, max_payload=2048,
                             max_frames=4)
    return np.concatenate(pieces), sync


def _flex_windows(sync, stream, first_block, n=8):
    """The extended windows of ``n`` blocks from ``first_block``."""
    bs = sync.block_size
    full = np.zeros(sync.overlap + (first_block + n) * bs, np.complex64)
    body = stream[:(first_block + n) * bs]
    full[sync.overlap:sync.overlap + len(body)] = body
    return torch.as_tensor(full).unfold(0, sync.overlap + bs, bs)[
        first_block:first_block + n]


@pytest.mark.gpu
def test_flex_front_end_cuda_matches_cpu(cuda, flex_stream):
    """``_mf_and_detect`` on the card against the same call on CPU tensors
    over windows that detect frames: detections and their offsets
    identical, ``mf`` within 1e-5 of max |mf|, the metric within 1e-4
    where the window energy is at least 100x the silence floor (the
    float32 cumsum of the energy rounds in another order on each device,
    which moves near-silent outputs)."""
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.ops.corr import comb_moving_sum
    stream, sync = flex_stream
    kernels.reset_launch_counts()
    for first in (8, 16):
        ext = _flex_windows(sync, stream, first)
        got = fs._mf_and_detect(sync, ext.to(cuda))
        torch.cuda.synchronize()
        ref = fs._mf_and_detect(sync, ext)
        mf, metric, _, _, det, locs = (v.cpu() for v in got)
        # the offsets of undetected slots are unspecified (top-k ties)
        assert torch.equal(det, ref[4]) and torch.equal(locs[det],
                                                        ref[5][det])
        assert bool(det.any())
        assert float((mf - ref[0]).abs().max()) <= \
            1e-5 * float(ref[0].abs().max())
        pw = ref[0].abs() ** 2
        e = comb_moving_sum(pw, 32, 2, metric.shape[-1] + 64)
        energy = e[..., :metric.shape[-1]] + e[..., 64:]
        loud = energy > 100 * 1e-4 * 64 * pw.mean(-1, keepdim=True)
        assert float((metric - ref[1]).abs()[loud].max()) <= 1e-4
    assert not any(kernels.launches.values())


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.5, 2.0, 1.33])
def test_msresamp_cuda_matches_cpu(cuda, flex_stream, rate):
    from liquid_usrp_tpu_torch.ops import resamp
    stream = torch.as_tensor(flex_stream[0][:40000])
    ms = resamp.msresamp_create(rate)
    outs = []
    for dev in (cuda, "cpu"):
        st = resamp.msresamp_state(ms, dev)
        ys = []
        for lo in (0, 24000):
            st, y, _, c = resamp.msresamp_block(ms, st,
                                                stream[lo:lo + 16000].to(dev))
            ys.append(y[:int(c)].cpu())
        outs.append(torch.cat(ys))
    assert outs[0].shape == outs[1].shape
    assert float((outs[0] - outs[1]).abs().max()) <= \
        1e-5 * float(outs[1].abs().max())


@pytest.mark.gpu
def test_flex_sync_on_the_card_and_clamped_candidates(cuda, flex_stream):
    """The batched sync decodes every frame on the card; candidates at and
    past a window's end read clamped indices (no device assert)."""
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    stream, sync = flex_stream
    n_ok = 0
    st = fs.flex_sync_init(sync, cuda)
    n_blk = -(-(len(stream) + sync.overlap) // sync.block_size) + 1
    x = np.zeros(n_blk * sync.block_size, np.complex64)
    x[:len(stream)] = stream
    for lo in range(0, n_blk, 8):
        blocks = torch.as_tensor(x[lo * 8192:(lo + 8) * 8192]).to(cuda)
        blocks = torch.nn.functional.pad(blocks, (0, 8 * 8192 -
                                                  blocks.shape[0]))
        st, res = fs.flex_sync_blocks_batched(sync, st,
                                              blocks.reshape(8, 8192))
        n_ok += int(_to_host(res).payload_valid.sum())
    assert n_ok == 6
    ext = _flex_windows(sync, stream, 8).to(cuda)
    mf, metric, c1, c2, _, _ = fs._mf_and_detect(sync, ext)
    n = metric.shape[-1]
    locs = torch.tensor([n - 1, n + 7000, 2 ** 30, 0], dtype=torch.int32,
                        device=cuda)
    row_of = torch.tensor([7, 0, 3, 7], device=cuda)
    out = fs._decode_candidate(sync, mf, metric, row_of, locs,
                               fs._row_gather(c1, row_of, locs),
                               fs._row_gather(c2, row_of, locs))
    torch.cuda.synchronize()
    assert out[0].shape == (4, sync.header_user)


# ---------------------------------------------------------------------------
# the soft decode path and the measurement ops (no kernel): card vs CPU
# ---------------------------------------------------------------------------

def _llr_close(got, want, rtol=1e-6):
    tol = rtol * max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol
    sure = want.abs() > tol
    assert torch.equal(torch.sign(got[sure]), torch.sign(want[sure]))


@pytest.mark.gpu
@pytest.mark.parametrize("n_table,scheme", [(64, "qpsk"), (64, "dpsk4"),
                                            (256, "qam256")])
def test_generic_demod_soft_cuda_matches_cpu(cuda, n_table, scheme):
    """LLRs within 1e-6 of max |LLR| of the CPU's, equal signs beyond."""
    from liquid_usrp_tpu_torch.framing import payload as pc
    from liquid_usrp_tpu_torch.ops import modem
    rng = np.random.default_rng(7)
    x = torch.as_tensor((rng.normal(size=(6, 3001)) + 1j *
                         rng.normal(size=(6, 3001))).astype(np.complex64))
    mod = torch.full((6,), modem.mod_from_name(scheme), dtype=torch.int32)
    want = pc.generic_demod_soft(x, mod, 3001 * 4, n_table)
    got = pc.generic_demod_soft(x.to(cuda), mod.to(cuda), 3001 * 4,
                                n_table).cpu()
    _llr_close(got, want)
    d = modem.demodulate_soft(modem.MOD_QAM16, x.to(cuda)).cpu()
    _llr_close(d, modem.demodulate_soft(modem.MOD_QAM16, x))


@pytest.mark.gpu
def test_golay_soft_cuda_matches_cpu_at_any_matmul_precision(cuda):
    """The float64 scores do not depend on TF32 or the float32 matmul
    precision: equal to the CPU except near-ties, and unchanged under
    ``set_float32_matmul_precision("medium")``."""
    from liquid_usrp_tpu_torch.ops import fec
    rng = np.random.default_rng(8)
    L = torch.as_tensor(rng.normal(size=(4096, 24)).astype(np.float32))
    want = fec.golay_decode_soft(L)
    got = fec.golay_decode_soft(L.to(cuda)).cpu()
    top2 = torch.topk(fec._golay_scores(L), 2).values
    tie = (top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0].abs().clamp(min=1)
    assert not ((got != want).any(-1) & ~tie).any()
    prev = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cuda.matmul.allow_tf32 = True
        again = fec.golay_decode_soft(L.to(cuda)).cpu()
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(again, got)


@pytest.mark.gpu
def test_soft_payload_decode_cuda_matches_cpu(cuda):
    """``decode_payload_batch_soft`` with v27 (channel LLRs and
    pseudo-LLRs), Golay and none rows: the card equals the CPU on the
    header-valid rows and decodes every payload."""
    from liquid_usrp_tpu_torch.framing import ofdm
    from liquid_usrp_tpu_torch.framing import payload as pc
    from liquid_usrp_tpu_torch.ops import crc, fec, modem
    from liquid_usrp_tpu_torch.utils.bits import unpack_bits
    rng = np.random.default_rng(9)
    combos = [(fec.FEC_CONV_V27, fec.FEC_NONE),
              (fec.FEC_CONV_V27, fec.FEC_HAMMING128),
              (fec.FEC_NONE, fec.FEC_GOLAY2412), (fec.FEC_NONE, fec.FEC_NONE)]
    plen, enc_max = 64, 3 * 68 * 2
    P = torch.zeros((len(combos), enc_max * 8 + 1), dtype=torch.complex64)
    pays = []
    for r, (f0, f1) in enumerate(combos):
        props = ofdm.FrameProps(check=crc.CRC_32, fec0=f0, fec1=f1,
                                mod=modem.MOD_QPSK)
        pay = rng.integers(0, 256, plen, dtype=np.uint8)
        bits = unpack_bits(pc.encode_payload(props, torch.as_tensor(pay)))
        pts = modem.modulate(modem.MOD_QPSK,
                             modem.bits_to_symbols(bits, 2))
        pts = pts + torch.as_tensor((0.3 * (rng.normal(size=pts.shape) + 1j
                                            * rng.normal(size=pts.shape))
                                     ).astype(np.complex64))
        P[r, :pts.shape[0]] = pts
        pays.append(pay)

    def col(i):
        return torch.tensor([c[i] for c in combos], dtype=torch.int32)
    args = (torch.full((4,), modem.MOD_QPSK, dtype=torch.int32), col(0),
            col(1), torch.full((4,), crc.CRC_32, dtype=torch.int32),
            torch.full((4,), plen, dtype=torch.int32),
            torch.tensor([True, True, True, False]))
    want = pc.decode_payload_batch_soft(enc_max, plen + 4, plen, P, *args,
                                        fecs=pc.PAYLOAD_FECS_FULL)
    got = pc.decode_payload_batch_soft(
        enc_max, plen + 4, plen, P.to(cuda), *(a.to(cuda) for a in args),
        fecs=pc.PAYLOAD_FECS_FULL)
    got = [v.cpu() for v in got]
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][:3], want[0][:3])
    assert got[1][:2].all()
    for r in range(2):
        assert np.array_equal(got[0][r].numpy(), pays[r])


@pytest.mark.gpu
def test_measurement_ops_cuda_match_cpu(cuda):
    """AGC within a relative 1e-5 of the CPU, the spectrogram within 1e-3
    dB with the same peak bins, ring logs equal."""
    from liquid_usrp_tpu_torch.ops import agc, spectrum, window
    rng = np.random.default_rng(10)
    x = torch.as_tensor((np.repeat([0.3, 3.0], 10000) *
                         (rng.normal(size=20000) + 1j *
                          rng.normal(size=20000))).astype(np.complex64))
    outs = [agc.agc_block(agc.agc_init(0.01, device=d), x.to(d))
            for d in (cuda, "cpu")]
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-6)
    sg = spectrum.spectrogram_create(64)
    got = spectrum.spectrogram_block(sg, x[:19968].to(cuda))
    want = spectrum.spectrogram_block(sg, x[:19968])
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-3
    assert torch.equal(got[2].cpu(), want[2])
    rings = [window.ring_init(1024, device=d) for d in (cuda, "cpu")]
    for lo, hi in ((0, 700), (700, 900), (900, 5000)):
        rings = [window.ring_push(r, x[lo:hi].to(r.buf.device))
                 for r in rings]
    assert torch.equal(rings[0].buf.cpu(), rings[1].buf)
    assert int(rings[0].count) == 1024


@pytest.mark.gpu
def test_wlan_viterbi_and_demap_cuda_match_cpu(cuda):
    """The WLAN soft Viterbi gives the CPU's bits on the same pairs (with
    erasures and exact ties); the soft demap is within 1e-6 of max |LLR|."""
    from liquid_usrp_tpu_torch.framing import wlan
    rng = np.random.default_rng(11)
    pairs = rng.normal(size=(4, 2300, 2)).astype(np.float32)
    pairs[1] = np.round(pairs[1] * 2) / 2
    pairs[2, 1000:] = 0.0
    pairs[3, rng.random((2300, 2)) < 0.3] = 0.0
    p = torch.as_tensor(pairs)
    assert torch.equal(wlan._viterbi_soft(p.to(cuda)).cpu(),
                       wlan._viterbi_soft(p))
    pts = torch.as_tensor((rng.normal(size=5000) + 1j *
                           rng.normal(size=5000)).astype(np.complex64))
    for bpsc in (1, 2, 4, 6):
        want = wlan._demap_soft(pts, bpsc)
        got = wlan._demap_soft(pts.to(cuda), bpsc).cpu()
        assert float((got - want).abs().max()) <= \
            1e-6 * float(want.abs().max())


# --- the payload codec's Viterbi kernel (csrc/viterbi.cu) ------------------

VITERBI_SCHEMES = ("v27", "v29", "v39", "v615", "v27p34", "v29p78")
# (rows, payload bytes): T = 8 n + K - 1 steps, from the shortest code to
# the --conv receiver's 2,052-byte budget (16,422 steps at K = 7), mostly
# not a multiple of 32 or 256; 10 x 2,052 is the ofdm1_conv.v27 cell's shape
VITERBI_SHAPES = ((1, 0), (3, 37), (70, 125), (1, 2052), (10, 2052),
                  (70, 2052))


def viterbi_costs(name, soft, rows, n_bytes, device):
    """Branch costs of ``rows`` encoded words on ``device`` and their
    ``big``, by row: 3 % bit errors (LLRs at 4 plus unit noise), 30 % (LLRs
    at 0.5: exact ties are frequent on hard bits), and 3 % with a run of a
    third of the steps erased (every cost 0)."""
    from liquid_usrp_tpu_torch.ops import conv, fec
    s = fec.fec_from_name(name)
    rng = np.random.default_rng(zlib.crc32(
        f"viterbi {name} {soft} {rows} {n_bytes}".encode()))
    data = rng.integers(0, 256, (rows, n_bytes), dtype=np.uint8)
    bits = np.unpackbits(fec.fec_encode(s, torch.as_tensor(data)).numpy(),
                         axis=-1)
    weak = (np.arange(rows) % 3 == 1)[:, None]
    if soft:
        llr = (2.0 * bits - 1.0) * np.where(weak, 0.5, 4.0) + \
            rng.normal(size=bits.shape)
        costs = conv._soft_costs(s, torch.as_tensor(llr, dtype=torch.float32),
                                 n_bytes)
    else:
        flips = rng.random(bits.shape) < np.where(weak, 0.3, 0.03)
        costs = conv._hard_costs(
            s, torch.as_tensor(np.packbits(bits ^ flips, axis=-1)), n_bytes)
    T = costs.shape[1]
    costs[2::3, T // 3:2 * T // 3] = 0
    return s, costs.to(device), conv.BIG_SOFT if soft else conv.BIG_HARD


@pytest.mark.gpu
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("name", VITERBI_SCHEMES)
def test_viterbi_kernel_matches_plain(cuda, name, soft):
    """Every trellis step's bit equals the plain version's on the card, one
    launch a call, at every shape of ``VITERBI_SHAPES`` (v615 up to 70
    rows of 125 bytes and 1 of 2,052: its plain version keeps T x S bools
    a row)."""
    from liquid_usrp_tpu_torch.ops import conv
    for rows, n_bytes in VITERBI_SHAPES:
        if name == "v615" and rows * n_bytes > 2052:
            continue
        if (rows, n_bytes) == (10, 2052) and name != "v27":
            continue
        s, costs, big = viterbi_costs(name, soft, rows, n_bytes, cuda)
        kernels.reset_launch_counts()
        got = conv._viterbi(s, costs, big)
        assert kernels.launches["viterbi"] == 1
        want = conv._viterbi_plain(s, costs, big)
        assert torch.equal(got, want), (rows, n_bytes)
        assert kernels.launches["viterbi"] == 1


@pytest.mark.gpu
def test_viterbi_kernel_global_decisions_match_plain(cuda):
    """Decisions past the shared memory go to the global scratch: 64 states
    over 29,606 steps (231 KB of decisions) and 256 over the receiver's
    budget; 256 states over 1,006 steps keep them on chip.  Each matches
    the plain version."""
    from liquid_usrp_tpu_torch.ops import conv
    for name, rows, n_bytes, on_chip in (("v27", 3, 3700, False),
                                         ("v29", 3, 2052, False),
                                         ("v29", 3, 125, True)):
        s, costs, big = viterbi_costs(name, False, rows, n_bytes, cuda)
        B, T, P = costs.shape
        S = 1 << (conv._params(s).K - 1)
        nbytes = kernels._scratch_bytes("viterbi_scratch", B, T, S, P)
        assert (nbytes == 0) == on_chip
        if not on_chip:
            assert nbytes == B * T * S // 8
        assert torch.equal(conv._viterbi(s, costs, big),
                           conv._viterbi_plain(s, costs, big)), name


@pytest.mark.gpu
def test_viterbi_kernel_refuses_and_never_runs_the_loop(cuda, monkeypatch):
    """Non-int32, non-contiguous or mis-shaped costs raise; on the card
    ``_viterbi`` never runs the plain loop; every conv scheme's
    ``conv_decode`` and ``conv_decode_soft`` on the card equal the CPU's."""
    from liquid_usrp_tpu_torch.ops import conv, fec
    s, costs, big = viterbi_costs("v27", False, 3, 37, cuda)
    with pytest.raises(TypeError):
        conv._viterbi(s, costs.to(torch.int64), big)
    with pytest.raises(ValueError):
        conv._viterbi(s, costs[:, ::2], big)
    with pytest.raises(ValueError):
        conv._viterbi(s, costs[..., :2].contiguous(), big)

    def loop(*args, **kw):
        raise AssertionError("the plain loop ran on the card")
    kernels.reset_launch_counts()
    monkeypatch.setattr(conv, "_viterbi_plain", loop)
    rng = np.random.default_rng(zlib.crc32(b"viterbi decode"))
    cpu = {}
    for name in fec.fec_names():
        s = fec.fec_from_name(name)
        if not fec._is_conv(s):
            continue
        data = rng.integers(0, 256, (3, 100), dtype=np.uint8)
        bits = np.unpackbits(fec.fec_encode(s, torch.as_tensor(data))
                             .numpy(), axis=-1)
        noisy = torch.as_tensor(np.packbits(
            bits ^ (rng.random(bits.shape) < 0.05), axis=-1))
        llr = torch.as_tensor((2.0 * bits - 1.0) + rng.normal(
            size=bits.shape), dtype=torch.float32)
        cpu[name] = (noisy, llr,
                     conv.conv_decode(s, noisy.to(cuda), 100).cpu(),
                     conv.conv_decode_soft(s, llr.to(cuda), 100).cpu())
    assert kernels.launches["viterbi"] == 2 * len(cpu)
    monkeypatch.undo()
    for name, (noisy, llr, hard, soft) in cpu.items():
        s = fec.fec_from_name(name)
        assert torch.equal(hard, conv.conv_decode(s, noisy, 100)), name
        assert torch.equal(soft, conv.conv_decode_soft(s, llr, 100)), name


@pytest.mark.gpu
def test_wlan_sync_cuda_matches_cpu(cuda):
    """Frames at three rates through CFO and noise: the card's sync gives
    the CPU's rows (flags, rate, length, PSDU, t_start exact; cfo within
    1e-5, rssi within 1e-4 dB); no OFDM kernel launches."""
    from liquid_usrp_tpu_torch.framing import wlan
    rng = np.random.default_rng(12)
    stream = np.zeros(30000, np.complex64)
    sent = []
    for pos, rate in ((900, 6), (9000, 24), (20000, 54)):
        psdu = rng.integers(0, 256, 200, dtype=np.uint8)
        f = wlan.wlan_assemble(rate, psdu, device="cpu").numpy()
        stream[pos:pos + len(f)] = f
        sent.append((pos, rate, psdu))
    stream = (stream * np.exp(0.01j * np.arange(30000)) + 0.02 * (
        rng.normal(size=30000) + 1j * rng.normal(size=30000))
              ).astype(np.complex64)
    kernels.reset_launch_counts()
    got = wlan.wlan_sync(stream, device=cuda)
    assert sum(kernels.launches.values()) == 0
    want = wlan.wlan_sync(stream, device="cpu")
    assert [(d["start"], d["rate"]) for d in got] == \
        [(p, r) for p, r, _ in sent] == [(d["start"], d["rate"]) for d in want]
    for g, w, (_, _, psdu) in zip(got, want, sent):
        assert g["psdu_valid"] and w["psdu_valid"]
        assert np.array_equal(g["psdu"], psdu)
        assert np.array_equal(w["psdu"], psdu)
        assert abs(g["cfo"] - w["cfo"]) <= 1e-5


@pytest.mark.gpu
def test_run_pipelined_and_tx_worker_on_the_card(cuda):
    """``run_pipelined`` over the multichannel step on the card decodes the
    frames the TX worker produced on another thread, through kernel B1."""
    from liquid_usrp_tpu_torch.io.pipeline import run_pipelined
    from liquid_usrp_tpu_torch.models.multichannel import (Mcrx,
                                                           MultichannelTx)
    N = 2
    tx = MultichannelTx(N, device=cuda)
    rng = np.random.default_rng(13)
    sent = {}
    tx.start_worker(chunk=256, max_ahead=16384)
    try:
        for ch in range(N):
            payload = rng.integers(0, 256, 200, dtype=np.uint8)
            tx.update_data(ch, np.full(8, ch, np.uint8), payload)
            sent[ch] = payload
        chunks = []
        while not all(tx.is_channel_ready(c) for c in range(N)):
            chunks.append(tx.read_samples(4096))
    finally:
        tx.stop_worker()
    chunks.append(tx.read_samples(tx.samples_ahead + 2 * N * 8192))
    mix = np.concatenate(chunks)
    sync = ofdm_sync.make_sync(ofdm.make_ofdm_params(48, 6, 4),
                               block_size=4096, max_payload=256,
                               use_pallas=1)
    rx = Mcrx(N, sync, None, cuda)
    g = 2 * N * 4096
    mix = np.concatenate([mix, np.zeros(-len(mix) % g + 4 * g,
                                        np.complex64)])
    got = {}

    def on_results(res):
        det = res.detected.cpu().numpy()
        for ch, i in zip(*np.nonzero(det)):
            if bool(res.payload_valid[ch, i]):
                n = int(res.payload_len[ch, i])
                got[int(ch)] = res.payload[ch, i, :n].cpu().numpy()

    kernels.reset_launch_counts()
    run_pipelined((mix[i:i + g] for i in range(0, len(mix), g)), rx.step,
                  rx.init_state(), on_results)
    assert kernels.launches["detect_metric_xcorr_onepass"] > 0
    assert set(got) == set(sent)
    for ch, payload in sent.items():
        assert np.array_equal(got[ch], payload)


@pytest.mark.gpu
def test_sharded_mcrx_ranks_share_the_card(cuda):
    """Two ranks on the one card, over gloo (their tensors cross through
    pinned host copies): the all-to-all receiver's rows equal the
    single-process receiver's over the same mixture, and each rank
    launched B1, no other detect kernel, and the decode's nearest-point
    kernel."""
    import torch_parallel_ranks as ranks
    from liquid_usrp_tpu_torch.models.multichannel import (
        make_mcrx_batched_step, make_mctx_step)
    from liquid_usrp_tpu_torch.parallel import distributed
    N, bs, cb = 4, 4096, 2
    cfg = {"N": N, "chunk_blocks": cb,
           "sync": dict(block_size=bs, max_payload=128, max_frames=8,
                        use_pallas=1)}
    T = 2 * cb * bs                     # one time row of a 1x2 mesh
    params = ofdm.make_ofdm_params(48, 6, 4)
    rng = np.random.default_rng(17)
    Y = np.zeros((T, 2 * N), np.complex64)
    sent = {}
    for ch in range(N):
        for pos in (300 + 200 * ch, 4500 + 300 * ch, 9000 + 100 * ch):
            p = rng.integers(0, 256, 100, dtype=np.uint8)
            w = ofdm.assemble_frame(
                params, ofdm.default_props(),
                torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
                torch.as_tensor(p)).numpy()
            Y[pos:pos + len(w), ch] = w
            sent[(ch, p.tobytes())] = pos
    init, step = make_mctx_step(N, cuda)
    _, y = step(init(), torch.as_tensor(Y, device=cuda))
    mixture = y.cpu().numpy()
    outs = distributed.spawn(ranks.card_sharded_mcrx, 2, cfg, mixture,
                             backend="gloo", timeout_s=600)
    for out in outs:
        assert out["backend"] == "gloo"
        assert out["device"].startswith("cuda")
        assert out["launches"]["detect_metric_xcorr_onepass"] > 0
        assert out["launches"]["nearest"] > 0
        assert not any(v for k, v in out["launches"].items()
                       if k not in ("detect_metric_xcorr_onepass", "nearest"))
    got = outs[0]["res"]
    sync = ofdm_sync.make_sync(params, **cfg["sync"])
    rinit, rstep = make_mcrx_batched_step(N, sync, 2 * cb, cuda)
    _, res = rstep(rinit(), torch.as_tensor(mixture, device=cuda))
    want = {f: v.reshape((N, -1) + tuple(v.shape[3:])).cpu().numpy()
            for f, v in res._asdict().items()}
    assert got["detected"].shape == want["detected"].shape

    def keyed(r):
        return {(int(ch), int(r["t_start"][ch, i])): (ch, i)
                for ch, i in zip(*np.nonzero(r["detected"]))}
    kg, kw = keyed(got), keyed(want)
    assert kg.keys() == kw.keys()
    decoded = set()
    for key, ig in kg.items():
        iw = kw[key]
        for f in ("header_valid", "payload_valid", "payload_len"):
            assert got[f][ig] == want[f][iw], (key, f)
        for f, tol in (("rssi", 1e-3), ("evm", 0.05), ("cfo", 1e-5)):
            assert abs(got[f][ig] - want[f][iw]) <= tol, (key, f)
        if got["payload_valid"][ig]:
            n = int(got["payload_len"][ig])
            assert np.array_equal(got["payload"][ig][:n],
                                  want["payload"][iw][:n])
            decoded.add((key[0], got["payload"][ig][:n].tobytes()))
    assert decoded == set(sent)
