"""The arithmetic of B1's period-fold path (``csrc/xcorr_fold.cu``), of
B3's window-sum path (``csrc/autocorr_metric.cu``) and of B2's
(``csrc/detect_candidates.cu``, both through ``csrc/window_sums.cuh``), on
the CPU.

The CUDA kernels run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  Here a NumPy float32 model of each kernel's own
order of work (the fold's lanes, windows and partial sums from the
wrapper's geometry; B3's chunked van Herk / Gil-Werman sums) is held to
the kernel's plain version, and the wrapper's choice of path is checked:
so a wrong index, window or partial sum fails here, before any card.

Tolerances: the fold model against ``detect_metric_xcorr_plain``: metric
max abs difference <= 1e-5 (float32 sums of the same terms in another
order; measured below 1e-6), and where the plain metric is 0 (every
segment under the floor) the model's is 0.  B3's model against
``autocorr_metric`` (float64 window sums): metric <= 1e-4 and ``c`` within
1e-4 of max ``|c|``, as the card tests hold the kernel.  B2's model
(balanced chunks, tile scans, segment parts and the picks) against
``detect_candidates_plain`` at the card tests' limits: ``detected`` equal,
values within 1e-4, offsets equal (within 3 where the metric has no exact
plateau: float32 sums against float64 ones may move a first argmax), ``c``
at the detected offsets within 1e-4 of max ``|c|``.  Inputs: seeded
numpy noise with the S0 template (or a frame) in it, a +40 dB burst
before quiet samples, and runs of a constant sample (an exact plateau).
"""
import numpy as np
import pytest
import torch

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.ops import corr, kernels

F32 = np.float32


def _s0_template(M):
    params = ofdm.make_ofdm_params(M, max(M // 8, 1), 4 if M > 16 else 2)
    return np.tile(params.s0_time, ofdm.NUM_S0).astype(np.complex64)


def _rows(M, n_metric, rows, seed, loud=False):
    """Rows for ``n_metric`` outputs (a few short of the template's reach,
    so the zero padding is read): 0.02-rms noise with the template at a
    seeded offset; ``loud``: a +40 dB copy of it first, then 0.01-rms
    noise."""
    tmpl = _s0_template(M)
    length = n_metric + len(tmpl) - 1 - 5
    rng = np.random.default_rng(seed)
    x = (0.02 * (rng.normal(size=(rows, length)) +
                 1j * rng.normal(size=(rows, length)))).astype(np.complex64)
    for r in range(rows):
        if loud:
            x[r, :len(tmpl)] += 100.0 * tmpl
            x[r, len(tmpl):] *= 0.5
        pos = int(rng.integers(len(tmpl), max(len(tmpl) + 1,
                                              length - len(tmpl))))
        n = min(len(tmpl), length - pos)
        x[r, pos:pos + n] += tmpl[:n]
    return x


def _fold_model(x, tmpl, span, n_metric, floor_scale=1e-4):
    """xcorr_fold_kernel and xcorr_fold_sum_kernel in float32: lane c
    walks its products in blocks of span, each window the suffix of one
    block plus the prefix of the next, its metric term (0 where it serves
    no segment) summed per offset; partial j of output c - j P is the sum
    at offset (-j P) mod span; then each output's partials in j order."""
    P, J, g, taps, meta = kernels._fold_geometry(
        np.ascontiguousarray(tmpl, np.complex64).tobytes(), span)
    n_tmpl = len(tmpl)
    n_seg = n_tmpl // span
    rows, length = x.shape
    n_lanes = n_metric + (J - 1) * P
    nx = n_lanes + P + 2 * span
    X = np.zeros((rows, nx), np.complex64)
    X[:, :min(length, nx)] = x[:, :nx]
    pw = (X.real * X.real + X.imag * X.imag).astype(F32)
    E = np.zeros((rows, n_lanes + P), F32)
    for q in range(span):
        E = E + pw[:, q:q + n_lanes + P]
    need = n_metric + n_tmpl - 1
    denom = max(length, kernels._xcorr_padded_len(n_metric, span, n_tmpl))
    xp = np.zeros((rows, max(length, need)), np.complex64)
    xp[:, :length] = x
    p_sum = torch.as_tensor(xp[:, :length].real ** 2 +
                            xp[:, :length].imag ** 2).sum(-1)
    floor = kernels._row_floor(p_sum, denom, span, floor_scale).numpy()
    acc = np.zeros((span, rows, n_lanes), F32)
    nblk = (P + span - 1) // span + 1
    suf = None
    for b in range(nblk):
        t0 = b * span
        y = [(taps[t0 + q] * X[:, t0 + q:t0 + q + n_lanes]).astype(
            np.complex64) for q in range(span)]
        if b > 0:
            w0 = t0 - span
            pre = np.zeros((rows, n_lanes), np.complex64)
            for o in range(span):
                if w0 + o >= P:
                    break
                if o > 0:
                    pre = pre + y[o - 1]
                if o % g:
                    continue
                v = suf[o] + pre if o > 0 else suf[0]
                es = E[:, w0 + o:w0 + o + n_lanes]
                num = (v.real * v.real + v.imag * v.imag).astype(F32)
                r = np.where((meta[w0 + o, 1] != 0) & (es > floor[:, None]),
                             num / np.maximum(es * meta[w0 + o, 0],
                                              F32(1e-12)), F32(0))
                acc[o] = acc[o] + r.astype(F32)
        suf = [None] * span
        suf[span - 1] = y[span - 1]
        for q in range(span - 2, -1, -1):
            suf[q] = y[q] + suf[q + 1]
    out = np.zeros((rows, n_metric), F32)
    for j in range(J):
        out = out + acc[(-j * P) % span][:, j * P:j * P + n_metric]
    return out / F32(n_seg)


def test_xcorr_path_follows_the_template():
    """M = 48's geometry keeps its ``__constant__`` instance, every other
    S0 template (period M/4) takes the fold, a template with no period the
    direct form; the fold's geometry at the sizes the paths run."""
    assert kernels.xcorr_path(_s0_template(48), 24) == "const"
    rng = np.random.default_rng(5)
    noise = (rng.normal(size=2056) + 1j * rng.normal(size=2056)).astype(
        np.complex64)
    assert kernels.template_period(noise) == 0
    assert kernels.xcorr_path(noise, 8) == "direct"
    want = {16: (4, 5, 4), 64: (16, 8, 16), 256: (64, 8, 16),
            1024: (256, 8, 16), 1028: (257, 8, 1), 2052: (513, 8, 3),
            4096: (1024, 8, 16)}
    for M, (P, J, g) in want.items():
        tmpl = _s0_template(M)
        span = ofdm_sync._xc_span(len(tmpl))
        assert kernels.template_period(tmpl) == M // 4
        assert kernels.xcorr_path(tmpl, span) == "fold"
        assert kernels._fold_geometry(tmpl.tobytes(), span)[:3] == (P, J, g)
    # a tone of exact period 4: P grows until J <= 16
    tone = np.tile(np.exp(2j * np.pi * np.arange(4) / 4), 512).astype(
        np.complex64)
    P, J, _, _, _ = kernels._fold_geometry(tone.tobytes(), 16)
    assert P % 4 == 0 and J <= kernels.XF_JMAX and \
        (2048 - 16) // (P - 4) + 1 > kernels.XF_JMAX


@pytest.mark.parametrize("M,n_metric,loud", [
    (16, 300, False), (64, 1500, False), (64, 1500, True),
    (256, 1200, True), (1028, 700, False), (1028, 700, True)])
def test_fold_model_matches_plain(M, n_metric, loud):
    tmpl = _s0_template(M)
    span = ofdm_sync._xc_span(len(tmpl))
    x = _rows(M, n_metric, 2, M + loud, loud)
    got = _fold_model(x, tmpl, span, n_metric)
    ref = kernels.detect_metric_xcorr_plain(torch.as_tensor(x), tmpl, span,
                                            n_metric).numpy()
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= 1e-5
    assert np.array_equal(got == 0, ref == 0)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


W3_CH = 896             # csrc/autocorr_metric.cu: terms a chunk


def _window_sums(x, lag, span, ch, n_w):
    """w3_totals_kernel and w3_window_sums (csrc/window_sums.cuh) in
    float32: the four planes of lag-product and power terms (the last
    sample repeated past the row end), blocks of span terms cut into
    chunks of ``ch``; the window at b span + q is the suffix of block b's
    chunk from q, the totals of block b's later chunks, those of block
    b + 1's earlier chunks and the prefix of block b + 1's chunk up to
    q - 1.  Returns the planes' windows (Re c, Im c, e1, e2) at offsets
    below ``n_w``."""
    rows, length = x.shape
    nch = -(-span // ch)
    nblk = -(-n_w // span)
    pos = np.arange((nblk + 1) * span)
    a = x[:, np.minimum(pos, length - 1)]
    b = x[:, np.minimum(pos + lag, length - 1)]
    planes = np.stack([a.real * b.real + a.imag * b.imag,
                       a.imag * b.real - a.real * b.imag,
                       a.real * a.real + a.imag * a.imag,
                       b.real * b.real + b.imag * b.imag]).astype(F32)
    t = np.zeros((4, rows, nblk + 1, nch * ch), F32)
    t[..., :span] = planes.reshape(4, rows, nblk + 1, span)
    t = t.reshape(4, rows, nblk + 1, nch, ch)
    tot = t.sum(-1, dtype=F32)
    # within a chunk: suffix sums (block b) and exclusive prefix sums
    suf = np.flip(np.cumsum(np.flip(t, -1), -1, dtype=F32), -1)
    pre = np.cumsum(t, -1, dtype=F32) - t
    tsuf = np.flip(np.cumsum(np.flip(tot, -1), -1, dtype=F32), -1) - tot
    tpre = np.cumsum(tot, -1, dtype=F32) - tot
    w = ((suf[:, :, :nblk] + tsuf[:, :, :nblk, :, None]) +
         (tpre[:, :, 1:, :, None] + pre[:, :, 1:]))
    w = w.reshape(4, rows, nblk, nch * ch)[..., :span]
    return w.reshape(4, rows, nblk * span)[..., :n_w]


def _gated_metric(x, w, span, floor_scale=1e-4):
    """ws_metric of the window sums ``w``: (metric, c)."""
    p = (x.real * x.real + x.imag * x.imag).astype(F32)
    floor = kernels._row_floor(torch.as_tensor(p).sum(-1), x.shape[-1],
                               span, floor_scale).numpy()[:, None]
    c2 = w[0] * w[0] + w[1] * w[1]
    metric = np.where(np.minimum(w[2], w[3]) > floor,
                      c2 / np.maximum(w[2] * w[3], F32(1e-12)), F32(0))
    return metric, w[0] + 1j * w[1]


def _b3_window_model(x, lag, span, floor_scale=1e-4):
    """B3's window-sum path: chunks of ``W3_CH`` terms (the last one
    shorter), every output below n_out."""
    n_out = x.shape[-1] - span - lag + 1
    return _gated_metric(x, _window_sums(x, lag, span, W3_CH, n_out), span,
                         floor_scale)


@pytest.mark.parametrize("M,loud", [(1152, False), (1152, True),
                                    (2048, True)])
def test_b3_window_model_matches_plain(M, loud):
    """B3 past its persistent kernel's tile (span + lag > 2,301): three
    chunks a block at M = 1,152 (span 2,016), four at 2,048, rows of
    three blocks and a ragged end; with a +40 dB S0 burst, then quiet."""
    lag, span = M // 4, ofdm.NUM_S0 * M - M // 4
    rng = np.random.default_rng(M + loud)
    length = 3 * span + lag + 345
    x = (0.02 * (rng.normal(size=(2, length)) +
                 1j * rng.normal(size=(2, length)))).astype(np.complex64)
    tmpl = _s0_template(M)
    x[:, span // 2:span // 2 + len(tmpl)] += (100.0 if loud else 1.0) * tmpl
    if loud:
        x[:, span // 2 + len(tmpl):] *= 0.5
    x[1, 2 * span:2 * span + len(tmpl)] += tmpl
    m, c = _b3_window_model(x, lag, span)
    mr, cr = kernels.autocorr_metric(torch.as_tensor(x), lag, span)
    mr, cr = mr.numpy(), cr.numpy()
    assert m.shape == mr.shape
    assert float(np.abs(m - mr).max()) <= 1e-4
    assert float(np.abs(c - cr).max()) <= 1e-4 * float(np.abs(cr).max())


SEG = kernels.CAND_SEG


def _b2_parts(ps, met, cw, n0s, P=2):
    """cand_sums_kernel's records of one row: the tiles start at ``n0s``;
    each segment's part in each tile it meets (at most ``P``): the
    metric's max, the first offset of the best pre-score ``ps``, whether a
    later offset ties it, and c there; the parts past its last tile
    empty."""
    n_seg = len(ps) // SEG
    parts = []
    for s in range(n_seg):
        cut = [n for n in n0s if s * SEG < n < s * SEG + SEG]
        assert len(cut) < P
        recs = []
        for a, b in zip([s * SEG] + cut, cut + [s * SEG + SEG]):
            v = ps[a:b].max()
            m = a + int(np.argmax(ps[a:b]))    # the first on ties
            tie = bool(v > -1 and (ps[a:b] == v).sum() > 1)
            recs.append((met[a:b].max(), v, m, tie, cw[m]))
        recs += [(-np.inf, F32(-2), 0, False, 0j)] * (P - len(recs))
        parts.append(recs)
    return parts


def _b2_picks(ps, met, parts, cw, c_direct, n_out, win):
    """cand_pick_kernel on one row: (value, offset, c) of every segment;
    with win < 64 the warp tests, in order, every offset whose pre-score
    beats the best score so far."""
    def window_max(n):
        lo, hi = max(n - win, 0), min(n + win, n_out - 1)
        sl, sr = lo // SEG, hi // SEG
        if sr - sl <= 1:
            return met[lo:hi + 1].max()
        between = max(r[0] for s in range(sl + 1, sr) for r in parts[s])
        return max(met[lo:(sl + 1) * SEG].max(), between,
                   met[sr * SEG:hi + 1].max())

    out = []
    for s, recs in enumerate(parts):
        _, v, m, tie, cm = recs[0]
        for rec in recs[1:]:                  # in order: the first keeps ties
            if rec[1] > v:
                _, v, m, tie, cm = rec
            elif rec[1] == v:
                tie = True
        pick = (F32(-1), s * SEG, cw[s * SEG])
        end = min(s * SEG + SEG, n_out)
        if v > -1 and win < SEG:
            for n in range(s * SEG, end):
                if ps[n] > pick[0] and window_max(n) <= ps[n]:
                    pick = (ps[n], n, None)
            if pick[0] > -1:
                n = pick[1]
                pick = (pick[0], n, cm if n == m else c_direct(n))
        elif v > -1:
            if window_max(m) <= v:
                pick = (v, m, cm)
            elif tie:                          # a later tie of m, in order
                for n in range(m + 1, end):
                    if ps[n] == v and window_max(n) <= v:
                        pick = (v, n, c_direct(n))
                        break
        out.append(pick)
    return out


def _b2_window_model(x, lag, span, win, T, thr, k, floor_scale=1e-4):
    """B2's window-sum path in float32 (w3_totals_kernel, cand_sums_kernel,
    cand_pick_kernel), then the wrapper's top-k: (vals, locs, c_at)."""
    rows, length = x.shape
    n_out = length - span - lag + 1
    n_seg = -(-n_out // SEG)
    nch = -(-span // W3_CH)
    ch = -(-span // nch)                       # balanced chunks
    P = (SEG - 2) // (span - (nch - 1) * ch) + 2
    w = _window_sums(x, lag, span, ch, n_seg * SEG)
    metric, cw = _gated_metric(x, w, span, floor_scale)
    n = np.arange(n_seg * SEG)
    met = np.where(n < n_out, metric, -np.inf).astype(F32)
    ps = np.where((n < n_out) & (n >= win) & (n < T + win) & (metric > thr),
                  metric, F32(-1)).astype(F32)
    n0s = [b * span + q * ch for b in range(-(-n_seg * SEG // span))
           for q in range(nch)]
    segs = []
    for r in range(rows):
        xr = x[r]

        def c_direct(v, xr=xr):               # the warp's term-by-term sum
            i = np.minimum(np.arange(v, v + span), length - 1)
            j = np.minimum(i + lag, length - 1)
            return complex((xr[i] * np.conj(xr[j])).astype(np.complex64)
                           .sum(dtype=np.complex64))
        parts = _b2_parts(ps[r], met[r], cw[r], n0s, P)
        segs.append(_b2_picks(ps[r], met[r], parts, cw[r], c_direct, n_out,
                              win))
    segval = torch.tensor([[p[0] for p in row] for row in segs])
    segarg = torch.tensor([[p[1] for p in row] for row in segs])
    segc = torch.tensor([[p[2] for p in row] for row in segs],
                        dtype=torch.complex64)
    vals, idx = torch.topk(segval, k, dim=-1)
    return vals, torch.gather(segarg, -1, idx), torch.gather(segc, -1, idx)


def _b2_rows(M, length, seed):
    """Three rows at M: 0.02-rms noise with the S0 template at a seeded
    offset; a +40 dB copy of it, then 0.01-rms noise and a unit copy;
    runs of the constant sample 1, one across the tile edge at 3 span."""
    lag, span = M // 4, ofdm.NUM_S0 * M - M // 4
    tmpl = _s0_template(M)
    rng = np.random.default_rng(seed)
    x = (0.02 * (rng.normal(size=(3, length)) +
                 1j * rng.normal(size=(3, length)))).astype(np.complex64)
    pos = int(rng.integers(2 * M, length - 2 * len(tmpl)))
    x[0, pos:pos + len(tmpl)] += tmpl
    x[1, M:M + len(tmpl)] += 100.0 * tmpl
    x[1, M + len(tmpl):] *= 0.5
    x[1, 3 * M + 2 * len(tmpl):3 * M + 3 * len(tmpl)] += tmpl
    x[2] = 0
    x[2, M + 200:M + 200 + span + lag + 900] = 1.0
    edge = 3 * span - 300
    x[2, edge:edge + span + lag + 700] = 1.0
    return x


@pytest.mark.parametrize("M", [512, 560, 1024])
def test_b2_window_model_matches_plain(M):
    """B2 past its one-pass kernel (M >= 476): a block one chunk of 896
    terms at 512, two balanced chunks of 490 at 560 (so segments straddle
    two tiles) and two of 896 at 1,024; a quiet row, a +40 dB burst
    before quiet samples and a plateau of constant samples across a tile
    edge, against the plain version."""
    lag, span, win = M // 4, ofdm.NUM_S0 * M - M // 4, M
    length = 5 * span + lag + 345
    x = _b2_rows(M, length, M)
    n_out = length - span - lag + 1
    args = (lag, span, win, n_out - 2 * M, 0.5, 12)
    v, loc, c = _b2_window_model(x, *args)
    vr, lr, _ = kernels.detect_candidates_plain(torch.as_tensor(x), *args)
    _, c_full = kernels.autocorr_metric(torch.as_tensor(x), lag, span)
    det = v > 0
    assert torch.equal(det, vr > 0) and bool(det[2].sum() > 5)
    assert float((v - vr).abs().max()) <= 1e-4
    for row in range(3):
        a, b = np.sort(loc[row][det[row]]), np.sort(lr[row][det[row]])
        assert np.abs(a - b).max(initial=0) <= (0 if row == 2 else 3)
    c_ref = torch.gather(c_full, -1, loc.to(torch.int64))[det]
    assert float((c[det] - c_ref).abs().max()) <= \
        1e-4 * float(c_full.abs().max())


# geometries (lag, span, win) that the one-pass kernel refuses, with span
# or win under a segment's 64: span <= 9 (14 parts a segment), win < 5
# with span 48 (3 parts), win 0 with span 3 (22 parts), the span of M =
# 512 with win 40, balanced chunks of 600 with win 20, and a span of 30
# whose NMS window leaves the one-pass tile no segment (4 parts)
B2_ANY = [(4, 5, 40), (16, 48, 3), (2, 3, 0), (128, 896, 40),
          (256, 1800, 20), (8, 30, 1200)]


def b2_any_case(lag, span, win):
    """Rows for a geometry of ``B2_ANY`` (``_b2_any_rows``, at least eight
    windows long) and B2's arguments after them: T = n_out - 2 win,
    threshold 0.5, k = every segment (the constant row's exact ties across
    segments then all count, whatever order a top-k gives ties)."""
    length = max(8 * (span + lag) + 2 * win, 3000) + 345
    x = _b2_any_rows(lag, span, length, lag + span + win)
    n_out = length - span - lag + 1
    return x, (lag, span, win, n_out - 2 * win, 0.5, -(-n_out // SEG))


def _b2_any_rows(lag, span, length, seed):
    """Three rows: 0.02-rms noise with two bursts of a seeded sequence of
    period ``lag`` (with noise of its own at -20 dB, so that the metric
    has no near plateau); a +40 dB burst, then 0.01-rms noise and a unit
    burst; runs of the constant sample 1 in zeros (exact plateaus)."""
    rng = np.random.default_rng(seed)
    x = (0.02 * (rng.normal(size=(3, length)) +
                 1j * rng.normal(size=(3, length)))).astype(np.complex64)
    n = span + 2 * lag + 40
    seq = np.exp(2j * np.pi * rng.random(lag))
    burst = (np.tile(seq, -(-n // lag))[:n] + 0.07 * (
        rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    for at in (length // 5, 3 * length // 5):
        x[0, at:at + n] += burst
    x[1, 100:100 + n] += 100.0 * burst
    x[1, 100 + n:] *= 0.5
    x[1, length // 2:length // 2 + n] += burst
    x[2] = 0
    for at in (length // 4, 2 * length // 3):
        x[2, at:at + n] = 1.0
    return x


def b2_segment_plain(x, lag, span, win, T, thr, k, floor_scale=1e-4):
    """What B2 computes, from the plain metric (``autocorr_metric``): every
    output's NMS score (-inf outside ``[0, n_out)``), each 64-output
    segment's max and first offset holding it, then the top-k over the
    segments: ``(vals, locs)``.  With win >= 64 a segment holds at most
    one NMS peak and this is ``detect_candidates_plain``; with win < 64
    the segments keep their best peak only, as the JAX kernel does."""
    metric = kernels.autocorr_metric(torch.as_tensor(x), lag, span,
                                     floor_scale)[0].numpy()
    rows, n_out = metric.shape
    n_seg = -(-n_out // SEG)
    pad = np.full((rows, n_seg * SEG + 2 * win), -np.inf, F32)
    pad[:, win:win + n_out] = metric
    lmax = np.lib.stride_tricks.sliding_window_view(
        pad, 2 * win + 1, axis=-1).max(-1)
    met = pad[:, win:win + n_seg * SEG]
    n = np.arange(n_seg * SEG)
    ok = (met >= lmax) & (met > thr) & (n >= win) & (n < T + win) & \
        (n < n_out)
    score = np.where(ok, met, F32(-1)).reshape(rows, n_seg, SEG)
    segval = torch.as_tensor(score.max(-1))
    segarg = torch.as_tensor(score.argmax(-1) + SEG * np.arange(n_seg))
    vals, idx = torch.topk(segval, k, dim=-1)
    return vals, torch.gather(segarg, -1, idx)


@pytest.mark.parametrize("lag,span,win", B2_ANY)
def test_b2_window_model_takes_any_geometry(lag, span, win):
    """B2's window-sum path at geometries that its one-pass kernel refuses
    and whose windows or tiles are shorter than a segment: a segment
    meets up to P tiles, and with win < 64 the picks test every offset
    that may score; against ``b2_segment_plain`` (``detect_candidates_plain``
    itself where win >= 64) at the limits of
    ``test_b2_window_model_matches_plain``."""
    x, args = b2_any_case(lag, span, win)
    v, loc, c = _b2_window_model(x, *args)
    vr, lr = b2_segment_plain(x, *args)
    if win >= SEG:
        vp, lp, _ = kernels.detect_candidates_plain(torch.as_tensor(x),
                                                    *args)
        assert torch.equal(vp, vr) and torch.equal(lp, lr.to(lp.dtype))
    _, c_full = kernels.autocorr_metric(torch.as_tensor(x), lag, span)
    det = v > 0
    assert torch.equal(det, vr > 0) and bool(det.any())
    assert float((v - vr).abs().max()) <= 1e-4
    for row in range(3):
        a, b = np.sort(loc[row][det[row]]), np.sort(lr[row][det[row]])
        assert np.abs(a - b).max(initial=0) <= (0 if row == 2 else 3)
    c_ref = torch.gather(c_full, -1, loc.to(torch.int64))[det]
    assert float((c[det] - c_ref).abs().max()) <= \
        1e-4 * float(c_full.abs().max())


def test_b2_pick_model_takes_a_later_tie():
    """A plateau of exact ties whose first offset sees a larger metric at
    its window's left edge: the segment's pick is the first later tie
    that passes the NMS test, with c summed term by term there, as the
    plain NMS and top-k choose."""
    win, n_out, T, thr = 100, 64 * 12, 64 * 12 - 100, 0.5
    met = np.zeros(n_out, F32)
    met[300] = 0.9
    met[395:420] = 0.8                         # ties in segment 6
    met[700] = 0.7                             # a lone peak in segment 10
    n = np.arange(n_out)
    ps = np.where((n >= win) & (n < T + win) & (met > thr), met,
                  F32(-1)).astype(F32)
    cw = (n + 1j * n).astype(np.complex64)
    parts = _b2_parts(ps, met, cw, [0, 5 * 64 + 17, 9 * 64 + 30])
    got = _b2_picks(ps, met, parts, cw, lambda v: complex(-v), n_out, win)
    vr, lr = corr.find_candidates(torch.as_tensor(met)[None], win, T, thr,
                                  3)
    picks = {p[1]: p for p in got if p[0] > -1}
    assert sorted(picks) == sorted(lr[0][vr[0] > 0].tolist()) == \
        [300, 401, 700]
    assert picks[401][2] == -401 and picks[700][2] == 700 + 700j


@pytest.mark.gpu
def test_b2_path_follows_the_geometry():
    """The wrapper's B2 kernel by OFDM M (lag M/4, span 7M/4, win M), as
    the CUDA library reports it (so on the card only): the one-pass
    kernel's M = 48 instance, its generic instance up to 472, the
    window-sum path from 476, with its chunk totals once a block of span
    terms is more than one chunk."""
    if not torch.cuda.is_available():
        pytest.skip("B2's path is chosen in the CUDA library: needs a card")
    want = {48: "m48", 64: "one_pass", 472: "one_pass",
            476: "window_sums", 4096: "window_sums"}
    for M, path in want.items():
        assert kernels.candidates_path(M // 4, 7 * M // 4, M) == path
    assert kernels.candidates_kernels(128, 896, 512) == (
        "cand_sums_kernel", "cand_pick_kernel")
    assert kernels.candidates_kernels(1024, 7168, 4096) == (
        "w3_totals_kernel", "cand_sums_kernel", "cand_pick_kernel")
    assert kernels.candidates_kernels(12, 84, 48) == (
        "detect_candidates_kernel",)
