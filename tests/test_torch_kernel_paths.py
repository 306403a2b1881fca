"""The arithmetic of B1's period-fold path (``csrc/xcorr_fold.cu``) and of
B3's window-sum path (``csrc/autocorr_metric.cu``), on the CPU.

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
1e-4 of max ``|c|``, as the card tests hold the kernel.  Inputs: seeded
numpy noise with the S0 template (or a frame) in it, and a +40 dB burst
before quiet samples.
"""
import numpy as np
import pytest
import torch

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.ops import kernels

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


def _b3_window_model(x, lag, span, floor_scale=1e-4):
    """w3_totals_kernel and w3_metric_kernel in float32: the four planes of
    lag-product and power terms (the last sample repeated past the row
    end), blocks of span terms cut into chunks of ``W3_CH``; the window at
    b span + q is the suffix of block b's chunk from q, the totals of
    block b's later chunks, those of block b + 1's earlier chunks and the
    prefix of block b + 1's chunk up to q - 1."""
    rows, length = x.shape
    n_out = length - span - lag + 1
    nch = -(-span // W3_CH)
    nblk = -(-n_out // span)
    pos = np.arange((nblk + 1) * span)
    a = x[:, np.minimum(pos, length - 1)]
    b = x[:, np.minimum(pos + lag, length - 1)]
    planes = np.stack([a.real * b.real + a.imag * b.imag,
                       a.imag * b.real - a.real * b.imag,
                       a.real * a.real + a.imag * a.imag,
                       b.real * b.real + b.imag * b.imag]).astype(F32)
    t = np.zeros((4, rows, nblk + 1, nch * W3_CH), F32)
    t[..., :span] = planes.reshape(4, rows, nblk + 1, span)
    t = t.reshape(4, rows, nblk + 1, nch, W3_CH)
    tot = t.sum(-1, dtype=F32)
    # within a chunk: suffix sums (block b) and exclusive prefix sums
    suf = np.flip(np.cumsum(np.flip(t, -1), -1, dtype=F32), -1)
    pre = np.cumsum(t, -1, dtype=F32) - t
    tsuf = np.flip(np.cumsum(np.flip(tot, -1), -1, dtype=F32), -1) - tot
    tpre = np.cumsum(tot, -1, dtype=F32) - tot
    w = ((suf[:, :, :nblk] + tsuf[:, :, :nblk, :, None]) +
         (tpre[:, :, 1:, :, None] + pre[:, :, 1:]))
    w = w.reshape(4, rows, nblk, nch * W3_CH)[..., :span]
    w = w.reshape(4, rows, nblk * span)[..., :n_out]
    p = (x.real * x.real + x.imag * x.imag).astype(F32)
    floor = kernels._row_floor(torch.as_tensor(p).sum(-1), length, span,
                               floor_scale).numpy()[:, None]
    c2 = w[0] * w[0] + w[1] * w[1]
    metric = np.where(np.minimum(w[2], w[3]) > floor,
                      c2 / np.maximum(w[2] * w[3], F32(1e-12)), F32(0))
    return metric, w[0] + 1j * w[1]


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
