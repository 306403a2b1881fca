"""The detect front-end's hand-written CUDA kernels and their plain versions.

Port of the five kernels of ``liquid_usrp_tpu/ops/pallas_kernels.py``:

* **B1** :func:`detect_metric_xcorr_onepass` — the segmented-coherent S0
  cross-correlation metric (``OfdmSync.use_pallas == 1``), CUDA sources
  ``csrc/xcorr_metric.cu`` (M = 48's template, and any template with no
  period) and ``csrc/xcorr_fold.cu`` (a periodic template, every other
  M; :func:`xcorr_path` chooses);
* **B2** :func:`detect_candidates_onepass` — the fused Schmidl-Cox metric,
  NMS and per-segment reduction, then a top-k over the segment maxima
  (``use_pallas == 2``), CUDA source ``csrc/detect_candidates.cu`` (a
  one-pass kernel up to OFDM M = 472, its window-sum path from 476 and
  at any other geometry the one-pass kernel refuses, sharing
  ``csrc/window_sums.cuh`` with B3; :func:`candidates_path` reads the
  library's choice);
* **B3** :func:`detect_metric_onepass` — the Schmidl-Cox metric and lag
  correlation ``(metric, c)`` at full rate (``use_pallas > 0`` with the
  legacy detector, and below the fused kernel's M >= 32), CUDA source
  ``csrc/autocorr_metric.cu``, plain version :func:`autocorr_metric`;
* **B4** :func:`detect_metric_fused_2d` and **B5**
  :func:`detect_metric_fused` — B3's ``(metric, c)`` as windowed
  differences of float32 prefix sums, one CUDA kernel
  ``csrc/autocorr_prefix.cu`` for both, plain version
  :func:`autocorr_metric_prefix`.

Each wrapper dispatches by the device of its input: a CUDA tensor launches
the kernel (built on first use by :mod:`._build`) or raises; a CPU tensor
runs the kernel's plain PyTorch version beside it.  Nothing falls back.
``launches`` counts kernel launches per wrapper (plain runs do not count),
and also those of the payload codec's Viterbi kernel (``ops/conv.py``) and
of the nearest-point scan (``framing/payload.py``).

Inputs carry any leading batch shape ``[..., len]``; each row is one
extended detect window, as the JAX code vmaps over windows.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import corr

__all__ = ["detect_metric_xcorr_onepass", "detect_metric_xcorr_plain",
           "xcorr_path", "template_period", "xcorr_paths",
           "detect_candidates_onepass", "detect_candidates_plain",
           "candidates_path", "candidates_kernels", "cand_paths",
           "detect_metric_onepass", "detect_metric_fused_2d",
           "detect_metric_fused", "autocorr_metric", "autocorr_metric_prefix",
           "launches", "reset_launch_counts", "CAND_SEG"]

CAND_SEG = 64           # samples per reduced segment (= topk_peaks' seg)

launches = {"detect_metric_xcorr_onepass": 0,
            "detect_candidates_onepass": 0,
            "detect_metric_onepass": 0,
            "detect_metric_fused_2d": 0,
            "detect_metric_fused": 0,
            "viterbi": 0,           # ops/conv.py::_viterbi, csrc/viterbi.cu
            "nearest": 0}           # framing/payload.py::_nearest_sym,
                                    # csrc/nearest.cu


# B1's launches by path (:func:`xcorr_path`), beside ``launches``
xcorr_paths = {"const": 0, "fold": 0, "direct": 0}
# B2's launches by path (:func:`candidates_path`)
cand_paths = {"m48": 0, "one_pass": 0, "window_sums": 0}


def reset_launch_counts() -> None:
    for counts in (launches, xcorr_paths, cand_paths):
        for name in counts:
            counts[name] = 0


def _check_rows(ext: torch.Tensor) -> torch.Tensor:
    if not ext.is_complex():
        raise TypeError(f"expected a complex stream, got {ext.dtype}")
    return ext.reshape(-1, ext.shape[-1]).to(torch.complex64)


def _row_floor(p_sum: torch.Tensor, n: int, span: int,
               floor_scale: float) -> torch.Tensor:
    """The silence floor ``floor_scale * span * (mean|x|^2 + 1e-12)`` per
    row, written as the JAX wrappers write it."""
    return floor_scale * span * (p_sum / n + 1e-12)


def _lib():
    from ._build import load_library
    return load_library()


def _where(geometry: dict) -> str:
    return ", ".join(f"{k}={v}" for k, v in geometry.items())


def _launch(fn_name: str, ext: torch.Tensor, geometry: dict, *args) -> None:
    """Runs the launch function ``fn_name`` on ``ext``'s device and current
    stream; a launch that refuses or fails raises with ``geometry``."""
    with torch.cuda.device(ext.device):
        stream = torch.cuda.current_stream(ext.device).cuda_stream
        rc = getattr(_lib(), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at "
                           f"{_where(geometry)}")


@functools.lru_cache(maxsize=64)
def _scratch_bytes(fn_name: str, *args) -> int:
    return int(getattr(_lib(), fn_name)(*args))


def _scratch(fn_name: str, device, geometry: dict, *args):
    """The device scratch a launch asks for (``fn_name`` gives its bytes),
    or ``None`` where it needs none (the one-pass kernels); out of device
    memory, raises with ``geometry``."""
    nbytes = _scratch_bytes(fn_name, *args)
    if nbytes < 0:
        raise RuntimeError(f"{fn_name}: refused at {_where(geometry)}")
    if not nbytes:
        return None
    try:
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    except torch.OutOfMemoryError as err:
        raise torch.OutOfMemoryError(
            f"{fn_name}: {nbytes} bytes of scratch at {_where(geometry)}: "
            f"{err}") from err


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# B1: segmented-coherent cross-correlation metric
# ---------------------------------------------------------------------------

def _garbage_rows(s: int) -> int:
    return -(-s // 128)


def _tree_garbage(L: int) -> int:
    g = {1: 0}
    k = 1
    while 2 * k <= L:
        g[2 * k] = g[k] + _garbage_rows(k)
        k *= 2
    out_g, off = 0, 0
    for k in sorted(g, reverse=True):
        if L & k:
            out_g = max(out_g, g[k] + _garbage_rows(off))
            off += k
    return out_g


def _xcorr_padded_len(n_metric: int, span: int, n_tmpl: int) -> int:
    """Length the JAX wrapper zero-pads a short row to (its (8, 128)-tile
    raster plus slack rows).  It sets the mean in the silence floor, so the
    port reproduces it; nothing else of the raster is carried over."""
    rows = -(-n_metric // 1024) * 8
    slack = _tree_garbage(span) + _garbage_rows(n_tmpl) + 1
    return (rows + slack) * 128


@functools.lru_cache(maxsize=16)
def _xcorr_consts(tmpl_bytes: bytes, span: int):
    """(tap re, tap im, segment energies) as float32 host arrays."""
    tmpl = np.frombuffer(tmpl_bytes, np.complex64)
    n_seg = len(tmpl) // span
    ea = np.array([np.sum(np.abs(tmpl[s * span:(s + 1) * span]) ** 2)
                   for s in range(n_seg)], np.float32)
    return (np.ascontiguousarray(tmpl.real, np.float32),
            np.ascontiguousarray(tmpl.imag, np.float32), ea)


# (taps, span) of the M=48 template, which B1's kernel keeps in
# __constant__ memory (csrc/xcorr_metric.cu)
_XC_CONST_GEOMETRY = (96, 24)


@functools.lru_cache(maxsize=16)
def _xcorr_device_consts(tmpl_bytes: bytes, span: int, device: str):
    """(template complex64, segment energies float32) on ``device``: where
    B1's kernel reads the taps of a template other than M=48's, which it
    keeps in ``__constant__`` memory."""
    ea = _xcorr_consts(tmpl_bytes, span)[2]
    return (torch.tensor(np.frombuffer(tmpl_bytes, np.complex64),
                         device=device),
            torch.tensor(ea, device=device))


def template_period(tmpl: np.ndarray) -> int:
    """The smallest p < len(tmpl) with ``tmpl[i + p] == tmpl[i]``
    everywhere (exactly), or 0.  The S0 template repeats with period M/4
    (S0 sits on every 4th subcarrier)."""
    t = np.asarray(tmpl)
    for p in np.nonzero(t[1:] == t[0])[0] + 1:
        if np.array_equal(t[p:], t[:-p]):
            return int(p)
    return 0


XF_JMAX = 16            # csrc/xcorr_fold.cu: partial sums an output
XF_SPAN_MAX = 24        # ... and its largest span


@functools.lru_cache(maxsize=16)
def _fold_geometry(tmpl_bytes: bytes, span: int):
    """The period-fold path's geometry of a template, or ``None`` where it
    has no period, a span the path does not take, or windows it cannot
    fold: ``(P, J, g, taps, meta)``.  P, a multiple of the period p, is
    each lane's walk (p unless that gives more than ``XF_JMAX`` partial
    sums an output); output n reads segment s from lane n + j P, j = s
    span // P < J, at window start t = s span - j P, whose offset t mod
    span is (-j P) mod span: a multiple of g = gcd(P, span).  The kernel
    sums a lane's windows per offset, so every window at one offset must
    serve the same partials, or none (true of every S0 template); ``taps``
    [P + 2 span] complex64, tap t = conj(tmpl[t mod p]) up to P + span -
    1, zeros after; ``meta`` [P + span, 2] float32: the segment energy of
    the window at t and 1 where it serves a segment, else 0 (so at every
    t >= P)."""
    tmpl = np.frombuffer(tmpl_bytes, np.complex64)
    n_tmpl = len(tmpl)
    p = template_period(tmpl)
    if not p or span > XF_SPAN_MAX:
        return None
    P = p
    while (n_tmpl - span) // P + 1 > XF_JMAX:
        P += p
    J = (n_tmpl - span) // P + 1
    ea = _xcorr_consts(tmpl_bytes, span)[2]
    taps = np.zeros(P + 2 * span, np.complex64)
    taps[:P + span - 1] = np.conj(tmpl[np.arange(P + span - 1) % p])
    meta = np.zeros((P + span, 2), np.float32)
    served = {}
    for t in range(P):
        js = tuple(j for j in range(J)
                   if (t + j * P) % span == 0 and t + j * P <= n_tmpl - span)
        if js:
            segs = [(t + j * P) // span for j in js]
            if len(set(ea[segs].tolist())) != 1 or \
                    served.setdefault(t % span, js) != js:
                return None
            meta[t] = ea[segs[0]], 1.0
    return P, J, math.gcd(P, span), taps, meta


def xcorr_path(tmpl: np.ndarray, span: int) -> str:
    """B1's kernel for a template: ``"const"`` for M = 48's geometry
    (96 taps, span 24: ``csrc/xcorr_metric.cu``'s ``__constant__``
    instance), ``"fold"`` for any other template with a period
    (``csrc/xcorr_fold.cu``), else ``"direct"`` (the direct-form generic
    instance of ``csrc/xcorr_metric.cu``)."""
    tmpl = np.ascontiguousarray(tmpl, np.complex64)
    if (len(tmpl), span) == _XC_CONST_GEOMETRY:
        return "const"
    return "direct" if _fold_geometry(tmpl.tobytes(), span) is None \
        else "fold"


@functools.lru_cache(maxsize=16)
def _fold_device_consts(tmpl_bytes: bytes, span: int, device: str):
    """The fold geometry's taps and metadata on ``device``."""
    _, _, _, taps, meta = _fold_geometry(tmpl_bytes, span)
    return (torch.tensor(taps, device=device),
            torch.tensor(meta, device=device))


def detect_metric_xcorr_onepass(ext: torch.Tensor, tmpl: np.ndarray,
                                span: int, n_metric: int,
                                floor_scale: float = 1e-4) -> torch.Tensor:
    """Segmented-coherent cross-correlation metric ``[..., n_metric]``.

    ``tmpl``: the known template (``n_seg * span`` complex host samples).
    Matches ``ofdm_sync._detect_metric_xcorr`` (time-domain MACs instead
    of its FFT-domain correlations).  On the card the kernel follows the
    template (:func:`xcorr_path`)."""
    tmpl = np.ascontiguousarray(tmpl, np.complex64)
    if len(tmpl) % span:
        raise ValueError(f"template length {len(tmpl)} is not a multiple "
                         f"of span {span}")
    lead = ext.shape[:-1]
    x = _check_rows(ext)
    if x.device.type == "cpu":
        out = detect_metric_xcorr_plain(x, tmpl, span, n_metric, floor_scale)
        return out.reshape(*lead, n_metric)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    x = x.contiguous()
    rows, length = x.shape
    tmpl_bytes = tmpl.tobytes()
    tre, tim, ea = _xcorr_consts(tmpl_bytes, span)
    denom = max(length, _xcorr_padded_len(n_metric, span, len(tmpl)))
    floors = _row_floor((x.real ** 2 + x.imag ** 2).sum(-1), denom, span,
                        floor_scale).to(torch.float32).contiguous()
    out = torch.empty((rows, n_metric), dtype=torch.float32, device=x.device)
    path = xcorr_path(tmpl, span)
    geometry = dict(rows=rows, len=length, n_tmpl=len(tmpl), span=span,
                    n_metric=n_metric, path=path)
    if path == "fold":
        P, J, g, _, _ = _fold_geometry(tmpl_bytes, span)
        taps, meta = _fold_device_consts(tmpl_bytes, span, str(x.device))
        try:
            part = torch.empty((rows, J, n_metric), dtype=torch.float32,
                               device=x.device)
        except torch.OutOfMemoryError as err:
            raise torch.OutOfMemoryError(
                f"xcorr_fold_launch: partial sums at {_where(geometry)}: "
                f"{err}") from err
        _launch("xcorr_fold_launch", x, geometry, x.data_ptr(), rows, length,
                span, len(tmpl) // span, P, J, g, n_metric,
                floors.data_ptr(), taps.data_ptr(), meta.data_ptr(),
                part.data_ptr(), out.data_ptr())
    else:
        dtmpl = dea = None
        if path == "direct":
            dtmpl, dea = _xcorr_device_consts(tmpl_bytes, span,
                                              str(x.device))
        _launch("xcorr_metric_launch", x, geometry, x.data_ptr(), rows,
                length, tre.ctypes.data_as(ctypes.c_void_p),
                tim.ctypes.data_as(ctypes.c_void_p),
                ea.ctypes.data_as(ctypes.c_void_p), _ptr(dtmpl), _ptr(dea),
                len(tmpl), span, n_metric, floors.data_ptr(), out.data_ptr())
    launches["detect_metric_xcorr_onepass"] += 1
    xcorr_paths[path] += 1
    return out.reshape(*lead, n_metric)


def detect_metric_xcorr_plain(ext: torch.Tensor, tmpl: np.ndarray,
                              span: int, n_metric: int,
                              floor_scale: float = 1e-4) -> torch.Tensor:
    """Plain PyTorch version of B1: a time-domain segmented MAC over
    ``[rows, len]`` windows, in the JAX kernel's order of operations."""
    tmpl = np.ascontiguousarray(tmpl, np.complex64)
    tre, tim, ea = _xcorr_consts(tmpl.tobytes(), span)
    n_tmpl = len(tmpl)
    n_seg = n_tmpl // span
    rows, length = ext.shape
    need = n_metric + n_tmpl - 1
    if length < need:
        ext = torch.cat([ext, torch.zeros((rows, need - length),
                                          dtype=ext.dtype,
                                          device=ext.device)], dim=-1)
    xr, xi = ext.real, ext.imag
    p = xr * xr + xi * xi
    denom = max(length, _xcorr_padded_len(n_metric, span, n_tmpl))
    floor = _row_floor(p[:, :length].sum(-1), denom, span,
                       floor_scale)[:, None]
    acc = None
    for s in range(n_seg):
        ure = uim = es = None
        for j in range(span):
            off = s * span + j
            a = xr[:, off:off + n_metric]
            b = xi[:, off:off + n_metric]
            tr, ti = float(tre[off]), float(tim[off])
            re_t = tr * a + ti * b          # conj(t) * x
            im_t = tr * b - ti * a
            pj = p[:, off:off + n_metric]
            ure = re_t if ure is None else ure + re_t
            uim = im_t if uim is None else uim + im_t
            es = pj if es is None else es + pj
        r = (ure * ure + uim * uim) / torch.clamp(es * float(ea[s]),
                                                  min=1e-12)
        r = torch.where(es > floor, r, torch.zeros_like(r))
        acc = r if acc is None else acc + r
    return acc / n_seg


# ---------------------------------------------------------------------------
# B2: fused Schmidl-Cox metric + NMS + segment reduction
# ---------------------------------------------------------------------------

def _moving_sum(x: torch.Tensor, L: int) -> torch.Tensor:
    """Windowed sums of length ``L`` along the last axis, from a float64
    (complex128) cumulative sum, so long streams lose no precision."""
    wide = torch.complex128 if x.is_complex() else torch.float64
    cs = torch.cumsum(x.to(wide), dim=-1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    return (cs[..., L:] - cs[..., :-L]).to(x.dtype)


def autocorr_metric(ext: torch.Tensor, lag: int, span: int,
                    floor_scale: float = 1e-4):
    """The S0 periodicity (Schmidl-Cox) metric for every offset:
    ``(metric [..., n_out], c [..., n_out])``, ``n_out = len - span - lag
    + 1``, with ``c[n] = sum_{i<span} x[n+i] conj(x[n+i+lag])`` and the
    silence floor gate.  The plain version of ``ofdm_sync._detect_metric``
    and the first half of B2."""
    prod = ext[..., :-lag] * torch.conj(ext[..., lag:])
    c = _moving_sum(prod, span)
    p = ext.real ** 2 + ext.imag ** 2
    e1 = _moving_sum(p[..., :-lag], span)
    e2 = _moving_sum(p[..., lag:], span)
    metric = (c.real ** 2 + c.imag ** 2) / torch.clamp(e1 * e2, min=1e-12)
    floor = _row_floor(p.sum(-1), p.shape[-1], span, floor_scale)[..., None]
    metric = torch.where(torch.minimum(e1, e2) > floor, metric,
                         torch.zeros_like(metric))
    return metric, c


# B2's paths by the code of csrc/detect_candidates.cu's
# detect_candidates_path: (path, the CUDA kernels a call launches)
_CAND_PATHS = (
    ("m48", ("detect_candidates_kernel",)),
    ("one_pass", ("detect_candidates_kernel",)),
    ("window_sums", ("cand_sums_kernel", "cand_pick_kernel")),
    ("window_sums", ("w3_totals_kernel", "cand_sums_kernel",
                     "cand_pick_kernel")))


@functools.lru_cache(maxsize=64)
def _cand_path(lag: int, span: int, win: int) -> tuple:
    return _CAND_PATHS[_lib().detect_candidates_path(lag, span, win)]


def candidates_path(lag: int, span: int, win: int) -> str:
    """B2's path at a geometry, as the CUDA library reports it (so only
    where it is built, beside a card): ``"m48"`` (the one-pass kernel's
    M = 48 template instance), ``"one_pass"`` (its generic instance, OFDM
    M from 32 to 472) or ``"window_sums"`` (OFDM M >= 476, and every
    other geometry)."""
    return _cand_path(lag, span, win)[0]


def candidates_kernels(lag: int, span: int, win: int) -> tuple:
    """The CUDA kernels one call of B2's wrapper launches at a geometry,
    as the CUDA library reports them: the window-sum path's chunk totals
    only where a block of ``span`` terms is more than one chunk."""
    return _cand_path(lag, span, win)[1]


def detect_candidates_onepass(ext: torch.Tensor, lag: int, span: int,
                              win: int, T: int, threshold: float, k: int,
                              floor_scale: float = 1e-4):
    """Fused S0 detect -> NMS -> top-k: ``(vals, locs, c_at)`` each
    ``[..., k]`` (``vals > 0`` = detected; ``locs`` int32 offsets into the
    window; ``c_at`` complex64 lag correlation at ``locs``)."""
    lead = ext.shape[:-1]
    x = _check_rows(ext)
    if x.device.type == "cpu":
        vals, locs, c_at = detect_candidates_plain(
            x, lag, span, win, T, threshold, k, floor_scale)
    elif x.device.type == "cuda":
        vals, locs, c_at = _detect_candidates_cuda(
            x.contiguous(), lag, span, win, T, threshold, k, floor_scale)
    else:
        raise RuntimeError(f"no kernel for device {x.device}")
    return (vals.reshape(*lead, k), locs.reshape(*lead, k),
            c_at.reshape(*lead, k))


def _detect_candidates_cuda(x, lag, span, win, T, threshold, k,
                            floor_scale):
    rows, length = x.shape
    n_out = length - span - lag + 1
    n_seg = -(-n_out // CAND_SEG)
    floors = _row_floor((x.real ** 2 + x.imag ** 2).sum(-1), length, span,
                        floor_scale).to(torch.float32).contiguous()
    dev = x.device
    segval = torch.empty((rows, n_seg), dtype=torch.float32, device=dev)
    segarg = torch.empty((rows, n_seg), dtype=torch.int32, device=dev)
    segcre = torch.empty((rows, n_seg), dtype=torch.float32, device=dev)
    segcim = torch.empty((rows, n_seg), dtype=torch.float32, device=dev)
    geometry = dict(rows=rows, len=length, lag=lag, span=span, win=win)
    scratch = _scratch("detect_candidates_scratch", dev, geometry, rows,
                       n_out, lag, span, win, n_seg)
    _launch("detect_candidates_launch", x, geometry, x.data_ptr(), rows,
            length, lag, span, win, T, float(threshold), floors.data_ptr(),
            n_out, n_seg, segval.data_ptr(), segarg.data_ptr(),
            segcre.data_ptr(), segcim.data_ptr(), _ptr(scratch))
    launches["detect_candidates_onepass"] += 1
    cand_paths[candidates_path(lag, span, win)] += 1
    # segment-rate second stage, as the JAX wrapper runs lax.top_k
    vals, seg_idx = torch.topk(segval, k, dim=-1)
    locs = torch.gather(segarg, -1, seg_idx)
    c_at = torch.complex(torch.gather(segcre, -1, seg_idx),
                         torch.gather(segcim, -1, seg_idx))
    return vals, locs, c_at


def detect_candidates_plain(ext: torch.Tensor, lag: int, span: int,
                            win: int, T: int, threshold: float, k: int,
                            floor_scale: float = 1e-4):
    """Plain PyTorch version of B2: ``_find_candidates(_detect_metric())``
    plus the lag correlation at the chosen offsets."""
    metric, c = autocorr_metric(ext, lag, span, floor_scale)
    vals, locs = corr.find_candidates(metric, win, T, threshold, k)
    idx = torch.clamp(locs.to(torch.int64), 0, c.shape[-1] - 1)
    return vals, locs, torch.gather(c, -1, idx)


# ---------------------------------------------------------------------------
# B3: the Schmidl-Cox metric at full rate; B4/B5: the same from prefix sums
# ---------------------------------------------------------------------------

def _metric_rows(name, plain, cuda, ext, lag, span, floor_scale):
    """Dispatch of the ``(metric, c)`` kernels: ``[..., len]`` windows ->
    ``(metric [..., n_out] float32, c [..., n_out] complex64)``, ``n_out =
    len - span - lag + 1``.  A CPU tensor runs ``plain``; a CUDA tensor
    runs ``cuda(x, lag, span, floor_scale, metric, c)`` on contiguous rows
    into the outputs it is given, and counts one launch of ``name``."""
    lead = ext.shape[:-1]
    x = _check_rows(ext)
    rows, length = x.shape
    n_out = length - span - lag + 1
    if lag < 1 or span < 1 or n_out < 1:
        raise ValueError(f"rows of {length} samples give no output at lag "
                         f"{lag}, span {span}")
    if x.device.type == "cpu":
        metric, c = plain(x, lag, span, floor_scale)
    elif x.device.type == "cuda":
        x = x.contiguous()
        metric = torch.empty((rows, n_out), dtype=torch.float32,
                             device=x.device)
        c = torch.empty((rows, n_out), dtype=torch.complex64,
                        device=x.device)
        cuda(x, lag, span, floor_scale, metric, c)
        launches[name] += 1
    else:
        raise RuntimeError(f"no kernel for device {x.device}")
    return metric.reshape(*lead, n_out), c.reshape(*lead, n_out)


def _autocorr_metric_cuda(x, lag, span, floor_scale, metric, c):
    rows, length = x.shape
    floors = _row_floor((x.real ** 2 + x.imag ** 2).sum(-1), length, span,
                        floor_scale).contiguous()
    n_out = metric.shape[-1]
    geometry = dict(rows=rows, len=length, lag=lag, span=span)
    scratch = _scratch("autocorr_metric_scratch", x.device, geometry, rows,
                       n_out, lag, span)
    _launch("autocorr_metric_launch", x, geometry, x.data_ptr(), rows,
            length, lag, span, floors.data_ptr(), n_out, metric.data_ptr(),
            c.data_ptr(), _ptr(scratch))


def detect_metric_onepass(ext: torch.Tensor, lag: int, span: int,
                          floor_scale: float = 1e-4):
    """Kernel B3: the Schmidl-Cox metric and lag correlation ``(metric,
    c)`` for every offset of each window, as :func:`autocorr_metric`
    defines them, summed in float32 on the card with no subtraction (any
    ``span`` and ``lag``)."""
    return _metric_rows("detect_metric_onepass", autocorr_metric,
                        _autocorr_metric_cuda, ext, lag, span, floor_scale)


def _prefix_sums(x: torch.Tensor, lag: int):
    """Stage 1 of B4/B5, as XLA runs it before the JAX kernels: float32
    prefix sums with a leading zero of the lag products' real and imaginary
    parts (``[..., len - lag + 1]``) and of the power (``[..., len + 1]``),
    and the power's row sum for the floor.  The JAX wrappers also
    edge-pad these arrays to their tile raster; no valid output reads the
    padding, so the port does not pad."""
    prod = x[..., :-lag] * torch.conj(x[..., lag:])
    p = x.real ** 2 + x.imag ** 2

    def pre(v):
        return torch.nn.functional.pad(torch.cumsum(v, dim=-1), (1, 0))
    return pre(prod.real), pre(prod.imag), pre(p), p.sum(-1)


def autocorr_metric_prefix(ext: torch.Tensor, lag: int, span: int,
                           floor_scale: float = 1e-4):
    """Plain version of B4/B5: :func:`autocorr_metric`'s ``(metric, c)``
    taken as windowed differences of the float32 prefix sums of
    :func:`_prefix_sums` (so its rounding is the JAX kernels', not the
    float64 sums of :func:`autocorr_metric`)."""
    cre, cim, cp, p_sum = _prefix_sums(ext, lag)
    n_out = ext.shape[-1] - span - lag + 1

    def diff(a, off):
        return a[..., off + span:off + span + n_out] - a[..., off:off + n_out]
    dre, dim = diff(cre, 0), diff(cim, 0)
    e1, e2 = diff(cp, 0), diff(cp, lag)
    metric = (dre * dre + dim * dim) / torch.clamp(e1 * e2, min=1e-12)
    floor = _row_floor(p_sum, ext.shape[-1], span, floor_scale)[..., None]
    metric = torch.where(torch.minimum(e1, e2) > floor, metric,
                         torch.zeros_like(metric))
    return metric, torch.complex(dre, dim)


def _autocorr_prefix_cuda(x, lag, span, floor_scale, metric, c):
    rows, length = x.shape
    cre, cim, cp, p_sum = _prefix_sums(x, lag)
    floors = _row_floor(p_sum, length, span, floor_scale).contiguous()
    _launch("autocorr_prefix_launch", x,
            dict(rows=rows, len=length, lag=lag, span=span),
            cre.data_ptr(), cim.data_ptr(), cp.data_ptr(), rows, length, lag,
            span, floors.data_ptr(), metric.shape[-1], metric.data_ptr(),
            c.data_ptr())


def detect_metric_fused_2d(ext: torch.Tensor, lag: int, span: int,
                           floor_scale: float = 1e-4):
    """Kernel B4: B3's ``(metric, c)`` from float32 prefix sums.  Keeps
    the JAX kernel's limit ``span + lag <= 128``."""
    if span + lag > 128:
        raise ValueError("2-D detect kernel requires span + lag <= 128")
    return _metric_rows("detect_metric_fused_2d", autocorr_metric_prefix,
                        _autocorr_prefix_cuda, ext, lag, span, floor_scale)


def detect_metric_fused(ext: torch.Tensor, lag: int, span: int,
                        floor_scale: float = 1e-4):
    """Kernel B5: B3's ``(metric, c)`` from float32 prefix sums, any
    span."""
    return _metric_rows("detect_metric_fused", autocorr_metric_prefix,
                        _autocorr_prefix_cuda, ext, lag, span, floor_scale)
