"""802.11a OFDM frames: transmitter and streaming receiver.

Port of ``liquid_usrp_tpu/framing/wlan.py``.  The 802.11a (1999) PHY:

* 64-subcarrier OFDM, 48 data + 4 pilot carriers (+-7, +-21), 16-sample CP;
* short + long training preambles (160 + 160 samples);
* SIGNAL field (rate and length, BPSK, rate-1/2 conv, one symbol);
* DATA: service + PSDU + tail + pad, the frame-synchronous scrambler
  (x^7 + x^4 + 1), the K=7 (133, 171) convolutional code with 2/3 and 3/4
  puncturing, the per-symbol block interleaver, BPSK/QPSK/16-QAM/64-QAM
  and the pilot polarity PN.

The constant tables are NumPy, computed as JAX computes them; the
per-frame work runs in torch on the device.  TX builds every symbol in one
pass and one ``torch.fft.ifft`` (JAX multiplies by a 64-point DFT matrix,
the MXU's form; the waveforms agree within 1e-6 of the largest sample).

RX, ``wlan_sync_block(sync, state, block) -> (state', WlanResults)``, per
extended window (``tail ++ block``):

1. the segmented long-training cross-correlation metric: 16 coherent
   8-sample segments, each normalised by its 8-tap window energy, under a
   silence gate; non-max suppression and a top-k;
2. a decode batched over the candidates (where JAX ``vmap``s): two-stage
   CFO (short-training lag 16, then long-training lag 64), the channel
   from the two long symbols, every symbol's FFT, equalisation and pilot
   phase, the SIGNAL field through the soft Viterbi, and the DATA field
   through all eight rates' demap, deinterleave and depuncture (as JAX's
   ``lax.switch`` inside ``vmap`` does), picked by each row's rate, then
   the soft Viterbi and the self-synchronising descrambler.

The decode gate is a host ``if`` on ``detected.any()`` where JAX has a
``lax.cond``.  Every gather into the window clamps its index, as a JAX
gather does.  :class:`WlanSyncState` and :class:`WlanResults` have JAX's
fields in JAX's order, so a JAX state taken mid-stream resumes here
(``utils/convert.py``); ``base`` is int32 and wraps at 2^31, as in JAX.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.corr import find_candidates
from ..ops.iqfmt import iq_from_any
from ..utils.consts import on
from ..utils.device import default_device

__all__ = ["WLAN_RATES", "wlan_frame_length", "wlan_assemble",
           "wlan_decode", "wlan_sync",
           "WlanSync", "WlanSyncState", "WlanResults", "make_wlan_sync",
           "wlan_sync_init", "wlan_sync_block", "make_wlan_sync_step"]

# rate Mb/s -> (bits/subcarrier BPSC, coding rate (num, den),
#               coded bits/symbol NCBPS, data bits/symbol NDBPS)
WLAN_RATES = {
    6: (1, (1, 2), 48, 24),
    9: (1, (3, 4), 48, 36),
    12: (2, (1, 2), 96, 48),
    18: (2, (3, 4), 96, 72),
    24: (4, (1, 2), 192, 96),
    36: (4, (3, 4), 192, 144),
    48: (6, (2, 3), 288, 192),
    54: (6, (3, 4), 288, 216),
}

_N_FFT = 64
_CP = 16
_DATA_IDX = [k for k in range(-26, 27)
             if k != 0 and abs(k) != 7 and abs(k) != 21]  # 48 carriers
_PILOT_IDX = [-21, -7, 7, 21]
_SCALE = _N_FFT / np.sqrt(52)


def _fftshift_index(k: int) -> int:
    return k % _N_FFT


_DIDX = np.array([_fftshift_index(k) for k in _DATA_IDX])
_PIDX = np.array([_fftshift_index(k) for k in _PILOT_IDX])


@functools.lru_cache(maxsize=None)
def _tables():
    """(short training symbol, long training symbol, pilot polarity PN)."""
    # short training: the standard S values on every 4th carrier
    s_set = {
        -24: 1 + 1j, -20: -1 - 1j, -16: 1 + 1j, -12: -1 - 1j, -8: -1 - 1j,
        -4: 1 + 1j, 4: -1 - 1j, 8: -1 - 1j, 12: 1 + 1j, 16: 1 + 1j,
        20: 1 + 1j, 24: 1 + 1j}
    S = np.zeros(_N_FFT, dtype=np.complex128)
    for k, v in s_set.items():
        S[_fftshift_index(k)] = np.sqrt(13.0 / 6.0) * v
    short = np.fft.ifft(S) * _N_FFT / np.sqrt(52)

    # long training: the standard L sequence on carriers -26..26
    L_seq = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1,
             -1, 1, -1, 1, 1, 1, 1,
             0,
             1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1,
             -1, 1, -1, 1, -1, 1, 1, 1, 1]
    L = np.zeros(_N_FFT, dtype=np.complex128)
    for i, k in enumerate(range(-26, 27)):
        L[_fftshift_index(k)] = L_seq[i]
    long_t = np.fft.ifft(L) * _N_FFT / np.sqrt(52)

    # pilot polarity PN: the scrambler's x^7 + x^4 + 1 sequence seeded
    # all-ones, as +-1 (standard 17.3.5.9)
    pn = 1.0 - 2.0 * _scramble_seq(0x7F).astype(np.float32)
    return short.astype(np.complex64), long_t.astype(np.complex64), \
        pn.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _scramble_seq(seed: int) -> np.ndarray:
    """One period (127 bits) of the x^7 + x^4 + 1 scrambler output."""
    state = seed & 0x7F
    seq = np.empty(127, np.uint8)
    for i in range(127):
        s = ((state >> 6) ^ (state >> 3)) & 1
        seq[i] = s
        state = ((state << 1) | s) & 0x7F
    return seq


# taps[j] multiplies b[i-j].  The generators g0=133, g1=171 (IEEE
# 802.11-1999 17.3.5.5) are written MSB = delay 0, so tap j is polynomial
# bit (6-j): delays {0,2,3,5,6} and {0,1,2,3,6}.
_G0_TAPS = np.array([(0o133 >> (6 - j)) & 1 for j in range(7)], np.uint8)
_G1_TAPS = np.array([(0o171 >> (6 - j)) & 1 for j in range(7)], np.uint8)


def _conv_encode_bits(bits: np.ndarray) -> np.ndarray:
    """K=7 (133, 171) rate 1/2 from the zero state (the caller appends the
    tail bits); each output is a GF(2) convolution."""
    b = np.asarray(bits, np.uint8)
    o0 = np.convolve(b, _G0_TAPS)[: len(b)] & 1
    o1 = np.convolve(b, _G1_TAPS)[: len(b)] & 1
    out = np.empty(2 * len(b), np.uint8)
    out[0::2] = o0
    out[1::2] = o1
    return out


@functools.lru_cache(maxsize=None)
def _interleave_perm(ncbps: int, bpsc: int) -> np.ndarray:
    """perm[k] = output position of input bit k (17.3.5.6, two steps)."""
    s = max(bpsc // 2, 1)
    k = np.arange(ncbps)
    i = (ncbps // 16) * (k % 16) + k // 16
    j = s * (i // s) + (i + ncbps - (16 * i // ncbps)) % s
    return j


def _interleave(bits: np.ndarray, ncbps: int, bpsc: int) -> np.ndarray:
    """Per-symbol two-permutation block interleaver."""
    perm = _interleave_perm(ncbps, bpsc)
    sym = bits.reshape(-1, ncbps)
    out = np.empty_like(sym)
    out[:, perm] = sym
    return out.reshape(-1)


def wlan_n_symbols(rate: int, length: int) -> int:
    ndbps = WLAN_RATES[rate][3]
    return -(-(16 + 8 * length + 6) // ndbps)


def wlan_frame_length(rate: int, length: int) -> int:
    """Total samples: short(160) + long(160) + SIGNAL(80) + data syms*80."""
    return 160 + 160 + 80 + wlan_n_symbols(rate, length) * 80


@functools.lru_cache(maxsize=None)
def _assemble_consts(rate: int, length: int, seed: int):
    """Host tables of one (rate, length, seed) frame geometry, as JAX
    builds them: preambles, the SIGNAL symbol grid, the scramble PN with
    the tail mask, puncture keep-indices, the inverse interleaver
    permutation, the constellation LUTs and the pilot grid."""
    bpsc, (num, den), ncbps, ndbps = WLAN_RATES[rate]
    short, long_t, pilot_pn = _tables()

    short_pre = np.tile(short[:16], 10)                    # 160 samples
    long_pre = np.concatenate([long_t[-32:], long_t, long_t])  # 160

    # SIGNAL: 24 bits, BPSK r=1/2, its own symbol
    rate_bits = list(_RATE_CODES[rate])
    len_bits = [(length >> i) & 1 for i in range(12)]      # LSB first
    sig = np.array(rate_bits + [0] + len_bits, dtype=np.uint8)
    parity = int(sig.sum()) & 1
    sig = np.concatenate([sig, [parity], np.zeros(6, np.uint8)])
    sig_pts = (2.0 * _interleave(_conv_encode_bits(sig), 48, 1) - 1.0
               ).astype(np.complex64)                   # BPSK

    n_sym = wlan_n_symbols(rate, length)
    n_data_bits = n_sym * ndbps
    # the scramble PN over the data bits; the tail bits are zeroed after
    # scrambling (standard 17.3.5.2): a static mask
    pn = np.tile(_scramble_seq(seed),
                 -(-n_data_bits // 127))[:n_data_bits].astype(np.uint8)
    tail_at = 16 + 8 * length
    keep_mask = np.ones(n_data_bits, np.uint8)
    keep_mask[tail_at:tail_at + 6] = 0
    coded_len = 2 * n_data_bits
    if (num, den) == (1, 2):
        punct_idx = np.arange(coded_len)
    else:
        pat = [1, 1, 1, 0] if (num, den) == (2, 3) else [1, 1, 1, 0, 0, 1]
        keep = np.tile(pat, coded_len // len(pat) + 1)[:coded_len]
        punct_idx = np.nonzero(keep)[0]
    perm = _interleave_perm(ncbps, bpsc)
    inv_perm = np.argsort(perm)     # out[:, perm] = in  <=>  out = in[:, inv]

    # constellation LUTs indexed by the bpsc-bit group value (MSB first)
    if bpsc == 1:
        lut_re = np.array([-1.0, 1.0], np.float32)
        lut_im = np.zeros(2, np.float32)
    elif bpsc == 2:
        v = np.array([-1.0, 1.0]) / np.sqrt(2)
        lut_re = np.repeat(v, 2).astype(np.float32)        # b0 -> re
        lut_im = np.tile(v, 2).astype(np.float32)          # b1 -> im
    elif bpsc == 4:
        a = np.array([-3, -1, 3, 1]) / np.sqrt(10)
        lut_re = np.repeat(a, 4).astype(np.float32)
        lut_im = np.tile(a, 4).astype(np.float32)
    else:
        a = np.array([-7, -5, -1, -3, 7, 5, 1, 3]) / np.sqrt(42)
        lut_re = np.repeat(a, 8).astype(np.float32)
        lut_im = np.tile(a, 8).astype(np.float32)

    sig_grid = np.zeros(_N_FFT, np.complex64)
    sig_grid[_DIDX] = sig_pts
    sig_grid[_PIDX] = np.array([1, 1, 1, -1]) * pilot_pn[0]
    pilot_grid = np.zeros((n_sym, _N_FFT), np.complex64)
    pilot_grid[:, _PIDX] = (np.array([1, 1, 1, -1])[None, :] *
                            pilot_pn[(1 + np.arange(n_sym)) % 127][:, None])
    weights = (1 << np.arange(bpsc - 1, -1, -1)).astype(np.int32)
    return dict(bpsc=bpsc, n_sym=n_sym, ndbps=ndbps, ncbps=ncbps,
                preamble=np.concatenate([short_pre, long_pre])
                .astype(np.complex64),
                pn=pn, keep_mask=keep_mask, punct_idx=punct_idx,
                inv_perm=inv_perm, lut_re=lut_re, lut_im=lut_im,
                weights=weights, sig_grid=sig_grid, pilot_grid=pilot_grid)


def _assemble(rate: int, length: int, seed: int,
              psdu: torch.Tensor) -> torch.Tensor:
    """The DATA path on the device for one static (rate, length): scramble
    and tail mask as one XOR and AND against the static PN, the K=7
    encoder as shifted XORs, puncture and interleave as static gathers,
    the constellation as LUT gathers, one IFFT over the SIGNAL and DATA
    grids, the CP by slicing."""
    c = _assemble_consts(rate, length, seed)
    dev = psdu.device
    n_data_bits = c["n_sym"] * c["ndbps"]
    # PSDU bits LSB first (the 802.11a order)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = ((psdu[:, None] >> shifts) & 1).reshape(-1)
    data = torch.cat([
        torch.zeros(16, dtype=torch.uint8, device=dev), bits,
        torch.zeros(n_data_bits - 16 - 8 * length, dtype=torch.uint8,
                    device=dev)])
    scrambled = (data ^ on(c["pn"], dev)) & on(c["keep_mask"], dev)

    def delayed(b, d):
        return torch.nn.functional.pad(b, (d, 0))[:n_data_bits]
    o0 = scrambled
    for d in (2, 3, 5, 6):
        o0 = o0 ^ delayed(scrambled, d)
    o1 = scrambled
    for d in (1, 2, 3, 6):
        o1 = o1 ^ delayed(scrambled, d)
    coded = torch.stack([o0, o1], dim=-1).reshape(-1)      # A/B interleaved
    punct = coded[on(c["punct_idx"], dev)]
    inter = punct.reshape(c["n_sym"], c["ncbps"])[:, on(c["inv_perm"], dev)]
    grp = inter.reshape(-1, c["bpsc"]).to(torch.int32)
    idx = (grp * on(c["weights"], dev)).sum(-1).long()
    pts = torch.complex(on(c["lut_re"], dev)[idx], on(c["lut_im"], dev)[idx])
    grids = on(c["pilot_grid"], dev).clone()
    grids[:, on(_DIDX, dev)] = pts.reshape(c["n_sym"], 48)
    grids = torch.cat([on(c["sig_grid"], dev)[None], grids])
    time = torch.fft.ifft(grids, dim=-1) * _SCALE
    with_cp = torch.cat([time[:, -_CP:], time], dim=-1)
    return torch.cat([on(c["preamble"], dev), with_cp.reshape(-1)])


def wlan_assemble(rate: int, psdu, seed: int = 0x5D,
                  device=None) -> torch.Tensor:
    """One 802.11a frame -> complex64 ``[wlan_frame_length]`` on
    ``device`` (``None``: ``utils.device.default_device()``).

    ``rate``: 6/9/12/18/24/36/48/54 Mb/s; ``psdu``: the payload bytes."""
    if rate not in WLAN_RATES:
        raise ValueError(f"invalid rate {rate}; one of {list(WLAN_RATES)}")
    dev = default_device(device)
    psdu = torch.as_tensor(np.asarray(psdu, np.uint8), device=dev)
    return _assemble(rate, int(psdu.shape[-1]), seed, psdu)


# ---------------------------------------------------------------------------
# RX: the streaming synchronizer, step(state, block)
# ---------------------------------------------------------------------------

_DET_SEG = 8        # detection segment length (coherent span)
_DET_NSEG = 16      # 16 segments x 8 = the full 128-sample [LT1 LT2]
_DET_WIN = 96       # NMS radius > the 64-sample LT self-similarity lobe

_RATE_LIST = tuple(sorted(WLAN_RATES))          # (6, 9, ..., 54)
_RATE_CODES = {6: (1, 1, 0, 1), 9: (1, 1, 1, 1), 12: (0, 1, 0, 1),
               18: (0, 1, 1, 1), 24: (1, 0, 0, 1), 36: (1, 0, 1, 1),
               48: (0, 0, 0, 1), 54: (0, 0, 1, 1)}


class WlanSync(NamedTuple):
    block_size: int
    max_psdu: int           # static PSDU decode budget (bytes)
    max_frames: int         # candidates per block
    threshold: float
    overlap: int            # carried tail (>= max frame + margins)
    max_sym: int            # static DATA symbol budget
    nb: int                 # static Viterbi data-bit budget
    w_frame: int            # static frame window (400 + max_sym*80)


class WlanSyncState(NamedTuple):
    tail: torch.Tensor      # [overlap] complex64
    base: torch.Tensor      # int32 stream index of tail[0]


class WlanResults(NamedTuple):
    """Fixed-shape per-block results; leading dim = max_frames."""
    detected: torch.Tensor      # bool
    signal_valid: torch.Tensor  # bool
    psdu_valid: torch.Tensor    # bool
    rate: torch.Tensor          # int32 Mb/s (0 when invalid)
    length: torch.Tensor        # int32 PSDU bytes
    psdu: torch.Tensor          # [max_frames, max_psdu] uint8
    cfo: torch.Tensor           # float32 rad/sample
    rssi: torch.Tensor          # float32 dB
    t_start: torch.Tensor       # int32 stream index of the frame's first
    #                             short-training sample


def make_wlan_sync(block_size: int = 8192, max_psdu: int = 256,
                   max_frames: int = 4,
                   threshold: float = 0.45) -> WlanSync:
    # the worst-case symbol count is the lowest rate's (24 data bits)
    max_sym = -(-(16 + 8 * max_psdu + 6) // 24)
    # the static data-bit budget covers n_sym * ndbps at every rate for a
    # length <= max_psdu (pad bits <= ndbps_max - 1 = 215)
    nb = 16 + 8 * max_psdu + 6 + 216
    w_frame = 400 + max_sym * 80
    return WlanSync(block_size=block_size, max_psdu=max_psdu,
                    max_frames=max_frames, threshold=threshold,
                    overlap=w_frame + 192 + 256, max_sym=max_sym,
                    nb=nb, w_frame=w_frame)


def wlan_sync_init(sync: WlanSync, device=None) -> WlanSyncState:
    dev = default_device(device)
    return WlanSyncState(
        tail=torch.zeros(sync.overlap, dtype=torch.complex64, device=dev),
        base=torch.tensor(-sync.overlap, dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=None)
def _det_templates():
    """Segmented [LT1 LT2] templates ``[_DET_NSEG, _DET_SEG]`` (conj) and
    per-segment energies."""
    _, long_t, _ = _tables()
    lt = np.concatenate([long_t, long_t])            # 128 samples
    segs = lt.reshape(_DET_NSEG, _DET_SEG)
    E = np.sum(np.abs(segs) ** 2, axis=-1).astype(np.float32)
    return np.conj(segs).astype(np.complex64), E


def _wlan_metric(sync: WlanSync, ext: torch.Tensor) -> torch.Tensor:
    """Segmented-coherent LT cross-correlation metric over the detect
    region ``[0, block + 2*_DET_WIN)`` (peak = LT1 start, value ~1).

    Segment s of offset n correlates ``x[n + 8s : n + 8s + 8]`` with its
    template row as eight products summed in place (JAX: a ``[L-7, 8] @
    [8, 16]`` matmul), so no TF32 or matmul precision setting reaches it;
    the 8-tap window energies are window sums (JAX: ``convolve``), not a
    cumsum difference."""
    tmpl_np, E_np = _det_templates()
    dev = ext.device
    R = sync.block_size + 2 * _DET_WIN
    span = _DET_SEG * _DET_NSEG                       # 128
    L = R + span                                      # samples touched
    x = ext[:L]
    # x[n + 8s + j] for n < R as a view [R, 16, 8]
    win = x.unfold(0, span, 1)[:R].reshape(R, _DET_NSEG, _DET_SEG)
    c = (win * on(tmpl_np, dev)).sum(-1)              # [R, 16]
    p = x.abs() ** 2
    e8 = p.unfold(0, _DET_SEG, 1).sum(-1)             # [L - 7]
    e = e8.unfold(0, span - _DET_SEG + 1, 1)[:R, ::_DET_SEG]   # [R, 16]
    nc = c.abs() ** 2 / torch.clamp(e * on(E_np, dev), min=1e-12)
    metric = nc.mean(-1)
    # silence gate: require real energy under the template
    floor = 1e-4 * _DET_NSEG * _DET_SEG * (p.mean() + 1e-12)
    return torch.where(e.sum(-1) > floor, metric,
                       torch.zeros_like(metric))


@functools.lru_cache(maxsize=None)
def _vit_tables():
    """Predecessor tables for the K=7 (133,171) trellis, as JAX builds
    them: ``reg = (b << 6) | s`` with ``s`` holding ``b[i-1]..b[i-6]``
    (bit 5..0), output j = parity(reg & g_j), ``next = reg >> 1``.

    Returns ``(bm0, bm1, base)``: the +-1 branch symbols ``[2, 32, 2]``
    float32 into state ``ns = h * 32 + s'`` from its predecessor ``2 s' +
    w`` (index ``[h, s', w]``), and ``base[ns] = 2 (ns mod 32)``, the first
    predecessor.  Checks that predecessor structure, which the decoder's
    views rely on."""
    S = 64
    pred = np.zeros((S, 2), np.int32)
    pred_bit = np.zeros((S, 2), np.uint8)
    out = np.zeros((S, 2, 2), np.float32)
    cnt = np.zeros(S, np.int32)
    for s in range(S):
        for b in (0, 1):
            reg = (b << 6) | s
            out[s, b, 0] = 2.0 * (bin(reg & 0o133).count("1") & 1) - 1.0
            out[s, b, 1] = 2.0 * (bin(reg & 0o171).count("1") & 1) - 1.0
            ns = reg >> 1
            pred[ns, cnt[ns]] = s
            pred_bit[ns, cnt[ns]] = b
            cnt[ns] += 1
    ns = np.arange(S)
    if not (np.array_equal(pred, (2 * (ns % 32))[:, None] + np.arange(2))
            and np.array_equal(pred_bit, np.repeat((ns >> 5)[:, None], 2,
                                                   axis=1))):
        raise AssertionError("unexpected K=7 trellis structure")
    bm = out[pred, pred_bit]                         # [S, 2, 2]
    return (bm[..., 0].reshape(2, 32, 2).copy(),
            bm[..., 1].reshape(2, 32, 2).copy(), pred[:, 0].astype(np.int64))


def _viterbi_soft(llr_pairs: torch.Tensor) -> torch.Tensor:
    """Soft Viterbi for the zero-state-started K=7 (133,171) code, batched
    over rows.

    ``llr_pairs [B, n, 2]`` float32 (positive => coded bit 1, 0 =
    erasure); free end state.  Returns the decoded bits ``[B, n]`` uint8.

    Each step decides exactly as JAX's ``lax.scan`` step: the candidate
    metrics ``(pm[pred] + rx0 * bm0) + rx1 * bm1`` in that order (``bm`` is
    +-1, so the products are exact), the choice ``m1 > m0`` (``argmax``'s
    first index on ties), then the path metrics less their maximum, after
    every step.  Eager torch runs each as its own launch, with no FMA
    contraction, so every device gives JAX's bits on the same pairs."""
    bm0_np, bm1_np, base_np = _vit_tables()
    B, n, _ = llr_pairs.shape
    dev = llr_pairs.device
    rx = llr_pairs.to(torch.float32).transpose(0, 1)          # [n, B, 2]
    # both branch terms of every step, each [n, B, 2, 32, 2]
    p0 = rx[:, :, 0, None, None, None] * on(bm0_np, dev)
    p1 = rx[:, :, 1, None, None, None] * on(bm1_np, dev)
    pm = torch.full((B, 64), -1e9, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    pm_in = pm.view(B, 1, 32, 2)          # pm[b, 2 s' + w]
    pm_out = pm.view(B, 2, 32)            # pm[b, h 32 + s']
    cand = torch.empty((B, 2, 32, 2), dtype=torch.float32, device=dev)
    c0, c1 = cand.unbind(-1)
    choices = torch.empty((n, B, 2, 32), dtype=torch.bool, device=dev)
    chosen = choices.unbind(0)
    for t in range(n):
        torch.add(pm_in, p0[t], out=cand)
        cand.add_(p1[t])
        torch.gt(c1, c0, out=chosen[t])
        torch.maximum(c0, c1, out=pm_out)
        pm.sub_(pm.amax(-1, keepdim=True))
    # traceback from the first best end state: the state before step t is
    # 2 (s mod 32) + choice, one gather a step into the next step's index
    ar = torch.arange(64, device=dev)
    s_end = torch.where(pm >= pm.amax(-1, keepdim=True), ar, 64).amin(-1)
    states = torch.empty((n, B, 1), dtype=torch.int64, device=dev)
    states[n - 1, :, 0] = s_end
    st = states.unbind(0)
    prev = (choices.view(n, B, 64).to(torch.int64) |
            on(base_np, dev)).unbind(0)
    for t in range(n - 1, 0, -1):
        torch.gather(prev[t], 1, st[t], out=st[t - 1])
    # the decoded bit of step t is the top bit of the state it enters
    return (states[..., 0].t() >> 5).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _axis_masks(nbits: int):
    """Level indices with bit t of the Gray axis label 0 / 1, per t."""
    idx = np.arange(1 << nbits)
    return [(np.nonzero(((idx >> (nbits - 1 - t)) & 1) == 0)[0],
             np.nonzero(((idx >> (nbits - 1 - t)) & 1) == 1)[0])
            for t in range(nbits)]


@functools.lru_cache(maxsize=None)
def _axis_levels(bpsc: int) -> np.ndarray:
    lut = {4: np.array([-3, -1, 3, 1]) / np.sqrt(10),
           6: np.array([-7, -5, -1, -3, 7, 5, 1, 3]) / np.sqrt(42)}[bpsc]
    return lut.astype(np.float32)


def _axis_llr(x: torch.Tensor, bpsc: int) -> torch.Tensor:
    """Max-log per-bit soft metrics for one Gray-coded PAM axis:
    ``[..., n] -> [..., n, bpsc // 2]``; positive => 1."""
    lv = _axis_levels(bpsc)
    d = (x[..., None] - on(lv, x.device)) ** 2
    outs = []
    for zero, one in _axis_masks(bpsc // 2):
        d0 = d[..., on(zero, x.device)].amin(-1)
        d1 = d[..., on(one, x.device)].amin(-1)
        outs.append(d0 - d1)
    return torch.stack(outs, dim=-1)


def _demap_soft(pts: torch.Tensor, bpsc: int) -> torch.Tensor:
    """Equalized points ``[..., n]`` -> per-bit LLRs ``[..., n, bpsc]``."""
    if bpsc == 1:
        return 2.0 * pts.real[..., None]
    if bpsc == 2:
        s = float(np.sqrt(2.0))
        return torch.stack([pts.real * s, pts.imag * s], dim=-1)
    if bpsc in (4, 6):
        return torch.cat([_axis_llr(pts.real, bpsc),
                          _axis_llr(pts.imag, bpsc)], dim=-1)
    raise ValueError(bpsc)


@functools.lru_cache(maxsize=None)
def _depuncture_pos(num: int, den: int, ndbps: int) -> np.ndarray:
    """Static within-symbol scatter: kept-LLR index -> position in the
    symbol's ``2*ndbps`` rate-1/2 coded slots."""
    pattern = {(1, 2): [1], (2, 3): [1, 1, 1, 0],
               (3, 4): [1, 1, 1, 0, 0, 1]}[(num, den)]
    keep = np.tile(pattern, 2 * ndbps // len(pattern) + 1)[: 2 * ndbps]
    return np.nonzero(keep)[0].astype(np.int64)


@functools.lru_cache(maxsize=None)
def _descr_tables():
    """(master 127-bit sequence, phase[state] offset table) for the
    self-synchronising descrambler: the output from any nonzero 7-bit state
    is a cyclic shift of the one maximal-length sequence."""
    master = _scramble_seq(0x7F)
    phase = np.zeros(128, np.int64)
    state = 0x7F
    for i in range(127):
        phase[state] = i
        s = ((state >> 6) ^ (state >> 3)) & 1
        state = ((state << 1) | s) & 0x7F
    return master, phase


def _rate_branch(sync: WlanSync, rate: int, Yd: torch.Tensor,
                 length: torch.Tensor):
    """DATA demap, deinterleave and depuncture at one static rate for every
    row: ``(Yd [B, max_sym, 48], length [B]) -> (llr_pairs [B, nb, 2],
    live_bits [B])``."""
    bpsc, (num, den), ncbps, ndbps = WLAN_RATES[rate]
    dev = Yd.device
    B = Yd.shape[0]
    llr = _demap_soft(Yd.reshape(B, -1), bpsc)       # [B, ms*48, bpsc]
    llr = llr.reshape(B, sync.max_sym, ncbps)
    llr = llr[..., on(_interleave_perm(ncbps, bpsc), dev)]   # deinterleave
    coded = torch.zeros((B, sync.max_sym, 2 * ndbps), dtype=torch.float32,
                        device=dev)
    coded[..., on(_depuncture_pos(num, den, ndbps), dev)] = llr
    flat = coded.reshape(B, -1)
    total = 2 * sync.nb
    if flat.shape[1] >= total:
        flat = flat[:, :total]
    else:
        flat = torch.nn.functional.pad(flat, (0, total - flat.shape[1]))
    n_sym = (16 + 8 * length + 6 + ndbps - 1) // ndbps
    live = torch.clamp(n_sym * ndbps, max=sync.nb).to(torch.int32)
    return flat.reshape(B, sync.nb, 2), live


@functools.lru_cache(maxsize=None)
def _decode_consts(max_sym: int):
    """Host tables of the candidate decode: the LT reference's inverse
    (1 off the active carriers), the active-carrier mask, the pilots'
    reference signs per symbol, the SIGNAL rate codes."""
    _, long_t, pilot_pn = _tables()
    L_ref = np.fft.fft(np.asarray(long_t)) / _SCALE
    act = np.abs(L_ref) > 0.1
    inv_ref = (np.conj(L_ref) / np.maximum(np.abs(L_ref) ** 2, 1e-12)
               ).astype(np.complex64)
    ppol = np.array([1.0, 1.0, 1.0, -1.0], np.float32)
    pref = (ppol[None, :] *
            pilot_pn[np.arange(1 + max_sym) % 127][:, None]).astype(
                np.float32)
    codes = np.array([_RATE_CODES[r] for r in _RATE_LIST], np.uint8)
    return act, inv_ref, pref, codes, np.array(_RATE_LIST, np.int32)


def _decode_candidates(sync: WlanSync, ext: torch.Tensor,
                       n0: torch.Tensor):
    """Refine and decode the candidates ``n0 [B]`` (LT1 starts in
    ``ext``), batched: ``(sig_ok, psdu_ok, rate, length, psdu, cfo,
    rssi)``, each with leading axis ``[B]``."""
    dev = ext.device
    W = sync.w_frame
    B = n0.shape[0]
    last = ext.shape[0] - 1
    start = torch.clamp(n0.to(torch.int64) - 192, min=0)          # [B]
    w = ext[torch.clamp(start[:, None] + torch.arange(W, device=dev), 0,
                        last)]                                   # [B, W]
    act, inv_ref, pref, codes, rate_vals = _decode_consts(sync.max_sym)
    t = torch.arange(W, dtype=torch.float32, device=dev)

    # two-stage CFO: coarse from the ST lag-16 products, fine from the LT
    # lag-64 product (the coarse residual is well inside +-pi/64)
    c16 = (w[:, 48:160] * w[:, 32:144].conj()).sum(-1)
    cfo_c = torch.angle(c16) / 16.0
    w1 = w[:, 192:320] * torch.exp(-1j * cfo_c[:, None] * t[192:320])
    c64 = (w1[:, 64:] * w1[:, :64].conj()).sum(-1)
    cfo = cfo_c + torch.angle(c64) / 64.0
    w = w * torch.exp(-1j * cfo[:, None] * t)

    # the channel from the two long-training symbols
    L1 = torch.fft.fft(w[:, 192:256], dim=-1) / _SCALE
    L2 = torch.fft.fft(w[:, 256:320], dim=-1) / _SCALE
    one = torch.ones((), dtype=torch.complex64, device=dev)
    H = torch.where(on(act, dev), (L1 + L2) / 2.0 * on(inv_ref, dev), one)
    Hsafe = torch.where(H.abs() > 1e-6, H, one)

    # every symbol (SIGNAL + max_sym DATA): batched FFT, EQ, pilot phase
    sym_i = 336 + 80 * torch.arange(1 + sync.max_sym, device=dev)[:, None] \
        + torch.arange(_N_FFT, device=dev)[None, :]
    Y = torch.fft.fft(w[:, sym_i], dim=-1) / _SCALE   # [B, 1+ms, 64]
    Yeq = Y / Hsafe[:, None, :]
    rot = (Yeq[..., on(_PIDX, dev)] * on(pref, dev)).mean(-1)
    rot = rot / torch.clamp(rot.abs(), min=1e-12)
    Yeq = Yeq * rot.conj()[..., None]

    # SIGNAL: BPSK r=1/2, its own interleaver, 24 decoded bits
    sig_llr = 2.0 * Yeq[:, 0, on(_DIDX, dev)].real
    sig_llr = sig_llr[:, on(_interleave_perm(48, 1), dev)]
    sig_bits = _viterbi_soft(sig_llr.reshape(B, 24, 2))
    eq = (sig_bits[:, None, :4] == on(codes, dev)).all(-1)      # [B, 8]
    rate_found = eq.any(-1)
    rate_idx = eq.to(torch.int32).argmax(-1)            # first match, or 0
    sig32 = sig_bits.to(torch.int32)
    length = (sig32[:, 5:17] << torch.arange(12, dtype=torch.int32,
                                             device=dev)).sum(-1)
    parity_ok = (sig32[:, :17].sum(-1) & 1) == sig32[:, 17]
    sig_ok = (rate_found & parity_ok & (length > 0) & (length <= 4095)
              & ~sig_bits[:, 18:24].bool().any(-1))
    length = torch.clamp(length, 0, 4095).to(torch.int32)

    # DATA: every rate's branch, then each row's by its rate index (JAX's
    # lax.switch under vmap runs all eight and selects too)
    Yd = Yeq[:, 1:, on(_DIDX, dev)]
    branches = [_rate_branch(sync, r, Yd, length) for r in _RATE_LIST]
    rows = torch.arange(B, device=dev)
    pairs = torch.stack([p for p, _ in branches])[rate_idx, rows]
    live = torch.stack([v for _, v in branches])[rate_idx, rows]
    pairs = torch.where(
        torch.arange(sync.nb, device=dev)[None, :, None] < live[:, None,
                                                                None],
        pairs, torch.zeros((), device=dev))
    scrambled = _viterbi_soft(pairs)                           # [B, nb]

    # the self-synchronising descrambler through the phase-offset table
    master, phase = _descr_tables()
    st7 = (scrambled[:, :7].to(torch.int64) <<
           torch.arange(6, -1, -1, device=dev)).sum(-1)
    ph = on(phase, dev)[st7]
    seq = on(master, dev)[(ph[:, None] +
                           torch.arange(sync.nb - 7, device=dev)) % 127]
    seq = torch.where(st7[:, None] == 0, torch.zeros_like(seq), seq)
    data = torch.cat([torch.zeros((B, 7), dtype=torch.uint8, device=dev),
                      scrambled[:, 7:] ^ seq], dim=-1)

    # PSDU bytes (LSB-first bit order, mirroring the TX unpack)
    mp = sync.max_psdu
    pb = data[:, 16:16 + 8 * mp].to(torch.int32)
    pb = pb * (torch.arange(8 * mp, device=dev)[None] < 8 * length[:, None])
    psdu = (pb.reshape(B, mp, 8) << torch.arange(8, dtype=torch.int32,
                                                 device=dev)).sum(-1)
    psdu = psdu.to(torch.uint8)

    # DATA validity: the tail bits, zeroed after scrambling, decode zero
    tail_i = torch.clamp(16 + 8 * length.to(torch.int64)[:, None] +
                         torch.arange(6, device=dev), 0, sync.nb - 1)
    tail_ok = ~torch.gather(scrambled, 1, tail_i).bool().any(-1)
    psdu_ok = sig_ok & tail_ok & (length <= mp)

    rate_val = on(rate_vals, dev)[rate_idx]
    pre = ext[torch.clamp(start[:, None] + torch.arange(160, device=dev), 0,
                          last)]
    rssi = 10.0 * torch.log10(torch.clamp((pre.abs() ** 2).mean(-1),
                                          min=1e-12))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (sig_ok, psdu_ok, torch.where(sig_ok, rate_val, zero),
            torch.where(sig_ok, length, zero), psdu, cfo, rssi)


def _gated_decode(sync: WlanSync, ext: torch.Tensor, gate: bool,
                  locs: torch.Tensor):
    if gate:
        return _decode_candidates(sync, ext, locs)
    R, dev = locs.shape[0], ext.device

    def zz(dt, *s):
        return torch.zeros((R, *s), dtype=dt, device=dev)
    return (zz(torch.bool), zz(torch.bool), zz(torch.int32),
            zz(torch.int32), zz(torch.uint8, sync.max_psdu),
            zz(torch.float32), zz(torch.float32))


def wlan_sync_block(sync: WlanSync, state: WlanSyncState,
                    block: torch.Tensor):
    """Process ``block_size`` samples (complex, or ``[2, bs]`` IQ planes)
    -> ``(state', WlanResults)``."""
    block = iq_from_any(block)
    ext = torch.cat([state.tail, block])
    metric = _wlan_metric(sync, ext)
    vals, locs = find_candidates(metric, _DET_WIN, sync.block_size,
                                 sync.threshold, sync.max_frames)
    detected = vals > 0
    (sig_ok, psdu_ok, rate, length, psdu, cfo,
     rssi) = _gated_decode(sync, ext, bool(detected.any()), locs)
    res = WlanResults(
        detected=detected,
        signal_valid=detected & sig_ok,
        psdu_valid=detected & psdu_ok,
        rate=rate, length=length, psdu=psdu, cfo=cfo, rssi=rssi,
        t_start=state.base + locs - 192)
    new_state = WlanSyncState(tail=ext[ext.shape[0] - sync.overlap:],
                              base=state.base + sync.block_size)
    return new_state, res


def make_wlan_sync_step(sync: WlanSync):
    """``step(state, block) -> (state', WlanResults)`` closure over one
    config (JAX jits this closure; the port runs it eagerly)."""
    def step(state: WlanSyncState, block: torch.Tensor):
        return wlan_sync_block(sync, state, block)
    return step


# ---------------------------------------------------------------------------
# convenience wrappers over the same core
# ---------------------------------------------------------------------------

def wlan_decode(samples: np.ndarray, max_psdu: int = 4095,
                device=None) -> dict:
    """Decode one 802.11a frame whose preamble starts at ``samples[0]`` (LT
    channel EQ, pilot tracking, soft Viterbi, self-synchronising
    descramble).  Returns rate, length and PSDU with validity flags."""
    samples = np.asarray(samples).astype(np.complex64)
    if len(samples) < 400:
        return {"rate": 0, "length": 0, "signal_valid": False,
                "psdu": None, "psdu_valid": False}
    # the static budget: the smallest power-of-two tier the frame could
    # need (rate 54 packs the most bytes a symbol)
    n_sym = max((len(samples) - 400) // 80, 1)
    implied = min(max_psdu, (n_sym * 216 - 22) // 8 + 1)
    tier = 64
    while tier < implied:
        tier *= 2
    sync = make_wlan_sync(max_psdu=min(tier, 4095))
    # n0 = 192 = the LT1 offset within the frame, so the candidate window
    # (which starts at n0 - 192) begins exactly at samples[0]
    need = sync.w_frame
    ext = np.zeros(need, np.complex64)
    ext[: min(len(samples), need)] = samples[:need]
    dev = default_device(device)
    out = _decode_candidates(sync, torch.as_tensor(ext, device=dev),
                             torch.full((1,), 192, dtype=torch.int32,
                                        device=dev))
    (sig_ok, psdu_ok, rate, length, psdu, _cfo,
     _rssi) = (v[0].cpu().numpy() for v in out)
    out = {"rate": int(rate) if sig_ok else None, "length": int(length),
           "signal_valid": bool(sig_ok), "psdu": None,
           "psdu_valid": False}
    if sig_ok:
        out["psdu"] = psdu[: int(length)]
        out["psdu_valid"] = bool(psdu_ok)
    return out


def wlan_sync(stream: np.ndarray, max_frames: int = 8,
              thresh: float = 0.45, max_psdu: int = 256,
              device=None) -> list:
    """Streaming 802.11a receiver over a whole host stream: detect frames
    anywhere in ``stream``, correct the CFO, decode each.

    Returns a list of :func:`wlan_decode`-shaped dicts with ``start`` (the
    sample index of the frame's first ST sample) and ``cfo``
    (radians/sample) added, in stream order."""
    x = np.asarray(stream).astype(np.complex64)
    sync = make_wlan_sync(max_psdu=max_psdu, threshold=thresh,
                          max_frames=min(max_frames, 4))
    step = make_wlan_sync_step(sync)
    state = wlan_sync_init(sync, device)
    bs = sync.block_size
    n_blocks = -(-len(x) // bs) + sync.overlap // bs + 1
    xs = np.zeros(n_blocks * bs, np.complex64)
    xs[:len(x)] = x
    xs = torch.as_tensor(xs, device=state.tail.device).reshape(n_blocks, bs)
    results = []
    for b in range(n_blocks):
        state, res = step(state, xs[b])
        res = WlanResults(*(v.cpu().numpy() for v in res))
        for i in np.nonzero(res.detected & res.signal_valid)[0]:
            if len(results) >= max_frames:
                break
            results.append({
                "start": int(res.t_start[i]),
                "cfo": float(res.cfo[i]),
                "rate": int(res.rate[i]),
                "length": int(res.length[i]),
                "signal_valid": True,
                "psdu": res.psdu[i][: int(res.length[i])]
                if res.psdu_valid[i] else None,
                "psdu_valid": bool(res.psdu_valid[i]),
            })
    return sorted(results, key=lambda d: d["start"])
