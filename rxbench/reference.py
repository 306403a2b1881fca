"""The plain reference that decides ``correct``.

Two parts, both plain NumPy in float64, independent of the receiver:

* **Which frames.**  The stream's truth (``txgen.Stream.frames``) says which
  frames were sent, on which channel, and where.  A frame sent at channel
  sample ``s`` reaches the receiver's stream at ``s + delay`` (the
  filterbank's delay, ``txgen.pfb_delay``), once a pass over the loop.  The
  receiver reports a frame in the block whose detect region
  ``[base + M, base + M + block_size)`` holds its start, ``base`` being the
  block's window start, one ``overlap`` before the block.  Every frame due
  in the dispatches that completed must be reported once, at its start,
  with both valid flags, its header and payload bytes and its frame
  properties; every other report is counted apart.
* **What the receiver estimated.**  At the start the receiver reports, the
  reference channelizes the stream itself (NCO mix-down and the 2N-bin
  analyzer, Kaiser m=7 As=60, in float64) and computes the estimators the
  configuration states at the frame's S0: the RSSI over the two S0
  symbols, the coarse carrier offset from the lag-M/4 correlation and the
  fine one from the period-M repetition (where the receiver decodes from a
  clamped window, over that window too: ``estimate_gaps``).  It reads the
  receiver's start only to judge its estimates at it, as a served model's
  tokens are judged.
"""
from __future__ import annotations

import numpy as np

from . import txgen

NUM_S0 = txgen.NUM_S0


def block_of(T: np.ndarray, overlap: int, M: int, block_size: int):
    """Block (per channel, from 0) whose detect region holds stream index
    ``T``."""
    return (T + overlap - M) // block_size


def expected_frames(stream: txgen.Stream, config: dict, n_blocks: int):
    """The frames due in the first ``n_blocks`` blocks of every channel:
    ``(channel, T, index into stream.frames)`` arrays, ``T`` the receiver's
    stream index of the frame's S0."""
    overlap = txgen.receiver_overlap(config)
    fr = stream.frames
    end = n_blocks * config["block_size"]
    passes = -(-(end + overlap) // stream.loop_len) + 1
    T = (fr["start"][None, :] + stream.delay +
         stream.loop_len * np.arange(passes)[:, None])
    idx = np.broadcast_to(np.arange(len(fr["start"])), T.shape)
    keep = (T >= 0) & (block_of(T, overlap, config["M"],
                                config["block_size"]) < n_blocks)
    idx = idx[keep]
    return fr["channel"][idx], T[keep], idx


def match(rows: dict, stream: txgen.Stream, config: dict, traffic: dict,
          n_blocks: int):
    """Compare the receiver's reports with the frames sent.

    ``rows``: column arrays over reported frames (``channel``, ``t``,
    ``header [n, 8]``, ``payload`` (list of arrays), ``payload_len``,
    ``header_valid``, ``payload_valid`` and, where the entry reports them,
    ``mod``, ``fec0``, ``fec1``, ``check``).  Returns ``(attempted,
    missed, wrong, extra, ok_rows)``: frames due, frames due that no report
    carries, reports of a frame due that say anything else than what was
    sent, reports of no frame due, and the indices of the rows that
    matched exactly."""
    ch, T, idx = expected_frames(stream, config, n_blocks)
    due = {(int(c), int(t)): int(i) for c, t, i in zip(ch, T, idx)}
    fr = stream.frames
    n_bytes = int(traffic["payload_len"])
    props = {"mod": txgen.MOD_IDS[traffic["mod"]],
             "fec0": txgen.FEC_IDS[traffic["fec0"]],
             "fec1": txgen.FEC_IDS[traffic["fec1"]],
             "check": txgen.CRC_IDS[traffic["check"]]}
    seen, wrong, extra, ok_rows = set(), 0, 0, []
    for r in range(len(rows["t"])):
        key = (int(rows["channel"][r]), int(rows["t"][r]))
        i = due.get(key)
        if i is None or key in seen:
            extra += 1
            continue
        seen.add(key)
        good = (bool(rows["header_valid"][r]) and
                bool(rows["payload_valid"][r]) and
                int(rows["payload_len"][r]) == n_bytes and
                np.array_equal(rows["header"][r], fr["header"][i]) and
                np.array_equal(rows["payload"][r][:n_bytes],
                               fr["payload"][i]) and
                all(int(rows[k][r]) == v for k, v in props.items()
                    if k in rows))
        if good:
            ok_rows.append(r)
        else:
            wrong += 1
    return len(due), len(due) - len(seen), wrong, extra, ok_rows


# ---------------------------------------------------------------------------
# the receiver's estimators, recomputed from the stream in float64
# ---------------------------------------------------------------------------

def _loop_samples(loop: np.ndarray, first: np.ndarray, n: int):
    """``loop`` repeated from index 0, zeros before it: rows of ``n``
    samples from each of ``first``."""
    i = first[:, None] + np.arange(n)
    out = loop[np.mod(i, len(loop))].astype(np.complex128)
    out[i < 0] = 0.0
    return out, i


def channel_samples(loop: np.ndarray, config: dict, channel: np.ndarray,
                    T: np.ndarray, n: int) -> np.ndarray:
    """Samples ``T .. T + n`` of each receiver stream: the stream itself
    for one channel; for N channels, the mixture mixed down by the
    centring NCO and analyzed by the 2N-bin filterbank, in float64."""
    N = int(config.get("num_channels", 1))
    if N == 1:
        return _loop_samples(loop, T, n)[0]
    B = 2 * N
    m = config["analyzer_m"]
    P = 2 * m
    h = txgen.pfb_prototype(B, m, config["analyzer_As"]).reshape(P, B)
    x, i = _loop_samples(loop, (T - (P - 1)) * B, (n + P - 1) * B)
    # NCO: +(N-1)/(4N) turn a sample, exact in whole turns
    x = x * np.exp(2j * np.pi * np.mod((N - 1) * i, 4 * N) / (4 * N))
    rev = x.reshape(len(T), n + P - 1, B)[..., ::-1]
    u = np.zeros((len(T), n, B), np.complex128)
    for q in range(P):
        u += h[q] * rev[:, P - 1 - q:P - 1 - q + n]
    k = np.asarray(channel)[:, None, None]
    return (u * np.exp(2j * np.pi * k * np.arange(B) / B)).sum(-1)


def estimates(w_at: np.ndarray, w_win: np.ndarray, M: int):
    """``(rssi dB, cfo rad/sample)`` of a frame whose S0 starts ``w_at
    [F, 2M]``, decoded in the window that starts ``w_win [F, 2M]``: the
    mean power of the window's first two symbols; the coarse offset from
    the lag-M/4 correlation over ``2M - M/4`` products at the S0, then the
    fine one from the window's period-M repetition, derotated by the coarse
    estimate."""
    d = M // 4
    L = NUM_S0 * M - d
    rssi = 10 * np.log10(np.maximum(
        np.mean(np.abs(w_win[:, :NUM_S0 * M]) ** 2, -1), 1e-12))
    c_at = (w_at[:, :L] * np.conj(w_at[:, d:d + L])).sum(-1)
    cfo = -np.angle(c_at) / d
    c_fine = (w_win[:, :M] * np.conj(w_win[:, M:2 * M])).sum(-1) * \
        np.exp(1j * cfo * M)
    return rssi, cfo - np.angle(c_fine) / M


def window_start(T: np.ndarray, config: dict) -> np.ndarray:
    """Where the receiver's decode window of a frame at ``T`` starts: one
    ``overlap`` long at the frame, its start clamped into the block's
    extended window (``overlap + block_size`` samples), as every dynamic
    slice of the receiver clamps (and the JAX package's); a frame in the
    last ``M - 1`` samples of a detect region is decoded from a window
    that starts early."""
    bs = config["block_size"]
    overlap = txgen.receiver_overlap(config)
    first = block_of(T, overlap, config["M"], bs) * bs - overlap
    return first + np.minimum(T - first, bs)


def estimate_gaps(rows: dict, sample: np.ndarray, loop: np.ndarray,
                  config: dict):
    """``(rssi gap, cfo gap, clamped)``: the largest gaps between the
    receiver's RSSI and carrier offset and the estimators' at each frame's
    S0, over the rows ``sample``, and how many of those frames the
    receiver decodes from a window that starts early (``window_start``).
    For those, the estimators over that window are accepted too, so that
    the check holds whether or not the receiver clamps."""
    if len(sample) == 0:
        return float("nan"), float("nan"), 0
    M = config["M"]
    ch, T = rows["channel"][sample], rows["t"][sample]
    rssi_rx, cfo_rx = rows["rssi"][sample], rows["cfo"][sample]
    w_at = channel_samples(loop, config, ch, T, NUM_S0 * M)
    rssi, cfo = estimates(w_at, w_at, M)
    d_rssi, d_cfo = np.abs(rssi_rx - rssi), np.abs(cfo_rx - cfo)
    start = window_start(T, config)
    early = np.nonzero(start != T)[0]
    if len(early):
        w_win = channel_samples(loop, config, ch[early], start[early],
                                NUM_S0 * M)
        rssi_w, cfo_w = estimates(w_at[early], w_win, M)
        d_rssi[early] = np.minimum(d_rssi[early],
                                   np.abs(rssi_rx[early] - rssi_w))
        d_cfo[early] = np.minimum(d_cfo[early], np.abs(cfo_rx[early] - cfo_w))
    return float(d_rssi.max()), float(d_cfo.max()), len(early)
