"""The benchmark's own transmitter: a frozen, plain copy of the OFDM frame
format and of the multichannel synthesizer.

It builds the IQ streams that the receiver under test decodes, from the
seed alone: the OFDM frame parameters (subcarrier allocation, S0/S1
preambles, pilots, taper), the header codec (CRC-16/ARC, Golay(24,12), PN
scramble, BPSK), the payload codec (CRC-32, Hamming(12,8), Golay(24,12),
the K=7 rate-1/2 convolutional code v27, PN scramble, QPSK), the OFDM
modulator, the 2N-bin polyphase synthesizer (Kaiser m=13, As=60) and the
spectrum-centering NCO, and the channel (carrier offset, AWGN).

Bit-level work is NumPy on the host; the sample-level work is plain
PyTorch on the device the caller names, batched over frames.  Nothing here
imports the receiver's package: the reference that judges the receiver
takes nothing the receiver made.
"""
from __future__ import annotations

import functools
import zlib
from typing import NamedTuple

import numpy as np
import torch

NUM_S0 = 2
HEADER_USER_BYTES = 8

CRC_NONE, CRC_16, CRC_32 = 0, 1, 2
FEC_NONE, FEC_HAMMING128, FEC_GOLAY2412, FEC_CONV_V27 = 0, 5, 6, 10
MOD_BPSK, MOD_QPSK = 0, 1
FEC_IDS = {"none": FEC_NONE, "h128": FEC_HAMMING128,
           "g2412": FEC_GOLAY2412, "v27": FEC_CONV_V27}
CRC_IDS = {"none": CRC_NONE, "crc16": CRC_16, "crc32": CRC_32}
MOD_IDS = {"bpsk": MOD_BPSK, "qpsk": MOD_QPSK}
_BPS = {MOD_BPSK: 1, MOD_QPSK: 2}


class Params(NamedTuple):
    M: int
    cp_len: int
    taper_len: int
    data_idx: np.ndarray
    pilot_idx: np.ndarray
    s0_time: np.ndarray
    s1_time: np.ndarray
    pilot_base: np.ndarray
    pilot_pn: np.ndarray
    taper_win: np.ndarray


class Props(NamedTuple):
    check: int
    fec0: int
    fec1: int
    mod: int


@functools.lru_cache(maxsize=None)
def ofdm_params(M: int, cp_len: int, taper_len: int) -> Params:
    """The default allocation: DC null, about 10 % edge guards, a pilot on
    every 7th active carrier in frequency order; S0 on every 4th active
    carrier (QPSK from the PN), S1 BPSK on every active carrier."""
    guard = max(1, int(round(M * 0.1)))
    null = {0} | {(M // 2 + g) % M for g in range(-guard + 1, guard)}
    active = [k for k in range(M) if k not in null]
    by_freq = sorted(active, key=lambda k: k - M if k > M // 2 else k)
    pilots = set(by_freq[::7])
    data_idx = np.array(sorted(k for k in active if k not in pilots))
    pilot_idx = np.array(sorted(pilots))
    rng = np.random.default_rng(0x5EED0FD + M)
    s0 = np.zeros(M, np.complex128)
    s0_set = [k for k in range(0, M, 4) if k not in null]
    ph = rng.integers(0, 4, size=len(s0_set))
    s0[s0_set] = np.exp(1j * (np.pi / 2 * ph + np.pi / 4))
    s0 *= np.sqrt(M / max(len(s0_set), 1))
    s0_time = np.fft.ifft(s0) * np.sqrt(M)
    s1 = np.zeros(M, np.complex128)
    act = sorted(set(range(M)) - null)
    s1[act] = rng.integers(0, 2, size=len(act)) * 2.0 - 1.0
    s1 *= np.sqrt(M / len(act))
    s1_time = np.fft.ifft(s1) * np.sqrt(M)
    pilot_base = rng.integers(0, 2, size=len(pilot_idx)) * 2.0 - 1.0
    pilot_pn = rng.integers(0, 2, size=127) * 2.0 - 1.0
    t = np.arange(taper_len) + 1.0
    taper_win = 0.5 * (1.0 - np.cos(np.pi * t / (taper_len + 1)))
    return Params(M, cp_len, taper_len, data_idx, pilot_idx,
                  s0_time.astype(np.complex64), s1_time.astype(np.complex64),
                  pilot_base.astype(np.float32), pilot_pn.astype(np.float32),
                  taper_win.astype(np.float32))


# ---------------------------------------------------------------------------
# codes (bit arrays are uint8 0/1, MSB first within a byte)
# ---------------------------------------------------------------------------

def _crc16_arc(data: bytes) -> int:
    """CRC-16/ARC: reflected 0x8005, init 0, no final XOR."""
    reg = 0
    for b in data:
        reg ^= b
        for _ in range(8):
            reg = (reg >> 1) ^ 0xA001 if reg & 1 else reg >> 1
    return reg


def crc_append(check: int, data: np.ndarray) -> np.ndarray:
    """Append the big-endian CRC to each row of ``data [F, n]``."""
    if check == CRC_NONE:
        return data
    if check == CRC_32:
        vals = [zlib.crc32(row.tobytes()) for row in data]
        width = 4
    else:
        vals = [_crc16_arc(row.tobytes()) for row in data]
        width = 2
    tail = np.array([[(v >> (8 * (width - 1 - i))) & 0xFF
                      for i in range(width)] for v in vals], np.uint8)
    return np.concatenate([data, tail.reshape(len(data), width)], axis=1)


def _systematic(cols: list[int], r: int) -> np.ndarray:
    """Generator ``[I_k | A^T]`` of the SEC code whose parity-check matrix
    is ``[A | I_r]`` with the columns ``cols`` of ``A``."""
    A = np.array([[(c >> (r - 1 - i)) & 1 for c in cols] for i in range(r)],
                 np.uint8)
    return np.concatenate([np.eye(len(cols), dtype=np.uint8), A.T], axis=1)


@functools.lru_cache(maxsize=None)
def _generator(fec: int) -> np.ndarray:
    if fec == FEC_HAMMING128:
        return _systematic([0b0011, 0b0101, 0b0110, 0b0111, 0b1001,
                            0b1010, 0b1011, 0b1100], 4)
    if fec == FEC_GOLAY2412:
        qr = {1, 3, 4, 5, 9}
        B = np.zeros((12, 12), np.uint8)
        for i in range(11):
            for j in range(11):
                B[i, j] = ((j - i) % 11) in qr
            B[i, 11] = B[11, i] = 1
        return np.concatenate([np.eye(12, dtype=np.uint8), B], axis=1)
    raise ValueError(f"no block code {fec}")


_V27 = (7, (0o171, 0o133))


def encoded_length(fec: int, n_bytes: int) -> int:
    if fec == FEC_NONE:
        return n_bytes
    if fec == FEC_CONV_V27:
        K, polys = _V27
        return -(-(len(polys) * (n_bytes * 8 + K - 1)) // 8)
    k, n = _generator(fec).shape
    return -(-(-(-n_bytes * 8 // k) * n) // 8)


def _bits(data: np.ndarray) -> np.ndarray:
    return np.unpackbits(data, axis=-1)


def _bytes(bits: np.ndarray, n_bytes: int) -> np.ndarray:
    pad = n_bytes * 8 - bits.shape[-1]
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    return np.packbits(bits, axis=-1)


def fec_encode(fec: int, data: np.ndarray) -> np.ndarray:
    """Encode each row of ``data [F, n]``."""
    F, n = data.shape
    if fec == FEC_NONE:
        return data
    bits = _bits(data).astype(np.int64)
    if fec == FEC_CONV_V27:
        K, polys = _V27
        x = np.pad(bits, ((0, 0), (K - 1, K - 1)))
        nbits = n * 8 + K - 1
        out = np.empty((F, nbits, len(polys)), np.int64)
        for r, g in enumerate(polys):
            acc = np.zeros((F, nbits), np.int64)
            for j in range(K):
                if (g >> j) & 1:
                    acc ^= x[:, j:j + nbits]
            out[:, :, r] = acc
        return _bytes(out.reshape(F, -1).astype(np.uint8),
                      encoded_length(fec, n))
    G = _generator(fec)
    k = G.shape[0]
    nblocks = -(-n * 8 // k)
    bits = np.pad(bits, ((0, 0), (0, nblocks * k - n * 8)))
    coded = (bits.reshape(F, nblocks, k) @ G) % 2
    return _bytes(coded.reshape(F, -1).astype(np.uint8),
                  encoded_length(fec, n))


@functools.lru_cache(maxsize=None)
def _pn(n: int, salt: int) -> np.ndarray:
    return np.random.default_rng(0x5C4A3B1E + salt).integers(
        0, 256, size=n, dtype=np.uint8)


def scramble(data: np.ndarray, salt: int) -> np.ndarray:
    return data ^ _pn(data.shape[-1], salt)


def header_bytes(header: np.ndarray, payload_len: int, props: Props
                 ) -> np.ndarray:
    """Encoded header bytes ``[F, 33]``: user bytes, ``[len u16 | mod |
    fec0 | fec1 | check]``, CRC-16, Golay(24,12), PN scramble (salt 1)."""
    F = len(header)
    internal = np.array([(payload_len >> 8) & 0xFF, payload_len & 0xFF,
                         props.mod, props.fec0, props.fec1, props.check],
                        np.uint8)
    dec = np.concatenate([header, np.tile(internal, (F, 1))], axis=1)
    dec = crc_append(CRC_16, dec)
    return scramble(fec_encode(FEC_GOLAY2412, dec), salt=1)


def payload_bytes(payload: np.ndarray, props: Props) -> np.ndarray:
    """payload -> CRC -> fec0 -> fec1 -> PN scramble (salt 2)."""
    enc = crc_append(props.check, payload)
    enc = fec_encode(props.fec0, enc)
    enc = fec_encode(props.fec1, enc)
    return scramble(enc, salt=2)


@functools.lru_cache(maxsize=None)
def constellation(mod: int) -> np.ndarray:
    """Gray-mapped unit-energy points: BPSK {+1, -1}; QPSK on the
    diagonals."""
    if mod == MOD_BPSK:
        return np.array([1.0, -1.0], np.complex64)
    perm = np.zeros(4, np.int64)
    for i in range(4):
        perm[i ^ (i >> 1)] = i
    return np.exp(1j * (2 * np.pi * perm / 4 + np.pi / 4)).astype(
        np.complex64)


def _symbols(bits: np.ndarray, bps: int) -> np.ndarray:
    n = -(-bits.shape[-1] // bps)
    bits = np.pad(bits, ((0, 0), (0, n * bps - bits.shape[-1])))
    w = 1 << np.arange(bps - 1, -1, -1)
    return (bits.reshape(len(bits), n, bps).astype(np.int64) * w).sum(-1)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def header_symbol_count(p: Params) -> int:
    return -(-encoded_length(FEC_GOLAY2412, HEADER_USER_BYTES + 8) * 8
             // len(p.data_idx))


def payload_symbol_count(p: Params, props: Props, n: int) -> int:
    enc = n + {CRC_NONE: 0, CRC_16: 2, CRC_32: 4}[props.check]
    enc = encoded_length(props.fec1, encoded_length(props.fec0, enc))
    n_mod = -(-enc * 8 // _BPS[props.mod])
    return -(-n_mod // len(p.data_idx))


def frame_length(p: Params, props: Props, n: int) -> int:
    return (NUM_S0 + 1) * p.M + (header_symbol_count(p) +
                                 payload_symbol_count(p, props, n)) * \
        (p.M + p.cp_len)


def _grid(p: Params, pts: torch.Tensor, n_sym: int, first: int
          ) -> torch.Tensor:
    """Points ``[F, n]`` on the data carriers of ``n_sym`` symbols, with
    the PN-rotated pilots -> ``[F, n_sym, M]``."""
    F, dev = pts.shape[0], pts.device
    n_data = len(p.data_idx)
    pts = torch.nn.functional.pad(pts, (0, n_sym * n_data - pts.shape[-1]))
    grid = torch.zeros((F, n_sym, p.M), dtype=torch.complex64, device=dev)
    grid[:, :, torch.as_tensor(p.data_idx, device=dev)] = \
        pts.reshape(F, n_sym, n_data)
    pn = torch.as_tensor(p.pilot_pn, device=dev)[
        (first + torch.arange(n_sym, device=dev)) % len(p.pilot_pn)]
    pil = pn[:, None] * torch.as_tensor(p.pilot_base, device=dev)
    grid[:, :, torch.as_tensor(p.pilot_idx, device=dev)] = \
        pil.to(torch.complex64)
    return grid


def assemble_frames(p: Params, props: Props, header: np.ndarray,
                    payload: np.ndarray, device) -> torch.Tensor:
    """Frames ``[F, frame_length]`` complex64 on ``device`` for headers
    ``[F, 8]`` and payloads ``[F, n]`` (uint8)."""
    F, n = payload.shape
    n_hsym = header_symbol_count(p)
    n_psym = payload_symbol_count(p, props, n)
    hsym = _symbols(_bits(header_bytes(header, n, props)), 1)
    psym = _symbols(_bits(payload_bytes(payload, props)), _BPS[props.mod])
    htab = torch.as_tensor(constellation(MOD_BPSK), device=device)
    ptab = torch.as_tensor(constellation(props.mod), device=device)
    grid = torch.cat([
        _grid(p, htab[torch.as_tensor(hsym, device=device)], n_hsym, 0),
        _grid(p, ptab[torch.as_tensor(psym, device=device)], n_psym,
              n_hsym)], dim=1)
    M, cp, tp = p.M, p.cp_len, p.taper_len
    t = torch.fft.ifft(grid, dim=-1) * torch.sqrt(
        torch.tensor(M, dtype=torch.float32))
    t = torch.cat([t[..., M - cp:], t], dim=-1)
    win = torch.cat([torch.as_tensor(p.taper_win, device=device),
                     torch.ones(M + cp - tp, dtype=torch.float32,
                                device=device)])
    body = (t * win.to(t.dtype)).reshape(F, -1)
    s0 = torch.as_tensor(p.s0_time, device=device)
    pre = torch.cat([s0.repeat(NUM_S0),
                     torch.as_tensor(p.s1_time, device=device)])
    return torch.cat([pre.expand(F, -1), body], dim=1)


# ---------------------------------------------------------------------------
# the multichannel synthesizer (2N-bin polyphase filterbank + NCO)
# ---------------------------------------------------------------------------

def kaiser_lowpass(n: int, fc: float, As: float) -> np.ndarray:
    """Kaiser-windowed sinc: ``n`` taps, cutoff ``fc`` cycles/sample."""
    As = abs(As)
    beta = (0.1102 * (As - 8.7) if As > 50.0 else
            0.5842 * (As - 21.0) ** 0.4 + 0.07886 * (As - 21.0)
            if As > 21.0 else 0.0)
    t = np.arange(n) - (n - 1) / 2.0
    return 2 * fc * np.sinc(2 * fc * t) * np.kaiser(n, beta)


def pfb_prototype(bins: int, m: int, As: float = 60.0) -> np.ndarray:
    """``2 * bins * m`` taps, cutoff at half a bin, unity passband gain
    per bin."""
    h = kaiser_lowpass(2 * bins * m, 0.5 / bins, As)
    return h / np.sum(h) * bins


def synthesize(streams: torch.Tensor, m: int = 13) -> torch.Tensor:
    """Channel streams ``[n, N]`` into bins ``0..N-1`` of a 2N-bin
    critically sampled synthesizer, centred by the NCO: mixture
    ``[2N * n]`` complex64."""
    n, N = streams.shape
    B = 2 * N
    dev = streams.device
    P = 2 * m
    h = torch.as_tensor(pfb_prototype(B, m).reshape(P, B).astype(np.float32),
                        device=dev).to(torch.complex64)
    Y = torch.zeros((n, B), dtype=torch.complex64, device=dev)
    Y[:, :N] = streams
    v = B * torch.fft.ifft(Y, dim=-1)
    ext = torch.cat([torch.zeros((P - 1, B), dtype=torch.complex64,
                                 device=dev), v])
    out = torch.zeros_like(v)
    for q in range(P):
        out = out + h[q][None, :] * ext[P - 1 - q:P - 1 - q + n]
    y = out.reshape(-1)
    return y * nco_rotation(-0.5 * (N - 1) / N * np.pi, y.shape[-1], dev)


def nco_rotation(freq_rad: float, n: int, device) -> torch.Tensor:
    """``exp(j * phase[i])`` for ``i < n``, the phase a 32-bit turn
    accumulator from 0, converted to float32 radians."""
    f = int(round(float(freq_rad) / (2 * np.pi) * 2.0 ** 32)) % (1 << 32)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    ph = ((f * idx) & 0xFFFFFFFF).to(torch.float32) * \
        float(np.float32(2 * np.pi / 2.0 ** 32))
    return torch.polar(torch.ones_like(ph), ph)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

class Stream(NamedTuple):
    """One loop of the traffic: host chunks and what they carry."""
    chunks: list            # host complex64 arrays, each one dispatch
    frames: dict            # per-frame truth: channel, start, header,
                            # payload (NumPy arrays over frames)
    delay: int              # receiver stream index of a frame = start +
                            # delay (+ the loop length each pass)
    loop_len: int           # receiver stream samples (per channel) a loop
    cfo: np.ndarray         # per channel, rad/sample


def _cis(phase: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(phase), phase)


def _frame_plan(traffic: dict, chunk_len: int, n_chunks: int,
                silence: int, flen: int) -> list:
    """Start sample of every frame in one loop of one channel stream."""
    gap = int(traffic["gap"])
    period = int(traffic.get("burst_every", 1))
    if period == 1:
        usable = n_chunks * chunk_len - silence
        return [i * (flen + gap) for i in range(usable // (flen + gap))]
    starts = []
    per = (chunk_len - gap) // (flen + gap)
    for c in range(0, n_chunks, period):
        starts += [c * chunk_len + gap + i * (flen + gap)
                   for i in range(per)]
    return starts


def _props(traffic: dict) -> Props:
    return Props(CRC_IDS[traffic["check"]], FEC_IDS[traffic["fec0"]],
                 FEC_IDS[traffic["fec1"]], MOD_IDS[traffic["mod"]])


def frame_start_plan(config: dict, traffic: dict) -> list:
    """The frame starts of one channel's loop (the same for every seed)."""
    p = ofdm_params(config["M"], config["cp_len"], config["taper_len"])
    N = int(config.get("num_channels", 1))
    chunk_ch = config["chunk_samples"] // (2 * N if N > 1 else 1)
    return _frame_plan(traffic, chunk_ch, int(traffic["loop_chunks"]),
                       receiver_overlap(config) + 4 * p.M,
                       frame_length(p, _props(traffic),
                                    int(traffic["payload_len"])))


def make_stream(config: dict, traffic: dict, seed: int, device) -> Stream:
    """The looped stream of one cell from the seed: payloads, headers and
    carrier offsets from NumPy's generator, noise from a
    ``torch.Generator`` on ``device``."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    p = ofdm_params(config["M"], config["cp_len"], config["taper_len"])
    props = _props(traffic)
    n_bytes = int(traffic["payload_len"])
    flen = frame_length(p, props, n_bytes)
    N = int(config.get("num_channels", 1))
    chunk_ch = config["chunk_samples"] // (2 * N if N > 1 else 1)
    n_chunks = int(traffic["loop_chunks"])
    loop_ch = chunk_ch * n_chunks
    starts = frame_start_plan(config, traffic)
    F = len(starts)
    cfo_max = float(traffic["cfo_max"])
    cfo = rng.uniform(-cfo_max, cfo_max, size=N)
    header = rng.integers(0, 256, (N, F, HEADER_USER_BYTES), dtype=np.uint8)
    if traffic.get("header_id", False):
        header[:, :, 0] = np.arange(F) >> 8 & 0xFF
        header[:, :, 1] = np.arange(F) & 0xFF
    payload = rng.integers(0, 256, (N, F, n_bytes), dtype=np.uint8)
    frames = assemble_frames(p, props, header.reshape(N * F, -1),
                             payload.reshape(N * F, -1), device)
    if traffic.get("gain_db"):
        frames = frames * 10.0 ** (float(traffic["gain_db"]) / 20.0)
    power = float((torch.abs(frames) ** 2).mean())
    noise_std = float(np.sqrt(power / 10.0 ** (traffic["snr_db"] / 10.0)
                              / 2.0))
    base = torch.zeros((N, loop_ch), dtype=torch.complex64, device=device)
    idx = (torch.as_tensor(starts, device=device)[:, None] +
           torch.arange(flen, device=device)).reshape(-1)
    base[:, idx] = frames.reshape(N, -1)
    n = torch.arange(loop_ch, dtype=torch.float64, device=device)
    rot = _cis((torch.as_tensor(cfo, device=device)[:, None] * n)
               .remainder(2 * np.pi).to(torch.float32))
    noise = torch.randn((2, N, loop_ch), generator=gen, device=device)
    base = base * rot + noise_std * torch.complex(noise[0], noise[1])
    if N > 1:
        mix = synthesize(base.T.contiguous(), m=config["synth_m"])
        delay = pfb_delay(2 * N, config["synth_m"], config["analyzer_m"])
    else:
        mix, delay = base[0], 0
    host = mix.cpu().numpy()
    L = config["chunk_samples"]
    chunks = [host[i * L:(i + 1) * L] for i in range(n_chunks)]
    truth = dict(
        channel=np.repeat(np.arange(N), F),
        start=np.tile(np.asarray(starts, np.int64), N),
        header=header.reshape(N * F, -1),
        payload=payload.reshape(N * F, -1))
    return Stream(chunks, truth, delay, loop_ch, cfo)


def receiver_overlap(config: dict) -> int:
    """The samples a receiver with this decode budget carries between
    blocks: one longest frame (``expansion * (max_payload + 4)`` coded
    bytes, a leading DPSK point) and four symbols."""
    p = ofdm_params(config["M"], config["cp_len"], config["taper_len"])
    enc_max = config["expansion"] * (config["max_payload"] + 4)
    max_psym = -(-(enc_max * 8 + 1) // len(p.data_idx))
    return (NUM_S0 + 1) * p.M + (header_symbol_count(p) + max_psym) * \
        (p.M + p.cp_len) + 4 * p.M


def pfb_delay(bins: int, m_synth: int, m_analyzer: int) -> int:
    """Channel samples from a channel sample into the synthesizer to the
    analyzer output that carries it: both prototypes are linear phase,
    and the analyzer's output ``n`` ends its input frame at ``n * bins +
    bins - 1``."""
    centre = ((2 * bins * m_synth - 1) + (2 * bins * m_analyzer - 1)) / 2
    d = (centre - (bins - 1)) / bins
    if d != int(d):
        raise ValueError("the filterbank delay is not a whole sample")
    return int(d)


