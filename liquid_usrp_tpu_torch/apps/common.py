"""Shared app plumbing: getopt-compatible flags, channel impairments,
resampling, the synchronizer drive loop, RX statistics and the framesync
debug dump.

Port of the parts of ``liquid_usrp_tpu/apps/common.py`` the OFDM and
flexframe apps use (``parse_args``, ``budget_note``, ``occupied_power``,
``print_usage_schemes``, ``apply_channel``, ``apply_msresamp``,
``iter_sync_results``, ``RxStats``, ``dump_framesync_octave``), plus
:func:`reject_unported` for flags whose machinery is not ported yet.
"""
from __future__ import annotations

import getopt as _getopt
import sys

import numpy as np
import torch

from ..ops import fec as fec_mod
from ..ops import modem as modem_mod

__all__ = ["parse_args", "reject_unported", "budget_note", "occupied_power",
           "print_usage_schemes", "apply_channel", "apply_msresamp",
           "resample_stream", "iter_sync_results", "RxStats",
           "dump_framesync_octave"]


def iter_sync_results(step, init_state, stream, block_size: int,
                      overlap: int, batched_fn=None, batch_blocks: int = 8):
    """Drive a synchronizer over a whole host stream; yield per-block
    results (NamedTuples of NumPy arrays, leading axis ``[max_frames]``)
    in stream order.

    The stream is padded with the flush tail (the carried overlap fully
    drains) and uploaded to the device of ``init_state.tail`` once.  With
    ``batched_fn(state, blocks)``, runs of ``batch_blocks`` full blocks go
    as one batched call with one device-to-host copy of its results; the
    leftover blocks go through the single-block ``step``."""
    from ..models.ofdmtxrx import _to_host
    bs = block_size
    flush = int(np.ceil(overlap / bs)) + 1
    n_blocks = -(-len(stream) // bs) + flush
    x = np.zeros(n_blocks * bs, np.complex64)
    x[:len(stream)] = stream
    x = torch.as_tensor(x, device=init_state.tail.device).reshape(
        n_blocks, bs)
    state = init_state
    batched = batched_fn is not None and batch_blocks > 1
    b = 0
    while b < n_blocks:
        if batched and n_blocks - b >= batch_blocks:
            state, res = batched_fn(state, x[b:b + batch_blocks])
            res_np = _to_host(res)
            for j in range(batch_blocks):
                yield type(res_np)(*(f[j] for f in res_np))
            b += batch_blocks
        else:
            state, res = step(state, x[b])
            yield _to_host(res)
            b += 1


def resample_stream(stream: np.ndarray, rate: float, device,
                    trim: bool = True) -> np.ndarray:
    """One ``msresamp_block`` over a whole host stream on ``device`` (the
    frame apps' TX and RX resampling): the valid outputs as NumPy.
    ``trim`` first cuts the stream to a multiple of the decimation
    granularity (``2**num_halfband``)."""
    from ..ops import resamp as resamp_mod
    ms = resamp_mod.msresamp_create(rate)
    st = resamp_mod.msresamp_state(ms, device)
    div = 2 ** ms.num_halfband if not ms.is_interp else 1
    n = len(stream) - len(stream) % div if trim else len(stream)
    _, y, _, count = resamp_mod.msresamp_block(
        ms, st, torch.as_tensor(np.asarray(stream[:n], np.complex64),
                                device=device))
    return y[:int(count)].cpu().numpy()


def apply_msresamp(stream: np.ndarray, rate: float,
                   device=None) -> np.ndarray:
    """Resample a whole host stream through the streaming msresamp chain
    on ``device`` (the default device when ``None``), in chunks that keep
    the decimation granularity (``2**num_halfband``); rate 1.0 is the
    identity."""
    if rate == 1.0 or not len(stream):
        return stream
    from ..ops import resamp as resamp_mod
    from ..utils.device import default_device
    dev = default_device(device)
    ms = resamp_mod.msresamp_create(rate)
    st = resamp_mod.msresamp_state(ms, dev)
    gran = 2 ** ms.num_halfband if not ms.is_interp else 1
    chunk = -(-16384 // gran) * gran
    pad = (-len(stream)) % chunk
    x = torch.as_tensor(np.concatenate([stream, np.zeros(pad, np.complex64)]),
                        device=dev)
    outs = []
    for i in range(0, x.shape[0], chunk):
        st, y, _, count = resamp_mod.msresamp_block(ms, st, x[i:i + chunk])
        outs.append(y[:int(count)])
    out = torch.cat(outs).cpu().numpy()
    # trim the resampled image of the padding tail
    return out[:int(round(len(stream) * rate))]


def parse_args(argv, optstring: str, long_opts=None):
    """getopt wrapper returning (dict, positional).  Last flag wins.
    Unknown or malformed flags exit with a one-line error."""
    try:
        opts, rest = _getopt.getopt(argv, optstring,
                                    long_opts or ["snr=", "cfo=", "delay=",
                                                  "seed="])
    except _getopt.GetoptError as e:
        print(f"error: {e} (use -h for usage)", file=sys.stderr)
        raise SystemExit(1)
    d = {}
    for k, v in opts:
        d[k.lstrip("-")] = v
    return d, rest


def reject_unported(flags: dict, names: dict) -> None:
    """Exit with an error naming each given flag that is not ported yet
    (``names``: flag -> what it would do), rather than ignore it."""
    bad = [f for f in names if f in flags]
    if bad:
        for f in bad:
            dash = "--" if len(f) > 1 else "-"
            print(f"error: {dash}{f} ({names[f]}) is not supported by the "
                  f"PyTorch port yet", file=sys.stderr)
        raise SystemExit(1)


def budget_note(props, payload_len: int) -> int:
    """The encode budget (expansion) for the selected FEC pair, printing
    the receiver flags it needs (``--conv`` for a scheme outside the base
    decode set, ``-e N`` past the default budget)."""
    from ..framing import payload as payload_codec
    exp = payload_codec.required_expansion(props, payload_len)
    need_conv = any(s not in payload_codec.PAYLOAD_FECS
                    for s in (props.fec0, props.fec1))
    flags = ([] if not need_conv else ["--conv"]) + \
        ([] if exp <= payload_codec.EXPANSION else [f"-e {exp}"])
    if flags:
        print(f"note: this FEC pair needs `{' '.join(flags)}` "
              f"on the receiver")
    return exp


def occupied_power(stream: np.ndarray) -> float:
    """Mean |x|^2 over the occupied samples (the frames, not the zero gaps
    between them); 1.0 for empty or silent input."""
    stream = np.asarray(stream)
    if not stream.size:
        return 1.0
    mag2 = np.abs(stream) ** 2
    occ = mag2[mag2 > 1e-6 * float(mag2.max())]
    if not occ.size:
        return 1.0
    return float(np.mean(occ)) or 1.0


def print_usage_schemes(file=None):
    """List the supported modulation and FEC names."""
    file = file if file is not None else sys.stdout
    print("  modulation schemes:", " ".join(modem_mod.mod_names()),
          file=file)
    print("  FEC schemes:", " ".join(fec_mod.fec_names()), file=file)


def apply_channel(stream: np.ndarray, flags: dict, seed: int = 0,
                  signal_power: float = 1.0) -> np.ndarray:
    """Apply the ``--snr/--cfo/--delay`` virtual-air impairments when any is
    given (the noise from a CPU ``torch.Generator`` seeded from ``--seed``,
    else ``seed``); the stream is returned unchanged otherwise."""
    snr = float(flags.get("snr", 1000.0))
    cfo = float(flags.get("cfo", 0.0))
    delay = int(flags.get("delay", 0))
    if snr >= 1000.0 and cfo == 0.0 and delay == 0:
        return stream
    from ..io.channel_model import Channel, channel_apply
    ch = Channel(snr_db=min(snr, 99.0), cfo=cfo, delay=delay)
    gen = torch.Generator().manual_seed(int(flags.get("seed", seed)))
    return channel_apply(ch, gen, torch.as_tensor(
        np.asarray(stream, np.complex64)), signal_power=signal_power).numpy()


class RxStats:
    """Aggregate counters + the reference's end-of-run report format."""

    def __init__(self):
        self.num_frames_detected = 0
        self.num_valid_headers = 0
        self.num_valid_packets = 0
        self.num_bytes_received = 0

    def update(self, frame: dict):
        self.num_frames_detected += 1
        if frame["header_valid"]:
            self.num_valid_headers += 1
        if frame["payload_valid"]:
            self.num_valid_packets += 1
            self.num_bytes_received += frame["payload_len"]

    def report(self, runtime_s: float, file=None):
        file = file if file is not None else sys.stdout
        d = max(self.num_frames_detected, 1)
        print("    frames detected     : %6u" % self.num_frames_detected,
              file=file)
        print("    valid headers       : %6u (%6.2f%%)" %
              (self.num_valid_headers, 100.0 * self.num_valid_headers / d),
              file=file)
        print("    valid packets       : %6u (%6.2f%%)" %
              (self.num_valid_packets, 100.0 * self.num_valid_packets / d),
              file=file)
        print("    bytes received      : %6u" % self.num_bytes_received,
              file=file)
        print("    run time            : %f s" % runtime_s, file=file)
        if runtime_s > 0:
            print("    data rate           : %12.8f kbps" %
                  (8.0 * self.num_bytes_received / runtime_s * 1e-3),
                  file=file)


def dump_framesync_octave(path: str, title: str, stream: np.ndarray,
                          cap: dict) -> None:
    """Write one framesync debug capture (``ofdm_sync.debug_capture``) as
    an octave script: raw IQ, detection metric, |H| and the received
    constellation."""
    def cvec(f, name, vals, limit=4096):
        f.write(name + " = [" + " ".join(
            "(%.5g%+.5gj)" % (v.real, v.imag) for v in vals[:limit])
            + "];\n")

    with open(path, "w") as f:
        f.write("%% " + title + " (octave)\nclear all;\n")
        f.write("%% strongest candidate: n0=%d detected=%d hdr_valid=%d "
                "cfo=%.6f rssi=%.1f dB\n" %
                (cap["n0"], cap["detected"], cap["header_valid"],
                 cap["cfo"], cap["rssi"]))
        cvec(f, "x", stream[:4096])
        f.write("metric = [" + " ".join(
            "%.4f" % v for v in cap["metric"][:4096]) + "];\n")
        cvec(f, "H", cap["H"])               # channel estimate [M]
        cvec(f, "syms_hdr", cap["hsyms_eq"])    # equalized header points
        cvec(f, "syms_pay", cap["psyms_eq"])    # equalized payload points
        f.write(
            "figure;\n"
            "subplot(2,2,1); plot(real(x)); ylabel('I');\n"
            "subplot(2,2,2); plot(metric); ylabel('detect metric');\n"
            "subplot(2,2,3); plot(20*log10(max(abs(H),1e-6))); "
            "ylabel('|H| dB'); xlabel('subcarrier');\n"
            "subplot(2,2,4); plot(real(syms_pay), imag(syms_pay), 'x', "
            "real(syms_hdr), imag(syms_hdr), '.'); axis square; "
            "xlabel('I'); ylabel('Q'); title('received constellation');\n")
