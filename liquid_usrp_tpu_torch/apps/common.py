"""Shared app plumbing: getopt-compatible flags and RX statistics.

Port of the parts of ``liquid_usrp_tpu/apps/common.py`` the multichannel
apps use (``parse_args``, ``occupied_power``, ``RxStats``), plus
:func:`reject_unported` for flags whose machinery is not ported yet.
"""
from __future__ import annotations

import getopt as _getopt
import sys

import numpy as np

__all__ = ["parse_args", "occupied_power", "RxStats", "reject_unported"]


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
