"""rssi — receive-power meter over an IQ file.

Port of ``liquid_usrp_tpu/apps/rssi.py`` (same flags and output): AGC
tracking (bandwidth 0.01), a periodic RSSI printout, ring-logged RSSI and
IQ, and an octave plot script on exit.  The stream goes through the
``--snr/--cfo/--delay`` impairments and the ``-r`` resampler first.  Runs
on the first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the
CPU).

    python -m liquid_usrp_tpu_torch.apps.rssi -i in.iq
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..io.streams import read_iq
from ..ops import agc as agc_mod
from ..ops import window as window_mod
from ..utils.device import default_device
from .common import apply_channel, apply_msresamp, parse_args

USAGE = """rssi -i in.iq [options]
  h : usage              i : input IQ file (required)
  b : AGC bandwidth (0.01)
  r : msresamp rate before the AGC (1.0 = off)
  L : print interval in samples (10000)
  o : octave dump file (optional, e.g. rssi_log.m)
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hi:b:r:L:o:")
    if "h" in flags:
        print(USAGE)
        return 0
    path = flags.get("i")
    if not path:
        print(USAGE)
        return 1
    bw = float(flags.get("b", 0.01))
    interval = int(flags.get("L", 10000))
    dump = flags.get("o")

    dev = default_device()
    stream = read_iq(path)
    stream = apply_channel(stream, flags)
    stream = apply_msresamp(stream, float(flags.get("r", 1.0)), dev)
    state = agc_mod.agc_init(bandwidth=bw, device=dev)
    rssi_log = window_mod.ring_init(1024, dtype=torch.float32, device=dev)
    iq_log = window_mod.ring_init(1024, device=dev)
    printed = 0
    did_print = False
    block = 4096
    # zero-pad to a whole block: the tail (or a sub-block file) is still
    # measured; prints and logs stay within the real samples
    orig_len = len(stream)
    if orig_len % block:
        stream = np.concatenate(
            [stream, np.zeros(block - orig_len % block, np.complex64)])
    last = max(orig_len - 1, 0)
    x_all = torch.as_tensor(np.asarray(stream, np.complex64), device=dev)
    rssi = None
    for i in range(0, len(stream) - block + 1, block):
        x = x_all[i:i + block]
        state, y, level, rssi = agc_mod.agc_block(state, x)
        n_real = min(block, orig_len - i)
        if n_real > 0:
            rssi_log = window_mod.ring_push(rssi_log, rssi[:n_real:16])
            iq_log = window_mod.ring_push(iq_log, x[:n_real:16])
        while printed + interval <= i + block:
            printed += interval
            j = printed - i - 1
            if 0 <= j < min(block, orig_len - i):
                print("  rssi = %8.2f dB" % float(rssi[j]))
                did_print = True
    if not did_print and orig_len > 0:
        # file shorter than one print interval: the level at the last
        # real sample, once (rssi still holds the final block)
        print("  rssi = %8.2f dB" % float(rssi[last - (len(stream) -
                                                       block)]))
    if dump:
        r = window_mod.ring_read(rssi_log).cpu().numpy()
        q = window_mod.ring_read(iq_log).cpu().numpy()
        with open(dump, "w") as f:
            f.write("%% auto-generated rssi log (octave)\nclear all;\n")
            f.write("rssi = [" + " ".join("%.3f" % v for v in r) + "];\n")
            f.write("x = [" + " ".join(
                "(%.5f+%.5fj)" % (v.real, v.imag) for v in q) + "];\n")
            f.write("figure; plot(rssi); ylabel('RSSI [dB]');\n")
        print(f"octave log written to {dump}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
