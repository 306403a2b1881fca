"""ofdmflexframe_tx — transmit OFDM frames to an IQ file.

Port of ``liquid_usrp_tpu/apps/ofdmflexframe_tx.py`` (same flags and
defaults): M=48 subcarriers, cp=6, taper=4, 1200-byte payloads, QPSK, FEC
none + Golay(24,12), CRC32, -12 dB soft gain; each header is a 2-byte packet
id and 6 random bytes.  Runs on the first CUDA device
(``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).
A convolutional or Reed-Solomon scheme needs ``--conv`` on the receiver
(the TX prints the note).

    python -m liquid_usrp_tpu_torch.apps.ofdmflexframe_tx -o tx.iq -N 10
"""
from __future__ import annotations

import sys

import numpy as np

from ..framing.ofdm import FrameProps
from ..io.streams import write_iq
from ..models.ofdmtxrx import OfdmTxRx
from ..ops import crc as crc_mod
from ..ops import fec as fec_mod
from ..ops import modem as modem_mod
from .common import budget_note, parse_args, print_usage_schemes

USAGE = """ofdmflexframe_tx -o out.iq [options]
  h     : usage
  o     : output IQ file (required)
  g     : software TX gain [dB], default -12
  N     : number of frames, default 10
  M     : number of subcarriers, default 48
  C     : cyclic prefix length, default 6
  T     : taper length, default 4
  P     : payload length [bytes], default 1200
  m     : modulation scheme, default qpsk
  c     : inner FEC, default none
  k     : outer FEC, default g2412
  s     : RNG seed, default 42
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "ho:g:N:M:C:T:P:m:c:k:s:")
    if "h" in flags:
        print(USAGE)
        print_usage_schemes()
        return 0
    out = flags.get("o")
    if not out:
        print(USAGE)
        return 1
    gain = float(flags.get("g", -12.0))
    num_frames = int(flags.get("N", 10))
    M = int(flags.get("M", 48))
    cp = int(flags.get("C", 6))
    taper = int(flags.get("T", 4))
    P = int(flags.get("P", 1200))
    try:
        mod = modem_mod.mod_from_name(flags.get("m", "qpsk"))
        fec0 = fec_mod.fec_from_name(flags.get("c", "none"))
        fec1 = fec_mod.fec_from_name(flags.get("k", "g2412"))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    seed = int(flags.get("s", 42))

    props = FrameProps(check=crc_mod.CRC_32, fec0=fec0, fec1=fec1, mod=mod)
    expansion = budget_note(props, P)
    txrx = OfdmTxRx(M=M, cp_len=cp, taper_len=taper, expansion=expansion)
    txrx.set_tx_gain_soft(gain)
    rng = np.random.default_rng(seed)
    gap = np.zeros(256, np.complex64)
    chunks = [gap]
    for pid in range(num_frames):
        header = np.empty(8, np.uint8)
        header[0] = (pid >> 8) & 0xFF
        header[1] = pid & 0xFF
        header[2:] = rng.integers(0, 256, 6, dtype=np.uint8)
        payload = rng.integers(0, 256, P, dtype=np.uint8)
        chunks.append(txrx.transmit_packet(header, payload, mod=mod,
                                           fec0=fec0, fec1=fec1))
        chunks.append(gap)
    stream = np.concatenate(chunks)
    write_iq(out, stream)
    print(f"ofdmflexframe_tx: wrote {num_frames} frames "
          f"({len(stream)} samples) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
