"""wlanframe_tx — IEEE 802.11a OFDM frame TX to an IQ file.

Port of ``liquid_usrp_tpu/apps/wlanframe_tx.py`` (same flags, seeds and
output): ``-N`` frames of ``-P`` random PSDU bytes at ``-r`` Mb/s (6-54),
80-sample symbols, 200-sample gaps, at ``-g`` dB.  The frames are built
on the first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the
CPU).

    python -m liquid_usrp_tpu_torch.apps.wlanframe_tx -o w.iq -N 3 -r 24
"""
from __future__ import annotations

import sys

import numpy as np

from ..framing import wlan
from ..io.streams import write_iq
from ..utils.device import default_device
from .common import parse_args

USAGE = """wlanframe_tx -o out.iq [options]
  h : usage                     o : output IQ file (required)
  r : rate Mb/s (6,9,12,18,24,36,48,54; default 6)
  N : number of frames (5)      P : PSDU bytes (200)
  g : soft gain dB (-12)        s : RNG seed (42)
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "ho:r:N:P:g:s:")
    if "h" in flags:
        print(USAGE)
        return 0
    out = flags.get("o")
    if not out:
        print(USAGE)
        return 1
    rate = int(flags.get("r", 6))
    num_frames = int(flags.get("N", 5))
    P = int(flags.get("P", 200))
    gain = 10 ** (float(flags.get("g", -12.0)) / 20.0)
    rng = np.random.default_rng(int(flags.get("s", 42)))
    dev = default_device()

    gap = np.zeros(200, np.complex64)
    chunks = [gap]
    for _ in range(num_frames):
        psdu = rng.integers(0, 256, P, dtype=np.uint8)
        frame = wlan.wlan_assemble(rate, psdu, device=dev).cpu().numpy()
        if len(frame) != wlan.wlan_frame_length(rate, P):
            raise RuntimeError(f"frame of {len(frame)} samples, expected "
                               f"{wlan.wlan_frame_length(rate, P)}")
        chunks.append(frame * gain)
        chunks.append(gap)
    stream = np.concatenate(chunks)
    write_iq(out, stream)
    print(f"wlanframe_tx: wrote {num_frames} frames at {rate} Mb/s "
          f"({len(stream)} samples) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
