"""packet_tx — fixed Frame64 TX to an IQ file.

Port of ``liquid_usrp_tpu/apps/packet_tx.py`` (same flags and defaults):
fixed 64-byte-payload framegen64 bursts (8-byte header: a 2-byte packet id
and 6 random bytes), resampled at ``-r`` (default 2.0).  Runs on the first
CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.packet_tx -o tx.iq -N 10
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..framing import flexframe as ff
from ..io.streams import write_iq
from ..utils.device import default_device
from .common import parse_args, resample_stream

USAGE = """packet_tx -o out.iq [options]
  h : usage                     o : output IQ file (required)
  g : soft gain dB (-12)        N : number of frames (10)
  r : output resampling rate (2.0)
  s : RNG seed (42)
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "ho:g:N:r:s:")
    if "h" in flags:
        print(USAGE)
        return 0
    out = flags.get("o")
    if not out:
        print(USAGE)
        return 1
    gain = 10 ** (float(flags.get("g", -12.0)) / 20.0)
    num_frames = int(flags.get("N", 10))
    rate = float(flags.get("r", 2.0))
    rng = np.random.default_rng(int(flags.get("s", 42)))

    dev = default_device()
    params = ff.make_flex_params()
    gap = np.zeros(300, np.complex64)
    chunks = [gap]
    for pid in range(num_frames):
        header = np.empty(ff.FRAME64_HEADER_USER, np.uint8)
        header[0] = (pid >> 8) & 0xFF
        header[1] = pid & 0xFF
        header[2:] = rng.integers(0, 256, 6, dtype=np.uint8)
        payload = rng.integers(0, 256, ff.FRAME64_PAYLOAD, dtype=np.uint8)
        frame = ff.frame64_assemble(params,
                                    torch.as_tensor(header, device=dev),
                                    torch.as_tensor(payload, device=dev))
        assert frame.shape[-1] == ff.FRAME64_LEN
        chunks.append(frame.cpu().numpy() * gain)
        chunks.append(gap)
    baseband = np.concatenate(chunks)
    if rate != 1.0:
        # decimation takes a multiple of the half-band factor
        baseband = resample_stream(baseband, rate, dev)
    write_iq(out, baseband)
    print(f"packet_tx: wrote {num_frames} frame64 bursts "
          f"({len(baseband)} samples) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
