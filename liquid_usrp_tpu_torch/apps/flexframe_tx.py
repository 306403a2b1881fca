"""flexframe_tx — single-carrier flexframe TX to an IQ file.

Port of ``liquid_usrp_tpu/apps/flexframe_tx.py`` (same flags and
defaults): frames at 2 samples/symbol, each with a 14-byte user header (a
2-byte packet id and 12 random bytes), then resampled by the multi-stage
arbitrary resampler at ``-r`` (default 2.0, so 4 samples/symbol on file).
Runs on the first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for
the CPU).  A convolutional or Reed-Solomon scheme needs ``--conv`` on the
receiver (the TX prints the note).

    python -m liquid_usrp_tpu_torch.apps.flexframe_tx -o tx.iq -N 10
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..framing import flexframe as ff
from ..io.streams import write_iq
from ..ops import fec as fec_mod
from ..ops import modem as modem_mod
from ..utils.device import default_device
from .common import (budget_note, parse_args, print_usage_schemes,
                     resample_stream)

USAGE = """flexframe_tx -o out.iq [options]
  h : usage                     o : output IQ file (required)
  g : soft gain dB (-12)        N : number of frames (10)
  P : payload bytes (64)        m : mod scheme (qpsk)
  c : inner FEC (none)          k : outer FEC (h128)
  r : output resampling rate (2.0)
  s : RNG seed (42)
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "ho:g:N:P:m:c:k:r:s:")
    if "h" in flags:
        print(USAGE)
        print_usage_schemes()
        return 0
    out = flags.get("o")
    if not out:
        print(USAGE)
        return 1
    gain = 10 ** (float(flags.get("g", -12.0)) / 20.0)
    num_frames = int(flags.get("N", 10))
    P = int(flags.get("P", 64))
    try:
        props = ff.FrameProps(
            mod=modem_mod.mod_from_name(flags.get("m", "qpsk")),
            fec0=fec_mod.fec_from_name(flags.get("c", "none")),
            fec1=fec_mod.fec_from_name(flags.get("k", "h128")))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    rate = float(flags.get("r", 2.0))
    seed = int(flags.get("s", 42))

    dev = default_device()
    params = ff.make_flex_params()
    expansion = budget_note(props, P)
    rng = np.random.default_rng(seed)
    gap = np.zeros(300, np.complex64)
    chunks = [gap]
    for pid in range(num_frames):
        # 14-byte user header: pid in bytes 0-1, the rest random
        header = np.empty(ff.FLEX_HEADER_USER, np.uint8)
        header[0] = (pid >> 8) & 0xFF
        header[1] = pid & 0xFF
        header[2:] = rng.integers(0, 256, ff.FLEX_HEADER_USER - 2,
                                  dtype=np.uint8)
        payload = rng.integers(0, 256, P, dtype=np.uint8)
        frame = ff.flex_assemble(
            params, props, torch.as_tensor(header, device=dev),
            torch.as_tensor(payload, device=dev), expansion=expansion)
        chunks.append(frame.cpu().numpy() * gain)
        chunks.append(gap)
    baseband = np.concatenate(chunks)
    if rate != 1.0:
        baseband = resample_stream(baseband, rate, dev, trim=False)
    write_iq(out, baseband)
    print(f"flexframe_tx: wrote {num_frames} frames "
          f"({len(baseband)} samples @ rate {rate}) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
