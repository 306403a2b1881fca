"""gmskframe_tx — GMSK frame TX to an IQ file.

Port of ``liquid_usrp_tpu/apps/gmskframe_tx.py`` (same flags and
defaults): CRC16, FEC none + Hamming(7,4), 200-byte payloads, k=2
samples/symbol, -12 dB soft gain, 300-sample gaps; each header is a 2-byte
packet id and 6 random bytes.  ``-r`` in (0.5, 2] runs the reference
chain, a half-band interpolation by 2 and then an arbitrary resampler at
``rate / 2``; any other rate runs the multi-stage resampler.  Runs on the
first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).  A
convolutional or Reed-Solomon scheme needs ``--conv`` on the receiver (the
TX prints the note).

    python -m liquid_usrp_tpu_torch.apps.gmskframe_tx -o tx.iq -N 10
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..framing import gmskframe as gf
from ..io.streams import write_iq
from ..ops import crc as crc_mod
from ..ops import fec as fec_mod
from ..ops import resamp as resamp_mod
from ..utils.device import default_device
from .common import (budget_note, parse_args, print_usage_schemes,
                     resample_stream)

USAGE = """gmskframe_tx -o out.iq [options]
  h : usage                     o : output IQ file (required)
  g : soft gain dB (-12)        N : number of frames (10)
  P : payload bytes (200)       v : CRC scheme crc16|crc32 (crc16)
  c : inner FEC (none)          k : outer FEC (h74)
  r : output resampling rate (1.0)
  s : RNG seed (42)
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "ho:g:N:P:v:c:k:r:s:")
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
    P = int(flags.get("P", 200))
    try:
        check = {"none": crc_mod.CRC_NONE, "crc16": crc_mod.CRC_16,
                 "crc32": crc_mod.CRC_32}[flags.get("v", "crc16")]
        props = gf.gmsk_default_props()._replace(
            check=check,
            fec0=fec_mod.fec_from_name(flags.get("c", "none")),
            fec1=fec_mod.fec_from_name(flags.get("k", "h74")))
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    rate = float(flags.get("r", 1.0))
    rng = np.random.default_rng(int(flags.get("s", 42)))

    dev = default_device()
    params = gf.make_gmsk_params()
    expansion = budget_note(props, P)
    gap = np.zeros(300, np.complex64)
    chunks = [gap]
    for pid in range(num_frames):
        header = np.empty(8, np.uint8)
        header[0] = (pid >> 8) & 0xFF
        header[1] = pid & 0xFF
        header[2:] = rng.integers(0, 256, 6, dtype=np.uint8)
        payload = rng.integers(0, 256, P, dtype=np.uint8)
        frame = gf.gmsk_assemble(
            params, props, torch.as_tensor(header, device=dev),
            torch.as_tensor(payload, device=dev), expansion=expansion)
        chunks.append(frame.cpu().numpy() * gain)
        chunks.append(gap)
    baseband = np.concatenate(chunks)
    if rate != 1.0 and 0.5 < rate <= 2.0:
        # the reference chain: half-band interp-by-2 first (the arbitrary
        # stage never filters a full-band signal), then the arbitrary
        # resampler created at 1.0 and set to rate / 2 <= 1
        hb = resamp_mod.resamp2_create(7, 60.0)
        _, up = resamp_mod.resamp2_interp_block(
            hb, resamp_mod.resamp2_state(hb, dev),
            torch.as_tensor(baseband, device=dev))
        rs = resamp_mod.resamp_set_rate(resamp_mod.resamp_create(1.0),
                                        rate / 2.0)
        _, y, _, count = resamp_mod.resamp_block(
            rs, resamp_mod.resamp_state(rs, dev), up)
        baseband = y[:int(count)].cpu().numpy()
    elif rate != 1.0:
        baseband = resample_stream(baseband, rate, dev, trim=False)
    write_iq(out, baseband)
    print(f"gmskframe_tx: wrote {num_frames} frames "
          f"({len(baseband)} samples) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
