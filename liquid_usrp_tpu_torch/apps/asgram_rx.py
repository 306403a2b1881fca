"""asgram_rx — ASCII spectrogram (FFT waterfall) over an IQ file.

Port of ``liquid_usrp_tpu/apps/asgram_rx.py`` (same flags and output):
nfft 64, -65 dB offset, 5 dB a character, rows printed with their peak
value and frequency.  Only the printed rows' frames are transformed.  The
stream goes through the ``--snr/--cfo/--delay`` impairments and the ``-r``
resampler first.  Runs on the first CUDA device
(``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.asgram_rx -i in.iq
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..io.streams import read_iq
from ..ops import spectrum as spec_mod
from ..ops import window as window_mod
from ..utils.device import default_device
from .common import apply_channel, apply_msresamp, parse_args

USAGE = """asgram_rx -i in.iq [options]
  h : usage              i : input IQ file (required)
  n : FFT size (64)      L : rows to print (20)
  o : dB offset (-65)    S : dB per character (5)
  r : msresamp rate before the FFT (1.0 = off)
  O : IQ ring-log dump file (.m octave)
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hi:n:L:o:S:O:r:")
    if "h" in flags:
        print(USAGE)
        return 0
    path = flags.get("i")
    if not path:
        print(USAGE)
        return 1
    nfft = int(flags.get("n", 64))
    rows = int(flags.get("L", 20))
    offset = float(flags.get("o", -65.0))
    scale = float(flags.get("S", 5.0))

    dev = default_device()
    stream = read_iq(path)
    stream = apply_channel(stream, flags)
    stream = apply_msresamp(stream, float(flags.get("r", 1.0)), dev)
    sg = spec_mod.spectrogram_create(nfft=nfft, ref_level=offset,
                                     scale=scale)
    n_frames = len(stream) // nfft
    take = min(rows, n_frames)
    stride = max(n_frames // max(take, 1), 1)
    # only the `take` strided display frames are transformed
    sel = np.concatenate([stream[i * stride * nfft:
                                 i * stride * nfft + nfft]
                          for i in range(take)]) if take else \
        np.zeros(0, np.complex64)
    psd, peak_db, peak_f = spec_mod.spectrogram_block(
        sg, torch.as_tensor(np.asarray(sel, np.complex64), device=dev))
    psd = psd.cpu().numpy()
    peak_db, peak_f = peak_db.cpu().numpy(), peak_f.cpu().numpy()
    for r in range(take):
        row = spec_mod.ascii_row(sg, psd[r])
        print("[%s] peak: %6.1f dB @ f=%+.3f" %
              (row, float(peak_db[r]), float(peak_f[r])))
    if flags.get("O"):
        ring = window_mod.ring_init(1024, device=dev)
        ring = window_mod.ring_push(ring, torch.as_tensor(
            np.asarray(stream, np.complex64), device=dev))
        q = window_mod.ring_read(ring).cpu().numpy()
        with open(flags["O"], "w") as f:
            f.write("%% asgram_rx IQ capture (octave)\nclear all;\n")
            f.write("x = [" + " ".join(
                "(%.5g%+.5gj)" % (v.real, v.imag) for v in q) + "];\n")
            f.write("figure; plot(real(x)); hold on; plot(imag(x));\n")
        print(f"IQ log written to {flags['O']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
