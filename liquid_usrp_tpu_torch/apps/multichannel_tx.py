"""multichannel_tx — N-channel OFDM downlink TX to an IQ file.

Port of ``liquid_usrp_tpu/apps/multichannel_tx.py`` (same flags): keeps
every channel saturated with random packets, packet id + channel id stamped
in header bytes 0-2, gain divided by N.  Runs on the first CUDA device
(``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.multichannel_tx -o mc.iq -n 2 -N 3
"""
from __future__ import annotations

import sys

import numpy as np

from ..io.streams import write_iq
from ..models.multichannel import MultichannelTx
from .common import parse_args, reject_unported

USAGE = """multichannel_tx -o out.iq [options]
  h : usage                     o : output IQ file (required)
  n : number of channels (2)    N : packets per channel (4)
  g : soft gain dB (-12)        P : payload bytes (256)
  M : subcarriers (48)          C : cyclic prefix (6)
  s : RNG seed (42)
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "ho:n:N:g:P:M:C:s:")
    if "h" in flags:
        print(USAGE)
        return 0
    reject_unported(flags, {"snr": "channel SNR", "cfo": "carrier offset",
                            "delay": "sample delay", "seed": "channel seed"})
    out = flags.get("o")
    if not out:
        print(USAGE)
        return 1
    N = int(flags.get("n", 2))
    if not (1 <= N <= 255):
        print("error: -n must be in [1, 255] (channel id rides a header "
              "byte)", file=sys.stderr)
        return 1
    num_packets = int(flags.get("N", 4))
    gain = 10 ** (float(flags.get("g", -12.0)) / 20.0) / N
    P = int(flags.get("P", 256))
    M = int(flags.get("M", 48))
    cp = int(flags.get("C", 6))
    rng = np.random.default_rng(int(flags.get("s", 42)))

    tx = MultichannelTx(N, M=M, cp_len=cp, taper_len=min(4, cp))
    pid = [0] * N
    sent = 0
    out_chunks = []
    while min(pid) < num_packets or not all(
            tx.is_channel_ready(c) for c in range(N)):
        for ch in range(N):
            if tx.is_channel_ready(ch) and pid[ch] < num_packets:
                header = np.empty(8, np.uint8)
                header[0] = (pid[ch] >> 8) & 0xFF
                header[1] = pid[ch] & 0xFF
                header[2] = ch          # channel id
                header[3:] = rng.integers(0, 256, 5, dtype=np.uint8)
                payload = rng.integers(0, 256, P, dtype=np.uint8)
                tx.update_data(ch, header, payload)
                pid[ch] += 1
                sent += 1
        out_chunks.append(tx.generate_samples(512) * gain)
    out_chunks.append(tx.generate_samples(64) * gain)
    stream = np.concatenate(out_chunks)
    write_iq(out, stream)
    print(f"multichannel_tx: wrote {sent} packets on {N} channels "
          f"({len(stream)} samples) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
