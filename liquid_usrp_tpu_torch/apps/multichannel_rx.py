"""multichannel_rx — N-channel OFDM uplink RX from an IQ file.

Port of ``liquid_usrp_tpu/apps/multichannel_rx.py``: per-frame line with
the channel id recovered from header byte 2, then aggregate stats.  Runs on
the first CUDA device when there is one.  The virtual-channel impairments
(``--snr/--cfo/--delay``) and the debug dump (``-d``) are not ported yet
and are rejected with an error.

    python -m liquid_usrp_tpu_torch.apps.multichannel_rx -i mc.iq -n 2
"""
from __future__ import annotations

import sys
import time

from ..io.streams import read_iq
from ..models.multichannel import MultichannelRx
from .common import RxStats, parse_args, reject_unported

USAGE = """multichannel_rx -i in.iq [options]
  h : usage                     i : input IQ file (required)
  n : number of channels (2)    M : subcarriers (48)
  C : cyclic prefix (6)         q : quiet
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hi:n:M:C:d:q")
    if "h" in flags:
        print(USAGE)
        return 0
    reject_unported(flags, {"d": "debug dump", "snr": "channel SNR",
                            "cfo": "carrier offset", "delay": "sample delay",
                            "seed": "channel seed"})
    path = flags.get("i")
    if not path:
        print(USAGE)
        return 1
    N = int(flags.get("n", 2))
    M = int(flags.get("M", 48))
    cp = int(flags.get("C", 6))
    verbose = "q" not in flags

    rx = MultichannelRx(N, M=M, cp_len=cp, taper_len=min(4, cp),
                        block_size=4096, max_payload=1024)
    stream = read_iq(path)
    stats = RxStats()
    t0 = time.time()
    frames = rx.execute(stream) + rx.flush()
    for f in frames:
        stats.update(f)
        if verbose:
            hdr = f["header"]
            pid = (int(hdr[0]) << 8) | int(hdr[1])
            print("  rx ch %2d (hdr ch %2d): pid=%5u, rssi=%6.1f dB, "
                  "hdr:%s, pay:%s" %
                  (f["channel"], int(hdr[2]), pid, f["stats"]["rssi"],
                   "ok" if f["header_valid"] else "FAIL",
                   "ok" if f["payload_valid"] else "FAIL"))
    print("multichannel_rx results:")
    stats.report(time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
