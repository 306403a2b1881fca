"""multichannel_rx — N-channel OFDM uplink RX from an IQ file.

Port of ``liquid_usrp_tpu/apps/multichannel_rx.py``: per-frame line with
the channel id recovered from header byte 2, then aggregate stats, the
virtual-channel impairments (``--snr/--cfo/--delay/--seed``) and a debug
dump per channel (``-d``).  Runs on the first CUDA device
(``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.multichannel_rx -i mc.iq -n 2
"""
from __future__ import annotations

import sys
import time

from ..io.streams import read_iq
from ..models.multichannel import MultichannelRx
from .common import RxStats, apply_channel, occupied_power, parse_args

USAGE = """multichannel_rx -i in.iq [options]
  h : usage                     i : input IQ file (required)
  n : number of channels (2)    M : subcarriers (48)
  C : cyclic prefix (6)         q : quiet
  d : debug dump prefix (writes <prefix>_framesync_channel<k>.m per
      channel)
  --snr/--cfo/--delay/--seed : virtual channel impairments
"""


def _dump_channel_debug(prefix: str, rx, stream) -> None:
    """Per-channel octave dumps: channelize the mixture once, then run the
    single-synchronizer debug capture on each channel's baseband stream."""
    from ..framing import ofdm_sync
    from .common import dump_framesync_octave
    chans = rx.channelize(stream[: (1 << 16) * 2 * rx.num_channels])
    for ch in range(rx.num_channels):
        cap = ofdm_sync.debug_capture(rx.sync, chans[ch], rx.rx.device)
        path = f"{prefix}_framesync_channel{ch}.m"
        dump_framesync_octave(
            path, f"multichannel_rx channel {ch} debug capture",
            chans[ch], cap)
        print(f"debug capture written to {path}")


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hi:n:M:C:d:q")
    if "h" in flags:
        print(USAGE)
        return 0
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
    stream = apply_channel(stream, flags,
                           signal_power=occupied_power(stream))
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
    if "d" in flags:
        _dump_channel_debug(flags["d"], rx, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
