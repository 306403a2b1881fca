"""packet_rx — fixed Frame64 RX from an IQ file.

Port of ``liquid_usrp_tpu/apps/packet_rx.py`` (same flags and defaults):
the flexframe synchronizer with an 8-byte header and a 64-byte payload
budget, holding frames to the Frame64 contract as ``framesync64`` does: a
decoded frame counts only when its header advertises exactly the Frame64
properties (64-byte payload, CRC32, Golay(24,12), QPSK); any other valid
header is a foreign burst, counted and reported.  Runs on the first CUDA
device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.packet_rx -i tx.iq
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..framing import flexframe as ff
from ..framing import flexframe_sync as ffs
from ..io.streams import read_iq
from ..utils.device import default_device
from .common import (RxStats, apply_channel, iter_sync_results,
                     occupied_power, parse_args, resample_stream)

USAGE = """packet_rx -i in.iq [options]
  h : usage              i : input IQ file (required)
  r : input resampling rate applied (0.5 default; 1.0 = none)
  q : quiet
  --snr/--cfo/--delay/--seed : virtual channel impairments
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hi:r:q")
    if "h" in flags:
        print(USAGE)
        return 0
    path = flags.get("i")
    if not path:
        print(USAGE)
        return 1
    rate = float(flags.get("r", 0.5))
    verbose = "q" not in flags

    dev = default_device()
    stream = read_iq(path)
    stream = apply_channel(stream, flags,
                           signal_power=occupied_power(stream))
    if rate != 1.0:
        stream = resample_stream(stream, rate, dev)

    f64 = ff.frame64_props()
    params = ff.make_flex_params()
    sync = ffs.make_flex_sync(params, block_size=8192,
                              max_payload=ff.FRAME64_PAYLOAD,
                              max_frames=4,
                              header_user=ff.FRAME64_HEADER_USER)
    stats = RxStats()
    foreign = 0
    t0 = time.time()
    for res in iter_sync_results(
            ffs.make_flex_sync_step(sync), ffs.flex_sync_init(sync, dev),
            stream, sync.block_size, sync.overlap,
            batched_fn=lambda st, blks: ffs.flex_sync_blocks_batched(
                sync, st, blks)):
        for i in np.nonzero(res.detected)[0]:
            hv = bool(res.header_valid[i])
            # Frame64 contract: one payload length and one coding
            is_f64 = (hv and int(res.payload_len[i]) == ff.FRAME64_PAYLOAD
                      and int(res.mod[i]) == f64.mod
                      and int(res.fec0[i]) == f64.fec0
                      and int(res.fec1[i]) == f64.fec1
                      and int(res.check[i]) == f64.check)
            if hv and not is_f64:
                foreign += 1
                if verbose:
                    print("  rx non-frame64 burst ignored (len=%d)" %
                          int(res.payload_len[i]))
                continue
            row = {"header_valid": hv,
                   "payload_valid": bool(res.payload_valid[i]),
                   "payload_len": int(res.payload_len[i])}
            stats.update(row)
            if verbose:
                pid = (int(res.header[i][0]) << 8) | int(res.header[i][1])
                print("  rx frame64: pid=%5u, rssi=%6.1f dB, evm=%6.1f dB, "
                      "cfo=%8.5f, hdr:%s, pay:%s" %
                      (pid, float(res.rssi[i]), float(res.evm[i]),
                       float(res.cfo[i]),
                       "ok" if row["header_valid"] else "FAIL",
                       "ok" if row["payload_valid"] else "FAIL"))
    print("packet_rx results:")
    stats.report(time.time() - t0)
    if foreign:
        print("    non-frame64 bursts  : %6u" % foreign)
    return 0


if __name__ == "__main__":
    sys.exit(main())
