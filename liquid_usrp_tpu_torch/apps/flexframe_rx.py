"""flexframe_rx — single-carrier flexframe RX from an IQ file.

Port of ``liquid_usrp_tpu/apps/flexframe_rx.py`` (same flags and
defaults): the stream goes through the ``--snr/--cfo/--delay`` impairments
(at the file rate), is resampled back to 2 samples/symbol at ``-r``
(default 0.5) and decoded by the flexframe synchronizer
(``block_size=8192``, ``max_frames=4``, ``-p`` payload budget, default
2048) in 8-block batched dispatches; a line per frame, then the aggregate
stats.  Runs on the first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu``
asks for the CPU).  ``--conv`` adds the convolutional and Reed-Solomon
payload FEC branches; ``--soft`` decodes from soft-decision LLRs: exact-ML
Golay headers and soft Viterbi payloads.

    python -m liquid_usrp_tpu_torch.apps.flexframe_rx -i tx.iq
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..framing import flexframe as ff
from ..framing import flexframe_sync as ffs
from ..framing.payload import EXPANSION
from ..io.streams import read_iq
from ..utils.device import default_device
from .common import (RxStats, apply_channel, iter_sync_results,
                     occupied_power, parse_args, resample_stream)

USAGE = """flexframe_rx -i in.iq [options]
  h : usage              i : input IQ file (required)
  r : input resampling rate applied (0.5 default; 1.0 = none)
  p : max payload budget in bytes, default 2048
  q : quiet
  e : decode budget (expansion), default 3 (TX prints the needed value)
  --snr/--cfo/--delay/--seed : virtual channel impairments
  --conv : enable convolutional/RS payload FEC decode branches
  --soft : soft-decision (LLR) decode: exact-ML Golay header, soft
          Viterbi for conv payload FECs
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hi:r:p:e:q",
                          ["snr=", "cfo=", "delay=", "seed=",
                           "conv", "soft"])
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

    params = ff.make_flex_params()
    sync = ffs.make_flex_sync(params, block_size=8192,
                              max_payload=int(flags.get("p", 2048)),
                              max_frames=4,
                              enable_conv="conv" in flags,
                              soft="soft" in flags,
                              expansion=int(flags.get("e", EXPANSION)))
    stats = RxStats()
    t0 = time.time()
    for res in iter_sync_results(
            ffs.make_flex_sync_step(sync), ffs.flex_sync_init(sync, dev),
            stream, sync.block_size, sync.overlap,
            batched_fn=lambda st, blks: ffs.flex_sync_blocks_batched(
                sync, st, blks)):
        for i in np.nonzero(res.detected)[0]:
            row = {"header_valid": bool(res.header_valid[i]),
                   "payload_valid": bool(res.payload_valid[i]),
                   "payload_len": int(res.payload_len[i])}
            stats.update(row)
            if verbose:
                pid = (int(res.header[i][0]) << 8) | int(res.header[i][1])
                print("  rx frame: pid=%5u, rssi=%6.1f dB, evm=%6.1f dB, "
                      "cfo=%8.5f, hdr:%s, pay:%s" %
                      (pid, float(res.rssi[i]), float(res.evm[i]),
                       float(res.cfo[i]),
                       "ok" if row["header_valid"] else "FAIL",
                       "ok" if row["payload_valid"] else "FAIL"))
    print("flexframe_rx results:")
    stats.report(time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
