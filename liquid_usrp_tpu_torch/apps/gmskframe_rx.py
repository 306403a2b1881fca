"""gmskframe_rx — GMSK frame RX from an IQ file.

Port of ``liquid_usrp_tpu/apps/gmskframe_rx.py`` (same flags and
defaults): the stream goes through the ``--snr/--cfo/--delay``
impairments, is resampled at ``-r`` (default 1.0, none) and decoded by the
GMSK synchronizer (``block_size=8192``, ``max_frames=4``, ``-p`` payload
budget, default 1024) in 8-block batched dispatches; a line per frame,
the aggregate stats, the packet error rate and the mean SNR estimate.
``--conv`` adds the convolutional and Reed-Solomon payload FEC branches;
``--soft`` decodes from soft-decision LLRs: exact-ML Golay headers and
soft Viterbi payloads.  Runs on the first CUDA device
(``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.gmskframe_rx -i tx.iq
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..framing import gmskframe as gf
from ..framing.payload import EXPANSION
from ..io.streams import read_iq
from ..utils.device import default_device
from .common import (RxStats, apply_channel, iter_sync_results,
                     occupied_power, parse_args, resample_stream)

USAGE = """gmskframe_rx -i in.iq [options]
  h : usage              i : input IQ file (required)
  r : input resampling rate (1.0)
  p : max payload budget in bytes, default 1024
  q : quiet
  e : decode budget (expansion), default 3 (TX prints the needed value)
  --conv : enable convolutional/RS payload FEC decode branches
  --snr/--cfo/--delay/--seed : virtual channel impairments
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
    rate = float(flags.get("r", 1.0))
    verbose = "q" not in flags

    dev = default_device()
    stream = read_iq(path)
    stream = apply_channel(stream, flags,
                           signal_power=occupied_power(stream))
    if rate != 1.0:
        stream = resample_stream(stream, rate, dev)

    params = gf.make_gmsk_params()
    sync = gf.make_gmsk_sync(params, block_size=8192,
                             max_payload=int(flags.get("p", 1024)),
                             max_frames=4,
                             enable_conv="conv" in flags,
                             soft="soft" in flags,
                             expansion=int(flags.get("e", EXPANSION)))
    stats = RxStats()
    snrs = []
    t0 = time.time()
    for res in iter_sync_results(
            gf.make_gmsk_sync_step(sync), gf.gmsk_sync_init(sync, dev),
            stream, sync.block_size, sync.overlap,
            batched_fn=lambda st, blks: gf.gmsk_sync_blocks_batched(
                sync, st, blks)):
        for i in np.nonzero(res.detected)[0]:
            row = {"header_valid": bool(res.header_valid[i]),
                   "payload_valid": bool(res.payload_valid[i]),
                   "payload_len": int(res.payload_len[i])}
            stats.update(row)
            snrs.append(-float(res.evm[i]))
            if verbose:
                pid = (int(res.header[i][0]) << 8) | int(res.header[i][1])
                print("  rx frame: pid=%5u, snr=%6.1f dB, cfo=%8.5f, "
                      "hdr:%s, pay:%s" %
                      (pid, -float(res.evm[i]), float(res.cfo[i]),
                       "ok" if row["header_valid"] else "FAIL",
                       "ok" if row["payload_valid"] else "FAIL"))
    runtime = time.time() - t0
    print("gmskframe_rx results:")
    stats.report(runtime)
    det = stats.num_frames_detected
    per = 1.0 - stats.num_valid_packets / det if det else 1.0
    print("    packet error rate   : %12.8f" % per)
    if snrs:
        print("    average SNR (est)   : %8.3f dB" % (sum(snrs) / len(snrs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
