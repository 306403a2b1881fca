"""wlanframe_rx — IEEE 802.11a OFDM frame RX from an IQ file.

Port of ``liquid_usrp_tpu/apps/wlanframe_rx.py`` (same flags, defaults
and report lines): drives the streaming synchronizer
(``framing/wlan.py::wlan_sync_block``) block by block over the file, after
the optional ``--snr/--cfo/--delay`` virtual channel.  It runs on the
first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.wlanframe_rx -i w.iq --snr 15
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..framing import wlan
from ..io.streams import read_iq
from ..utils.device import default_device
from .common import apply_channel, occupied_power, parse_args

USAGE = """wlanframe_rx -i in.iq [options]
  h : usage                     i : input IQ file (required)
  p : max PSDU budget bytes (default 256)
  t : detection threshold (default 0.45)
  q/v : quiet / verbose
  --snr/--cfo/--delay : virtual channel impairments
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hi:p:t:qv", ["snr=", "cfo=", "delay=", "seed="])
    if "h" in flags:
        print(USAGE)
        return 0
    path = flags.get("i")
    if not path:
        print(USAGE)
        return 1
    verbose = "q" not in flags
    max_psdu = int(flags.get("p", 256))
    thresh = float(flags.get("t", 0.45))

    stream = read_iq(path)
    stream = apply_channel(stream, flags,
                           signal_power=occupied_power(stream))

    sync = wlan.make_wlan_sync(max_psdu=max_psdu, threshold=thresh)
    step = wlan.make_wlan_sync_step(sync)
    state = wlan.wlan_sync_init(sync, default_device())
    bs = sync.block_size
    n_blocks = -(-len(stream) // bs) + sync.overlap // bs + 1
    padded = np.zeros(n_blocks * bs, np.complex64)
    padded[:len(stream)] = stream
    blocks = torch.as_tensor(padded, device=state.tail.device).reshape(
        n_blocks, bs)

    t0 = time.time()
    det = sig_ok = psdu_ok = 0
    byte_total = 0
    for b in range(n_blocks):
        state, res = step(state, blocks[b])
        res = wlan.WlanResults(*(v.cpu().numpy() for v in res))
        for i in np.nonzero(res.detected)[0]:
            det += 1
            if not res.signal_valid[i]:
                continue
            sig_ok += 1
            ok = bool(res.psdu_valid[i])
            if ok:
                psdu_ok += 1
                byte_total += int(res.length[i])
            if verbose:
                print("  rx frame: t=%8d, rate=%2d Mb/s, len=%4d, "
                      "rssi=%6.1f dB, cfo=%8.5f, psdu:%s" %
                      (int(res.t_start[i]), int(res.rate[i]),
                       int(res.length[i]), float(res.rssi[i]),
                       float(res.cfo[i]), "ok" if ok else "FAIL"))
    runtime = time.time() - t0
    print("wlanframe_rx results:")
    print("    frames detected     : %6u" % det)
    print("    valid SIGNAL        : %6u (%.2f%%)" %
          (sig_ok, 100.0 * sig_ok / max(det, 1)))
    print("    valid PSDUs         : %6u (%.2f%%)" %
          (psdu_ok, 100.0 * psdu_ok / max(det, 1)))
    print("    bytes received      : %6u" % byte_total)
    print("    run time            : %f s" % runtime)
    return 0


if __name__ == "__main__":
    sys.exit(main())
