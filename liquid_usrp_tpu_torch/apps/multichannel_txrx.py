"""multichannel_txrx — two-endpoint burst-TDD exerciser over a virtual air.

Port of ``liquid_usrp_tpu/apps/multichannel_txrx.py`` (same flags, seeds
and report lines): TX bursts of random-length packets on all channels,
drain (``wait_for_tx_to_complete``), then listen, for ``-R`` rounds.  Two
:class:`MultichannelTxRx` nodes alternate TX and RX roles each round
through a :class:`VirtualAir` whose frequency offset follows from the
endpoints' ``RadioConfig`` mistuning (``--ppm``).  Each burst queues two
packets a channel, so ``wait_for_channel`` polls on the hot path.  Both
nodes run on the first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks
for the CPU); their receivers detect with kernel B1.

    python -m liquid_usrp_tpu_torch.apps.multichannel_txrx -n 4 -P 400 -R 4
"""
from __future__ import annotations

import sys

import numpy as np

from ..io.radio import VirtualAir
from ..models.multichannel import MultichannelTxRx
from ..models.ofdmtxrx import RadioConfig
from .common import RxStats, parse_args

USAGE = """multichannel_txrx [options]
  h : usage                     n : number of channels (2)
  R : TDD rounds (2)            P : max payload bytes (200)
  M : subcarriers (48)          C : cyclic prefix (6)
  q : quiet
  --snr : link SNR dB (30)      --ppm : node-B LO error, ppm (0.2)
"""


def main(argv=None) -> int:
    import time as _time
    _t0 = _time.time()
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hn:R:P:M:C:q", ["snr=", "ppm=", "seed="])
    if "h" in flags:
        print(USAGE)
        return 0
    N = int(flags.get("n", 2))
    if not (1 <= N <= 255):
        print("error: -n must be in [1, 255]", file=sys.stderr)
        return 1
    rounds = int(flags.get("R", 2))
    P = int(flags.get("P", 200))
    M = int(flags.get("M", 48))
    cp = int(flags.get("C", 6))
    snr = float(flags.get("snr", 30.0))
    ppm = float(flags.get("ppm", 0.2))
    verbose = "q" not in flags
    rng = np.random.default_rng(7)

    node_a = MultichannelTxRx(N, M=M, cp_len=cp, taper_len=min(4, cp),
                              block_size=4096, max_payload=1024)
    node_b = MultichannelTxRx(N, M=M, cp_len=cp, taper_len=min(4, cp),
                              block_size=4096, max_payload=1024)
    radio_a, radio_b = RadioConfig(), RadioConfig()
    air = VirtualAir(snr_db=snr, seed=int(flags.get("seed", 3)))
    stats = RxStats()
    sent: dict[int, np.ndarray] = {}
    ok_payload = 0
    pid = 0

    for rd in range(rounds):
        # TDD role alternation: A bursts on even rounds, B on odd
        tx_node, rx_node = (node_a, node_b) if rd % 2 == 0 else (node_b,
                                                                 node_a)
        tx_radio, rx_radio = (radio_a, radio_b) if rd % 2 == 0 else (radio_b,
                                                                     radio_a)
        hop_ppm = -ppm if rd % 2 == 0 else +ppm
        # TX burst: two random-length packets per channel; the second
        # queue waits in wait_for_channel until the first drains
        burst = []
        for rep in range(2):
            for ch in range(N):
                burst.append(tx_node.wait_for_channel(ch))
                header = np.empty(8, np.uint8)
                header[0] = (pid >> 8) & 0xFF
                header[1] = pid & 0xFF
                header[2] = ch
                header[3:] = rng.integers(0, 256, 5, dtype=np.uint8)
                plen = int(rng.integers(1, P + 1))
                payload = rng.integers(0, 256, plen, dtype=np.uint8)
                if not tx_node.transmit_packet(ch, header, payload):
                    raise RuntimeError(f"channel {ch} refused packet")
                sent[pid] = payload
                pid += 1
        burst.append(tx_node.wait_for_tx_to_complete())
        rx_stream = air.propagate(tx_radio, rx_radio,
                                  np.concatenate(burst), ppm_error=hop_ppm)
        # RX listen window at the other endpoint
        frames = rx_node.rx.execute(rx_stream) + rx_node.rx.flush()
        for f in frames:
            stats.update(f)
            fpid = (int(f["header"][0]) << 8) | int(f["header"][1])
            if (f["payload_valid"] and fpid in sent and
                    np.array_equal(f["payload"], sent[fpid])):
                ok_payload += 1
            if verbose:
                print("  round %d %s rx ch %2d: pid=%5u pay:%s len=%d" %
                      (rd, "a->b" if rd % 2 == 0 else "b->a", f["channel"],
                       fpid, "ok" if f["payload_valid"] else "FAIL",
                       f["payload_len"]))
    print("multichannel_txrx results:")
    stats.report(_time.time() - _t0)
    print("    payload-exact       : %6u / %u sent" % (ok_payload, pid))
    return 0 if ok_payload == pid else 1


if __name__ == "__main__":
    sys.exit(main())
