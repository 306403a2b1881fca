"""halfduplex_txrx — stop-and-wait ARQ over a virtual air loopback.

Port of ``liquid_usrp_tpu/apps/halfduplex_txrx.py`` (same flags, seeds and
output): node A transmits a packet, node B acknowledges every valid one by
echoing the header it decoded, and A retries on a miss (``-R`` retries a
packet).  Two ``OfdmTxRx`` endpoints share one carrier through a
``VirtualAir`` whose frequency offset follows from the endpoints' radio
configs (``--ppm`` mistunes node B's oscillator).  Both endpoints run on
the first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.halfduplex_txrx -N 5
"""
from __future__ import annotations

import sys

import numpy as np

from ..io.radio import VirtualAir
from ..models.ofdmtxrx import OfdmTxRx
from .common import parse_args

USAGE = """halfduplex_txrx [options]
  h : usage                     N : packets (5)
  P : payload bytes (64)        M : subcarriers (48)
  C : cyclic prefix (6)         R : max retries per packet (3)
  q : quiet
  --snr : link SNR dB (25)      --ppm : node-B LO error, ppm (0.5)
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hN:P:M:C:R:q", ["snr=", "ppm=", "seed="])
    if "h" in flags:
        print(USAGE)
        return 0
    num_packets = int(flags.get("N", 5))
    P = int(flags.get("P", 64))
    M = int(flags.get("M", 48))
    cp = int(flags.get("C", 6))
    retries = int(flags.get("R", 3))
    snr = float(flags.get("snr", 25.0))
    ppm = float(flags.get("ppm", 0.5))
    verbose = "q" not in flags
    rng = np.random.default_rng(11)

    node_a = OfdmTxRx(M=M, cp_len=cp, taper_len=min(4, cp),
                      max_payload=max(P, 64))
    node_b = OfdmTxRx(M=M, cp_len=cp, taper_len=min(4, cp),
                      max_payload=max(P, 64))
    air = VirtualAir(snr_db=snr, seed=int(flags.get("seed", 7)))
    node_b.start_rx()
    node_a.start_rx()

    delivered = 0
    attempts = 0
    for pid in range(num_packets):
        header = np.empty(8, np.uint8)
        header[0] = (pid >> 8) & 0xFF
        header[1] = pid & 0xFF
        header[2:] = rng.integers(0, 256, 6, dtype=np.uint8)
        payload = rng.integers(0, 256, P, dtype=np.uint8)
        got_ack = False
        for attempt in range(retries + 1):
            attempts += 1
            node_a.transmit_packet(header, payload)
            # B's oscillator runs `ppm` fast relative to A: the A->B and
            # B->A hops see the derived CFO with opposite signs
            rx = air.propagate(node_a.radio, node_b.radio,
                               node_a.drain_tx(), ppm_error=-ppm)
            frames = node_b.run_rx(rx, flush=True)
            # ACK only a fully valid packet — a frame whose payload CRC
            # failed must be retransmitted, that is the point of ARQ
            good = [f for f in frames if f["payload_valid"]]
            if not good:
                continue
            # B acks by echoing the header IT DECODED back to A (B has
            # no access to A's ground truth)
            node_b.transmit_packet(np.asarray(good[0]["header"],
                                              dtype=np.uint8),
                                   np.zeros(1, np.uint8))
            ack = air.propagate(node_b.radio, node_a.radio,
                                node_b.drain_tx(), ppm_error=+ppm)
            acks = node_a.run_rx(ack, flush=True)
            if any(f["header_valid"] and
                   (int(f["header"][0]) << 8 | int(f["header"][1])) == pid
                   for f in acks):
                got_ack = True
                break
        if got_ack:
            delivered += 1
        if verbose:
            print("  packet %3d: %s (%d attempt%s)" %
                  (pid, "delivered" if got_ack else "LOST", attempt + 1,
                   "s" if attempt else ""))
    print("halfduplex_txrx: %d/%d delivered, %d transmissions" %
          (delivered, num_packets, attempts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
