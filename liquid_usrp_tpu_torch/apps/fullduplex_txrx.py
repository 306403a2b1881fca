"""fullduplex_txrx — simultaneous TX and RX over frequency-separated links.

Port of ``liquid_usrp_tpu/apps/fullduplex_txrx.py`` (same flags, seeds and
output): each node transmits on one carrier and receives on a second one
``--offset`` away (``-R`` swaps the roles).  Both nodes' TX timelines lie on
one clock with overlapping bursts, each direction propagates through its
own ``VirtualAir`` with a frequency offset derived from the radio configs,
and the receive loop advances both directions block-interleaved.  Exits 0
only if every frame arrives in both directions.  Both endpoints run on the
first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.fullduplex_txrx -N 5
"""
from __future__ import annotations

import sys

import numpy as np

from ..io.radio import VirtualAir
from ..models.ofdmtxrx import OfdmTxRx
from .common import RxStats, parse_args

USAGE = """fullduplex_txrx [options]
  h : usage                     N : frames each direction (5)
  P : payload bytes (800)       M : subcarriers (48)
  C : cyclic prefix (6)         R : swap TX/RX carrier roles
  q : quiet
  --snr  : link SNR dB (25)     --ppm : node-B LO error, ppm (0.5)
  --offset : duplex carrier separation Hz (100e6)
"""


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hN:P:M:C:Rq",
                          ["snr=", "ppm=", "offset=", "seed="])
    if "h" in flags:
        print(USAGE)
        return 0
    num_frames = int(flags.get("N", 5))
    P = int(flags.get("P", 800))
    M = int(flags.get("M", 48))
    cp = int(flags.get("C", 6))
    snr = float(flags.get("snr", 25.0))
    ppm = float(flags.get("ppm", 0.5))
    offset = float(flags.get("offset", 100e6))
    swap = "R" in flags
    verbose = "q" not in flags
    seed = int(flags.get("seed", 13))
    rng = np.random.default_rng(seed)

    a = OfdmTxRx(M=M, cp_len=cp, taper_len=min(4, cp), max_payload=2048)
    b = OfdmTxRx(M=M, cp_len=cp, taper_len=min(4, cp), max_payload=2048)
    # duplex frequency plan (the reference's src/fullduplex_txrx.cc:66-143):
    # A transmits on fc and listens on fc+offset; B is the mirror.  -R
    # swaps the roles.
    fc = a.radio.tx_freq
    f_lo, f_hi = fc, fc + offset
    if swap:
        f_lo, f_hi = f_hi, f_lo
    a.set_tx_freq(f_lo)
    a.set_rx_freq(f_hi)
    b.set_tx_freq(f_hi)
    b.set_rx_freq(f_lo)

    air_ab = VirtualAir(snr_db=snr, seed=seed + 1)
    air_ba = VirtualAir(snr_db=snr, seed=seed + 2)

    def build_timeline(node: OfdmTxRx, stagger: int):
        """Continuous TX sample timeline: frames + idle gaps."""
        bufs = [np.zeros(stagger, np.complex64)]
        for pid in range(num_frames):
            header = np.empty(8, np.uint8)
            header[0] = (pid >> 8) & 0xFF
            header[1] = pid & 0xFF
            header[2:] = rng.integers(0, 256, 6, dtype=np.uint8)
            payload = rng.integers(0, 256, P, dtype=np.uint8)
            node.transmit_packet(header, payload)
            bufs.append(node.drain_tx())
            bufs.append(np.zeros(int(rng.integers(200, 500)), np.complex64))
        return np.concatenate(bufs)

    tx_a = build_timeline(a, 0)
    # B's bursts start mid-way through A's first frame: the two directions
    # overlap in time and are separated only by the duplex carrier plan
    tx_b = build_timeline(b, len(tx_a) // (2 * max(num_frames, 1)))
    T = max(len(tx_a), len(tx_b))
    tx_a = np.concatenate([tx_a, np.zeros(T - len(tx_a), np.complex64)])
    tx_b = np.concatenate([tx_b, np.zeros(T - len(tx_b), np.complex64)])

    # node B's reference oscillator is `ppm` off; both directions see the
    # derived CFO with opposite signs (default plan: B transmits on the
    # high carrier and receives the low one)
    rx_at_b = air_ab.propagate(a.radio, b.radio, tx_a, ppm_error=-ppm)
    rx_at_a = air_ba.propagate(b.radio, a.radio, tx_b, ppm_error=+ppm)
    cfo_ab = 2 * np.pi * (a.radio.tx_freq - b.radio.rx_freq
                          - a.radio.tx_freq * ppm * 1e-6) / b.radio.rx_rate
    cfo_ba = 2 * np.pi * (b.radio.tx_freq * (1 + ppm * 1e-6)
                          - a.radio.rx_freq) / a.radio.rx_rate

    import time as _time
    t0 = _time.time()
    a.start_rx()
    b.start_rx()
    stats_ab, stats_ba = RxStats(), RxStats()
    cfo_meas = {"ab": [], "ba": []}

    def deliver(direction, stats, frames):
        for f in frames:
            stats.update(f)
            cfo_meas[direction].append(f["stats"]["cfo"])
            if verbose:
                pid = (int(f["header"][0]) << 8) | int(f["header"][1])
                print("  rx %s pid=%5u rssi=%6.1f dB cfo=%+.5f rad/sample "
                      "pay:%s" % (direction, pid, f["stats"]["rssi"],
                                  f["stats"]["cfo"],
                                  "ok" if f["payload_valid"] else "FAIL"))

    # block-interleaved duplex loop: each chunk index is one shared time
    # slot in which BOTH nodes are transmitting and receiving
    chunk = 8192
    for lo in range(0, T, chunk):
        deliver("ab", stats_ab, b.run_rx(rx_at_b[lo:lo + chunk]))
        deliver("ba", stats_ba, a.run_rx(rx_at_a[lo:lo + chunk]))
    deliver("ab", stats_ab, b.run_rx(np.zeros(0, np.complex64), flush=True))
    deliver("ba", stats_ba, a.run_rx(np.zeros(0, np.complex64), flush=True))

    print("fullduplex_txrx role plan: A tx %.1f MHz / rx %.1f MHz%s" %
          (a.radio.tx_freq / 1e6, a.radio.rx_freq / 1e6,
           "  (-R swapped)" if swap else ""))
    for name, stats, exp, meas in (("a->b", stats_ab, cfo_ab, cfo_meas["ab"]),
                                   ("b->a", stats_ba, cfo_ba, cfo_meas["ba"])):
        print("fullduplex_txrx results (%s):" % name)
        stats.report(_time.time() - t0)
        if meas:
            print("    derived cfo         : %+.5f rad/sample "
                  "(measured %+.5f)" % (exp, float(np.mean(meas))))
    ok = (stats_ab.num_valid_packets == num_frames and
          stats_ba.num_valid_packets == num_frames)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
