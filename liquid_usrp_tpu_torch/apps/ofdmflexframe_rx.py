"""ofdmflexframe_rx — receive OFDM frames from an IQ file.

Port of ``liquid_usrp_tpu/apps/ofdmflexframe_rx.py`` (same flags): a line
per frame (RSSI, EVM, CFO, header and payload status), then the aggregate
stats.  Runs on the first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu``
asks for the CPU).  ``--conv`` adds the convolutional and Reed-Solomon
payload FEC branches; ``--soft`` decodes from soft-decision LLRs: exact-ML
Golay headers and soft Viterbi payloads.

    python -m liquid_usrp_tpu_torch.apps.ofdmflexframe_rx -i tx.iq
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..framing.payload import EXPANSION
from ..io.streams import read_iq
from ..models.ofdmtxrx import OfdmTxRx
from .common import RxStats, apply_channel, occupied_power, parse_args

USAGE = """ofdmflexframe_rx -i in.iq [options]
  h     : usage
  i     : input IQ file (required)
  M     : number of subcarriers, default 48
  C     : cyclic prefix length, default 6
  T     : taper length, default 4
  p     : max payload budget in bytes, default 2048 (smaller = lower
          detection latency: the carried overlap scales with it)
  d     : debug dump prefix (writes <prefix>_framesync_debug.m)
  q/v   : quiet / verbose
  --snr/--cfo/--delay/--seed : virtual channel impairments
  --save-state/--load-state : checkpoint/resume the synchronizer state
          (bit-exact across invocations; split a stream anywhere)
  --stream : block-streamed input via the native double-buffered reader
          (constant memory; impairment flags are unsupported in this mode)
  --bf16 : ship RX blocks to the device as bfloat16 I/Q planes
  --ingest c64|bf16|sc8 : general form of --bf16; sc8 ships int8 wire
          codes (full-scale ADC convention, keep |I|,|Q| <= 1)
  e     : decode budget (encoded/decoded expansion), default 3; the
          transmitter prints the value to use for heavy FEC pairs
  --conv : enable convolutional/RS payload FEC decode branches
  --soft : soft-decision (LLR) decode: exact-ML Golay header, soft
          Viterbi for conv payload FECs
"""


def _dump_debug(prefix: str, txrx, stream) -> None:
    """Octave dump of the synchronizer's internals for the strongest frame
    in the first 65,536 samples."""
    from ..framing import ofdm_sync
    from .common import dump_framesync_octave
    n = min(len(stream), 1 << 16)
    cap = ofdm_sync.debug_capture(txrx._sync, stream[:n], txrx.device)
    path = f"{prefix}_framesync_debug.m"
    dump_framesync_octave(path, "ofdmflexframe_rx debug capture",
                          stream[:n], cap)
    print(f"debug capture written to {path}")


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "hi:M:C:T:p:d:e:qv",
                          ["snr=", "cfo=", "delay=", "seed=",
                           "save-state=", "load-state=", "stream",
                           "bf16", "ingest=", "conv", "soft"])
    if "h" in flags:
        print(USAGE)
        return 0
    path = flags.get("i")
    if not path:
        print(USAGE)
        return 1
    M = int(flags.get("M", 48))
    cp = int(flags.get("C", 6))
    taper = int(flags.get("T", 4))
    max_payload = int(flags.get("p", 2048))
    verbose = "q" not in flags

    stats = RxStats()

    def callback(header, header_valid, payload, payload_len, payload_valid,
                 frame_stats):
        stats.update({"header_valid": header_valid,
                      "payload_valid": payload_valid,
                      "payload_len": payload_len})
        if verbose:
            pid = (int(header[0]) << 8) | int(header[1])
            print("  rx frame: pid=%5u, rssi=%6.1f dB, evm=%6.1f dB, "
                  "cfo=%8.5f, hdr:%s, pay:%s" %
                  (pid, frame_stats["rssi"], frame_stats["evm"],
                   frame_stats["cfo"],
                   "ok" if header_valid else "FAIL",
                   "ok" if payload_valid else "FAIL"))

    txrx = OfdmTxRx(M=M, cp_len=cp, taper_len=taper,
                    max_payload=max_payload, callback=callback,
                    enable_conv="conv" in flags, soft="soft" in flags,
                    rx_ingest=flags.get(
                        "ingest", "bf16" if "bf16" in flags else "c64"),
                    expansion=int(flags.get("e", EXPANSION)))
    streaming = "stream" in flags
    if streaming and any(k in flags for k in ("snr", "cfo", "delay")):
        print("--stream does not compose with impairment flags")
        return 1
    if not streaming:
        stream = read_iq(path)
        stream = apply_channel(stream, flags,
                               signal_power=occupied_power(stream))
    bs = txrx._sync.block_size
    if "load-state" in flags:
        from ..utils.checkpoint import load_state
        like = {"sync": txrx._rx_state,
                "pending": torch.zeros(bs, dtype=torch.complex64),
                "pending_len": torch.tensor(0, dtype=torch.int32)}
        data = load_state(flags["load-state"], like)
        txrx._rx_state = data["sync"]
        txrx._pending = data["pending"].numpy()[: int(data["pending_len"])]
    t0 = time.time()
    txrx.start_rx()
    if streaming:
        # native double-buffered reader + host prefetch thread: constant
        # memory, device decode overlapped with file I/O
        from ..io.native import NativeReader, available
        from ..io.pipeline import BlockPrefetcher
        if available():
            source = NativeReader(path, bs)
        else:
            whole = read_iq(path)
            source = iter(np.array_split(whole, max(1, len(whole) // bs)))
        for blk in BlockPrefetcher(source):
            txrx.run_rx(blk)
        if "save-state" not in flags:
            txrx.run_rx(np.zeros(0, np.complex64), flush=True)
    else:
        # a run that saves its state continues later: flush only otherwise
        txrx.run_rx(stream, flush="save-state" not in flags)
    runtime = time.time() - t0
    if "save-state" in flags:
        from ..utils.checkpoint import save_state
        pend = txrx._pending
        padded = np.zeros(bs, np.complex64)
        padded[: len(pend)] = pend
        save_state(flags["save-state"],
                   {"sync": txrx._rx_state,
                    "pending": torch.from_numpy(padded),
                    "pending_len": torch.tensor(len(pend),
                                                dtype=torch.int32)})
        print("synchronizer state saved to %s" % flags["save-state"])
    if "d" in flags and not streaming:
        _dump_debug(flags["d"], txrx, stream)
    print("ofdmflexframe_rx results:")
    stats.report(runtime)
    return 0


if __name__ == "__main__":
    sys.exit(main())
