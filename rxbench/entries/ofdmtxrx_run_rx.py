"""The single-channel receiver: ``OfdmTxRx.run_rx`` after ``start_rx()``,
one call a host buffer of ``batch_blocks`` blocks, so that each call is one
batched dispatch (the whole-file mode of ``apps/ofdmflexframe_rx.py``).
``run_rx`` returns the decoded frames as dict rows, on the host.
"""
from __future__ import annotations

import numpy as np

from liquid_usrp_tpu_torch.models.ofdmtxrx import OfdmTxRx


class Entry:
    def __init__(self, config: dict, device, ingest: str = "c64"):
        self._rx = OfdmTxRx(
            M=config["M"], cp_len=config["cp_len"],
            taper_len=config["taper_len"], block_size=config["block_size"],
            batch_blocks=config["batch_blocks"],
            max_payload=config["max_payload"],
            enable_conv=config["enable_conv"],
            expansion=config["expansion"], rx_ingest=ingest, device=device)
        self._rx.start_rx()
        self.blocks_per_dispatch = config["batch_blocks"]
        self.dispatch_samples = config["block_size"] * config["batch_blocks"]
        self._frames: list = []

    def host_input(self, chunk: np.ndarray):
        return chunk

    def reset(self):
        self._rx.reset_rx()
        self._frames = []

    def run(self, buffers, clock):
        for buf in buffers:
            clock.called()
            self._frames += self._rx.run_rx(buf)
            clock.done()

    def rows(self) -> dict:
        f = self._frames
        return {
            "channel": np.zeros(len(f), np.int64),
            "t": np.array([r["t"] for r in f], np.int64),
            "header": [r["header"] for r in f],
            "payload": [r["payload"] for r in f],
            "payload_len": np.array([r["payload_len"] for r in f]),
            "header_valid": np.array([r["header_valid"] for r in f], bool),
            "payload_valid": np.array([r["payload_valid"] for r in f],
                                      bool),
            "rssi": np.array([r["stats"]["rssi"] for r in f], np.float64),
            "evm": np.array([r["stats"]["evm"] for r in f], np.float64),
            "cfo": np.array([r["stats"]["cfo"] for r in f], np.float64),
        }
