"""The multichannel receiver's main path: ``io/pipeline.py::run_pipelined``
driving ``Mcrx.step`` (``make_mcrx_batched_step``) over host chunks.

The window hands ``run_pipelined`` a source of pageable host buffers (as a
file or a radio buffer would give them); the program stages them itself.
The step it gets is the program's, wrapped only to read the clock, and
``on_results`` is the benchmark's sink: it brings each dispatch's
``FrameResults`` to the host in one copy and keeps the detected rows.
"""
from __future__ import annotations

import numpy as np
import torch

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.io.pipeline import run_pipelined
from liquid_usrp_tpu_torch.models.multichannel import make_mcrx_batched_step

from ..sink import frame_rows, to_host


class Entry:
    def __init__(self, config: dict, device, ingest: str = "c64"):
        N = config["num_channels"]
        params = ofdm.make_ofdm_params(config["M"], config["cp_len"],
                                       config["taper_len"])
        sync = ofdm_sync.make_sync(
            params, block_size=config["block_size"],
            max_payload=config["max_payload"],
            max_frames=config["max_frames"],
            expansion=config["expansion"],
            use_pallas=config["use_pallas"])
        self._init, self._step = make_mcrx_batched_step(
            N, sync, config["n_blocks"], device)
        self.blocks_per_dispatch = config["n_blocks"]
        self.dispatch_samples = 2 * N * config["block_size"] * \
            config["n_blocks"]
        self.ingest = ingest
        self._rows: list = []

    def host_input(self, chunk: np.ndarray):
        """complex64 as it is; ``"bf16"``: host bfloat16 planes ``[2,
        n]``, which ``run_pipelined`` hands on as they are."""
        if self.ingest == "c64":
            return chunk
        t = torch.from_numpy(chunk)
        return torch.stack([t.real, t.imag]).to(torch.bfloat16)

    def reset(self):
        self._rows = []

    def run(self, buffers, clock):
        def step(state, x):
            clock.called()
            return self._step(state, x)

        def on_results(res):
            host = to_host(res)
            clock.done()
            self._rows.append(host)

        run_pipelined(buffers, step, self._init(), on_results=on_results)

    def rows(self) -> dict:
        return frame_rows(self._rows)
