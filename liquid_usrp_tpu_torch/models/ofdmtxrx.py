"""ofdmtxrx — single-channel OFDM packet transceiver.

Port of ``liquid_usrp_tpu/models/ofdmtxrx.py`` (the reference's ``ofdmtxrx``
class): constructor checks and defaults, the radio-parameter setters,
``transmit_packet`` with the soft gain, symbol-granular TX
(``assemble_frame``/``write_symbol``/``end_transmit_frame``), and the
block-wise receiver :meth:`OfdmTxRx.run_rx`, which delivers decoded frames
as dict rows and to a callback.  Runs of ``batch_blocks`` full blocks go
through ``ofdm_sync.sync_blocks_batched`` in one dispatch, the rest through
the single-block step; each dispatch copies its results to the host once.

The transceiver runs on ``device`` (by default the first CUDA device; it
raises without one unless ``LIQUID_USRP_TORCH_DEVICE`` names another, see
``utils/device.py``).  Its synchronizer resolves ``use_pallas="auto"`` to 1:
kernel B1 detects, and :meth:`OfdmTxRx.debug_print` takes its metric from
kernel B3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..framing import ofdm, ofdm_sync
from ..framing import payload as payload_codec
from ..ops import fec as fec_mod
from ..ops import modem as modem_mod
from ..utils.device import default_device
from ..utils.profiling import span

__all__ = ["OfdmTxRx", "RadioConfig"]


@dataclass
class RadioConfig:
    """Virtual radio front-end state (the reference's multi_usrp surface);
    the defaults are the reference's."""
    tx_freq: float = 462.0e6
    tx_rate: float = 500e3
    tx_gain_soft: float = -12.0   # dB
    tx_gain_uhd: float = 40.0     # dB (metadata only)
    rx_freq: float = 462.0e6
    rx_rate: float = 500e3
    rx_gain_uhd: float = 20.0
    tx_antenna: str = "TX/RX"     # metadata
    rx_antenna: str = "RX2"


def _to_host(res):
    """Every field of the results NamedTuple ``res`` (``FrameResults``,
    ``FlexResults``) as NumPy, in one device-to-host copy: the fields travel
    packed as bytes."""
    packed = torch.cat([v.contiguous().reshape(-1).view(torch.uint8)
                        for v in res]).cpu().numpy()
    out, off = [], 0
    for v in res:
        dt = torch.empty(0, dtype=v.dtype).numpy().dtype
        n = v.numel() * v.element_size()
        out.append(packed[off:off + n].view(dt).reshape(tuple(v.shape)))
        off += n
    return type(res)(*out)


class OfdmTxRx:
    """Single-channel OFDM packet transceiver over IQ stream endpoints."""

    def __init__(self, M: int = 48, cp_len: int = 6, taper_len: int = 4,
                 callback: Optional[Callable] = None,
                 block_size: int = 16384, max_payload: int = 2048,
                 rx_transform: Optional[Callable] = None,
                 batch_blocks: int = 8, rx_ingest: str = "c64",
                 enable_conv: bool = False, soft: bool = False,
                 expansion: int = payload_codec.EXPANSION, device=None):
        # the reference constructor's checks
        if M < 8:
            raise ValueError("number of subcarriers must be at least 8")
        if cp_len < 1:
            raise ValueError("cyclic prefix length must be at least 1")
        if taper_len > cp_len:
            raise ValueError("taper length cannot exceed cyclic prefix")
        if rx_ingest not in ("c64", "bf16", "sc8"):
            raise ValueError(f"unknown rx_ingest {rx_ingest!r}")
        self.device = default_device(device)
        self.params = ofdm.make_ofdm_params(M, cp_len, taper_len)
        self.props = ofdm.default_props()
        self.radio = RadioConfig()
        self.callback = callback
        self.expansion = int(expansion)
        self._sync = ofdm_sync.make_sync(self.params, block_size=block_size,
                                         max_payload=max_payload,
                                         enable_conv=enable_conv, soft=soft,
                                         expansion=self.expansion)
        self._step = ofdm_sync.make_sync_step(self._sync)
        self._rx_state = ofdm_sync.sync_init(self._sync, self.device)
        self._pending = np.zeros(0, np.complex64)
        self._rx_running = False
        self._batch_blocks = max(1, int(batch_blocks))
        # transform between receive and sync, on the device: the functional
        # form of the reference's blocking-RX buffer handshake
        self.rx_transform = rx_transform
        # device-ingest format of RX blocks: "c64"; "bf16" planes (half the
        # host-to-device bytes); "sc8" int8 wire codes (a quarter; +-127 <->
        # +-1.0, the caller is the AGC, out-of-range samples clip)
        self.rx_ingest = rx_ingest
        self._tx_buffer: list[np.ndarray] = []
        self._assembled: Optional[np.ndarray] = None
        self._assembled_pos = 0
        self._debug = False
        self._debug_samples: Optional[np.ndarray] = None

    # -- radio parameter surface -------------------------------------------
    def set_tx_freq(self, f: float):
        self.radio.tx_freq = f

    def set_tx_rate(self, r: float):
        self.radio.tx_rate = r

    def set_tx_gain_soft(self, g_db: float):
        self.radio.tx_gain_soft = g_db

    def set_tx_gain_uhd(self, g_db: float):
        self.radio.tx_gain_uhd = g_db

    def set_rx_freq(self, f: float):
        self.radio.rx_freq = f

    def set_rx_rate(self, r: float):
        self.radio.rx_rate = r

    def set_rx_gain_uhd(self, g_db: float):
        self.radio.rx_gain_uhd = g_db

    def set_tx_antenna(self, name: str):
        self.radio.tx_antenna = name

    def set_rx_antenna(self, name: str):
        self.radio.rx_antenna = name

    # -- TX ----------------------------------------------------------------
    def set_properties(self, check=None, fec0=None, fec1=None, mod=None):
        """The frame-generator properties (names or enum ids)."""
        def res(v, cur, parser):
            if v is None:
                return cur
            return parser(v) if isinstance(v, str) else v
        self.props = ofdm.FrameProps(
            check=res(check, self.props.check,
                      lambda s: {"none": 0, "crc16": 1,
                                 "crc32": 2}[s.lower()]),
            fec0=res(fec0, self.props.fec0, fec_mod.fec_from_name),
            fec1=res(fec1, self.props.fec1, fec_mod.fec_from_name),
            mod=res(mod, self.props.mod, modem_mod.mod_from_name),
        )

    def _frame(self, header, payload) -> np.ndarray:
        """One frame with the soft gain applied, as host complex64."""
        g = 10.0 ** (self.radio.tx_gain_soft / 20.0)
        frame = ofdm.assemble_frame(
            self.params, self.props,
            torch.as_tensor(np.asarray(header, np.uint8), device=self.device),
            torch.as_tensor(np.asarray(payload, np.uint8),
                            device=self.device),
            expansion=self.expansion,
            rx_max_payload=self._sync.max_payload) * g
        return frame.cpu().numpy()

    def transmit_packet(self, header, payload, mod=None, fec0=None,
                        fec1=None) -> np.ndarray:
        """Assemble and soft-gain a frame (with optional per-packet
        property overrides); returns and queues its samples."""
        self.set_properties(fec0=fec0, fec1=fec1, mod=mod)
        out = self._frame(header, payload)
        self._tx_buffer.append(out)
        return out

    def assemble_frame(self, header, payload, mod=None, fec0=None,
                       fec1=None):
        """Assemble a frame for symbol-granular output
        (:meth:`write_symbol`)."""
        self.set_properties(fec0=fec0, fec1=fec1, mod=mod)
        self._assembled = self._frame(header, payload)
        self._assembled_pos = 0

    def write_symbol(self) -> tuple[np.ndarray, bool]:
        """Next symbol-sized chunk of the assembled frame; (samples, last)."""
        if self._assembled is None:
            raise RuntimeError("no frame assembled")
        step = self.params.M + self.params.cp_len
        start = self._assembled_pos
        chunk = self._assembled[start:start + step]
        self._assembled_pos += len(chunk)
        last = self._assembled_pos >= len(self._assembled)
        if last:
            self._assembled = None
        return chunk, last

    def end_transmit_frame(self) -> np.ndarray:
        """Remaining samples of the assembled frame in one chunk."""
        if self._assembled is None:
            return np.zeros(0, dtype=np.complex64)
        rest = self._assembled[self._assembled_pos:]
        self._assembled = None
        return rest

    def reset_tx(self):
        """Drop queued packets and any partially written assembled frame."""
        self._tx_buffer = []
        self._assembled = None
        self._assembled_pos = 0

    def drain_tx(self) -> np.ndarray:
        """Concatenate and clear everything queued by transmit_packet."""
        if not self._tx_buffer:
            return np.zeros(0, dtype=np.complex64)
        out = np.concatenate(self._tx_buffer)
        self._tx_buffer = []
        return out

    # -- RX ----------------------------------------------------------------
    def start_rx(self):
        self._rx_running = True

    def stop_rx(self):
        self._rx_running = False

    def reset_rx(self):
        self._rx_state = ofdm_sync.sync_init(self._sync, self.device)

    def debug_enable(self):
        """Retain the most recent RX block for :meth:`debug_print`."""
        self._debug = True

    def debug_disable(self):
        self._debug = False
        self._debug_samples = None

    def debug_print(self, prefix: str) -> str:
        """Write the captured block and its detection metric (kernel B3 at
        the default detect level) as an octave file; returns the path."""
        samples = self._debug_samples
        if samples is None:
            raise RuntimeError("debug_enable() first, then run_rx()")
        metric = ofdm_sync._detect_metric(
            self._sync, torch.as_tensor(samples, device=self.device)
        )[0].cpu().numpy()
        path = f"{prefix}_framesync_debug.m"
        with open(path, "w") as f:
            f.write("%% ofdmtxrx debug capture (octave)\nclear all;\n")
            f.write("x = [" + " ".join(
                "(%.5g%+.5gj)" % (v.real, v.imag)
                for v in samples[:4096]) + "];\n")
            f.write("metric = [" + " ".join(
                "%.4f" % v for v in metric[:4096]) + "];\n")
            f.write("figure; subplot(2,1,1); plot(real(x)); ylabel('I'); "
                    "subplot(2,1,2); plot(metric); "
                    "ylabel('detect metric');\n")
        return path

    def _emit_rows(self, res_np, frames: list):
        """Turn one block's host-side FrameResults ([K, ...] NumPy fields)
        into dict rows and callback deliveries."""
        for i in np.nonzero(res_np.detected)[0]:
            row = {
                "t": int(res_np.t_start[i]),
                "header": res_np.header[i],
                "header_valid": bool(res_np.header_valid[i]),
                "payload": res_np.payload[i][: int(res_np.payload_len[i])],
                "payload_valid": bool(res_np.payload_valid[i]),
                "payload_len": int(res_np.payload_len[i]),
                "stats": {
                    "rssi": float(res_np.rssi[i]),
                    "evm": float(res_np.evm[i]),
                    "cfo": float(res_np.cfo[i]),
                },
            }
            frames.append(row)
            if self.callback is not None:
                self.callback(
                    row["header"], row["header_valid"], row["payload"],
                    row["payload_len"], row["payload_valid"], row["stats"])

    def _to_device(self, arr: np.ndarray, shape: tuple) -> torch.Tensor:
        """Host complex64 samples -> the ingest format on the device, in
        the block layout ``shape`` (planes lead with ``[2]``): one
        ``rx.ingest`` span."""
        with span("rx.ingest"):
            if self.rx_ingest == "c64":
                return torch.as_tensor(arr.reshape(shape),
                                       device=self.device)
            from ..io.native import cf32_to_bf16_planes, cf32_to_sc8_planes
            conv = (cf32_to_bf16_planes if self.rx_ingest == "bf16"
                    else cf32_to_sc8_planes)
            return conv(arr.reshape(-1)).reshape((2,) + shape).to(
                self.device)

    def _transform(self, blk: np.ndarray) -> np.ndarray:
        return self.rx_transform(torch.as_tensor(
            blk, device=self.device)).cpu().numpy()

    def run_rx(self, samples: np.ndarray, flush: bool = False) -> list[dict]:
        """Feed IQ samples through the synchronizer; returns decoded frames
        (also delivered to the callback).  Samples short of a block carry
        to the next call; ``flush`` pads zeros until the carried overlap
        has drained.  Each dispatch (a batched chunk or a single block)
        is one ``rx.dispatch`` span: its upload, synchronizer and results
        with the host copy."""
        if not self._rx_running:
            return []
        bs = self._sync.block_size
        samples = np.concatenate([self._pending,
                                  np.asarray(samples, np.complex64)])
        if flush:
            pad = (-(-len(samples) // bs) + 1 +
                   self._sync.overlap // bs + 1) * bs - len(samples)
            samples = np.concatenate(
                [samples, np.zeros(pad, dtype=np.complex64)])
        n_blocks = len(samples) // bs
        nb = self._batch_blocks
        frames: list = []
        b = 0
        last_block = None
        while b < n_blocks:
            if n_blocks - b >= nb and nb > 1:
                chunk = samples[b * bs:(b + nb) * bs].reshape(nb, bs)
                if self.rx_transform is not None:
                    chunk = np.stack([self._transform(row) for row in chunk])
                with span("rx.dispatch"):
                    self._rx_state, res = ofdm_sync.sync_blocks_batched(
                        self._sync, self._rx_state,
                        self._to_device(chunk, (nb, bs)))
                    with span("rx.results"):
                        res_np = _to_host(res)
                        for j in range(nb):
                            self._emit_rows(ofdm_sync.FrameResults(
                                *(f[j] for f in res_np)), frames)
                last_block = chunk[-1]
                b += nb
            else:
                blk = samples[b * bs:(b + 1) * bs]
                if self.rx_transform is not None:
                    blk = self._transform(blk)
                with span("rx.dispatch"):
                    self._rx_state, res = self._step(
                        self._rx_state, self._to_device(blk, (bs,)))
                    with span("rx.results"):
                        self._emit_rows(_to_host(res), frames)
                last_block = blk
                b += 1
        if self._debug and last_block is not None:
            # the last block as the synchronizer saw it (after rx_transform)
            self._debug_samples = np.array(last_block, np.complex64)
        self._pending = samples[n_blocks * bs:]
        return frames
