"""Multichannel OFDM transceivers over a polyphase channelizer.

Port of ``liquid_usrp_tpu/models/multichannel.py``:

* TX (``multichanneltx``): N OFDM frame streams feed bins 0..N-1 of a
  2N-channel polyphase synthesizer (Kaiser m=13, As=60), then an NCO
  centers the spectrum (:func:`make_mctx_step`, :class:`MultichannelTx`).
* RX (``multichannelrx``): NCO mix-down, 2N-channel analyzer (m=7), and the
  N per-channel synchronizers batched into one detect + decode
  (:func:`make_mcrx_step`, :func:`make_mcrx_batched_step`,
  :class:`MultichannelRx`).

The step builders keep the JAX signatures, ``(init_state, step)``.  The RX
builders return the bound methods of an :class:`Mcrx` module, which holds
the device tables (PFB prototype and synchronizer tables) as buffers and
the device the step runs on.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..framing import ofdm, ofdm_sync
from ..framing import payload as payload_codec
from ..ops import iqfmt
from ..ops import nco as nco_mod
from ..ops import pfb as pfb_mod
from ..utils.device import default_device

__all__ = ["MultichannelTx", "MultichannelRx", "Mcrx", "McrxState",
           "MctxState", "make_mcrx_step", "make_mcrx_batched_step",
           "make_mctx_step"]


def _center_offset(num_channels: int) -> float:
    """Spectrum-centering NCO frequency (rad/sample)."""
    return -0.5 * (num_channels - 1) / num_channels * np.pi


# ---------------------------------------------------------------------------
# TX
# ---------------------------------------------------------------------------

class MctxState(NamedTuple):
    nco: nco_mod.NcoState
    chz: pfb_mod.PfbchState


def make_mctx_step(num_channels: int, device=None):
    """``(init_state, step)`` for the synthesis side: ``step(state,
    Y[B, 2N]) -> (state', y[2N*B])`` (channels in bins 0..N-1).
    ``device=None``: ``utils.device.default_device()``."""
    N = num_channels
    device = default_device(device)
    chz = pfb_mod.pfbch_create(2 * N, m=13, As=60.0)
    h = torch.as_tensor(chz.h_pol).to(device)

    def init_state() -> MctxState:
        return MctxState(nco=nco_mod.nco_init(_center_offset(N),
                                              device=device),
                         chz=pfb_mod.pfbch_state(chz, device))

    def step(state: MctxState, Y: torch.Tensor):
        chz_state, y = pfb_mod.pfb_synthesize_block(chz, state.chz, Y, h)
        nco_state, y = nco_mod.nco_mix_block(state.nco, y, up=True)
        return MctxState(nco=nco_state, chz=chz_state), y

    return init_state, step


class MultichannelTx:
    """N-channel OFDM downlink synthesizer (host scheduling + device DSP).

    The reference's asynchronous TX worker thread is not ported yet."""

    def __init__(self, num_channels: int, M: int = 48, cp_len: int = 6,
                 taper_len: int = 4, expansion: int = payload_codec.EXPANSION,
                 device=None):
        self.num_channels = num_channels
        self.device = default_device(device)
        self.params = ofdm.make_ofdm_params(M, cp_len, taper_len)
        self.expansion = int(expansion)
        self.props = [ofdm.default_props() for _ in range(num_channels)]
        self.chz = pfb_mod.pfbch_create(2 * num_channels, m=13, As=60.0)
        self._init, self._step = make_mctx_step(num_channels, self.device)
        self._state = self._init()
        self._queues = [np.zeros(0, np.complex64)
                        for _ in range(num_channels)]

    def GetNumChannels(self) -> int:
        return self.num_channels

    def Reset(self):
        """Drop queued packets and the carried synthesis state."""
        self._queues = [np.zeros(0, np.complex64)
                        for _ in range(self.num_channels)]
        self._state = self._init()

    def is_channel_ready(self, ch: int) -> bool:
        """True when channel ``ch`` has drained its queued frame."""
        return len(self._queues[ch]) == 0

    def update_data(self, ch: int, header, payload, mod=None, fec0=None,
                    fec1=None):
        """Queue one packet on channel ``ch``."""
        if not self.is_channel_ready(ch):
            raise RuntimeError(f"channel {ch} not ready for data")
        p = self.props[ch]
        if mod is not None or fec0 is not None or fec1 is not None:
            p = ofdm.FrameProps(
                check=p.check,
                fec0=p.fec0 if fec0 is None else fec0,
                fec1=p.fec1 if fec1 is None else fec1,
                mod=p.mod if mod is None else mod)
            self.props[ch] = p
        frame = ofdm.assemble_frame(
            self.params, p,
            torch.as_tensor(np.asarray(header, np.uint8), device=self.device),
            torch.as_tensor(np.asarray(payload, np.uint8),
                            device=self.device),
            expansion=self.expansion)
        self._queues[ch] = frame.cpu().numpy()

    def generate_samples(self, n_channel_samples: int) -> np.ndarray:
        """Produce ``2N * n_channel_samples`` output samples: each channel
        contributes ``n_channel_samples`` baseband samples from its queue
        (zeros when idle)."""
        N = self.num_channels
        Y = np.zeros((n_channel_samples, 2 * N), dtype=np.complex64)
        for ch in range(N):
            q = self._queues[ch]
            take = min(len(q), n_channel_samples)
            if take:
                Y[:take, ch] = q[:take]
                self._queues[ch] = q[take:]
        self._state, y = self._step(self._state,
                                    torch.as_tensor(Y, device=self.device))
        return y.cpu().numpy()


# ---------------------------------------------------------------------------
# RX
# ---------------------------------------------------------------------------

class McrxState(NamedTuple):
    nco: nco_mod.NcoState
    chz: pfb_mod.PfbchState
    syncs: ofdm_sync.OfdmSyncState      # stacked leading axis [N]


class Mcrx(torch.nn.Module):
    """The fused multichannel RX: NCO mix-down -> 2N-bin PFB analyzer ->
    N-channel batched synchronizer, one ``step`` per chunk of
    ``2N * block_size * n_blocks`` mixture samples.

    Buffers: the PFB prototype ``h_pol`` and the synchronizer's
    :class:`~..framing.ofdm_sync.SyncTables`.  ``n_blocks=None`` is the
    single-block step of :func:`make_mcrx_step` (results ``[N,
    max_frames]``); an integer gives :func:`make_mcrx_batched_step`'s
    results ``[N, n_blocks, max_frames]``.  ``device=None`` (the default of
    every RX and TX entry here) is ``utils.device.default_device()``: the
    first CUDA device, else it raises."""

    def __init__(self, num_channels: int, sync: ofdm_sync.OfdmSync,
                 n_blocks: int | None = None, device=None):
        super().__init__()
        self.num_channels = num_channels
        self.sync = sync
        self.n_blocks = n_blocks
        self.chz = pfb_mod.pfbch_create(2 * num_channels, m=7, As=60.0)
        self.register_buffer("h_pol", torch.as_tensor(self.chz.h_pol),
                             persistent=False)
        self.tables = ofdm_sync.SyncTables(sync)
        self.to(default_device(device))

    @property
    def device(self) -> torch.device:
        return self.h_pol.device

    def init_state(self) -> McrxState:
        N, dev = self.num_channels, self.device
        one = ofdm_sync.sync_init(self.sync, dev)
        return McrxState(
            nco=nco_mod.nco_init(-_center_offset(N), device=dev),
            chz=pfb_mod.pfbch_state(self.chz, dev),
            syncs=ofdm_sync.OfdmSyncState(
                tail=one.tail.expand(N, -1).clone(),
                base=one.base.expand(N).clone()))

    def front_end(self, state: McrxState, x: torch.Tensor):
        """NCO mix-down + PFB analysis of one chunk: ``(nco', chz',
        chans [N, n_blocks, block_size])``."""
        N = self.num_channels
        nb = 1 if self.n_blocks is None else self.n_blocks
        nco_state, y = nco_mod.nco_mix_block(
            state.nco, iqfmt.iq_from_any(x.to(self.device)), up=True)
        chz_state, X = pfb_mod.pfb_analyze_block(self.chz, state.chz, y,
                                                 self.h_pol)
        chans = X[:, :N].T.reshape(N, nb, self.sync.block_size)
        return nco_state, chz_state, chans

    def step(self, state: McrxState, x: torch.Tensor):
        """``x``: complex64 ``[2N * block_size * n_blocks]`` or IQ planes
        ``[2, ...]`` -> ``(state', FrameResults)``."""
        nco_state, chz_state, chans = self.front_end(state, x)
        sync_states, res = ofdm_sync.sync_channels_batched(
            self.sync, state.syncs, chans, self.tables)
        if self.n_blocks is None:
            res = ofdm_sync.FrameResults(*(v[:, 0] for v in res))
        return McrxState(nco=nco_state, chz=chz_state,
                         syncs=sync_states), res

    forward = step


def make_mcrx_step(num_channels: int, sync: ofdm_sync.OfdmSync,
                   device=None):
    """``(init_state, step)`` for the fused multichannel RX: ``step(state,
    x[2N*B]) -> (state', FrameResults[N, max_frames])``, ``B =
    sync.block_size`` channel samples per channel per step."""
    rx = Mcrx(num_channels, sync, None, device)
    return rx.init_state, rx.step


def make_mcrx_batched_step(num_channels: int, sync: ofdm_sync.OfdmSync,
                           n_blocks: int, device=None):
    """Multi-block batched RX step: ``step(state, x[2N * block_size *
    n_blocks]) -> (state', FrameResults[N, n_blocks, max_frames])`` — the
    whole chunk is mixed and channelized in one pass and the detect
    front-end runs over blocks and channels at once."""
    rx = Mcrx(num_channels, sync, n_blocks, device)
    return rx.init_state, rx.step


class MultichannelRx:
    """N-channel uplink analyzer with batched per-channel frame sync."""

    def __init__(self, num_channels: int, M: int = 48, cp_len: int = 6,
                 taper_len: int = 4, callback=None, block_size: int = 4096,
                 max_payload: int = 1024, enable_conv: bool = False,
                 soft: bool = False,
                 expansion: int = payload_codec.EXPANSION, device=None):
        self.num_channels = num_channels
        self.params = ofdm.make_ofdm_params(M, cp_len, taper_len)
        self.sync = ofdm_sync.make_sync(
            self.params, block_size=block_size, max_payload=max_payload,
            enable_conv=enable_conv, soft=soft, expansion=expansion)
        self.callback = callback
        self.rx = Mcrx(num_channels, self.sync, None, device)
        self._state = self.rx.init_state()
        self._pending = np.zeros(0, np.complex64)

    def GetNumChannels(self) -> int:
        return self.num_channels

    def Reset(self):
        """Drop the carried analyzer and per-channel sync state."""
        self._state = self.rx.init_state()
        self._pending = np.zeros(0, np.complex64)

    @property
    def granularity(self) -> int:
        return 2 * self.num_channels * self.sync.block_size

    def execute(self, samples: np.ndarray) -> list[dict]:
        """Feed mixture samples; returns the decoded frames across
        channels (each also passed to ``callback``)."""
        buf = np.concatenate([self._pending,
                              np.asarray(samples, np.complex64)])
        g = self.granularity
        frames = []
        while len(buf) >= g:
            chunk, buf = buf[:g], buf[g:]
            self._state, res = self.rx.step(
                self._state, torch.as_tensor(chunk, device=self.rx.device))
            res = ofdm_sync.FrameResults(*(v.cpu().numpy() for v in res))
            for ch, i in zip(*np.nonzero(res.detected)):
                n = int(res.payload_len[ch, i])
                row = {
                    "channel": int(ch),
                    "t": int(res.t_start[ch, i]),
                    "header": res.header[ch, i],
                    "header_valid": bool(res.header_valid[ch, i]),
                    "payload": res.payload[ch, i][:n],
                    "payload_valid": bool(res.payload_valid[ch, i]),
                    "payload_len": n,
                    "stats": {"rssi": float(res.rssi[ch, i]),
                              "evm": float(res.evm[ch, i]),
                              "cfo": float(res.cfo[ch, i])},
                }
                frames.append(row)
                if self.callback is not None:
                    self.callback(**row)
        self._pending = buf.copy()
        return frames

    def flush(self) -> list[dict]:
        """Push zeros until the carried overlap has drained."""
        pad = self.granularity * (
            1 + (2 * self.num_channels * self.sync.overlap)
            // self.granularity + 1)
        return self.execute(np.zeros(pad, np.complex64))

    def channelize(self, samples: np.ndarray) -> np.ndarray:
        """Mixture -> per-channel baseband streams ``[N, len // 2N]``
        through the same NCO + PFB front end, from a fresh state."""
        N = self.num_channels
        g = 2 * N
        x = np.asarray(samples, np.complex64)
        x = torch.as_tensor(x[: (len(x) // g) * g], device=self.rx.device)
        _, y = nco_mod.nco_mix_block(
            nco_mod.nco_init(-_center_offset(N), device=self.rx.device), x,
            up=True)
        _, X = pfb_mod.pfb_analyze_block(
            self.rx.chz, pfb_mod.pfbch_state(self.rx.chz, self.rx.device), y,
            self.rx.h_pol)
        return X[:, :N].T.cpu().numpy()
