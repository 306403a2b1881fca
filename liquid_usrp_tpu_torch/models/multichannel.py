"""Multichannel OFDM transceivers over a polyphase channelizer.

Port of ``liquid_usrp_tpu/models/multichannel.py``:

* TX (``multichanneltx``): N OFDM frame streams feed bins 0..N-1 of a
  2N-channel polyphase synthesizer (Kaiser m=13, As=60), then an NCO
  centers the spectrum (:func:`make_mctx_step`, :class:`MultichannelTx`).
* RX (``multichannelrx``): NCO mix-down, 2N-channel analyzer (m=7), and the
  N per-channel synchronizers batched into one detect + decode
  (:func:`make_mcrx_step`, :func:`make_mcrx_batched_step`,
  :class:`MultichannelRx`).
* TX + RX (``multichanneltxrx``): the composition, with the TX worker
  thread that runs ahead of the radio and channel-availability polling
  (:class:`MultichannelTxRx`).

The step builders keep the JAX signatures, ``(init_state, step)``.  The RX
builders return the bound methods of an :class:`Mcrx` module, which holds
the device tables (PFB prototype and synchronizer tables) as buffers and
the device the step runs on.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..framing import ofdm, ofdm_sync
from ..framing import payload as payload_codec
from ..ops import iqfmt
from ..ops import nco as nco_mod
from ..ops import pfb as pfb_mod
from ..utils.device import default_device
from ..utils.profiling import span

__all__ = ["MultichannelTx", "MultichannelRx", "MultichannelTxRx", "Mcrx",
           "McrxState",
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

    ``self._cv`` guards the queues, the synthesis state and the worker's
    ahead-buffer, so :meth:`update_data` on one thread and the worker (or
    :meth:`generate_samples`) on another do not race.  The worker thread
    launches its work on ``self.device``, on that device's current stream,
    as the caller's thread does; ``_generate``'s copy to the host is its
    sync point."""

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
        # per-channel pending baseband samples (time-domain frame streams)
        self._queues = [np.zeros(0, np.complex64)
                        for _ in range(num_channels)]
        # the async TX worker (the reference's tx_worker thread, which keeps
        # the radio fed ahead of the consumption cursor); idle until
        # start_worker()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._ahead: list[np.ndarray] = []   # produced, unconsumed samples
        self._ahead_len = 0
        self._max_ahead = 0

    def GetNumChannels(self) -> int:
        return self.num_channels

    def Reset(self):
        """Drop queued packets, the carried synthesis state and the
        worker's ahead-buffer."""
        with self._cv:
            self._queues = [np.zeros(0, np.complex64)
                            for _ in range(self.num_channels)]
            self._state = self._init()
            self._ahead = []
            self._ahead_len = 0

    def is_channel_ready(self, ch: int) -> bool:
        """True when channel ``ch`` has drained its queued frame."""
        with self._cv:
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
        samples = ofdm.assemble_frame(
            self.params, p,
            torch.as_tensor(np.asarray(header, np.uint8), device=self.device),
            torch.as_tensor(np.asarray(payload, np.uint8),
                            device=self.device),
            expansion=self.expansion).cpu().numpy()
        with self._cv:
            # check again under the lock: a concurrent producer may have
            # queued a frame since the check above, and overwriting it
            # would drop that packet
            if len(self._queues[ch]):
                raise RuntimeError(f"channel {ch} not ready for data")
            self._queues[ch] = samples
            self._cv.notify_all()

    def generate_samples(self, n_channel_samples: int) -> np.ndarray:
        """Produce ``2N * n_channel_samples`` output samples: each channel
        contributes ``n_channel_samples`` baseband samples from its queue
        (zeros when idle).  With the worker running, use
        :meth:`read_samples`: the worker owns the generation cursor."""
        with self._cv:
            return self._generate(n_channel_samples)

    def _generate(self, n_channel_samples: int) -> np.ndarray:
        """One synthesis step; the caller holds ``self._cv``."""
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

    # -- async TX worker ----------------------------------------------------
    # The worker pre-generates into a bounded ahead-buffer; the consumer's
    # read_samples() waits on the producer, and the producer waits while
    # max_ahead samples are buffered.

    def start_worker(self, chunk: int = 256, max_ahead: int = 65536):
        """Start ahead-of-cursor production (``chunk`` channel samples a
        step, at most ``max_ahead`` output samples buffered)."""
        with self._cv:
            if self._running:
                return
            self._running = True
            self._max_ahead = int(max_ahead)
        self._worker = threading.Thread(
            target=self._produce_loop, args=(int(chunk),), daemon=True)
        self._worker.start()

    def _produce_loop(self, chunk: int):
        try:
            while True:
                with self._cv:
                    while (self._running
                           and self._ahead_len >= self._max_ahead):
                        self._cv.wait(0.1)
                    if not self._running:
                        return
                    y = self._generate(chunk)
                    self._ahead.append(y)
                    self._ahead_len += len(y)
                    self._cv.notify_all()
        finally:
            # a failed generation must not strand consumers in their wait
            # loops: clear the running flag and wake everyone (the
            # exception itself goes to threading.excepthook)
            with self._cv:
                self._running = False
                self._cv.notify_all()

    @property
    def samples_ahead(self) -> int:
        """Output samples produced ahead of the consumption cursor."""
        with self._cv:
            return self._ahead_len

    def read_samples(self, n: int) -> np.ndarray:
        """Consume ``n`` output samples from the ahead-buffer, waiting
        while the worker produces; generates the rest here when the worker
        is stopped or ``n`` exceeds ``max_ahead`` (the producer parks at
        the bound, so waiting past it would never progress)."""
        with self._cv:
            while (self._running and self._ahead_len < n
                   and self._ahead_len < self._max_ahead):
                self._cv.wait(0.1)
            if self._ahead_len < n:
                miss = n - self._ahead_len
                per_step = 2 * self.num_channels
                y = self._generate(-(-miss // per_step))
                self._ahead.append(y)
                self._ahead_len += len(y)
            # consume from the front, chunk by chunk: O(n) copied a call,
            # not O(buffered)
            out, taken = [], 0
            while taken < n:
                head = self._ahead[0]
                take = min(len(head), n - taken)
                out.append(head[:take])
                if take == len(head):
                    self._ahead.pop(0)
                else:
                    self._ahead[0] = head[take:]
                taken += take
            self._ahead_len -= n
            self._cv.notify_all()
            return (out[0] if len(out) == 1
                    else np.concatenate(out) if out
                    else np.zeros(0, np.complex64))

    def stop_worker(self):
        """Stop the producer; buffered samples stay readable."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join()
            self._worker = None


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
        with span("rx.front_end"):
            nco_state, y = nco_mod.nco_mix_block(
                state.nco, iqfmt.iq_from_any(x.to(self.device)), up=True)
            chz_state, X = pfb_mod.pfb_analyze_block(self.chz, state.chz, y,
                                                     self.h_pol)
            chans = X[:, :N].T.reshape(N, nb, self.sync.block_size)
        return nco_state, chz_state, chans

    def step(self, state: McrxState, x: torch.Tensor):
        """``x``: complex64 ``[2N * block_size * n_blocks]`` or IQ planes
        ``[2, ...]`` -> ``(state', FrameResults)``: one ``rx.dispatch``
        span."""
        with span("rx.dispatch"):
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
    """N-channel uplink analyzer with batched per-channel frame sync.
    ``use_pallas`` is the detect level of ``ofdm_sync.make_sync`` (JAX's
    class takes none and runs its ``"auto"``)."""

    def __init__(self, num_channels: int, M: int = 48, cp_len: int = 6,
                 taper_len: int = 4, callback=None, block_size: int = 4096,
                 max_payload: int = 1024, enable_conv: bool = False,
                 soft: bool = False,
                 expansion: int = payload_codec.EXPANSION, device=None,
                 use_pallas="auto"):
        self.num_channels = num_channels
        self.params = ofdm.make_ofdm_params(M, cp_len, taper_len)
        self.sync = ofdm_sync.make_sync(
            self.params, block_size=block_size, max_payload=max_payload,
            enable_conv=enable_conv, soft=soft, expansion=expansion,
            use_pallas=use_pallas)
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


# ---------------------------------------------------------------------------
# full duplex composition
# ---------------------------------------------------------------------------

class MultichannelTxRx:
    """TX + RX composition (the multichanneltxrx surface: non-blocking
    ``transmit_packet`` and channel-availability polling).  ``rx_kwargs``
    go to :class:`MultichannelRx` (``block_size``, ``max_payload``,
    ``enable_conv``, ``soft``, ``use_pallas`` through its sync, ``device``,
    ...); the TX side takes the same ``device`` and ``expansion``."""

    def __init__(self, num_channels: int, M: int = 48, cp_len: int = 6,
                 taper_len: int = 4, callback=None, **rx_kwargs):
        from .ofdmtxrx import RadioConfig
        self.tx = MultichannelTx(
            num_channels, M, cp_len, taper_len,
            expansion=rx_kwargs.get("expansion", payload_codec.EXPANSION),
            device=rx_kwargs.get("device"))
        self.rx = MultichannelRx(num_channels, M, cp_len, taper_len,
                                 callback=callback, **rx_kwargs)
        self.num_channels = num_channels
        self.radio = RadioConfig()
        self._rx_running = False

    # -- radio parameter surface ---------------------------------------------
    def set_tx_freq(self, f: float):
        self.radio.tx_freq = f

    def set_tx_rate(self, r: float):
        self.radio.tx_rate = r

    def set_tx_gain_soft(self, g_db: float):
        self.radio.tx_gain_soft = g_db

    def set_tx_gain_uhd(self, g_db: float):
        self.radio.tx_gain_uhd = g_db

    def set_tx_antenna(self, name: str):
        self.radio.tx_antenna = name

    def set_rx_freq(self, f: float):
        self.radio.rx_freq = f

    def set_rx_rate(self, r: float):
        self.radio.rx_rate = r

    def set_rx_gain_uhd(self, g_db: float):
        self.radio.rx_gain_uhd = g_db

    def set_rx_antenna(self, name: str):
        self.radio.rx_antenna = name

    def reset_tx(self):
        self.tx.Reset()

    def reset_rx(self):
        self.rx.Reset()

    def start_rx(self):
        self._rx_running = True

    def stop_rx(self):
        self._rx_running = False

    def run_rx(self, samples) -> list:
        """Feed mixture samples while RX is started (the rx_worker gate)."""
        if not self._rx_running:
            return []
        return self.rx.execute(samples)

    def transmit_packet(self, ch: int, header, payload, mod=None,
                        fec0=None, fec1=None) -> bool:
        if not self.tx.is_channel_ready(ch):
            return False
        self.tx.update_data(ch, header, payload, mod, fec0, fec1)
        return True

    def is_channel_available(self, ch: int) -> bool:
        return self.tx.is_channel_ready(ch)

    def get_available_channel(self) -> Optional[int]:
        for ch in range(self.num_channels):
            if self.tx.is_channel_ready(ch):
                return ch
        return None

    def wait_for_channel(self, ch: int) -> np.ndarray:
        """Drain samples until channel ``ch`` is ready for data and return
        the drained air (empty when the channel was already free).  With
        the worker running this consumes its ahead-buffer; otherwise
        draining is the sample generation."""
        out = []
        was_waiting = not self.tx.is_channel_ready(ch)
        while not self.tx.is_channel_ready(ch):
            out.append(self.tx.read_samples(512))
        if was_waiting:
            # the frame tail synthesized past the queue-empty edge may
            # still be buffered: include it, so the air carries the packet
            out.append(self.tx.read_samples(self.tx.samples_ahead))
        return (np.concatenate(out) if out
                else np.zeros(0, np.complex64))

    def wait_for_tx_to_complete(self) -> np.ndarray:
        """Drain all queued frames to samples, then what is still buffered
        and the synthesizer's memory (the end-of-burst flush)."""
        out = []
        while not all(self.tx.is_channel_ready(c)
                      for c in range(self.num_channels)):
            out.append(self.tx.read_samples(512))
        flush = 2 * self.tx.chz.P
        out.append(self.tx.read_samples(
            self.tx.samples_ahead + 2 * self.num_channels * flush))
        return (np.concatenate(out) if out
                else np.zeros(0, np.complex64))

    # async TX (start_tx/stop_tx): production runs ahead of the consumer on
    # the worker thread
    def start_tx(self, chunk: int = 256, max_ahead: int = 65536):
        self.tx.start_worker(chunk=chunk, max_ahead=max_ahead)

    def stop_tx(self):
        self.tx.stop_worker()

    def read_tx_samples(self, n: int) -> np.ndarray:
        return self.tx.read_samples(n)
