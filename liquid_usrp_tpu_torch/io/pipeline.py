"""Host I/O overlapped with device DSP.

Port of ``liquid_usrp_tpu/io/pipeline.py``: a producer thread keeps a
bounded queue of IQ blocks filled from any iterator (a file through the
native double-buffered reader, for example) while the consumer drives the
synchronizer step (:class:`BlockPrefetcher`, :func:`run_pipelined`);
PyTorch's asynchronous CUDA launches overlap the device work with the next
block's host preparation, so the handshake is the queue.
:class:`AsyncTxProducer` is the TX side: a worker thread generating sample
blocks ahead of the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..utils.profiling import span

__all__ = ["BlockPrefetcher", "run_pipelined", "AsyncTxProducer"]


class BlockPrefetcher:
    """Producer thread filling a bounded block queue from an iterator.  An
    error raised by the source is raised again in the consumer."""

    def __init__(self, source: Iterable[np.ndarray], depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = iter(source)
        self._done = object()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        try:
            for blk in self._src:
                self._q.put(blk)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            # a source failure must reach the consumer, not end the stream
            # silently as if the capture were simply shorter
            self._q.put(_SourceError(e))
        finally:
            self._q.put(self._done)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            item = self._q.get()
            if item is self._done:
                return
            if isinstance(item, _SourceError):
                raise item.error
            yield item


class _SourceError:
    """An exception of the source, carried through the queue."""

    def __init__(self, error: BaseException):
        self.error = error


def _state_device(state) -> torch.device | None:
    """The device of the first tensor in a state tree."""
    if isinstance(state, torch.Tensor):
        return state.device
    if isinstance(state, (tuple, list)):
        for v in state:
            dev = _state_device(v)
            if dev is not None:
                return dev
    return None


def run_pipelined(source: Iterable[np.ndarray], step: Callable, state,
                  on_results: Callable | None = None, depth: int = 4,
                  block_size: int | None = None):
    """Drive ``step(state, block) -> (state, results)`` over a prefetched
    stream; returns the final state.

    ``source`` yields IQ blocks (ragged complex blocks are re-chunked to
    ``block_size`` when given): complex blocks reach the step on the
    device of ``state`` as complex64, planes or wire-code arrays (``[2,
    ...]`` int8, int16 or bfloat16, NumPy or host tensors) keep their dtype
    so that ``iq_from_any`` dequantizes them.  ``on_results`` receives
    each step's results after the next step has been launched, so the
    host reads step k's results while the card runs step k+1.  Spans:
    ``rx.ingest`` for each block's staging, ``rx.deliver`` for each
    ``on_results`` call (the k-th holds the k-th step's results)."""
    def rechunk(it):
        if block_size is None:
            yield from it
            return
        buf = np.zeros(0, np.complex64)
        for blk in it:
            buf = np.concatenate([buf, np.asarray(blk)])
            while len(buf) >= block_size:
                yield buf[:block_size]
                buf = buf[block_size:]
        if len(buf):
            yield np.concatenate(
                [buf, np.zeros(block_size - len(buf), np.complex64)])

    device = _state_device(state)

    def stage(blk):
        # an asynchronous copy from pinned memory: no sync here
        with span("rx.ingest"):
            t = blk if isinstance(blk, torch.Tensor) else torch.as_tensor(
                np.asarray(blk))
            if t.is_complex():
                t = t.to(torch.complex64)
            if device.type == "cuda":
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)

    def deliver(results):
        with span("rx.deliver"):
            on_results(results)

    pending = None
    for blk in rechunk(BlockPrefetcher(source, depth)):
        state, results = step(state, stage(blk))
        if pending is not None and on_results is not None:
            deliver(pending)         # the previous step's, while this runs
        pending = results
    if pending is not None and on_results is not None:
        deliver(pending)
    return state


class AsyncTxProducer:
    """TX worker thread: packet submission decoupled from sample production.

    :meth:`transmit_packet` enqueues work without blocking, and a worker
    thread keeps a bounded queue of generated sample blocks filled ahead of
    the consumer's stream cursor (idle channels produce zeros, as the
    reference's TX worker does).  Every access to the TX object happens on
    the worker thread.  An exception of the worker ends :meth:`blocks`
    by raising it in the consumer (JAX's ``blocks`` waits on for ever)."""

    _DONE = object()

    def __init__(self, tx, block_channel_samples: int = 256,
                 depth: int = 8):
        self._tx = tx
        self._block = block_channel_samples
        self._work: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._pending: list = []       # submitted but not yet stamped
        self._error: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    # -- producer side (any thread) ---------------------------------------
    def transmit_packet(self, ch: int, header, payload, **props) -> None:
        """Non-blocking submit (the reference's transmit_packet)."""
        self._work.put((int(ch), np.asarray(header, np.uint8),
                        np.asarray(payload, np.uint8), props))

    def close(self) -> None:
        self._work.put(self._DONE)

    # -- worker ------------------------------------------------------------
    def _run(self):
        try:
            self._worker()
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            self._error = e
            raise

    def _worker(self):
        tx = self._tx
        open_ = True
        while not self._stop.is_set():
            # pull new submissions (non-blocking once producing)
            while open_:
                try:
                    item = self._work.get_nowait()
                except queue.Empty:
                    break
                if item is self._DONE:
                    open_ = False
                    break
                self._pending.append(item)
            # stamp work onto ready channels
            still = []
            for ch, header, payload, props in self._pending:
                if tx.is_channel_ready(ch):
                    tx.update_data(ch, header, payload, **props)
                else:
                    still.append((ch, header, payload, props))
            self._pending = still
            idle = (not self._pending and
                    all(tx.is_channel_ready(c)
                        for c in range(tx.num_channels)))
            if not open_ and idle:
                # flush the synthesis filter memory (the end-of-burst drain)
                taps = getattr(getattr(tx, "chz", None), "P", 0)
                if taps:
                    self._put(tx.generate_samples(2 * taps))
                self._put(self._DONE)
                return
            # generate ahead of the cursor (waits while the queue is full,
            # checking the stop flag so that stop() always unblocks it)
            if self._put(tx.generate_samples(self._block)):
                return

    def _put(self, item) -> bool:
        """Bounded put that aborts on stop(); True when stopped."""
        while True:
            try:
                self._out.put(item, timeout=0.1)
                return False
            except queue.Full:
                if self._stop.is_set():
                    return True

    # -- consumer side ------------------------------------------------------
    def blocks(self) -> Iterator[np.ndarray]:
        """Yield generated sample blocks until the producer drains (or
        stop() interrupts it)."""
        while True:
            try:
                item = self._out.get(timeout=0.1)
            except queue.Empty:
                if not self._t.is_alive():
                    if self._error is not None:
                        raise self._error
                    return   # stopped with a full queue: no _DONE came
                continue
            if item is self._DONE:
                return
            yield item

    def queued_blocks(self) -> int:
        """Blocks currently generated ahead of the consumer."""
        return self._out.qsize()

    def stop(self):
        """Abandon production: unblocks a worker parked on the full output
        queue and ends blocks() iteration (buffered blocks drain first)."""
        self._stop.set()
        self._t.join(timeout=5.0)
        # wake a consumer waiting in blocks(): the worker may have exited
        # without queueing _DONE
        try:
            self._out.put_nowait(self._DONE)
        except queue.Full:
            pass
