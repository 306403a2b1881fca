"""Host I/O overlapped with device DSP.

Port of :class:`BlockPrefetcher` from ``liquid_usrp_tpu/io/pipeline.py``: a
producer thread keeps a bounded queue of IQ blocks filled from any iterator
(a file through the native double-buffered reader, for example) while the
consumer drives the synchronizer; PyTorch's asynchronous CUDA launches
overlap the device work with the next block's host preparation.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np

__all__ = ["BlockPrefetcher"]


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
