"""DoublyBufferedData — RCU-like read-mostly data.

Rebuild of ``butil/containers/doubly_buffered_data.h:87``: readers read the
foreground buffer without locking; a modifier mutates the background buffer,
atomically swaps the index, waits for in-flight readers of the old foreground
to drain, then applies the same mutation to the (new) background so both
copies converge. Every load balancer's server list lives in one of these
(SURVEY §2.1).

Python adaptation: the foreground reference swap is a single attribute store
(atomic under the GIL); reader drain is tracked with per-buffer epoch counters
instead of thread-local mutexes.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class DoublyBufferedData(Generic[T]):
    def __init__(self, factory: Callable[[], T]):
        self._bufs = [factory(), factory()]
        self._fg = 0  # index of foreground buffer
        self._readers = [0, 0]
        self._reader_lock = threading.Lock()
        self._modify_lock = threading.Lock()

    # ------------------------------------------------------------------ read
    def read(self) -> "_ScopedRead[T]":
        """Context manager yielding the foreground buffer.

        with data.read() as servers: ...
        """
        return _ScopedRead(self)

    # ---------------------------------------------------------------- modify
    def modify(self, fn: Callable[[T], object]) -> object:
        """Apply fn to both buffers with the foreground swapped in between.

        fn must be deterministic w.r.t. the buffer it receives. Returns fn's
        result from the second (now-background) application, matching the
        reference's return-value contract.
        """
        with self._modify_lock:
            bg = 1 - self._fg
            fn(self._bufs[bg])
            # Swap foreground: new readers now land on the freshly-modified
            # buffer; the old foreground becomes background once drained.
            self._fg = bg
            old_fg = 1 - bg
            self._wait_readers(old_fg)
            return fn(self._bufs[old_fg])

    def _wait_readers(self, idx: int, spin_s: float = 0.0005) -> None:
        while True:
            with self._reader_lock:
                if self._readers[idx] == 0:
                    return
            time.sleep(spin_s)

    # -------------------------------------------------------------- internal
    def _pin(self) -> int:
        with self._reader_lock:
            idx = self._fg
            self._readers[idx] += 1
            return idx

    def _unpin(self, idx: int) -> None:
        with self._reader_lock:
            self._readers[idx] -= 1


class _ScopedRead(Generic[T]):
    __slots__ = ("_data", "_idx")

    def __init__(self, data: DoublyBufferedData[T]):
        self._data = data
        self._idx = -1

    def __enter__(self) -> T:
        self._idx = self._data._pin()
        return self._data._bufs[self._idx]

    def __exit__(self, *exc) -> None:
        self._data._unpin(self._idx)
