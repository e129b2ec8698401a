"""IOBuf — zero-copy chained buffer, the unit of all payload movement.

TPU-native rebuild of the reference's ``butil/iobuf.h:62`` (IOBuf: ref-counted
block chain, ``append``/``cutn`` at iobuf.h:141,207). Our design keeps the
same contract — cheap append, cheap cut, no large copies — but is built on
Python ``memoryview`` slices over immutable blocks instead of manual
refcounting (the CPython GC plays the role of the block refcount). A pluggable
block source lets pinned-host buffers back blocks later (the reference's RDMA
``block_pool.cpp`` / our PJRT pinned-host allocator, see SURVEY §5.8).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator, List, Optional

try:  # numpy backs the owned-block exporter; gate, don't require
    import numpy as _np
except Exception:  # pragma: no cover - numpy ships with the jax toolchain
    _np = None

DEFAULT_BLOCK_SIZE = 8192


if _np is not None:

    class _OwnedBlock(_np.ndarray):
        """Buffer exporter that runs a release hook when the LAST memoryview
        over it dies (the reference's iobuf block refcount, done with the
        CPython refcount: every slice/re-wrap of a memoryview keeps its
        exporter alive through ``Py_buffer.obj``, so the hook fires exactly
        when no live view can read the block anymore — however the views
        were split by ``cutn``/``pop_front`` or queued for a socket write).
        """

        _release: Optional[Callable[[], None]] = None

        def __del__(self):
            cb = self._release
            if cb is not None:
                self._release = None
                try:
                    cb()
                except Exception:
                    pass

else:  # pragma: no cover - degraded environment without numpy
    _OwnedBlock = None


def supports_block_ownership() -> bool:
    """True when append_user_data(..., release=) can defer the release to
    actual consumption instead of copying eagerly."""
    return _OwnedBlock is not None


class IOBuf:
    """A chain of (memoryview, offset, length) refs over shared blocks.

    Appending bytes stores a view; cutting N bytes moves views (splitting at
    most one block) — no payload copy in either direction. ``tobytes`` is the
    only full-copy operation and is what crosses into the device transport.
    """

    __slots__ = ("_refs", "_size")

    def __init__(self, data: Optional[bytes] = None):
        self._refs: deque = deque()  # of memoryview
        self._size = 0
        if data:
            self.append(data)

    # ------------------------------------------------------------------ size
    def __len__(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0

    @property
    def size(self) -> int:
        return self._size

    # ---------------------------------------------------------------- append
    def append(self, data) -> None:
        """Append bytes-like or another IOBuf (steals its refs — O(blocks))."""
        if isinstance(data, IOBuf):
            if data is self:
                # self-append duplicates content instead of losing it
                self.append(self.tobytes())
                return
            self._refs.extend(data._refs)
            self._size += data._size
            data._refs = deque()
            data._size = 0
            return
        mv = memoryview(data) if not isinstance(data, memoryview) else data
        if mv.nbytes == 0:
            return
        if mv.format != "B":
            mv = mv.cast("B")
        self._refs.append(mv)
        self._size += mv.nbytes

    def append_copy(self, data) -> None:
        """Append a private copy (when the caller will mutate its buffer)."""
        self.append(bytes(data))

    def append_user_data(self, mv: memoryview,
                         release: Optional[Callable[[], None]] = None) -> bool:
        """Append a caller-owned block without copy.

        Mirrors ``append_user_data_with_meta`` (reference iobuf.h:141) used
        for registered/pinned memory on the zero-copy path. With ``release``,
        the block is wrapped in a refcounted exporter and the callback fires
        exactly once, when the last live view over the block dies — i.e. when
        ``cutn``/``pop_front``/``clear`` consumption (or any downstream
        holder: a parsed message body, a socket write queue) has let go of
        every byte. Returns True when the append was zero-copy with deferred
        release; False when the environment forced a private copy (release
        already ran — the caller may reuse the buffer immediately).
        """
        if release is None:
            self.append(mv)
            return True
        if not isinstance(mv, memoryview):
            mv = memoryview(mv)
        if mv.nbytes == 0:
            release()
            return True
        if _OwnedBlock is None:
            # no exporter available: keep the CONTRACT (caller may recycle
            # the block once release ran) by copying, then releasing now
            self.append(bytes(mv))
            release()
            return False
        blk = _np.frombuffer(mv, dtype=_np.uint8).view(_OwnedBlock)
        blk._release = release
        self.append(memoryview(blk))
        return True

    def has_owned_blocks(self) -> bool:
        """True if any ref aliases a release-tracked block (borrowed
        registered memory): wholesale snapshot copies of such a buffer
        defeat the zero-copy receive path, so batch cutters bail to the
        ref-moving parse path when this holds."""
        if _OwnedBlock is None:
            return False
        for mv in self._refs:
            if type(mv.obj) is _OwnedBlock:
                return True
        return False

    # ------------------------------------------------------------------- cut
    def cutn(self, n: int) -> "IOBuf":
        """Cut the first n bytes into a new IOBuf (zero-copy)."""
        if n < 0:  # a negative n would silently corrupt the size invariant
            raise ValueError(f"cutn({n})")
        out = IOBuf()
        self.cutn_into(n, out)
        return out

    def cutn_into(self, n: int, out: "IOBuf") -> int:
        n = min(n, self._size)
        remain = n
        refs = self._refs
        while remain > 0:
            mv = refs[0]
            ln = mv.nbytes
            if ln <= remain:
                out._refs.append(refs.popleft())
                out._size += ln
                remain -= ln
            else:
                out._refs.append(mv[:remain])
                out._size += remain
                refs[0] = mv[remain:]
                remain = 0
        self._size -= n
        return n

    def cutn_into_buffer(self, n: int, dest) -> int:
        """Copy the first n bytes into writable buffer ``dest`` and pop them.

        The claiming consume of the streaming parse path: unlike ``cutn``
        (which moves refs and keeps source blocks alive inside the result),
        this drops the source refs as it copies, so release hooks of borrowed
        registered blocks fire immediately — mid-message, not when the parsed
        message is eventually dropped. Returns bytes copied.
        """
        if n < 0:
            raise ValueError(f"cutn_into_buffer({n})")
        n = min(n, self._size)
        if n == 0:
            return 0
        target = dest if isinstance(dest, memoryview) else memoryview(dest)
        if target.format != "B":
            target = target.cast("B")
        remain = n
        off = 0
        refs = self._refs
        while remain > 0:
            mv = refs[0]
            ln = mv.nbytes
            if ln <= remain:
                target[off:off + ln] = mv
                off += ln
                remain -= ln
                refs.popleft()
            else:
                target[off:off + remain] = mv[:remain]
                refs[0] = mv[remain:]
                remain = 0
        self._size -= n
        return n

    def pop_front(self, n: int) -> int:
        """Drop the first n bytes."""
        if n < 0:
            raise ValueError(f"pop_front({n})")
        n = min(n, self._size)
        remain = n
        refs = self._refs
        while remain > 0:
            mv = refs[0]
            ln = mv.nbytes
            if ln <= remain:
                refs.popleft()
                remain -= ln
            else:
                refs[0] = mv[remain:]
                remain = 0
        self._size -= n
        return n

    def clear(self) -> None:
        self._refs.clear()
        self._size = 0

    # ------------------------------------------------------------------ peek
    def fetch(self, n: int) -> bytes:
        """Copy out the first n bytes without consuming them."""
        n = min(n, self._size)
        if n == 0:
            return b""
        first = self._refs[0]
        if first.nbytes >= n:  # fast path: one block
            return bytes(first[:n])
        parts = []
        remain = n
        for mv in self._refs:
            take = min(mv.nbytes, remain)
            parts.append(bytes(mv[:take]))
            remain -= take
            if remain == 0:
                break
        return b"".join(parts)

    def fetch1(self) -> Optional[int]:
        if self._size == 0:
            return None
        return self._refs[0][0]

    # ------------------------------------------------------------- full copy
    def tobytes(self) -> bytes:
        if not self._refs:
            return b""
        if len(self._refs) == 1:
            return bytes(self._refs[0])
        return b"".join(bytes(mv) for mv in self._refs)

    def readinto(self, buf) -> int:
        """Copy the whole chain into a writable buffer; returns bytes copied."""
        target = memoryview(buf).cast("B")
        off = 0
        for mv in self._refs:
            ln = mv.nbytes
            target[off : off + ln] = mv
            off += ln
        return off

    # -------------------------------------------------------------- chunking
    def iter_blocks(self) -> Iterator[memoryview]:
        return iter(self._refs)

    def block_count(self) -> int:
        return len(self._refs)

    def cut_into_writer(self, write_fn, max_bytes: int = 1 << 20) -> int:
        """Feed blocks to write_fn(bytes-like)->int until it short-writes.

        The analog of ``cut_into_file_descriptor`` (iobuf.h:163): writes as
        much as the sink accepts and pops exactly that many bytes.
        """
        written = 0
        while self._refs and written < max_bytes:
            mv = self._refs[0]
            try:
                n = write_fn(mv)
            except BlockingIOError:
                break
            if n is None:  # SSL-style would-block
                break
            self.pop_front(n)
            written += n
            if n < mv.nbytes:
                break
        return written

    def __bytes__(self) -> bytes:
        return self.tobytes()

    def __eq__(self, other) -> bool:
        if isinstance(other, IOBuf):
            return self.tobytes() == other.tobytes()
        if isinstance(other, (bytes, bytearray, memoryview)):
            return self.tobytes() == bytes(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"IOBuf(size={self._size}, blocks={len(self._refs)})"


class IOBufAppender:
    """Buffered small-write appender (reference ``IOBufAppender``).

    Batches many tiny appends into DEFAULT_BLOCK_SIZE blocks so the chain does
    not degrade into one ref per byte.
    """

    __slots__ = ("_buf", "_pending", "_pending_len")

    def __init__(self):
        self._buf = IOBuf()
        self._pending: List[bytes] = []
        self._pending_len = 0

    def append(self, data: bytes) -> None:
        self._pending.append(bytes(data))
        self._pending_len += len(data)
        if self._pending_len >= DEFAULT_BLOCK_SIZE:
            self.flush()

    def flush(self) -> None:
        if self._pending:
            self._buf.append(b"".join(self._pending))
            self._pending.clear()
            self._pending_len = 0

    def buf(self) -> IOBuf:
        self.flush()
        return self._buf
