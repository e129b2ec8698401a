"""Credit sub-windows: leasing slices of a PeerWindow to worker processes.

The parent endpoint owns the tunnel's credit window (transport.PeerWindow —
the free-list over the CLIENT's registered block pool). Workers must be
able to post bulk responses into that pool without a parent round-trip per
response, but the credit machinery (acquire parks, FT_ACK releases, the
CreditLedger's balance checks) must stay single-owner. The lease protocol
splits the difference:

- the parent's ``LeaseManager`` acquires batches of block indices from the
  PeerWindow (bounded, non-parking: short timeout) and GRANTS them to a
  worker over its ring (``R_LEASE_GRANT``); the grant is just integers;
- the worker's ``SubWindow`` holds granted indices in a local free-list
  and takes them **all-or-nothing, never blocking** (``take_now``) — the
  worker's dispatch loop also services grants, so parking on one would
  self-deadlock;
- a posted response's credits flow home on the normal path: client parses,
  client FT_ACKs, parent ``on_ack`` releases into the PeerWindow. The
  LeaseManager only forgets them (``note_posted``);
- un-posted credits come back explicitly (``W_LEASE_RETURN`` →
  ``note_returned``) or wholesale when the worker dies
  (``reclaim_worker``), so the ledger balances at teardown no matter how
  the worker exits.

Epoch discipline: every grant carries the window generation it was cut
from. A re-handshake swaps the pool + epoch; stale grants are dropped by
the worker and stale returns by the parent — credits never cross epochs.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Set


class LeaseManager:
    """Parent-side bookkeeping of which worker holds which credits of one
    endpoint's PeerWindow. All methods are thread-safe (collector thread +
    shutdown path)."""

    def __init__(self, window, epoch: int):
        self.window = window
        self.epoch = epoch
        self._lock = threading.Lock()
        self._leased: Dict[int, Set[int]] = {}   # worker idx -> indices held
        self.grants = 0
        self.grant_misses = 0
        self.reclaims = 0

    def grant(self, widx: int, want: int,
              timeout: float = 0.05) -> Optional[List[int]]:
        """Acquire up to ``want`` credits for worker ``widx``. Bounded wait:
        the collector thread must not park a credit round-trip long — an
        empty window answers None and the worker keeps using its W_RESP
        fallback until credits free up."""
        if want <= 0:
            return None
        got = self.window.acquire(want, timeout=timeout)
        if not got:
            self.grant_misses += 1
            return None
        with self._lock:
            self._leased.setdefault(widx, set()).update(got)
        self.grants += 1
        return got

    def ungrant(self, widx: int, indices) -> None:
        """A grant that never reached the worker (ring full, worker died
        between grant and push): release straight back to the window."""
        indices = list(indices)
        with self._lock:
            held = self._leased.get(widx)
            if held is not None:
                held.difference_update(indices)
        self.window.release(indices)

    def note_posted(self, widx: int, indices) -> None:
        """Worker filled these blocks and the parent posted the segs frame:
        the credits are now in flight to the client and return through the
        normal FT_ACK -> on_ack -> window.release path."""
        with self._lock:
            held = self._leased.get(widx)
            if held is not None:
                held.difference_update(indices)

    def note_returned(self, widx: int, indices) -> None:
        """Worker handed unused credits back (idle shrink or reclaim)."""
        indices = list(indices)
        with self._lock:
            held = self._leased.get(widx)
            if held is None:
                fresh = indices
            else:
                fresh = [i for i in indices if i in held]
                held.difference_update(fresh)
        if fresh:
            self.window.release(fresh)

    def reclaim_worker(self, widx: int) -> int:
        """Worker death: every credit it still holds goes back to the
        window in one motion (its shm mapping died with it; the blocks
        themselves are parent/client-owned and unaffected)."""
        with self._lock:
            held = self._leased.pop(widx, None)
        if not held:
            return 0
        self.reclaims += 1
        self.window.release(sorted(held))
        return len(held)

    def release_all(self) -> int:
        """Plane shutdown: force-return every outstanding lease so the
        endpoint's orderly close finds the window whole."""
        with self._lock:
            all_held = [i for s in self._leased.values() for i in s]
            self._leased.clear()
        if all_held:
            self.window.release(sorted(all_held))
        return len(all_held)

    def leased_count(self, widx: int) -> int:
        with self._lock:
            held = self._leased.get(widx)
            return len(held) if held else 0

    def leased_counts(self) -> Dict[int, int]:
        with self._lock:
            return {w: len(s) for w, s in self._leased.items()}


class SubWindow:
    """Worker-side slice of the client's registered pool: the shm segment
    attached BY NAME plus a local free-list of leased block indices. No
    conditions, no parking — ``take_now`` either satisfies the whole ask
    from leased credits or answers None and the caller falls back to the
    inline W_RESP path."""

    def __init__(self, name: str, block_size: int, block_count: int,
                 epoch: int):
        from multiprocessing import shared_memory as _shm

        from brpc_tpu_torch.shard.ring import _untrack

        self._shm = _shm.SharedMemory(name=name)
        _untrack(name)
        self.name = name
        self.block_size = block_size
        self.block_count = block_count
        self.epoch = epoch
        self._lock = threading.Lock()
        self._free: deque = deque()
        self.granted_total = 0
        self.taken_total = 0
        self.take_misses = 0

    def grant(self, indices, epoch: int) -> bool:
        """Accept a lease grant; stale-epoch grants are dropped (their
        indices were already reclaimed parent-side when the epoch turned)."""
        if epoch != self.epoch:
            return False
        with self._lock:
            self._free.extend(indices)
        self.granted_total += len(indices)
        return True

    def take_now(self, want: int) -> Optional[List[int]]:
        """All-or-nothing, non-blocking: a partial bulk response would
        strand a half-written packet, so either the whole ask is served
        from leased credits or the caller uses the W_RESP fallback."""
        with self._lock:
            if want <= 0 or len(self._free) < want:
                self.take_misses += 1
                return None
            got = [self._free.popleft() for _ in range(want)]
        self.taken_total += want
        return got

    def give_back(self, want: int) -> List[int]:
        """Surrender up to ``want`` free credits (R_LEASE_RECLAIM): the
        caller ships them home as W_LEASE_RETURN."""
        with self._lock:
            take = min(want, len(self._free))
            return [self._free.popleft() for _ in range(take)]

    def free_count(self) -> int:
        return len(self._free)

    def fill(self, idx: int, data, length: int) -> None:
        """memcpy ``length`` bytes into leased block ``idx`` — the single
        copy a sharded bulk response pays, landing directly in
        client-visible registered memory."""
        base = idx * self.block_size
        self._shm.buf[base:base + length] = data

    def close(self) -> None:
        try:
            self._shm.close()
        except Exception:
            pass
