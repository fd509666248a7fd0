"""Shared serving primitives: double-buffered ingestion and slot pools —
the port's copy of `repro/serve/queue.py`.

`DoubleBuffer` is the software analogue of the hardware external-events
processor's present/future BRAM pair: producers always write into the
FUTURE buffer and never contend with the batch currently executing;
the dispatcher promotes future -> present only at a batch boundary
(inside `take`). `take` also implements the micro-batch admission
policy — wait for the first item, then keep admitting until either
`max_n` items are aboard or `max_wait_s` has elapsed since the batch
opened (deadline + max-batch).

`SlotPool` is a fixed-capacity slot allocator shared by the spike
server's session lanes and the LM server's decode slots
(`repro_torch.launch.serve`) — acquire a free slot id, release it when the
stream ends, read the active mask for batched state updates.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np

__all__ = ["DoubleBuffer", "SlotPool", "BufferFull", "BufferClosed"]


class BufferFull(RuntimeError):
    """Raised when a bounded serving resource is at capacity — the
    `DoubleBuffer` ingestion queue, or the LM server's decode
    `SlotPool`. Backpressure is the caller's contract: the portal maps
    this to HTTP 503 + Retry-After instead of queueing without bound.
    Carries `pending` and `capacity`; dispatch layers may attach
    `retry_after_s` before re-raising."""

    def __init__(self, pending: int, capacity: int,
                 what: str = "ingestion buffer"):
        super().__init__(
            f"{what} full: {pending} pending >= capacity "
            f"{capacity} — retry after the present batch drains")
        self.pending = int(pending)
        self.capacity = int(capacity)
        self.retry_after_s: Optional[float] = None


class BufferClosed(RuntimeError):
    """Raised by `put` after `close()` — the server is shutting down
    (portal maps it to 503)."""

    def __init__(self):
        super().__init__("buffer is closed")


class DoubleBuffer:
    """Two-sided request buffer: `put` appends to the future side (and
    never blocks on an executing batch); `take` promotes accumulated
    items to the present side at batch boundaries and applies the
    deadline + max-batch admission policy. FIFO order is preserved
    across promotions. `capacity` bounds the TOTAL pending count
    (present + future): a put beyond it raises `BufferFull` — loaded
    callers shed instead of queueing unboundedly."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = None if capacity is None else int(capacity)
        self._future: List = []
        self._present: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        # ingestion statistics (read under the lock via `stats`)
        self.swaps = 0
        self.max_future_depth = 0
        self.rejected = 0

    # ------------------------------------------------------- producers
    def put(self, item) -> None:
        """Enqueue into the FUTURE buffer. Never blocks on the present
        batch — this is the double-buffering contract. Raises
        `BufferFull` at capacity, `BufferClosed` after `close()`."""
        with self._cond:
            if self._closed:
                raise BufferClosed()
            if self.capacity is not None \
                    and self._pending_locked() >= self.capacity:
                self.rejected += 1
                raise BufferFull(self._pending_locked(), self.capacity)
            self._future.append(item)
            self.max_future_depth = max(self.max_future_depth,
                                        len(self._future))
            self._cond.notify_all()

    def close(self) -> None:
        """Wake all waiters; further `put` calls raise."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def reopen(self) -> None:
        """Accept items again after `close()` — a restarted server
        reuses its buffer (stats and capacity carry over)."""
        with self._cond:
            self._closed = False

    # ------------------------------------------------------ dispatcher
    def _promote_locked(self) -> None:
        """future -> present (the batch-boundary buffer swap)."""
        if self._future:
            self._present.extend(self._future)
            self._future = []
            self.swaps += 1

    def _pending_locked(self) -> int:
        return len(self._present) + len(self._future)

    @property
    def pending(self) -> int:
        with self._cond:
            return self._pending_locked()

    def take(self, max_n: int, max_wait_s: float = 0.0,
             coalesce: Optional[Callable] = None,
             idle_wait_s: float = 0.05) -> List:
        """Admit the next micro-batch. Blocks up to `idle_wait_s` for a
        first item (returns [] if none arrives — the dispatcher's idle
        tick), then admits items in FIFO order until `max_n` are aboard
        or `max_wait_s` has passed since the batch opened.

        `coalesce(batch, next_item) -> bool` decides whether
        `next_item` may join the open batch; a refused item stays at
        the head for the next take — that is how reconfiguration
        barriers and model switches cut batches without reordering."""
        out: List = []
        with self._cond:
            if not self._pending_locked() and not self._closed:
                self._cond.wait(idle_wait_s)
            if not self._pending_locked():
                return out
            opened = time.monotonic()
            while len(out) < max_n:
                self._promote_locked()
                while self._present and len(out) < max_n:
                    nxt = self._present[0]
                    if out and coalesce is not None \
                            and not coalesce(out, nxt):
                        return out
                    out.append(self._present.popleft())
                if len(out) >= max_n:
                    break
                remain = max_wait_s - (time.monotonic() - opened)
                if remain <= 0 or self._closed:
                    break
                self._cond.wait(remain)
                if not self._pending_locked() \
                        and time.monotonic() - opened >= max_wait_s:
                    break
        return out

    def drain(self) -> List:
        """Remove and return everything still pending (both sides), in
        FIFO order. Used by `SpikeServer.shutdown` to resolve or cancel
        leftover futures so no client ever hangs on process exit."""
        with self._cond:
            self._promote_locked()
            out = list(self._present)
            self._present.clear()
            return out

    def stats(self) -> dict:
        with self._cond:
            return {"pending": self._pending_locked(),
                    "swaps": self.swaps,
                    "max_future_depth": self.max_future_depth,
                    "capacity": self.capacity,
                    "rejected": self.rejected}


class SlotPool:
    """Fixed-capacity slot allocator. Slot ids are stable integers in
    [0, n_slots); `mask` is the bool active vector batched state
    updates index with (the LM server's `active` array, the spike
    server's session-lane occupancy)."""

    def __init__(self, n_slots: int):
        self.n_slots = int(n_slots)
        self._free = deque(range(self.n_slots))
        self._mask = np.zeros((self.n_slots,), bool)
        self._cond = threading.Condition()

    def acquire(self, timeout: Optional[float] = None) -> Optional[int]:
        """Claim a free slot id; blocks up to `timeout` (None = no
        wait). Returns None if none freed up in time."""
        with self._cond:
            if not self._free and timeout:
                self._cond.wait(timeout)
            if not self._free:
                return None
            s = self._free.popleft()
            self._mask[s] = True
            return s

    def acquire_slot(self, slot: int) -> int:
        """Claim one SPECIFIC free slot (checkpoint restore re-pins
        sessions to the exact lanes they held — session ids double as
        lane ids in the serving tier). Raises if the slot is out of
        range or already held."""
        with self._cond:
            if not 0 <= slot < self.n_slots:
                raise IndexError(f"slot {slot} outside pool of "
                                 f"{self.n_slots}")
            if self._mask[slot]:
                raise ValueError(f"slot {slot} is already held")
            self._free.remove(slot)
            self._mask[slot] = True
            return slot

    def release(self, slot: int) -> None:
        with self._cond:
            if not 0 <= slot < self.n_slots:
                raise IndexError(f"slot {slot} outside pool of "
                                 f"{self.n_slots}")
            if not self._mask[slot]:
                raise ValueError(f"slot {slot} is not held")
            self._mask[slot] = False
            self._free.append(slot)
            self._cond.notify()

    @property
    def mask(self) -> np.ndarray:
        """Bool (n_slots,) active vector — a live view, index it
        read-only."""
        return self._mask

    @property
    def n_active(self) -> int:
        with self._cond:
            return int(self._mask.sum())

    @property
    def n_free(self) -> int:
        with self._cond:
            return len(self._free)
